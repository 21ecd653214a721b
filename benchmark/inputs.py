"""Everything a run feeds both sides, made from ``--seed``.

* Weights: the recipe of the port's test fixtures and bench (normal
  convolution weights, batch-norm statistics of order one folded in),
  drawn on the device by one ``torch.Generator`` in three calls for the
  whole net; then each convolution is scaled, in order, so that its output
  (before the bias) has a root mean square of one on a few frames from the
  seed, as a trained net's batch-normalised layers have, and each anchor's
  objectness bias is set so that about as few candidates pass the
  threshold as a trained net gives (``CANDIDATE_SHARE``). Without the
  scaling, the recipe's activations grow through Darknet-53's 23 residual
  blocks to a root mean square of tens, the heads' logits spread by tens,
  box sizes run to exp(60) and a bf16 walk's rounding moves boxes by tens
  of percent.
* Frames: BGR uint8 images of one size, smooth colour fields with grain,
  so that every seed gives the same sizes and work and other pixels.
"""
from __future__ import annotations

from types import ModuleType
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from reference.yolo import Net, conv_in_channels

BN_EPS = 1e-5
# the share of cells whose objectness reaches OBJECTNESS_FLOOR on the scaling
# frames: about 45 of yolov3@608's 22,743 candidates, as a trained net gives
CANDIDATE_SHARE = 0.002
OBJECTNESS_FLOOR = 0.06  # the 0.05 threshold over a best class prob of ~0.9
# objectness logits spread this much, so that the few cells over the
# threshold reach scores from 0.05 to about 0.5, not all just over 0.05
OBJECTNESS_SPREAD = 2.0
SCALING_FRAMES = 4  # frames of the net's size that set each conv's scale
FIELD_PX = 16  # the frames' colour fields change about every 16 pixels
GRAIN = 16.0  # and carry grain of this standard deviation (of 255)

Weights = Dict[int, Tuple[torch.Tensor, torch.Tensor]]


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 7919 + stream) % (2 ** 63))
    return g


def make_weights(ref: ModuleType, net: Net, seed: int, device) -> Weights:
    """{conv index: (folded OIHW weight, bias)} float32 on ``device``; the
    scaling walks ``net`` with the plain reference ``ref`` (the module the
    configuration names, ``harness.reference_module``)."""
    weights = draw_weights(net, seed, device)
    frames = make_frames(SCALING_FRAMES, (net.height, net.width), seed, 2, device)
    x = ref.letterbox(torch.from_numpy(frames).to(device), (net.height, net.width))

    per = 5 + net.classes
    obj_at = -np.log(1.0 / OBJECTNESS_FLOOR - 1.0)

    def unit(layer, y):
        w, b = weights[layer.index]
        y = y - b[:, None, None]
        s = 1.0 / y.pow(2).mean().sqrt().clamp_min(1e-12)
        y = y * s
        s = s * torch.ones_like(b)
        if layer.index + 1 in net.heads:
            # each anchor's objectness spreads by OBJECTNESS_SPREAD logits,
            # and its bias puts CANDIDATE_SHARE of the scaling frames'
            # cells over the threshold
            b = b.clone()
            for a in range(4, y.shape[1], per):
                t = OBJECTNESS_SPREAD / y[:, a].std().clamp_min(1e-12)
                y[:, a] *= t
                s[a] *= t
                b[a] = obj_at - torch.quantile(y[:, a].flatten(), 1 - CANDIDATE_SHARE)
        weights[layer.index] = (w * s[:, None, None, None], b)
        return y + b[:, None, None]

    with torch.inference_mode():
        ref.forward(net, weights, x, on_conv=unit)
    return weights


def draw_weights(net: Net, seed: int, device) -> Weights:
    """The recipe's weights before their scaling."""
    g = generator(seed, 0, device)
    shapes = [(l.channels, conv_in_channels(net, l), int(l.opts.get("size", 1)))
              for l in net.convs]
    n_w = sum(co * ci * k * k for co, ci, k in shapes)
    n_c = sum(co for co, _, _ in shapes)
    flat_w = torch.randn(n_w, generator=g, device=device)
    normal = torch.randn(3, n_c, generator=g, device=device)  # beta, mean, bias
    uniform = torch.rand(2, n_c, generator=g, device=device) + 0.5  # gamma, var
    out: Weights = {}
    ow = oc = 0
    for l, (co, ci, k) in zip(net.convs, shapes):
        w = flat_w[ow:ow + co * ci * k * k].view(co, ci, k, k) / np.sqrt(ci * k * k)
        sl = slice(oc, oc + co)
        if int(l.opts.get("batch_normalize", 0)):
            beta, mean = normal[0, sl] * 0.1, normal[1, sl] * 0.1
            gamma, var = uniform[0, sl], uniform[1, sl]
            s = gamma / torch.sqrt(var + BN_EPS)
            w, b = w * s[:, None, None, None], beta - mean * s
        else:
            b = normal[2, sl] * 0.1
        out[l.index] = (w.contiguous(), b.contiguous())
        ow += co * ci * k * k
        oc += co
    return out


def as_folded_hwio(weights: Weights) -> Dict[int, Dict[str, np.ndarray]]:
    """The Darknet loaders' folded form, ``{idx: {"w": HWIO, "b": (C,)}}``
    in host memory: what a program takes through its public loading path."""
    return {i: {"w": w.permute(2, 3, 1, 0).contiguous().cpu().numpy(),
                "b": b.cpu().numpy()} for i, (w, b) in weights.items()}


def make_frames(n: int, hw, seed: int, stream: int, device) -> np.ndarray:
    """(n, H, W, 3) uint8 frames in host memory: a colour field of one
    value every ``FIELD_PX`` pixels upsampled bilinearly, plus grain."""
    g = generator(seed, 100 + stream, device)
    h, w = hw
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(0, n, 32):  # in chunks: a few hundred MB on the device
        m = min(32, n - i)
        base = torch.rand(m, 3, max(1, h // FIELD_PX), max(1, w // FIELD_PX),
                          generator=g, device=device) * 255.0
        field = F.interpolate(base, size=(h, w), mode="bilinear",
                              align_corners=False)
        grain = torch.randn(m, 3, h, w, generator=g, device=device) * GRAIN
        img = (field + grain).clamp(0, 255).round().to(torch.uint8)
        out[i:i + m] = img.permute(0, 2, 3, 1).cpu().numpy()
    return out
