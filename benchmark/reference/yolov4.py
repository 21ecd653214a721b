"""Plain PyTorch YOLOv4 in float32: the yardstick that decides ``correct``
for a configuration that names ``"reference": "yolov4"``.

Written from the published description (Bochkovskiy, Wang and Liao,
arXiv:2004.10934) and the layer list of AlexeyAB/darknet's ``cfg/yolov4.cfg``,
not from the program under test: it imports nothing of the port, of ``jax``
or of the JAX package. What YOLOv4 shares with YOLOv3 comes from
``reference.yolo``: the cfg reader, the letterbox and its inverse, the
selection and the dataclasses (so ``check`` and ``counts`` read this module's
results as they read that one's). Written here:

1. the walk: ``reference.yolo``'s layers (``[convolutional]`` with folded
   batch norm, ``[shortcut]``, ``[route]``, ``[upsample]`` nearest,
   ``[maxpool]`` with Darknet's padding, so SPP's stride-1 pools of 5, 9 and
   13 keep the map's size) in float32 with TF32 off, and the activations
   leaky ReLU 0.1, linear and Mish, ``x * tanh(softplus(x))`` with
   ``F.softplus``'s threshold of 20 (past it softplus(x) is x, as Darknet's
   ``MISH_THRESHOLD`` has it);
2. each head decoded with its ``scale_x_y`` s, read from the ``[yolo]``
   section (1 where absent): centre = (sigmoid(t_xy) * s - (s - 1) / 2 +
   cell) x stride, size = exp(t_wh) x anchor, score = sigmoid(objectness) x
   sigmoid(best class logit), class = first best;
3. ``reference.yolo.select``: candidates at or above the threshold, the
   ``top_k`` best, greedy class-aware suppression, the ``max_results`` best,
   boxes mapped back to source pixels and clipped to the frame.

Departures from the published model: the frame is letterboxed (aspect kept,
grey padding, ``reference.yolo.letterbox``, as the program under test
prepares it) where Darknet's detector resizes it to 608 x 608 without
keeping the aspect; suppression is greedy and class-aware at the
configuration's IoU threshold (0.3) where the cfg names ``greedynms`` and
Darknet's detector uses 0.45; the ``[yolo]`` sections' training keys
(``iou_thresh``, ``beta_nms``, ``iou_loss`` and the rest) play no part.

The walk's rounding is a parameter as in ``reference.yolo``: the bf16
configuration's control rounds each convolution's operands to float8
(``reference.yolo.fp8_cast``). The int4 control walks ``reference.yolo``
alone, so ``rounding`` is refused here.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from reference.yolo import (EXP_CLAMP, LEAKY_SLOPE, Cast, Decoded, Detections,
                            Net, letterbox, read_cfg, select, unletterbox)

__all__ = ["read_cfg", "letterbox", "forward", "detect", "decode", "mish"]

SOFTPLUS_THRESHOLD = 20.0  # Darknet's MISH_THRESHOLD


def mish(x: torch.Tensor) -> torch.Tensor:
    """x * tanh(softplus(x)), softplus(x) = x past the threshold."""
    return x * torch.tanh(F.softplus(x, threshold=SOFTPLUS_THRESHOLD))


def activate(x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "leaky":
        return F.leaky_relu(x, LEAKY_SLOPE)
    if activation == "mish":
        return mish(x)
    if activation != "linear":
        raise ValueError(f"activation {activation!r} is not supported")
    return x


def forward(net: Net, weights: Dict[int, Tuple[torch.Tensor, torch.Tensor]],
            x: torch.Tensor, cast: Cast = None,
            on_conv: Optional[Callable] = None,
            rounding=None) -> List[torch.Tensor]:
    """(B, 3, H, W) float32 → each head's raw map (B, A*(5+C), h, w), float32
    with TF32 off. ``weights[i] = (w OIHW, b)``, batch norm folded in.
    ``cast`` rounds each convolution's input and weights (the control).
    ``on_conv(layer, y)`` sees each convolution's output before its
    activation and returns the output to go on with (the weights' scaling,
    ``inputs.make_weights``)."""
    if rounding is not None:
        raise ValueError("reference.yolov4 walks in float32 (or float8 "
                         "operands); a quantized walk is reference.yolo's")
    keep = {j for l in net.layers for j in l.inputs if j != l.index - 1}
    saved: Dict[int, torch.Tensor] = {}
    heads: List[torch.Tensor] = []
    prev = x
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for layer in net.layers:
            o, k = layer.opts, layer.kind
            if k == "convolutional":
                w, b = weights[layer.index]
                size = int(o.get("size", 1))
                pad = size // 2 if int(o.get("pad", 0)) else int(o.get("padding", 0))
                inp = prev if cast is None else cast(prev)
                w = w if cast is None else cast(w)
                out = F.conv2d(inp, w, b, stride=int(o.get("stride", 1)),
                               padding=pad)
                if on_conv is not None:
                    out = on_conv(layer, out)
                out = activate(out, o.get("activation", "logistic"))
            elif k == "maxpool":
                size, stride = int(o["size"]), int(o.get("stride", 1))
                total = int(o.get("padding", size - 1))
                lo = total // 2
                padded = F.pad(prev, (lo, total - lo, lo, total - lo),
                               value=float("-inf"))
                out = F.max_pool2d(padded, size, stride)
            elif k == "upsample":
                out = F.interpolate(prev, scale_factor=int(o.get("stride", 2)),
                                    mode="nearest")
            elif k == "shortcut":
                out = activate(prev + saved[layer.inputs[1]],
                               o.get("activation", "linear"))
            elif k == "route":
                parts = [prev if j == layer.index - 1 else saved[j]
                         for j in layer.inputs]
                out = torch.cat(parts, dim=1)
            else:  # yolo
                heads.append(prev)
                out = prev
            if layer.index in keep:
                saved[layer.index] = out
            prev = out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return heads


def head_scale(net: Net, head: int) -> float:
    """A ``[yolo]`` section's ``scale_x_y`` (1 where it gives none)."""
    return float(net.layers[head].opts.get("scale_x_y", 1.0))


def decode(net: Net, maps: Sequence[torch.Tensor],
           scales: Optional[Sequence[float]] = None) -> Decoded:
    """Every candidate of a batch, heads in cfg order, cell-major then
    anchor. ``scales``: each head's ``scale_x_y`` (its section's when None;
    a test passes ones to see that the scale is not dropped)."""
    boxes, obj, cls = [], [], []
    c = net.classes
    if scales is None:
        scales = [head_scale(net, h) for h in net.heads]
    for head, m, s in zip(net.heads, maps, scales):
        layer = net.layers[head]
        a = len(layer.anchors)
        b, _, gh, gw = m.shape
        stride = net.height // gh
        f = m[:, :a * (5 + c)].permute(0, 2, 3, 1).reshape(b, gh, gw, a, 5 + c)
        gy, gx = torch.meshgrid(torch.arange(gh, device=m.device),
                                torch.arange(gw, device=m.device), indexing="ij")
        half = (s - 1.0) / 2.0
        cx = (torch.sigmoid(f[..., 0]) * s - half + gx[..., None]) * stride
        cy = (torch.sigmoid(f[..., 1]) * s - half + gy[..., None]) * stride
        anc = torch.tensor(layer.anchors, dtype=torch.float32, device=m.device)
        bw = torch.exp(f[..., 2].clamp(max=EXP_CLAMP)) * anc[:, 0]
        bh = torch.exp(f[..., 3].clamp(max=EXP_CLAMP)) * anc[:, 1]
        boxes.append(torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2,
                                  cy + bh / 2], -1).reshape(b, -1, 4))
        obj.append(torch.sigmoid(f[..., 4]).reshape(b, -1))
        cls.append(torch.sigmoid(f[..., 5:]).reshape(b, -1, c))
    return Decoded(torch.cat(boxes, 1), torch.cat(obj, 1), torch.cat(cls, 1))


def detect(net: Net, weights, frames_bgr: torch.Tensor, prob_thresh: float,
           iou_thresh: float, top_k: int, max_results: int,
           cast: Cast = None, rounding=None) -> Tuple[List[Detections], Decoded]:
    """The whole path on a batch of same-size frames: detections per image
    in source pixels, and the decoded candidates (net pixels) they came
    from. ``cast`` as :func:`forward` takes it."""
    src_hw = tuple(frames_bgr.shape[1:3])
    net_hw = (net.height, net.width)
    dec = decode(net, forward(net, weights, letterbox(frames_bgr, net_hw), cast,
                              rounding=rounding))
    score, cls = dec.scores
    out = []
    for i in range(frames_bgr.shape[0]):
        bx, sc, cl = (dec.boxes[i].cpu().numpy(), score[i].cpu().numpy(),
                      cls[i].cpu().numpy())
        keep = select(bx, sc, cl, prob_thresh, iou_thresh, top_k, max_results)
        out.append(Detections(unletterbox(bx[keep], src_hw, net_hw),
                              sc[keep].astype(np.float32), cl[keep]))
    return out, dec
