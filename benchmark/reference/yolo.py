"""Plain PyTorch YOLOv3 in float32: the yardstick that decides ``correct``.

Written from the published description (Redmon & Farhadi, arXiv:1804.02767,
and Darknet's ``cfg`` format), not from the program under test: it imports
nothing of the port, of ``jax`` or of the JAX package. One image path:

1. BGR uint8 frame → RGB, /255, bilinear resize with half-pixel centres
   (``F.interpolate``, no antialias) to the letterbox size, centred on a
   grey canvas of 128/255;
2. the cfg's layers in float32 with TF32 off (``[convolutional]`` with
   folded batch norm, leaky ReLU 0.1, ``[shortcut]``, ``[route]``,
   ``[upsample]`` nearest, ``[maxpool]`` with Darknet's padding,
   ``[yolo]``);
3. each head decoded: centre = (sigmoid(t_xy) + cell) x stride, size =
   exp(t_wh) x anchor, score = sigmoid(objectness) x sigmoid(best class
   logit), class = first best;
4. candidates at or above the threshold, the ``top_k`` best (ties: the
   lower index first), greedy class-aware suppression at IoU > threshold,
   the ``max_results`` best survivors, boxes mapped back to source pixels
   and clipped to the frame.

The walk's rounding is a parameter: a configuration that quantizes runs
the rounding of ``reference.int8``, and the bf16 configuration's control
rounds each convolution's operands to float8 (:func:`fp8_cast`); the
reference of a float configuration runs float32.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

PAD_VALUE = 128.0 / 255.0
LEAKY_SLOPE = 0.1
EXP_CLAMP = 60.0  # exp(t_wh) is bounded so float32 never overflows


@dataclass
class Layer:
    index: int
    kind: str
    opts: Dict[str, str]
    inputs: Tuple[int, ...] = ()
    channels: int = 0
    stride: int = 1  # cumulative downsampling of the output
    anchors: Tuple[Tuple[float, float], ...] = ()


@dataclass
class Net:
    layers: List[Layer]
    width: int
    height: int
    channels: int
    classes: int = 0
    heads: List[int] = field(default_factory=list)  # indices of [yolo] layers

    @property
    def convs(self) -> List[Layer]:
        return [l for l in self.layers if l.kind == "convolutional"]


def read_cfg(path) -> Net:
    """A Darknet ``.cfg`` file → :class:`Net` with each layer's inputs,
    output channels and cumulative stride."""
    sections: List[Tuple[str, Dict[str, str]]] = []
    for raw in Path(path).read_text().splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        if line.startswith("["):
            sections.append((line.strip("[]").strip(), {}))
        else:
            key, value = line.split("=", 1)
            sections[-1][1][key.strip()] = value.strip()
    (kind0, netopts), body = sections[0], sections[1:]
    if kind0 not in ("net", "network"):
        raise ValueError(f"{path}: the first section is [{kind0}], not [net]")
    net = Net([], int(netopts["width"]), int(netopts["height"]),
              int(netopts.get("channels", 3)))
    for i, (kind, opts) in enumerate(body):
        prev = i - 1
        layer = Layer(i, kind, opts)
        src_c = net.channels if prev < 0 else net.layers[prev].channels
        src_s = 1 if prev < 0 else net.layers[prev].stride
        if kind == "convolutional":
            stride = int(opts.get("stride", 1))
            layer.inputs, layer.channels = (prev,), int(opts["filters"])
            layer.stride = src_s * stride
        elif kind == "maxpool":
            stride = int(opts.get("stride", 1))
            layer.inputs, layer.channels = (prev,), src_c
            layer.stride = src_s * stride
        elif kind == "upsample":
            layer.inputs, layer.channels = (prev,), src_c
            layer.stride = src_s // int(opts.get("stride", 2))
        elif kind == "shortcut":
            other = int(opts["from"])
            other = i + other if other < 0 else other
            layer.inputs, layer.channels, layer.stride = (prev, other), src_c, src_s
        elif kind == "route":
            idx = [int(v) for v in opts["layers"].split(",") if v.strip()]
            layer.inputs = tuple(i + v if v < 0 else v for v in idx)
            layer.channels = sum(net.layers[j].channels for j in layer.inputs)
            layer.stride = net.layers[layer.inputs[0]].stride
        elif kind == "yolo":
            flat = [float(v) for v in opts["anchors"].split(",") if v.strip()]
            pairs = list(zip(flat[0::2], flat[1::2]))
            mask = [int(v) for v in opts["mask"].split(",") if v.strip()]
            layer.anchors = tuple(pairs[m] for m in mask)
            layer.inputs, layer.channels, layer.stride = (prev,), src_c, src_s
            net.classes = int(opts["classes"])
            net.heads.append(i)
        else:
            raise ValueError(f"{path}: layer {i} [{kind}] is not supported")
        net.layers.append(layer)
    return net


def conv_in_channels(net: Net, layer: Layer) -> int:
    src = layer.inputs[0]
    return net.channels if src < 0 else net.layers[src].channels


# ----------------------------------------------------------------- letterbox

def letterbox_geometry(src_hw, net_hw) -> Tuple[float, int, int, int, int]:
    """(scale, top, left, new_h, new_w): the aspect-preserving scale, the
    resized size rounded half up, the image centred (the low side gets the
    smaller half of the remainder)."""
    (sh, sw), (nh, nw) = src_hw, net_hw
    scale = min(nh / sh, nw / sw)
    new_h, new_w = int(np.floor(sh * scale + 0.5)), int(np.floor(sw * scale + 0.5))
    return scale, (nh - new_h) // 2, (nw - new_w) // 2, new_h, new_w


def letterbox(frames_bgr: torch.Tensor, net_hw) -> torch.Tensor:
    """(B, H, W, 3) uint8 BGR → (B, 3, net_h, net_w) float32 RGB in [0, 1]."""
    b, h, w, _ = frames_bgr.shape
    _, top, left, new_h, new_w = letterbox_geometry((h, w), net_hw)
    x = frames_bgr.flip(-1).permute(0, 3, 1, 2).to(torch.float32) / 255.0
    if (new_h, new_w) != (h, w):
        x = F.interpolate(x, size=(new_h, new_w), mode="bilinear",
                          align_corners=False, antialias=False)
    out = torch.full((b, 3, *net_hw), PAD_VALUE, dtype=torch.float32,
                     device=x.device)
    out[:, :, top:top + new_h, left:left + new_w] = x
    return out


def unletterbox(boxes: np.ndarray, src_hw, net_hw) -> np.ndarray:
    """tlbr boxes in net pixels → source pixels, clipped to the frame."""
    scale, top, left, _, _ = letterbox_geometry(src_hw, net_hw)
    out = boxes.astype(np.float32).copy()
    out[..., [0, 2]] = ((out[..., [0, 2]] - left) / scale).clip(0, src_hw[1])
    out[..., [1, 3]] = ((out[..., [1, 3]] - top) / scale).clip(0, src_hw[0])
    return out


# ------------------------------------------------------------------- forward

Cast = Optional[Callable[[torch.Tensor], torch.Tensor]]


def fp8_cast(x: torch.Tensor) -> torch.Tensor:
    """The control's rounding: ``x`` scaled so its largest magnitude is
    float8 e4m3's largest finite value, rounded to e4m3, scaled back
    (float32 out)."""
    amax = x.abs().amax().clamp_min(1e-12)
    s = 448.0 / amax
    return (x * s).to(torch.float8_e4m3fn).to(torch.float32) / s


def forward(net: Net, weights: Dict[int, Tuple[torch.Tensor, torch.Tensor]],
            x: torch.Tensor, cast: Cast = None,
            on_conv: Optional[Callable] = None,
            rounding=None) -> List[torch.Tensor]:
    """(B, 3, H, W) float32 → each head's raw map (B, A*(5+C), h, w), float32
    with TF32 off. ``weights[i] = (w OIHW, b)``, batch norm folded in.
    ``cast`` rounds each convolution's input and weights (the control).
    ``on_conv(layer, y)`` sees each convolution's output before its
    activation and returns the output to go on with (the weights' scaling,
    ``inputs.make_weights``). ``rounding`` (``reference.int8``) rounds a
    convolution's input (``conv_input(layer, x)``), its output before the
    activation (``pre_activation(layer, y)``) and every layer's output
    (``output(layer, y)``) as a configuration states."""
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
                if rounding is not None:
                    inp = rounding.conv_input(layer, inp)
                out = F.conv2d(inp, w, b, stride=int(o.get("stride", 1)),
                               padding=pad)
                if on_conv is not None:
                    out = on_conv(layer, out)
                if rounding is not None:
                    out = rounding.pre_activation(layer, out)
                act = o.get("activation", "logistic")
                if act == "leaky":
                    out = F.leaky_relu(out, LEAKY_SLOPE)
                elif act != "linear":
                    raise ValueError(f"activation {act!r} is not supported")
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
                out = prev + saved[layer.inputs[1]]
            elif k == "route":
                parts = [prev if j == layer.index - 1 else saved[j]
                         for j in layer.inputs]
                out = torch.cat(parts, dim=1)
            else:  # yolo
                heads.append(prev)
                out = prev
            if rounding is not None:
                out = rounding.output(layer, out)
            if layer.index in keep:
                saved[layer.index] = out
            prev = out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return heads


@dataclass
class Decoded:
    """Every candidate of a batch, heads in cfg order, cell-major then
    anchor: tlbr boxes in net pixels (B, N, 4), objectness (B, N), class
    probabilities (B, N, C)."""

    boxes: torch.Tensor
    obj: torch.Tensor
    cls: torch.Tensor

    @property
    def scores(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(best score obj x max class prob, first best class)."""
        best, idx = self.cls.max(dim=-1)
        return self.obj * best, idx


def decode(net: Net, maps: Sequence[torch.Tensor]) -> Decoded:
    boxes, obj, cls = [], [], []
    c = net.classes
    for head, m in zip(net.heads, maps):
        layer = net.layers[head]
        a = len(layer.anchors)
        b, _, gh, gw = m.shape
        stride = net.height // gh
        f = m[:, :a * (5 + c)].permute(0, 2, 3, 1).reshape(b, gh, gw, a, 5 + c)
        gy, gx = torch.meshgrid(torch.arange(gh, device=m.device),
                                torch.arange(gw, device=m.device), indexing="ij")
        cx = (torch.sigmoid(f[..., 0]) + gx[..., None]) * stride
        cy = (torch.sigmoid(f[..., 1]) + gy[..., None]) * stride
        anc = torch.tensor(layer.anchors, dtype=torch.float32, device=m.device)
        bw = torch.exp(f[..., 2].clamp(max=EXP_CLAMP)) * anc[:, 0]
        bh = torch.exp(f[..., 3].clamp(max=EXP_CLAMP)) * anc[:, 1]
        boxes.append(torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2,
                                  cy + bh / 2], -1).reshape(b, -1, 4))
        obj.append(torch.sigmoid(f[..., 4]).reshape(b, -1))
        cls.append(torch.sigmoid(f[..., 5:]).reshape(b, -1, c))
    return Decoded(torch.cat(boxes, 1), torch.cat(obj, 1), torch.cat(cls, 1))


def iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of tlbr boxes (n, 4) x (m, 4) → (n, m)."""
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(br - tl, 0, None), axis=-1)
    area = lambda z: np.prod(np.clip(z[:, 2:] - z[:, :2], 0, None), axis=-1)  # noqa: E731
    return inter / np.maximum(area(a)[:, None] + area(b)[None, :] - inter, 1e-9)


@dataclass
class Detections:
    """One image's detections in source pixels, best first."""

    boxes: np.ndarray   # (n, 4) float32 tlbr
    scores: np.ndarray  # (n,) float32
    classes: np.ndarray  # (n,) int64


def select(boxes: np.ndarray, scores: np.ndarray, classes: np.ndarray,
           prob_thresh: float, iou_thresh: float, top_k: int,
           max_results: int) -> np.ndarray:
    """Indices of one image's kept candidates, best first: the ``top_k``
    best at or above ``prob_thresh`` (ties: lower index first), greedy
    suppression of a later candidate whose IoU with a kept one of its class
    is above ``iou_thresh``, then the ``max_results`` best."""
    cand = np.flatnonzero(scores >= prob_thresh)
    cand = cand[np.argsort(-scores[cand], kind="stable")][:top_k]
    over = iou(boxes[cand], boxes[cand]) > iou_thresh
    same = classes[cand][:, None] == classes[cand][None, :]
    conflict = over & same
    kept: List[int] = []
    for i in range(len(cand)):
        if not any(conflict[j, i] for j in kept):
            kept.append(i)
    return cand[kept][:max_results]


def detect(net: Net, weights, frames_bgr: torch.Tensor, prob_thresh: float,
           iou_thresh: float, top_k: int, max_results: int,
           cast: Cast = None, rounding=None) -> Tuple[List[Detections], Decoded]:
    """The whole path on a batch of same-size frames: detections per image
    in source pixels, and the decoded candidates (net pixels) they came
    from. ``cast`` and ``rounding`` as :func:`forward` takes them."""
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
