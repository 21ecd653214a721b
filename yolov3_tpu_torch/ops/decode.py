"""YOLO head decode in plain tensor ops: raw NHWC head map → boxes.

Port of ``yolov3_tpu/ops/decode.py``. Per head, the (B, gy, gx, A·(5+C))
map is viewed per anchor; ``sigmoid(tx, ty)`` plus the cell offset, times
the stride, gives the center (with a head's ``scale_x_y`` s, YOLOv4's,
``sigmoid(t)·s − (s − 1)/2`` in place of ``sigmoid(t)``); ``exp(min(tw, 60)) · anchor`` the size (net
pixels); ``sigmoid`` the objectness and class scores. Order is cell-major
(``cell·A + anchor``), heads concatenated in cfg order: the reference
``Darknet.forward`` contract.

No kernel here: XLA lowered these on its own in the JAX package, and the
port leaves them to PyTorch's elementwise ops. The kernels with the same
math are K1 / K1c (``ops/cuda_decode.py``), which emit anchor-major records.
The anchors are a device constant made once per (anchors, type, device)
(:func:`anchor_wh`): a copy from the host on every call would be refused
inside a CUDA-graph capture.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

Anchors = Sequence[Tuple[float, float]]

_ANCHOR_WH: Dict[Tuple, torch.Tensor] = {}


def anchor_wh(anchors: Anchors, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """The (A, 2) anchor sizes as a tensor of ``dtype`` on ``device``, made
    at the first call for these anchors and kept: the same bits as
    ``torch.tensor(anchors, dtype=dtype, device=device)``."""
    key = (tuple(tuple(float(v) for v in wh) for wh in anchors), dtype,
           torch.device(device))
    t = _ANCHOR_WH.get(key)
    if t is None:
        t = _ANCHOR_WH[key] = torch.tensor(anchors, dtype=dtype).to(device)
    return t


def sigmoid_xy(t: torch.Tensor, scale_x_y: float) -> torch.Tensor:
    """sigmoid(t)·s − (s − 1)/2 in ``t``'s type; sigmoid(t) itself at s = 1."""
    sig = torch.sigmoid(t)
    if scale_x_y == 1.0:
        return sig
    return sig * scale_x_y - (scale_x_y - 1.0) / 2.0


def per_head(scales: Optional[Sequence[float]], n: int):
    """Each of ``n`` heads' ``scale_x_y``: ``scales``, or 1 for every head."""
    return [1.0] * n if scales is None else [float(v) for v in scales]


def _grid(gy: int, gx: int, a: int, dtype: torch.dtype,
          device: torch.device) -> torch.Tensor:
    """(gy, gx, a, 2) cell offsets [col, row]."""
    col = torch.arange(gx, dtype=dtype, device=device)[None, :, None].expand(gy, gx, a)
    row = torch.arange(gy, dtype=dtype, device=device)[:, None, None].expand(gy, gx, a)
    return torch.stack([col, row], dim=-1)


def decode_head(feat: torch.Tensor, anchors: Anchors, stride: int,
                num_classes: int, scale_x_y: float = 1.0) -> torch.Tensor:
    """One head's raw NHWC map (B, gy, gx, ≥A·(5+C)) → (B, gy·gx·A, 5+C)
    center-xywh boxes in net pixels, sigmoid objectness and classes. The
    math runs in ``feat``'s dtype, as in the JAX package (``forward`` widens
    the maps to float32 first)."""
    b, gy, gx, _ = feat.shape
    a, per = len(anchors), 5 + num_classes
    f = feat[..., :a * per].reshape(b, gy, gx, a, per)
    xy = (sigmoid_xy(f[..., 0:2], scale_x_y)
          + _grid(gy, gx, a, f.dtype, f.device)) * stride
    # exp clamp at 60: float32 exp overflows past ~88
    wh = (torch.exp(torch.clamp(f[..., 2:4], max=60.0))
          * anchor_wh(anchors, f.dtype, f.device))
    conf = torch.sigmoid(f[..., 4:])  # objectness and classes in one sigmoid
    return torch.cat([xy, wh, conf], dim=-1).reshape(b, gy * gx * a, per)


def decode_all(feats: Sequence[torch.Tensor], anchors_per_head: Sequence[Anchors],
               strides: Sequence[int], num_classes: int,
               scales: Optional[Sequence[float]] = None) -> torch.Tensor:
    """Decode every head and concatenate → (B, N, 5+C) (reference layout).
    ``scales``: each head's ``scale_x_y`` (1 when None)."""
    return torch.cat([decode_head(f, a, s, num_classes, sxy)
                      for f, a, s, sxy in zip(feats, anchors_per_head, strides,
                                              per_head(scales, len(feats)))],
                     dim=1)


def decode_compact_head(feat: torch.Tensor, anchors: Anchors, stride: int,
                        num_classes: int, scale_x_y: float = 1.0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode plus the per-anchor score / class reduction → (tlbr boxes
    (B, n, 4), scores (B, n) = sigmoid(obj)·sigmoid(max class logit), first
    argmax classes (B, n) int32), cell-major. Float32 math whatever the
    map's dtype (a bf16 map widens exactly)."""
    b, gy, gx, _ = feat.shape
    a, per = len(anchors), 5 + num_classes
    f = feat[..., :a * per].reshape(b, gy, gx, a, per).float()
    xy = (sigmoid_xy(f[..., 0:2], scale_x_y)
          + _grid(gy, gx, a, torch.float32, f.device)) * float(stride)
    wh = (torch.exp(torch.clamp(f[..., 2:4], max=60.0))
          * anchor_wh(anchors, torch.float32, f.device))
    half = wh * 0.5
    boxes = torch.cat([xy - half, xy + half], dim=-1)
    cls_max, cls_idx = f[..., 5:].max(dim=-1)  # first index among ties
    score = torch.sigmoid(f[..., 4]) * torch.sigmoid(cls_max)
    n = gy * gx * a
    return (boxes.reshape(b, n, 4), score.reshape(b, n),
            cls_idx.to(torch.int32).reshape(b, n))


def decode_compact(feats: Sequence[torch.Tensor],
                   anchors_per_head: Sequence[Anchors],
                   strides: Sequence[int], num_classes: int,
                   scales: Optional[Sequence[float]] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compact decode of every head → (boxes (B,N,4), scores (B,N),
    classes (B,N)) concatenated in cfg head order. ``scales``: each head's
    ``scale_x_y`` (1 when None)."""
    parts = [decode_compact_head(f, a, s, num_classes, sxy)
             for f, a, s, sxy in zip(feats, anchors_per_head, strides,
                                     per_head(scales, len(feats)))]
    return tuple(torch.cat([p[i] for p in parts], dim=1) for i in range(3))
