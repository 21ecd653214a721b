"""On-device preprocessing: uint8 frames → letterboxed, normalized NHWC fp32.

Port of ``yolov3_tpu/ops/preprocess.py``. Frames cross host→device as raw
uint8 (4× fewer bytes than fp32); resize, pad and normalize run on the
device. Two modes:

* ``letterbox`` — aspect-preserving resize + centered gray padding (pad value
  128/255, see :data:`PAD_FLOAT`);
* ``stretch`` — plain aspect-distorting bilinear resize.

Bilinear resize uses half-pixel centers without antialias, as two separable
fp32 matmuls (``A_h @ x @ A_wᵀ``). TF32 is off for both products whatever
the caller's setting: interpolation weights must not round to 10 mantissa
bits (the JAX package pins ``Precision.HIGHEST`` for the same reason).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..precision import tf32
from ..utils.boxes import letterbox_geometry

# One letterbox pad contract across every path: 128/255 ≈ 0.50196, the
# value the uint8 host loader of the JAX package pads with (0.5 is not
# representable in uint8).
PAD_UINT8 = 128
PAD_FLOAT = float(np.float32(PAD_UINT8) / np.float32(255.0))

Interp = Tuple[torch.Tensor, torch.Tensor]  # (A_h (out_h, H), A_w (out_w, W))


def _interp_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) bilinear interpolation matrix — half-pixel centers, edge
    clamp, no antialias (cv2.INTER_LINEAR semantics)."""
    scale = src / dst
    pos = (np.arange(dst) + 0.5) * scale - 0.5
    i0 = np.floor(pos).astype(np.int64)
    frac = (pos - i0).astype(np.float32)
    i1 = np.clip(i0 + 1, 0, src - 1)
    i0 = np.clip(i0, 0, src - 1)
    m = np.zeros((dst, src), np.float32)
    m[np.arange(dst), i0] += 1.0 - frac
    m[np.arange(dst), i1] += frac
    return m


def resize_target(src_hw: Tuple[int, int], net_hw: Tuple[int, int],
                  mode: str) -> Tuple[int, int]:
    """(out_h, out_w) the bilinear resize produces for ``mode``."""
    if mode == "stretch":
        return tuple(net_hw)
    if mode != "letterbox":
        raise ValueError(f"unknown preprocess mode {mode!r}")
    return letterbox_geometry(src_hw, net_hw)[3:5]


def interp_matrices(src_hw: Tuple[int, int], out_hw: Tuple[int, int],
                    device: torch.device) -> Interp:
    """Both interpolation matrices of a (src → out) resize, on ``device``."""
    return (torch.from_numpy(_interp_matrix(src_hw[0], out_hw[0])).to(device),
            torch.from_numpy(_interp_matrix(src_hw[1], out_hw[1])).to(device))


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int],
                    interp: Optional[Interp] = None) -> torch.Tensor:
    """Bilinear resize of (B, H, W, C) float32 via two separable matmuls.
    ``interp`` passes precomputed :func:`interp_matrices` (the Detector
    caches them per source shape)."""
    b, h, w, c = x.shape
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x
    a_h, a_w = interp if interp is not None else interp_matrices(
        (h, w), (oh, ow), x.device)
    with tf32(False):
        y = torch.einsum("oh,bhwc->bowc", a_h, x)
        return torch.einsum("pw,bowc->bopc", a_w, y)


def preprocess(frames: torch.Tensor, net_hw: Tuple[int, int],
               mode: str = "letterbox", pad_value: float = PAD_FLOAT,
               interp: Optional[Interp] = None) -> torch.Tensor:
    """(B, H, W, 3) uint8 RGB → (B, net_h, net_w, 3) float32 in [0, 1]."""
    if frames.dtype != torch.uint8:
        raise TypeError(f"frames must be uint8 (got {frames.dtype})")
    b, h, w, c = frames.shape
    nh, nw = net_hw
    x = frames.to(torch.float32) * (1.0 / 255.0)
    out_h, out_w = resize_target((h, w), (nh, nw), mode)
    resized = resize_bilinear(x, (out_h, out_w), interp)
    if mode == "stretch":
        return resized
    _, pad_top, pad_left, new_h, new_w = letterbox_geometry((h, w), (nh, nw))
    # F.pad pads the last dims first: (C lo, C hi, W lo, W hi, H lo, H hi)
    return F.pad(resized, (0, 0, pad_left, nw - new_w - pad_left,
                           pad_top, nh - new_h - pad_top),
                 value=pad_value)


def preprocess_host(frames, net_hw: Tuple[int, int], mode: str = "letterbox",
                    pad_value: float = PAD_FLOAT) -> np.ndarray:
    """cv2-based host version with the same semantics (for source shapes too
    heterogeneous to batch, and as the parity oracle of the on-device path):
    (B, H, W, 3) or (H, W, 3) uint8 → (B, net_h, net_w, 3) float32 numpy."""
    import cv2

    frames = np.asarray(frames)
    if frames.ndim == 3:
        frames = frames[None]
    b, h, w, c = frames.shape
    nh, nw = net_hw
    out = np.full((b, nh, nw, c), pad_value, dtype=np.float32)
    if mode == "stretch":
        for i in range(b):
            out[i] = cv2.resize(frames[i], (nw, nh),
                                interpolation=cv2.INTER_LINEAR) / 255.0
        return out
    if mode != "letterbox":
        raise ValueError(f"unknown preprocess mode {mode!r}")
    _, pad_top, pad_left, new_h, new_w = letterbox_geometry((h, w), (nh, nw))
    for i in range(b):
        r = cv2.resize(frames[i], (new_w, new_h),
                       interpolation=cv2.INTER_LINEAR).astype(np.float32) / 255.0
        out[i, pad_top:pad_top + new_h, pad_left:pad_left + new_w] = r
    return out
