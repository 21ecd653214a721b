"""Box-format conversions, letterbox geometry and net→image coordinate
rescaling.

A copy of the functions of ``yolov3_tpu/utils/boxes.py`` (that package
imports JAX; the port must not).
``tests/test_torch_frontend.py`` holds the copies equal to the originals.
Pure numpy — runs on tiny (≤K) arrays after the device→host transfer.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def cxywh_to_tlbr(boxes: np.ndarray) -> np.ndarray:
    """(…, 4) center-x, center-y, w, h → top-left/bottom-right corners."""
    boxes = np.asarray(boxes, dtype=np.float32)
    half = boxes[..., 2:4] * 0.5
    return np.concatenate([boxes[..., 0:2] - half, boxes[..., 0:2] + half], axis=-1)


def tlbr_to_cxywh(boxes: np.ndarray) -> np.ndarray:
    boxes = np.asarray(boxes, dtype=np.float32)
    wh = boxes[..., 2:4] - boxes[..., 0:2]
    return np.concatenate([boxes[..., 0:2] + wh * 0.5, wh], axis=-1)


def letterbox_geometry(src_hw: Tuple[int, int], net_hw: Tuple[int, int]
                       ) -> Tuple[float, int, int, int, int]:
    """Full letterbox geometry: (scale, pad_top, pad_left, new_h, new_w).

    scale = min(net/src) per axis (aspect preserved); the resized image is
    centered, remainder split evenly (low side gets the floor). The resize
    target (new_h, new_w) is part of the contract: the device preprocess and
    unletterbox must place content with this exact geometry or boxes shift
    by 1px on half-pixel resolutions (e.g. 832x501 → 416 gives 250.5).
    """
    sh, sw = src_hw
    nh, nw = net_hw
    scale = min(nh / sh, nw / sw)
    # round-half-up, NOT python's banker's round() (see docstring)
    new_h = int(np.floor(sh * scale + 0.5))
    new_w = int(np.floor(sw * scale + 0.5))
    pad_top = (nh - new_h) // 2
    pad_left = (nw - new_w) // 2
    return scale, pad_top, pad_left, new_h, new_w


def letterbox_params(src_hw: Tuple[int, int], net_hw: Tuple[int, int]
                     ) -> Tuple[float, int, int]:
    """(scale, pad_top, pad_left) — see :func:`letterbox_geometry`."""
    return letterbox_geometry(src_hw, net_hw)[:3]


def unletterbox_tlbr(boxes: np.ndarray, src_hw: Tuple[int, int],
                     net_hw: Tuple[int, int], clip: bool = True) -> np.ndarray:
    """Map tlbr boxes from net-input pixels back to original-image pixels —
    the exact inverse of the letterbox transform; optional clip to image."""
    scale, pad_top, pad_left = letterbox_params(src_hw, net_hw)
    out = np.asarray(boxes, dtype=np.float32).copy()
    out[..., [0, 2]] = (out[..., [0, 2]] - pad_left) / scale
    out[..., [1, 3]] = (out[..., [1, 3]] - pad_top) / scale
    if clip:
        sh, sw = src_hw
        out[..., [0, 2]] = out[..., [0, 2]].clip(0, sw)
        out[..., [1, 3]] = out[..., [1, 3]].clip(0, sh)
    return out


def unstretch_tlbr(boxes: np.ndarray, src_hw: Tuple[int, int],
                   net_hw: Tuple[int, int], clip: bool = True) -> np.ndarray:
    """Inverse of the aspect-distorting plain-resize mode."""
    sh, sw = src_hw
    nh, nw = net_hw
    out = np.asarray(boxes, dtype=np.float32).copy()
    out[..., [0, 2]] *= sw / nw
    out[..., [1, 3]] *= sh / nh
    if clip:
        out[..., [0, 2]] = out[..., [0, 2]].clip(0, sw)
        out[..., [1, 3]] = out[..., [1, 3]].clip(0, sh)
    return out
