"""K1: packed YOLO head decode — CUDA kernel wrapper and its plain version.

Port of ``yolov3_tpu/ops/pallas_decode.py :: decode_packed_head_pallas`` /
``decode_packed_pallas``. Each head map (B, gy, gx, C ≥ A·(5+C_cls)) in
channels-last order becomes candidate records

    payload[b, head_offset + a·gy·gx + cell] =
        [x0, y0, x1, y1, score·[score ≥ prob_thresh], first-argmax class,
         cand = head_offset + a·gy·gx + cell, 0]

(anchor-major within a head, heads in cfg order), the input that
``ops.nms.batched_nms_packed`` selects from. ``scores`` is the view
``payload[..., 4]``.

:func:`decode_packed_head` launches ``csrc/decode_packed.cu`` for a CUDA
tensor and raises when it cannot; for a CPU tensor it runs
:func:`decode_packed_head_reference`, the same math in tensor ops (the CPU
tests and ``chip_smoke.py``'s comparison use it). Channel padding needs no
copy: the kernel takes the map's element strides.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from ._build import check_launch, load_kernels

Anchors = Sequence[Tuple[float, float]]
MAX_ANCHORS = 64  # K1_MAX_ANCHORS in csrc/decode_packed.cu: the kernel's parameter block


def _check_head(feat: torch.Tensor, anchors: Anchors, num_classes: int) -> None:
    if feat.dim() != 4:
        raise ValueError(f"head map must be (B, gy, gx, C), got {tuple(feat.shape)}")
    if feat.dtype != torch.float32:
        raise TypeError(f"head map must be float32, got {feat.dtype}")
    need = len(anchors) * (5 + num_classes)
    if not anchors or num_classes < 1 or feat.shape[3] < need:
        raise ValueError(f"head map has {feat.shape[3]} channels, needs "
                         f"{len(anchors)}*(5+{num_classes}) = {need}")


def decode_packed_head_reference(feat: torch.Tensor, anchors: Anchors,
                                 stride: int, num_classes: int,
                                 prob_thresh: float = 0.0,
                                 head_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch K1 for one head → records (B, a·gy·gx, 8) float32."""
    _check_head(feat, anchors, num_classes)
    b, gy, gx, _ = feat.shape
    a, per = len(anchors), 5 + num_classes
    cells = gy * gx
    f = feat[..., :a * per].reshape(b, cells, a, per)
    cell = torch.arange(cells, device=feat.device)
    col = (cell % gx).to(torch.float32)[:, None]        # (cells, 1)
    row = (cell // gx).to(torch.float32)[:, None]
    anc = torch.tensor(anchors, dtype=torch.float32, device=feat.device)

    cx = (torch.sigmoid(f[..., 0]) + col) * stride       # (b, cells, a)
    cy = (torch.sigmoid(f[..., 1]) + row) * stride
    w = torch.exp(torch.clamp(f[..., 2], max=60.0)) * anc[:, 0]
    h = torch.exp(torch.clamp(f[..., 3], max=60.0)) * anc[:, 1]

    cls = f[..., 5:]
    m = cls.amax(dim=-1)
    # first argmax: the lowest class index that attains the max
    iota = torch.arange(num_classes, device=feat.device)
    idx = torch.where(cls >= m[..., None], iota, num_classes).amin(dim=-1)
    score = torch.sigmoid(f[..., 4]) * torch.sigmoid(m)
    score = torch.where(score >= prob_thresh, score, torch.zeros_like(score))

    cand = (head_offset + torch.arange(a, device=feat.device)[None, :] * cells
            + cell[:, None]).to(torch.float32)           # (cells, a), exact < 2^24
    rec = torch.stack([cx - w * 0.5, cy - h * 0.5, cx + w * 0.5, cy + h * 0.5,
                       score, idx.to(torch.float32), cand.expand_as(score),
                       torch.zeros_like(score)], dim=-1)  # (b, cells, a, 8)
    return rec.permute(0, 2, 1, 3).reshape(b, a * cells, 8)


def decode_packed_head(feat: torch.Tensor, anchors: Anchors, stride: int,
                       num_classes: int, prob_thresh: float = 0.0,
                       head_offset: int = 0,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode one head into ``out[:, head_offset : head_offset + a·gy·gx]``
    of a (B, N, 8) float32 payload (allocated when ``out`` is None, with
    N = head_offset + a·gy·gx); returns the payload.

    CUDA tensor: launches the K1 kernel on the current stream (counted in
    ``decode_packed_head.launches``) or raises. CPU tensor: the plain
    version."""
    _check_head(feat, anchors, num_classes)
    b, gy, gx, _ = feat.shape
    a = len(anchors)
    n_head = a * gy * gx
    if out is None:
        out = torch.empty((b, head_offset + n_head, 8), dtype=torch.float32,
                          device=feat.device)
    if (out.dim() != 3 or out.shape[0] != b or out.shape[2] != 8
            or out.shape[1] < head_offset + n_head
            or out.dtype != torch.float32 or out.device != feat.device):
        raise ValueError(f"payload {tuple(out.shape)} {out.dtype} on "
                         f"{out.device} cannot take head records "
                         f"[{head_offset}, {head_offset + n_head}) of batch {b}")
    if feat.device.type == "cpu":
        out[:, head_offset:head_offset + n_head] = decode_packed_head_reference(
            feat, anchors, stride, num_classes, prob_thresh, head_offset)
        return out
    if feat.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or CPU tensors, got {feat.device}")
    if feat.stride(3) != 1 or not out.is_contiguous():
        raise ValueError("K1 needs a channels-last head map (channel stride 1) "
                         "and a contiguous payload")
    if a > MAX_ANCHORS:
        raise ValueError(f"K1 takes at most {MAX_ANCHORS} anchors per head, got {a}")
    if out.shape[1] >= 2 ** 24:
        raise ValueError("candidate indices must stay below 2^24 to be exact in f32")
    lib = load_kernels()
    flat = [float(v) for wh in anchors for v in wh]
    anchors_c = (ctypes.c_float * len(flat))(*flat)
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        rc = lib.yolo_decode_packed_head(
            feat.data_ptr(), feat.stride(0), feat.stride(1), feat.stride(2),
            b, gy, gx, a, num_classes, anchors_c, float(stride),
            float(prob_thresh), head_offset, out.shape[1], out.data_ptr(),
            stream)
    check_launch(rc, "decode_packed_head")
    decode_packed_head.launches += 1
    return out


decode_packed_head.launches = 0


def decode_packed(feats: Sequence[torch.Tensor], anchors_per_head: Sequence[Anchors],
                  strides: Sequence[int], num_classes: int,
                  prob_thresh: float = 0.0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed decode of every head → (payload (B, N, 8), scores (B, N)).
    One payload allocation; each head writes its slice in place, so no
    concat follows. ``scores`` is the view ``payload[..., 4]``."""
    sizes: List[int] = [len(a) * f.shape[1] * f.shape[2]
                        for f, a in zip(feats, anchors_per_head)]
    payload = torch.empty((feats[0].shape[0], sum(sizes), 8),
                          dtype=torch.float32, device=feats[0].device)
    off = 0
    for f, a, s, n in zip(feats, anchors_per_head, strides, sizes):
        decode_packed_head(f, a, s, num_classes, prob_thresh=prob_thresh,
                           head_offset=off, out=payload)
        off += n
    return payload, payload[..., 4]
