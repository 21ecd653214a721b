"""K2: greedy class-aware suppression — CUDA kernel wrapper and its plain versions.

Port of ``yolov3_tpu/ops/pallas_nms.py :: pallas_suppress``, the Pallas twin
of the XLA blocked loop ``yolov3_tpu/ops/nms.py ::
_greedy_suppress_blocked_fused`` (bit-identical to each other). Input: per
image, K score-sorted tlbr boxes, classes and a valid mask; output: the keep
mask of exact greedy NMS in score order.

In eager PyTorch that loop would cost K/64 blocks × (several launches plus a
host sync for the data-dependent ``while``), so on the card the kernel
(``csrc/nms_suppress.cu``, K ≤ 1024) IS the path: phase 1 builds the packed
conflict bits of the upper triangle over the whole card, phase 2 walks them
in one warp per image, one step per kept candidate. :func:`suppress`
launches it for CUDA tensors and raises when it cannot; for CPU tensors it
runs :func:`suppress_reference`, the scalar greedy loop of
``nms._greedy_suppress`` in tensor ops. :func:`conflict_bits_reference` and
:func:`walk_reference` are the plain versions of the two phases, in the
kernel's bit layout and walk order.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ._build import check_launch, load_kernels

MAX_K = 1024  # K2_MAX_K in csrc/nms_suppress.cu: the walk's bits fit shared memory
TILE = 64     # K2_TILE: phase 1's tiles are TILE rows x TILE columns


def row_words(k: int) -> int:
    """32-bit words of one row of phase 1's scratch (``k2_row_words``):
    ceil(K / 32) rounded up to a multiple of 4, so rows are 16-byte pieces."""
    return -(-(-(-k // 32)) // 4) * 4


def bits_blocks(b: int, k: int) -> int:
    """Blocks of phase 1 for B images of K candidates: the 64 x 64 tiles of
    each image's upper triangle."""
    t = -(-k // TILE)
    return b * t * (t + 1) // 2


def written_words(k: int, device=None) -> torch.Tensor:
    """(K, row_words(K)) bool: the words of phase 1's scratch the kernel
    writes. Row i's are those of its tiles, 2·⌊i/64⌋ ≤ w < 2·⌈K/64⌉: from
    the row's diagonal tile to the last tile. The walk reads nothing else."""
    w = torch.arange(row_words(k), device=device)
    first = 2 * (torch.arange(k, device=device) // TILE)
    return (w[None, :] >= first[:, None]) & (w[None, :] < 2 * -(-k // TILE))


def conflict_matrix(boxes: torch.Tensor, classes: torch.Tensor,
                    iou_thresh: float) -> torch.Tensor:
    """(B, K, K) bool: IoU > τ (``nms.iou_matrix``, whose float order the
    kernel repeats: union = (area_i + area_j) - inter) and same class."""
    from .nms import iou_matrix  # nms imports this module

    return ((iou_matrix(boxes) > iou_thresh)
            & (classes[:, :, None] == classes[:, None, :]))


def conflict_bits_reference(boxes: torch.Tensor, classes: torch.Tensor,
                            iou_thresh: float) -> torch.Tensor:
    """Plain phase 1: the packed conflict bits in the kernel's layout,
    (B, K, row_words(K)) int32 (the 32-bit patterns): bit t of word w of row
    i is conflict(i, 32·w + t), 0 for columns ≥ K, on the words the kernel
    writes (:func:`written_words`); the others are 0 here and unspecified
    on the card."""
    conflict = conflict_matrix(boxes, classes, iou_thresh)
    b, k = conflict.shape[:2]
    rw = row_words(k)
    cols = torch.zeros((b, k, rw * 32), dtype=torch.int64, device=boxes.device)
    cols[..., :k] = conflict.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=boxes.device)
    words = (cols.reshape(b, k, rw, 32) << shifts).sum(-1)  # < 2^32
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return torch.where(written_words(k, boxes.device), words,
                       torch.zeros_like(words)).to(torch.int32)


def walk_reference(bits: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Plain phase 2, the kernel's walk: per image an alive mask (valid and
    not removed); the lowest alive candidate i is kept and row i's words
    from its own word on (``bits`` as :func:`conflict_bits_reference`
    lays them out) are removed from the mask. One step per kept candidate."""
    b, k = valid.shape
    words = -(-k // 32)
    rows = bits.cpu().numpy().astype(np.int64) & 0xFFFFFFFF
    flags = valid.cpu().numpy()
    keep = np.zeros((b, k), dtype=bool)
    for img in range(b):
        alive = sum(1 << i for i in np.flatnonzero(flags[img]).tolist())
        while alive:
            i = (alive & -alive).bit_length() - 1
            keep[img, i] = True
            row = sum(int(rows[img, i, w]) << (32 * w)
                      for w in range(i // 32, words))
            alive &= ~((1 << i) | row)
    return torch.from_numpy(keep).to(valid.device)


def suppress_reference(boxes: torch.Tensor, classes: torch.Tensor,
                       valid: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """Plain PyTorch K2: keep[i] = valid[i] ∧ ¬∃ j<i: keep[j] ∧ conflict[j, i].
    K sequential steps of tensor ops (no host sync)."""
    _check(boxes, classes, valid)
    conflict = conflict_matrix(boxes, classes, iou_thresh)
    keep = torch.zeros_like(valid)
    for i in range(boxes.shape[1]):
        suppressed = (keep & conflict[:, :, i]).any(dim=1)
        keep[:, i] = valid[:, i] & ~suppressed
    return keep


def _check(boxes: torch.Tensor, classes: torch.Tensor,
           valid: torch.Tensor) -> None:
    if boxes.dim() != 3 or boxes.shape[2] != 4 or boxes.dtype != torch.float32:
        raise ValueError(f"boxes must be (B, K, 4) float32, got "
                         f"{tuple(boxes.shape)} {boxes.dtype}")
    bk = boxes.shape[:2]
    if classes.shape != bk or classes.dtype != torch.int32:
        raise ValueError(f"classes must be {tuple(bk)} int32, got "
                         f"{tuple(classes.shape)} {classes.dtype}")
    if valid.shape != bk or valid.dtype != torch.bool:
        raise ValueError(f"valid must be {tuple(bk)} bool, got "
                         f"{tuple(valid.shape)} {valid.dtype}")
    if not boxes.device == classes.device == valid.device:
        raise ValueError("boxes, classes and valid must share a device")


def suppress(boxes: torch.Tensor, classes: torch.Tensor, valid: torch.Tensor,
             iou_thresh: float) -> torch.Tensor:
    """Greedy class-aware suppression → keep mask (B, K) bool.

    boxes (B, K, 4) tlbr float32 in score-desc order; classes (B, K) int32;
    valid (B, K) bool. CUDA tensors: launches K2 on the current stream
    (counted in ``suppress.launches``, one a call for its two kernels) or
    raises. CPU tensors: the plain version."""
    _check(boxes, classes, valid)
    if boxes.device.type == "cpu":
        return suppress_reference(boxes, classes, valid, iou_thresh)
    return suppress_bits(boxes, classes, valid, iou_thresh)[0]


def suppress_bits(boxes: torch.Tensor, classes: torch.Tensor,
                  valid: torch.Tensor, iou_thresh: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`suppress` that also returns phase 1's scratch, (B, K,
    row_words(K)) int32: the kernel's on CUDA tensors (words outside
    :func:`written_words` unspecified), :func:`conflict_bits_reference` on
    CPU tensors."""
    _check(boxes, classes, valid)
    if boxes.device.type == "cpu":
        return (suppress_reference(boxes, classes, valid, iou_thresh),
                conflict_bits_reference(boxes, classes, iou_thresh))
    if boxes.device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA or CPU tensors, got {boxes.device}")
    b, k = boxes.shape[:2]
    if not (boxes.is_contiguous() and classes.is_contiguous()
            and valid.is_contiguous()):
        raise ValueError("K2 needs contiguous boxes, classes and valid")
    if k > MAX_K:
        raise ValueError(f"K2 takes at most K={MAX_K} candidates, got {k}")
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    bits = torch.empty((b, k, row_words(k)), dtype=torch.int32,
                       device=boxes.device)
    if b == 0 or k == 0:
        return keep, bits
    launch(load_kernels(), boxes, classes, valid, iou_thresh, keep, bits)
    suppress.launches += 1
    return keep, bits


suppress.launches = 0


def launch(lib, boxes: torch.Tensor, classes: torch.Tensor,
           valid: torch.Tensor, iou_thresh: float, keep: torch.Tensor,
           bits: torch.Tensor) -> None:
    """K2's C entry in ``lib`` (the library, or an ablated build of
    ``csrc/nms_suppress.cu``: ``tools/ablate_phases.py``) on checked CUDA
    tensors: phase 1 into ``bits``, phase 2 into ``keep``; raises if a
    launch failed."""
    b, k = boxes.shape[:2]
    if bits.data_ptr() % 16:
        raise ValueError("K2's scratch must be 16-byte aligned")
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        rc = lib.yolo_nms_suppress(boxes.data_ptr(), classes.data_ptr(),
                                   valid.data_ptr(), b, k, float(iou_thresh),
                                   bits.data_ptr(), keep.data_ptr(), stream)
    check_launch(rc, "nms_suppress")
