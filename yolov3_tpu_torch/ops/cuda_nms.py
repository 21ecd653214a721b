"""K2: greedy class-aware suppression — CUDA kernel wrapper and its plain version.

Port of ``yolov3_tpu/ops/pallas_nms.py :: pallas_suppress``, the Pallas twin
of the XLA blocked loop ``yolov3_tpu/ops/nms.py ::
_greedy_suppress_blocked_fused`` (bit-identical to each other). Input: per
image, K score-sorted tlbr boxes, classes and a valid mask; output: the keep
mask of exact greedy NMS in score order.

In eager PyTorch that loop would cost K/64 blocks × (several launches plus a
host sync for the data-dependent ``while``), so on the card the kernel
(``csrc/nms_suppress.cu``, one block per image, K ≤ 1024) IS the path.
:func:`suppress` launches it for CUDA tensors and raises when it cannot; for
CPU tensors it runs :func:`suppress_reference`, the scalar greedy loop of
``nms._greedy_suppress`` in tensor ops.
"""
from __future__ import annotations

import torch

from ._build import check_launch, load_kernels

MAX_K = 1024  # K2_MAX_K in csrc/nms_suppress.cu: the conflict bitmask fits shared memory


def conflict_matrix(boxes: torch.Tensor, classes: torch.Tensor,
                    iou_thresh: float) -> torch.Tensor:
    """(B, K, K) bool: IoU > τ (``nms.iou_matrix``, whose float order the
    kernel repeats: union = (area_i + area_j) - inter) and same class."""
    from .nms import iou_matrix  # nms imports this module

    return ((iou_matrix(boxes) > iou_thresh)
            & (classes[:, :, None] == classes[:, None, :]))


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
    (counted in ``suppress.launches``) or raises. CPU tensors: the plain
    version."""
    _check(boxes, classes, valid)
    if boxes.device.type == "cpu":
        return suppress_reference(boxes, classes, valid, iou_thresh)
    if boxes.device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA or CPU tensors, got {boxes.device}")
    b, k = boxes.shape[:2]
    if not (boxes.is_contiguous() and classes.is_contiguous()
            and valid.is_contiguous()):
        raise ValueError("K2 needs contiguous boxes, classes and valid")
    if k > MAX_K:
        raise ValueError(f"K2 takes at most K={MAX_K} candidates, got {k}")
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    if b == 0 or k == 0:
        return keep
    lib = load_kernels()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        rc = lib.yolo_nms_suppress(boxes.data_ptr(), classes.data_ptr(),
                                   valid.data_ptr(), b, k, float(iou_thresh),
                                   keep.data_ptr(), stream)
    check_launch(rc, "nms_suppress")
    suppress.launches += 1
    return keep


suppress.launches = 0
