"""Batched, static-shape, class-aware NMS.

Port of ``yolov3_tpu/ops/nms.py``: candidate selection → greedy suppression
(K2, ``ops.cuda_nms.suppress``) → optional compaction (``compact_results``)
→ ``pack_results`` for one device→host copy. Three entry points, each
bit-identical to the JAX function of the same name on the same inputs:

* ``batched_nms_packed``: K1 / K4 payload records (the packed routes);
* ``batched_nms_compact``: K1c or ``ops.decode.decode_compact`` outputs
  (the compact route), pair-max or direct top-k selection;
* ``batched_nms``: decoded (B, N, 5+C) rows (``forward()``'s contract).

They take the JAX functions' parameters in the same positions. ``impl``
names the JAX package's two suppressions, "xla" and "pallas", which are
bit-identical; here both run K2. There is no interpret mode: a CPU tensor
already runs K2's plain version, so ``interpret=True`` raises.

Tie order is the hazard: ``torch.topk`` promises no order among equal
values, while ``lax.top_k`` puts the lower index first. Every selection here
is therefore a stable sort: candidates already sit in ascending index order
(or are sorted by index first), then a stable sort by score descending
keeps the lower index first among equal scores.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .cuda_nms import suppress


# candidate indices ride in float32 lanes: exact below 2^24
EXACT_INDEX_LIMIT = 2 ** 24
IMPLS = ("xla", "pallas")


class NMSResult(NamedTuple):
    boxes: torch.Tensor    # (B, K, 4) tlbr, net-input pixels
    scores: torch.Tensor   # (B, K) obj * class prob, 0 where invalid
    classes: torch.Tensor  # (B, K) int32 class ids, -1 where invalid
    valid: torch.Tensor    # (B, K) bool survivor mask


def auto_top_k(graph, net_hw) -> int:
    """The NMS working-set preset: 256 for small graphs (candidate space
    ≤ 4096, e.g. tiny@416 with 2535), 512 otherwise. Results change only on
    images where more than K candidates pass the serving threshold (the >K
    truncation contract)."""
    return 256 if graph.num_detections(*net_hw) <= 4096 else 512


def pack_results(res: NMSResult) -> torch.Tensor:
    """Flatten an NMSResult into ONE float32 tensor for a single D2H copy:
    ``[..., :4]`` tlbr boxes, ``[..., 4]`` score, ``[..., 5]`` class id.
    Validity needs no plane: suppressed and pad slots have score 0 and every
    survivor's score is > 0, so ``score > 0`` ≡ ``valid``."""
    return torch.cat([res.boxes, res.scores[..., None],
                      res.classes.to(torch.float32)[..., None]], dim=-1)


def unpack_results(arr) -> NMSResult:
    """Host-side inverse of :func:`pack_results` (numpy fields out)."""
    arr = np.asarray(arr)
    scores = arr[..., 4]
    return NMSResult(boxes=arr[..., :4], scores=scores,
                     classes=arr[..., 5].astype(np.int32),
                     valid=scores > 0.0)


def iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of (..., K, 4) tlbr boxes → (..., K, K), with the float
    operations of ``yolov3_tpu.ops.nms.iou_matrix`` in its order."""
    area = (torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
            * torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0))
    tl = torch.maximum(boxes[..., :, None, :2], boxes[..., None, :, :2])
    br = torch.minimum(boxes[..., :, None, 2:], boxes[..., None, :, 2:])
    wh = torch.clamp(br - tl, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def _sort_desc(values: torch.Tensor) -> torch.Tensor:
    """Indices ordering ``values`` descending along dim 1; equal values keep
    their input order (the lower index first, like ``lax.top_k``)."""
    return torch.sort(values, dim=1, descending=True, stable=True).indices


def _select_pairmax_payload(payload: torch.Tensor, masked: torch.Tensor,
                            k: int, group: int = 2):
    """Exact top-k selection over a candidate payload (B, N, 8) with lanes
    [x0, y0, x1, y1, thresholded score, class, candidate index, –], in
    (score desc, candidate index asc) order → (boxes (B,k,4), scores (B,k),
    classes (B,k) int32, valid (B,k)).

    Group-max: the top-k groups of ``group`` candidates by their max score
    (ties → lower group first) hold every top-k candidate, whatever the
    group width (proof at ``yolov3_tpu/ops/nms.py::_select_pairmax``); the
    ``group·k`` survivors are then ordered exactly. CONTRACT: lane 4 equals
    ``masked`` (already thresholded, ≥ 0)."""
    b, n = masked.shape
    if n >= EXACT_INDEX_LIMIT:
        raise ValueError(f"pair-max selection needs N < 2^24 for exact f32 "
                         f"candidate indices, got N={n}")
    if group < 2:
        raise ValueError(f"select group must be >= 2, got {group}")
    npg = -(-n // group) * group
    if npg != n:
        payload = F.pad(payload, (0, 0, 0, npg - n))
        masked = F.pad(masked, (0, npg - n))
    kp = min(k, npg // group)
    pmax = masked.reshape(b, npg // group, group).amax(dim=2)
    # int32 view: monotone for non-negative floats, as in the reference
    pair_i = _sort_desc(pmax.contiguous().view(torch.int32))[:, :kp]
    pairs = torch.gather(payload.reshape(b, npg // group, 8 * group), 1,
                         pair_i[..., None].expand(b, kp, 8 * group))
    cand = pairs.reshape(b, group * kp, 8)
    # (score desc, candidate index asc): index sort, then stable score sort
    order = torch.sort(cand[:, :, 6], dim=1, stable=True).indices
    cand = torch.gather(cand, 1, order[..., None].expand_as(cand))
    order = _sort_desc(cand[:, :, 4].contiguous().view(torch.int32))[:, :k]
    top = torch.gather(cand, 1, order[..., None].expand(b, order.shape[1], 8))
    top_scores = top[:, :, 4].contiguous()
    return (top[:, :, :4].contiguous(), top_scores,
            top[:, :, 5].to(torch.int32), top_scores > 0.0)


def _select_topk(boxes: torch.Tensor, masked: torch.Tensor,
                 classes: torch.Tensor, k: int):
    """Direct top-k selection (``lax.top_k`` + gathers): the k highest
    ``masked`` scores, ties → lower index first → (boxes, scores, classes,
    valid)."""
    top_i = _sort_desc(masked)[:, :k]
    top_scores = torch.gather(masked, 1, top_i)
    return (torch.gather(boxes, 1, top_i[..., None].expand(-1, -1, 4)),
            top_scores, torch.gather(classes, 1, top_i), top_scores > 0.0)


def _select_pairmax(boxes: torch.Tensor, masked: torch.Tensor,
                    classes: torch.Tensor, k: int, group: int = 2):
    """Exact top-k selection via group-max over compact-decode outputs:
    build the packed payload (candidate index in lane 6, exact in f32 below
    2^24) and run :func:`_select_pairmax_payload`. At N ≥ 2^24 the index
    would not be exact, so the direct top-k form runs instead (the same
    results)."""
    b, n = masked.shape
    if n >= EXACT_INDEX_LIMIT:
        return _select_topk(boxes, masked, classes, k)
    iota = torch.arange(n, dtype=torch.float32, device=masked.device)
    payload = torch.cat([boxes, masked[..., None],
                         classes.to(torch.float32)[..., None],
                         iota.expand(b, n)[..., None],
                         torch.zeros_like(masked)[..., None]], dim=-1)
    return _select_pairmax_payload(payload, masked, k, group=group)


def _candidates(det: torch.Tensor, prob_thresh: float, top_k: int):
    """Per image of (B, N, 5+C) decoded rows: score = obj × max class prob,
    first-argmax class, threshold, top-k (ties → lower index) → (tlbr boxes,
    scores, classes int32, valid)."""
    class_prob, class_idx = det[..., 5:].max(dim=-1)  # first index among ties
    score = det[..., 4] * class_prob
    masked = torch.where(score >= prob_thresh, score, torch.zeros_like(score))
    half = det[..., 2:4] * 0.5
    boxes = torch.cat([det[..., :2] - half, det[..., :2] + half], dim=-1)
    return _select_topk(boxes, masked, class_idx.to(torch.int32),
                        min(top_k, det.shape[1]))


def _suppress_batch(boxes: torch.Tensor, scores: torch.Tensor,
                    classes: torch.Tensor, valid: torch.Tensor,
                    iou_thresh: float, impl: str = "xla",
                    interpret: bool = False) -> NMSResult:
    """K2 over the selected candidates; suppressed slots zeroed (class -1).
    ``impl`` "xla" or "pallas": both run K2."""
    if impl not in IMPLS:
        raise ValueError(f"unknown NMS impl {impl!r}")
    if interpret:
        raise ValueError("interpret=True: the port has no interpret mode; a "
                         "CPU tensor runs K2's plain version")
    keep = suppress(boxes, classes, valid, iou_thresh)
    return NMSResult(
        boxes=torch.where(keep[..., None], boxes, torch.zeros_like(boxes)),
        scores=torch.where(keep, scores, torch.zeros_like(scores)),
        classes=torch.where(keep, classes, torch.full_like(classes, -1)),
        valid=keep,
    )


def compact_results(res: NMSResult, max_results: int) -> NMSResult:
    """Gather the top ``max_results`` survivors per image (score desc, ties
    → lower slot first), shrinking the buffers that leave the device."""
    k = res.scores.shape[1]
    r = min(max_results, k)
    masked = torch.where(res.valid, res.scores, torch.full_like(res.scores, -1.0))
    idx = _sort_desc(masked)[:, :r]
    top_scores = torch.gather(masked, 1, idx)
    valid = torch.gather(res.valid, 1, idx) & (top_scores > 0)
    boxes = torch.gather(res.boxes, 1, idx[..., None].expand(-1, -1, 4))
    classes = torch.gather(res.classes, 1, idx)
    return NMSResult(
        boxes=boxes,
        scores=torch.where(valid, top_scores, torch.zeros_like(top_scores)),
        classes=torch.where(valid, classes, torch.full_like(classes, -1)),
        valid=valid,
    )


def batched_nms(detections: torch.Tensor, prob_thresh: float = 0.05,
                iou_thresh: float = 0.3, top_k: int = 512,
                impl: str = "xla", interpret: bool = False) -> NMSResult:
    """Class-aware NMS over decoded detections (B, N, 5+C) (``forward()``'s
    output). Exactly the ``top_k`` highest-scoring candidates above
    ``prob_thresh`` enter suppression (the >K truncation contract)."""
    return _suppress_batch(*_candidates(detections, prob_thresh, top_k),
                           iou_thresh, impl, interpret)


def batched_nms_compact(boxes: torch.Tensor, scores: torch.Tensor,
                        classes: torch.Tensor, prob_thresh: float = 0.05,
                        iou_thresh: float = 0.3, top_k: int = 512,
                        impl: str = "xla", interpret: bool = False,
                        max_results: int = 0, select_impl: str = "pairmax",
                        select_group: int = 2) -> NMSResult:
    """NMS over compact-decode outputs: tlbr boxes (B, N, 4), scores (B, N),
    classes (B, N) int32 → threshold → top-k → K2. The same results as
    :func:`batched_nms` on the same data. ``select_impl``: "pairmax"
    (group-max, :func:`_select_pairmax`) or "topk" (direct); the results are
    bit-identical. ``max_results > 0`` compacts the output."""
    masked = torch.where(scores >= prob_thresh, scores, torch.zeros_like(scores))
    k = min(top_k, scores.shape[1])
    if select_impl == "pairmax":
        sel = _select_pairmax(boxes, masked, classes, k, group=select_group)
    elif select_impl == "topk":
        sel = _select_topk(boxes, masked, classes, k)
    else:
        raise ValueError(f"unknown select_impl {select_impl!r}")
    res = _suppress_batch(*sel, iou_thresh, impl, interpret)
    if max_results and max_results < k:
        res = compact_results(res, max_results)
    return res


def batched_nms_packed(payload: torch.Tensor, scores: torch.Tensor,
                       iou_thresh: float = 0.3, top_k: int = 512,
                       impl: str = "xla", interpret: bool = False,
                       max_results: int = 0, select_group: int = 2
                       ) -> NMSResult:
    """NMS over the packed decode output (serving path): ``payload``
    (B, N, 8) candidate records and ``scores`` (B, N) from
    ``ops.cuda_decode.decode_packed`` / ``decode_packed_fused`` — already
    thresholded by the decode (pass the serving ``prob_thresh`` there; this
    applies none). ``max_results > 0`` compacts the output to that many top
    survivors."""
    k = min(top_k, scores.shape[1])
    res = _suppress_batch(*_select_pairmax_payload(
        payload, scores, k, group=select_group), iou_thresh, impl, interpret)
    if max_results and max_results < k:
        res = compact_results(res, max_results)
    return res
