"""K1, K1c, K3, K4: YOLO head decode kernels — CUDA wrappers and plain versions.

Ports of ``yolov3_tpu/ops/pallas_decode.py``:

* K1 ``decode_packed`` / ``decode_packed_head`` (``decode_packed_pallas`` /
  ``decode_packed_head_pallas``): each head map (B, gy, gx, C ≥ A·(5+C_cls)),
  float32 or bf16, channels-last, becomes candidate records

      payload[b, head_offset + a·gy·gx + cell] =
          [x0, y0, x1, y1, score·[score ≥ prob_thresh], first-argmax class,
           cand = head_offset + a·gy·gx + cell, 0]

  (anchor-major within a head, heads in cfg order), the input that
  ``ops.nms.batched_nms_packed`` selects from. ``scores`` is the view
  ``payload[..., 4]``. All the heads of a call are ONE launch
  (``csrc/decode_packed.cu``: a head table in the parameter block, laid out
  by :func:`plan_decode`; tiles of cells staged in shared memory, G lanes a
  record); ``decode_packed_head`` launches the same kernel with one head.
* K1c ``decode_compact`` / ``decode_compact_head``
  (``decode_compact_head_pallas``): the same kernel storing the records
  split into boxes (B, n, 4), scores (B, n) and int32 classes (B, n), with
  no candidate lane; ``forward_compact(decode_impl="pallas")``.
* K4 ``decode_packed_fused_head`` (``decode_packed_head_fused_pallas``): K1's
  records computed from the PRE-head activation (B, gy, gx, Cin) and the 1×1
  head conv's weights (Cout, Cin) + bias, float32 sums; the head map never
  reaches device memory. ``forward_packed_fused``. A 1×1 GEMM on the
  tensor cores (``wgmma``) with the decode as its epilogue, one block per
  (tile of cells, anchor), tiled by :func:`plan_fused_tiles`: bf16 operands
  as they are, float32 operands as split TF32 (three TF32 products a
  product: float32 accuracy, ``ops/tf32.py``).
* K3 ``decode_all`` / ``decode_head`` (``decode_all_pallas`` /
  ``decode_head_pallas``): the full decode, the head maps → the reference
  ``Darknet.forward`` tensor (B, N, 5+C), cell-major within a head, heads
  concatenated. All the heads of a call are ONE launch writing straight into
  the concatenated output (``csrc/decode_full.cu``: a head table laid out by
  :func:`plan_full_decode`; blocks of ``K3_TILE`` output elements staged
  through shared memory in 16-byte pieces); ``decode_head`` launches the
  same kernel with one head. Plain version ``ops.decode.decode_all``.
  ``model.forward``.

K1, K1c and K4 share one decode body (``csrc/decode_common.cuh``), and K3
takes its sigmoid, clamp and exp from the same header. For a CUDA
tensor each wrapper launches its kernel on the current stream (counted in
``<wrapper>.launches``) or raises; for a CPU tensor, and only then, it runs
its plain PyTorch version (``*_reference``), which the CPU tests and
``chip_smoke.py``'s comparison use. Head maps decode in float32 whatever
their type: a bf16 map widens exactly. Channel padding needs no copy: the
kernels take the map's element strides.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..precision import tf32
from . import decode as plain_decode
from ._build import check_launch, load_kernels, sm_count
from .tf32 import tf32_operands

Anchors = Sequence[Tuple[float, float]]
MAX_ANCHORS = 64  # K1_MAX_ANCHORS in csrc/decode_common.cuh: the kernels' parameter block
# the JAX package's route gate (``pallas_decode.MAX_ANCHORS``): the Detector
# sends heads with more anchors to the plain-tensor decode, as the reference
# does, so a graph takes the same route in both packages
GATE_ANCHORS = 4
FUSED_CIN_MULTIPLE = 128  # ``fused_head_supported``'s lane boundary
# K4's widest tile (the widest wgmma N): an anchor's 5 + C columns above it
# run in pieces of it, one after another in the same block
K4_MAX_TILE = 256
MAP_DTYPES = (torch.float32, torch.bfloat16)
# K1 / K1c (csrc/decode_packed.cu): heads a launch's table holds, the cells
# of a block's tile (the first that fits shared memory), the lanes that
# decode one (cell, anchor) and the planner's choice of them by map type
# (measured by chip_smoke.py's k1 phase at yolov3@416 B=8, PERF.md), and a
# block's most shared memory on the H100
K1_MAX_HEADS = 8
K1_TILES = (32, 16)
K1_GROUPS = (2, 4)
K1_GROUP = {torch.float32: 4, torch.bfloat16: 2}
K1_SMEM_LIMIT = 232448
# K3 (csrc/decode_full.cu): heads a launch's table holds, and the output
# elements a block owns
K3_MAX_HEADS = 8
K3_TILE = 4096


def supported(anchors_per_head: Sequence[Anchors]) -> bool:
    """The packed / compact kernel route's gate: ≤ 4 anchors per head
    (``pallas_decode.supported``; every published yolov3 variant has 3)."""
    return all(len(a) <= GATE_ANCHORS for a in anchors_per_head)


def fused_head_supported(cin: int, anchors: Anchors) -> bool:
    """K4's shape gate, the JAX package's ``fused_head_supported``: the
    pre-head channel count on the 128 boundary and ≤ 4 anchors."""
    return cin % FUSED_CIN_MULTIPLE == 0 and len(anchors) <= GATE_ANCHORS


def _check_head(feat: torch.Tensor, anchors: Anchors, num_classes: int) -> None:
    if feat.dim() != 4:
        raise ValueError(f"head map must be (B, gy, gx, C), got {tuple(feat.shape)}")
    if feat.dtype not in MAP_DTYPES:
        raise TypeError(f"head map must be float32 or bfloat16, got {feat.dtype}")
    need = len(anchors) * (5 + num_classes)
    if not anchors or num_classes < 1 or feat.shape[3] < need:
        raise ValueError(f"head map has {feat.shape[3]} channels, needs "
                         f"{len(anchors)}*(5+{num_classes}) = {need}")


def _check_device(t: torch.Tensor, kernel: str) -> bool:
    """True for a CPU tensor (plain version), False for CUDA (the kernel);
    raises for any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{kernel} runs on CUDA or CPU tensors, got {t.device}")
    return False


def _anchors_c(anchors: Anchors):
    flat = [float(v) for wh in anchors for v in wh]
    return (ctypes.c_float * len(flat))(*flat)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def decode_packed_head_reference(feat: torch.Tensor, anchors: Anchors,
                                 stride: int, num_classes: int,
                                 prob_thresh: float = 0.0,
                                 head_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch K1 for one head → records (B, a·gy·gx, 8) float32."""
    _check_head(feat, anchors, num_classes)
    b, gy, gx, _ = feat.shape
    a, per = len(anchors), 5 + num_classes
    cells = gy * gx
    f = feat[..., :a * per].float().reshape(b, cells, a, per)
    cell = torch.arange(cells, device=feat.device)
    col = (cell % gx).to(torch.float32)[:, None]        # (cells, 1)
    row = (cell // gx).to(torch.float32)[:, None]
    # made by fill kernels, not copied from the host: a CUDA-graph capture
    # (chip_smoke.py times the plain versions so) refuses a host copy
    anc = torch.stack([torch.full((), float(v), dtype=torch.float32,
                                  device=feat.device)
                       for wh in anchors for v in wh]).reshape(len(anchors), 2)

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


def _payload_out(out: Optional[torch.Tensor], b: int, n_end: int,
                 device: torch.device) -> torch.Tensor:
    """The (B, N, 8) float32 payload a head writes records [.., n_end) of."""
    if out is None:
        out = torch.empty((b, n_end, 8), dtype=torch.float32, device=device)
    if (out.dim() != 3 or out.shape[0] != b or out.shape[2] != 8
            or out.shape[1] < n_end or out.dtype != torch.float32
            or out.device != device):
        raise ValueError(f"payload {tuple(out.shape)} {out.dtype} on "
                         f"{out.device} cannot take head records up to "
                         f"{n_end} of batch {b}")
    return out


def _check_kernel_io(feat: torch.Tensor, outs: Sequence[torch.Tensor],
                     a: int, kernel: str) -> None:
    if feat.stride(3) != 1 or not all(o.is_contiguous() for o in outs):
        raise ValueError(f"{kernel} needs a channels-last input (channel "
                         f"stride 1) and contiguous outputs")
    if a > MAX_ANCHORS:
        raise ValueError(f"{kernel} takes at most {MAX_ANCHORS} anchors per "
                         f"head, got {a}")
    if outs[0].shape[1] >= 2 ** 24:
        raise ValueError("candidate indices must stay below 2^24 to be exact in f32")


class HeadRow(NamedTuple):
    head: int         # index of the head in the call
    dense: bool       # the map's tile is one contiguous range (cp.async)
    first_block: int  # the head's first block in its launch
    blocks: int       # ceil(B·gy·gx / tile_cells)
    anchor0: int      # the head's first anchor in the launch's anchor table
    head_offset: int  # its first candidate slot


class DecodePlan(NamedTuple):
    """One launch of K1 / K1c (``csrc/decode_packed.cu``): its head table."""
    rows: Tuple[HeadRow, ...]
    tile_cells: int   # cells a block: 32, or 16 where 32 rows do not fit
    group: int        # lanes that decode one (cell, anchor)
    blocks: int


def dense_map(feat: torch.Tensor, n_anchors: int, num_classes: int) -> bool:
    """True when K1's tile of ``feat`` is one contiguous, 16-byte aligned
    range: channels-last with the pixel stride equal to the A·(5+C)
    channels decoded, rows and images packed (strides of size-1 dims
    ignored), and a 16-byte aligned base. A channel-padded map or a sliced
    view is not: it takes the kernel's strided element path."""
    need = n_anchors * (5 + num_classes)
    if feat.shape[3] != need or feat.data_ptr() % 16:
        return False
    want = (feat.shape[1] * feat.shape[2] * need, feat.shape[2] * need, need, 1)
    return all(st == w for st, w, n in zip(feat.stride(), want, feat.shape)
               if n > 1)


def _launch_chunks(feats: Sequence[torch.Tensor],
                   anchors_per_head: Sequence[Anchors],
                   max_heads: int) -> List[List[int]]:
    """The heads of each launch of a head-table kernel (K1, K3):
    consecutive heads of one map type share a launch while they fit its
    table, ``max_heads`` heads and ``MAX_ANCHORS`` anchors."""
    chunks: List[List[int]] = []
    for h, (f, a) in enumerate(zip(feats, anchors_per_head)):
        last = chunks[-1] if chunks else None
        if (last is None or len(last) == max_heads
                or feats[last[0]].dtype != f.dtype
                or sum(len(anchors_per_head[i]) for i in last) + len(a)
                > MAX_ANCHORS):
            chunks.append([h])
        else:
            last.append(h)
    return chunks


def plan_decode(feats: Sequence[torch.Tensor],
                anchors_per_head: Sequence[Anchors], num_classes: int,
                head_offsets: Sequence[int], group: Optional[int] = None
                ) -> List[DecodePlan]:
    """The launches of K1 / K1c for these heads: one for a graph's heads
    (:func:`_launch_chunks` with ``K1_MAX_HEADS``). Within a launch, head
    h's blocks follow head h-1's and block t of a head takes cells
    [t·tile_cells, (t+1)·tile_cells) of its flattened (image·gy·gx + cell)
    index, so every (image, cell) falls in exactly one block.
    ``tile_cells`` is 32 where 32 rows of the widest head's A·(5+C)
    channels fit ``K1_SMEM_LIMIT`` bytes of shared memory, else 16; wider
    rows raise. ``group``: lanes a record, ``K1_GROUP`` of the map type by
    default."""
    if group is not None and group not in K1_GROUPS:
        raise ValueError(f"K1 decodes a record with {K1_GROUPS} lanes, "
                         f"got {group}")
    per = 5 + num_classes
    plans = []
    for chunk in _launch_chunks(feats, anchors_per_head, K1_MAX_HEADS):
        size = feats[chunk[0]].element_size()
        widest = max(len(anchors_per_head[h]) for h in chunk) * per * size
        tile = next((t for t in K1_TILES if t * widest <= K1_SMEM_LIMIT), None)
        if tile is None:
            raise ValueError(f"K1 stages {min(K1_TILES)} cells of A*(5+C) "
                             f"channels in {K1_SMEM_LIMIT} bytes of shared "
                             f"memory: {widest} bytes a cell do not fit")
        rows, first, anchor0 = [], 0, 0
        for h in chunk:
            f, a = feats[h], anchors_per_head[h]
            n = -(-f.shape[0] * f.shape[1] * f.shape[2] // tile)
            rows.append(HeadRow(h, dense_map(f, len(a), num_classes), first,
                                n, anchor0, head_offsets[h]))
            first += n
            anchor0 += len(a)
        plans.append(DecodePlan(tuple(rows), tile, group or K1_GROUP[
            feats[chunk[0]].dtype], first))
    return plans


def launch_decode(feats: Sequence[torch.Tensor],
                  anchors_per_head: Sequence[Anchors],
                  strides: Sequence[int], num_classes: int,
                  prob_thresh: float, head_offsets: Sequence[int],
                  outs: Sequence[torch.Tensor], kernel: str,
                  group: Optional[int] = None, lib=None) -> int:
    """Launch K1 (``outs`` = [payload]) or K1c (``outs`` = [boxes, scores,
    classes]) over CUDA head maps as :func:`plan_decode` plans them (with
    ``group`` lanes a record); return the number of launches (1 for every
    published cfg). The wrappers' launcher; ``chip_smoke.py`` times each
    ``group`` through it, and ``tools/ablate_phases.py`` its builds
    (``lib``: a library other than the package's)."""
    b = feats[0].shape[0]
    for f, a in zip(feats, anchors_per_head):
        _check_kernel_io(f, outs, len(a), kernel)
        if f.shape[0] != b or f.device != outs[0].device:
            raise ValueError(f"{kernel}: every head map must have batch {b} "
                             f"and lie on {outs[0].device}")
    if any(o.data_ptr() % 16 for o in outs):
        raise ValueError(f"{kernel} stores records in 16-byte pieces: its "
                         f"outputs must be 16-byte aligned")
    lib = lib or load_kernels()
    packed = len(outs) == 1
    ptrs = ([outs[0].data_ptr(), 0, 0, 0] if packed
            else [0, *(o.data_ptr() for o in outs)])
    plans = plan_decode(feats, anchors_per_head, num_classes, head_offsets,
                        group)
    for plan in plans:
        args, strides_c, anchors = [], [], []
        for row in plan.rows:
            f = feats[row.head]
            a = anchors_per_head[row.head]
            args += [f.data_ptr(), f.stride(0), f.stride(1), f.stride(2),
                     f.shape[1], f.shape[2], len(a), row.anchor0,
                     row.head_offset, row.first_block, int(row.dense)]
            strides_c.append(float(strides[row.head]))
            anchors += [float(v) for wh in a for v in wh]
        with torch.cuda.device(outs[0].device):
            rc = lib.yolo_decode_heads(
                (ctypes.c_longlong * len(args))(*args),
                (ctypes.c_float * len(strides_c))(*strides_c), len(plan.rows),
                (ctypes.c_float * len(anchors))(*anchors), len(anchors) // 2,
                int(feats[plan.rows[0].head].dtype == torch.bfloat16),
                int(packed), plan.group, plan.tile_cells, plan.blocks, b,
                num_classes, float(prob_thresh), outs[0].shape[1], *ptrs,
                _stream(outs[0].device))
        check_launch(rc, kernel)
    return len(plans)


def decode_packed_head(feat: torch.Tensor, anchors: Anchors, stride: int,
                       num_classes: int, prob_thresh: float = 0.0,
                       head_offset: int = 0,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1: decode one head into ``out[:, head_offset : head_offset + a·gy·gx]``
    of a (B, N, 8) float32 payload (allocated when ``out`` is None, with
    N = head_offset + a·gy·gx); returns the payload.

    CUDA tensor: launches the K1 kernel with a one-head table on the
    current stream (counted in ``decode_packed_head.launches``) or raises.
    CPU tensor: the plain version."""
    _check_head(feat, anchors, num_classes)
    b, gy, gx, _ = feat.shape
    n_head = len(anchors) * gy * gx
    out = _payload_out(out, b, head_offset + n_head, feat.device)
    if _check_device(feat, "K1"):
        out[:, head_offset:head_offset + n_head] = decode_packed_head_reference(
            feat, anchors, stride, num_classes, prob_thresh, head_offset)
        return out
    decode_packed_head.launches += launch_decode(
        [feat], [anchors], [stride], num_classes, prob_thresh, [head_offset],
        [out], "K1")
    return out


decode_packed_head.launches = 0


def candidate_offsets(feats: Sequence[torch.Tensor],
                      anchors_per_head: Sequence[Anchors]) -> List[int]:
    """Each head's first candidate slot, heads in order with a·gy·gx
    candidates each, then the total N."""
    offsets, off = [], 0
    for f, a in zip(feats, anchors_per_head):
        offsets.append(off)
        off += len(a) * f.shape[1] * f.shape[2]
    return offsets + [off]


def decode_packed(feats: Sequence[torch.Tensor], anchors_per_head: Sequence[Anchors],
                  strides: Sequence[int], num_classes: int,
                  prob_thresh: float = 0.0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 over every head → (payload (B, N, 8), scores (B, N)). One payload
    allocation, written in place, so no concat follows. ``scores`` is the
    view ``payload[..., 4]``.

    CUDA tensors: ONE launch of the K1 kernel for all the heads (counted in
    ``decode_packed.launches``) or raises. CPU tensors: the plain version
    head by head."""
    for f, a in zip(feats, anchors_per_head):
        _check_head(f, a, num_classes)
    offsets = candidate_offsets(feats, anchors_per_head)
    payload = torch.empty((feats[0].shape[0], offsets[-1], 8),
                          dtype=torch.float32, device=feats[0].device)
    if _check_device(feats[0], "K1"):
        for f, a, s, off in zip(feats, anchors_per_head, strides, offsets):
            decode_packed_head(f, a, s, num_classes, prob_thresh=prob_thresh,
                               head_offset=off, out=payload)
    else:
        decode_packed.launches += launch_decode(
            feats, anchors_per_head, strides, num_classes, prob_thresh,
            offsets, [payload], "K1")
    return payload, payload[..., 4]


decode_packed.launches = 0


# ---------------------------------------------------------------- K1c


CompactOut = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def decode_compact_head_reference(feat: torch.Tensor, anchors: Anchors,
                                  stride: int, num_classes: int,
                                  prob_thresh: float = 0.0) -> CompactOut:
    """Plain PyTorch K1c for one head: K1's records split three ways →
    (boxes (B, n, 4), scores (B, n), classes (B, n) int32), anchor-major."""
    rec = decode_packed_head_reference(feat, anchors, stride, num_classes,
                                       prob_thresh)
    return rec[..., :4], rec[..., 4], rec[..., 5].to(torch.int32)


def _compact_out(out: Optional[CompactOut], b: int, n_end: int,
                 device: torch.device) -> CompactOut:
    if out is None:
        return (torch.empty((b, n_end, 4), dtype=torch.float32, device=device),
                torch.empty((b, n_end), dtype=torch.float32, device=device),
                torch.empty((b, n_end), dtype=torch.int32, device=device))
    boxes, scores, classes = out
    n = boxes.shape[1] if boxes.dim() == 3 else -1
    if (boxes.shape != (b, n, 4) or scores.shape != (b, n)
            or classes.shape != (b, n) or n < n_end
            or boxes.dtype != torch.float32 or scores.dtype != torch.float32
            or classes.dtype != torch.int32
            or not boxes.device == scores.device == classes.device == device):
        raise ValueError(f"compact outputs {tuple(boxes.shape)} "
                         f"{tuple(scores.shape)} {tuple(classes.shape)} cannot "
                         f"take head records up to {n_end} of batch {b}")
    return out


def decode_compact_head(feat: torch.Tensor, anchors: Anchors, stride: int,
                        num_classes: int, prob_thresh: float = 0.0,
                        head_offset: int = 0,
                        out: Optional[CompactOut] = None) -> CompactOut:
    """K1c: decode one head into slots ``[head_offset, head_offset + a·gy·gx)``
    of (boxes (B, N, 4), scores (B, N), classes (B, N) int32) (allocated
    when ``out`` is None); returns the three.

    CUDA tensor: launches the K1c kernel (K1's, storing three ways) with a
    one-head table on the current stream (counted in
    ``decode_compact_head.launches``) or raises. CPU tensor: the plain
    version."""
    _check_head(feat, anchors, num_classes)
    b, gy, gx, _ = feat.shape
    n_head = len(anchors) * gy * gx
    out = _compact_out(out, b, head_offset + n_head, feat.device)
    if _check_device(feat, "K1c"):
        boxes, scores, classes = out
        sl = slice(head_offset, head_offset + n_head)
        boxes[:, sl], scores[:, sl], classes[:, sl] = (
            decode_compact_head_reference(feat, anchors, stride, num_classes,
                                          prob_thresh))
        return out
    decode_compact_head.launches += launch_decode(
        [feat], [anchors], [stride], num_classes, prob_thresh, [head_offset],
        out, "K1c")
    return out


decode_compact_head.launches = 0


def decode_compact(feats: Sequence[torch.Tensor],
                   anchors_per_head: Sequence[Anchors],
                   strides: Sequence[int], num_classes: int,
                   prob_thresh: float = 0.0) -> CompactOut:
    """K1c over every head → (boxes (B, N, 4), scores (B, N), classes (B, N)
    int32), anchor-major within each head, heads in cfg order: the same
    detection sets as ``ops.decode.decode_compact`` (cell-major).

    CUDA tensors: ONE launch of the K1c kernel for all the heads (counted
    in ``decode_compact.launches``) or raises. CPU tensors: the plain
    version head by head."""
    for f, a in zip(feats, anchors_per_head):
        _check_head(f, a, num_classes)
    offsets = candidate_offsets(feats, anchors_per_head)
    out = _compact_out(None, feats[0].shape[0], offsets[-1], feats[0].device)
    if _check_device(feats[0], "K1c"):
        for f, a, s, off in zip(feats, anchors_per_head, strides, offsets):
            decode_compact_head(f, a, s, num_classes, prob_thresh=prob_thresh,
                                head_offset=off, out=out)
    else:
        decode_compact.launches += launch_decode(
            feats, anchors_per_head, strides, num_classes, prob_thresh,
            offsets, out, "K1c")
    return out


decode_compact.launches = 0


# ---------------------------------------------------------------- K4


def _check_fused(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 anchors: Anchors, num_classes: int) -> int:
    """Validate K4's operands; return the head's channel count A·(5+C)."""
    if x.dim() != 4 or x.dtype not in MAP_DTYPES:
        raise ValueError(f"pre-head map must be (B, gy, gx, Cin) float32 or "
                         f"bfloat16, got {tuple(x.shape)} {x.dtype}")
    cin = x.shape[3]
    if not fused_head_supported(cin, anchors):
        raise ValueError(f"fused packed decode needs Cin % "
                         f"{FUSED_CIN_MULTIPLE} == 0 and <= {GATE_ANCHORS} "
                         f"anchors/head, got Cin={cin}, {len(anchors)} anchors")
    need = len(anchors) * (5 + num_classes)
    if (w.dim() != 2 or w.shape[1] != cin or w.shape[0] < need
            or bias.dim() != 1 or bias.shape[0] < need):
        raise ValueError(f"head weights {tuple(w.shape)} / bias "
                         f"{tuple(bias.shape)} do not fit Cin={cin} and "
                         f"{need} head channels")
    return need


def decode_packed_fused_head_reference(x: torch.Tensor, w: torch.Tensor,
                                       bias: torch.Tensor, anchors: Anchors,
                                       stride: int, num_classes: int,
                                       prob_thresh: float = 0.0,
                                       head_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch K4: the 1×1 head conv as one float32 matmul (TF32 off)
    plus the bias, then :func:`decode_packed_head_reference` → records
    (B, a·gy·gx, 8)."""
    need = _check_fused(x, w, bias, anchors, num_classes)
    b, gy, gx, cin = x.shape
    with tf32(False):
        h = x.reshape(-1, cin).float() @ w[:need].float().T + bias[:need].float()
    return decode_packed_head_reference(h.reshape(b, gy, gx, need), anchors,
                                        stride, num_classes, prob_thresh,
                                        head_offset)


class FusedTiles(NamedTuple):
    block_m: int   # cells of a block's tile: 64 or 128
    n_tile: int    # the tile's columns, 5 + C padded
    resident: int  # blocks a multiprocessor the kernel is built for: 1 or 2


def plan_fused_tiles(m: int, per: int, anchors: int, cin: int,
                     sm_count: int, elem_size: int = 2) -> FusedTiles:
    """The tiles of K4's kernels (``csrc/decode_fused.cu``) for M = B·gy·gx
    cells, ``per`` = 5 + C channels an anchor, ``anchors`` per head,
    ``cin`` pre-head channels and operands of ``elem_size`` bytes (2: bf16,
    4: float32), on a card with ``sm_count`` multiprocessors. The grid is
    ceil(M / block_m) × anchors blocks of block_m cells × one anchor.

    ``n_tile``: ``per`` rounded up to a multiple of 32 (one warpgroup's
    ``wgmma`` N, at most 128), above 128 to a multiple of 64 (two
    warpgroups, each half the columns, and then 64-row tiles), above
    ``K4_MAX_TILE`` (256) that width: the block runs the anchor's columns
    in pieces of 256, one K loop each, the class max passing from piece to
    piece.
    ``block_m``: 64 while every 64-row tile of the head gets a
    multiprocessor of its own, else 128, which re-reads the anchor's weights
    half as often. ``resident``: 2 for bf16 where the whole K fits a ring
    of two 128-channel steps (Cin ≤ 256) and two such blocks fit a
    multiprocessor's shared memory (block_m + n_tile ≤ 224): one block's
    fill and decode then overlap the other's products; with a longer K the
    deeper ring of one block a multiprocessor wins. The float32 kernel's
    ring (the activations beside the weights' hi and lo tiles, up to four
    32-channel steps) leaves room for one block: resident 1. ``chip_smoke.py``'s ``k4`` phase times every
    choice at yolov3@416's heads (``PERF.md``)."""
    if per <= 5:
        raise ValueError(f"K4's kernels take 5 + C > 5 channels an anchor, "
                         f"got {per}")
    if per > 128:
        block_m, n_tile = 64, min(-(-per // 64) * 64, K4_MAX_TILE)
    else:
        n_tile = -(-per // 32) * 32
        block_m = 64 if -(-m // 64) * anchors <= sm_count else 128
    resident = (2 if elem_size == 2 and cin <= 256 and block_m + n_tile <= 224
                else 1)
    return FusedTiles(block_m, n_tile, resident)


def check_fused_mma_input(x: torch.Tensor, num_classes: int,
                          n_anchors: int) -> None:
    """Raise for a head that K4's kernels do not take: more than
    ``MAX_ANCHORS`` anchors, or channel rows that do not start on 16-byte
    boundaries (batch, row and pixel strides a multiple of 16 bytes (8
    bf16, 4 float32 elements) and a 16-byte aligned base). Any class count
    passes, as the route gate's (:func:`fused_head_supported`) does. There
    is no fallback: the wrapper calls this before any launch."""
    if n_anchors > MAX_ANCHORS:
        raise ValueError(f"K4 takes at most {MAX_ANCHORS} anchors per head, "
                         f"got {n_anchors}")
    row = 16 // x.element_size()
    if (x.stride(3) != 1 or any(s % row for s in x.stride()[:3])
            or x.data_ptr() % 16):
        raise ValueError(f"K4's kernels read channel rows in 16-byte "
                         f"pieces: it needs channel stride 1, batch / row / "
                         f"pixel strides that are multiples of {row} "
                         f"elements and a 16-byte aligned x, got strides "
                         f"{tuple(x.stride())}")


def decode_packed_fused_head(x: torch.Tensor, w: torch.Tensor,
                             bias: torch.Tensor, anchors: Anchors, stride: int,
                             num_classes: int, prob_thresh: float = 0.0,
                             head_offset: int = 0,
                             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4: one head's K1 records from its pre-head activation ``x``
    (B, gy, gx, Cin), Cin % 128 == 0, and head conv ``w`` (≥A·(5+C), Cin),
    ``bias`` (≥A·(5+C),), written into ``out`` like
    :func:`decode_packed_head`. ``w`` is cast to ``x``'s type (bf16 operands
    stay bf16); products are summed in float32 at every precision.

    CUDA tensor: launches the K4 kernel on the current stream (counted in
    ``decode_packed_fused_head.launches``) or raises: the tensor-core kernel
    of x's type, bf16 or float32 as split TF32 (:func:`check_fused_mma_input`
    says what they refuse). CPU tensor: the plain version."""
    need = _check_fused(x, w, bias, anchors, num_classes)
    b, gy, gx, cin = x.shape
    a = len(anchors)
    n_head = a * gy * gx
    out = _payload_out(out, b, head_offset + n_head, x.device)
    if _check_device(x, "K4"):
        out[:, head_offset:head_offset + n_head] = (
            decode_packed_fused_head_reference(x, w, bias, anchors, stride,
                                               num_classes, prob_thresh,
                                               head_offset))
        return out
    check_fused_mma_input(x, num_classes, a)
    tiles = plan_fused_tiles(b * gy * gx, 5 + num_classes, a, cin,
                             sm_count(x.get_device()), x.element_size())
    w = w[:need].to(x.dtype).contiguous()
    bias = bias[:need].float().contiguous()
    if w.device != x.device or bias.device != x.device:
        raise ValueError("K4 needs x, w and bias on one device")
    _check_kernel_io(x, [out], a, "K4")
    w_lo = None  # float32: the weights split once, kept on w
    if x.dtype == torch.float32:
        w, w_lo = tf32_operands(w)
    lib = load_kernels()
    with torch.cuda.device(x.device):
        rc = lib.yolo_decode_packed_fused_head(
            x.data_ptr(), x.stride(0), x.stride(1), x.stride(2),
            int(x.dtype == torch.bfloat16), w.data_ptr(),
            None if w_lo is None else w_lo.data_ptr(), bias.data_ptr(),
            b, gy, gx, cin, a, num_classes, _anchors_c(anchors), float(stride),
            float(prob_thresh), head_offset, out.shape[1], *tiles,
            out.data_ptr(), _stream(x.device))
    check_launch(rc, "decode_packed_fused_head")
    decode_packed_fused_head.launches += 1
    return out


decode_packed_fused_head.launches = 0


def decode_packed_fused(pre_heads: Sequence[torch.Tensor],
                        head_weights: Sequence[torch.Tensor],
                        head_biases: Sequence[torch.Tensor],
                        anchors_per_head: Sequence[Anchors],
                        strides: Sequence[int], num_classes: int,
                        prob_thresh: float = 0.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 over every head → (payload (B, N, 8), scores (B, N)); candidate
    order identical to :func:`decode_packed`."""
    sizes = [len(a) * x.shape[1] * x.shape[2]
             for x, a in zip(pre_heads, anchors_per_head)]
    payload = torch.empty((pre_heads[0].shape[0], sum(sizes), 8),
                          dtype=torch.float32, device=pre_heads[0].device)
    off = 0
    for x, w, bias, a, s, n in zip(pre_heads, head_weights, head_biases,
                                   anchors_per_head, strides, sizes):
        decode_packed_fused_head(x, w, bias, a, s, num_classes,
                                 prob_thresh=prob_thresh, head_offset=off,
                                 out=payload)
        off += n
    return payload, payload[..., 4]


# ---------------------------------------------------------------- K3


class FullHeadRow(NamedTuple):
    head: int         # index of the head in the call
    dense: bool       # one packed range per image, 16-byte aligned base
    first_block: int  # the head's first block in its launch
    tiles: int        # blocks an image: ceil(segment / K3_TILE)
    anchor0: int      # the head's first anchor in the launch's anchor table
    row_offset: int   # its first row of an image in the (B, N, 5+C) output
    segment: int      # elements of one (image, head): gy·gx·A·(5+C) < 2^31


class FullDecodePlan(NamedTuple):
    """One launch of K3 (``csrc/decode_full.cu``): its head table."""
    rows: Tuple[FullHeadRow, ...]
    blocks: int


def plan_full_decode(feats: Sequence[torch.Tensor],
                     anchors_per_head: Sequence[Anchors], num_classes: int,
                     row_offsets: Sequence[int]) -> List[FullDecodePlan]:
    """The launches of K3 for these heads: one for a graph's heads
    (:func:`_launch_chunks` with ``K3_MAX_HEADS``). Head h writes
    output rows [row_offsets[h], + gy·gx·A) of every image; its (image,
    head) range of ``segment`` elements is split into ``tiles`` blocks of
    ``K3_TILE`` elements, image by image, after head h-1's blocks. The
    kernel addresses a block's range from a 64-bit base with 32-bit offsets,
    so a segment must stay below 2^31 elements and a launch below 2^31
    blocks; both raise."""
    per = 5 + num_classes
    plans = []
    for chunk in _launch_chunks(feats, anchors_per_head, K3_MAX_HEADS):
        rows, first, anchor0 = [], 0, 0
        for h in chunk:
            f, a = feats[h], anchors_per_head[h]
            seg = f.shape[1] * f.shape[2] * len(a) * per
            if seg >= 2 ** 31:
                raise ValueError(f"K3 addresses an (image, head) range of "
                                 f"{seg} elements with 32-bit offsets: it "
                                 f"must stay below 2^31")
            tiles = -(-seg // K3_TILE)
            rows.append(FullHeadRow(h, dense_map(f, len(a), num_classes),
                                    first, tiles, anchor0, row_offsets[h],
                                    seg))
            first += f.shape[0] * tiles
            anchor0 += len(a)
        if first >= 2 ** 31:
            raise ValueError(f"K3 launch of {first} blocks: at most 2^31 - 1")
        plans.append(FullDecodePlan(tuple(rows), first))
    return plans


def launch_full_decode(feats: Sequence[torch.Tensor],
                       anchors_per_head: Sequence[Anchors],
                       strides: Sequence[int], num_classes: int,
                       row_offsets: Sequence[int], out: torch.Tensor,
                       lib=None) -> int:
    """Launch K3 over CUDA head maps into ``out`` (B, N, 5+C) float32 as
    :func:`plan_full_decode` plans them; return the number of launches (1
    for every published cfg). The wrappers' launcher; ``tools/ablate_phases``
    times its builds through it (``lib``: a library other than the
    package's)."""
    b = feats[0].shape[0]
    for f, a in zip(feats, anchors_per_head):
        _check_kernel_io(f, [out], len(a), "K3")
        if f.shape[0] != b or f.device != out.device:
            raise ValueError(f"K3: every head map must have batch {b} and "
                             f"lie on {out.device}")
    if (out.dim() != 3 or out.shape[0] != b or out.shape[2] != 5 + num_classes
            or out.dtype != torch.float32 or out.data_ptr() % 16):
        raise ValueError(f"K3 writes a 16-byte aligned float32 (B, N, 5+C) "
                         f"output, got {tuple(out.shape)} {out.dtype}")
    lib = lib or load_kernels()
    plans = plan_full_decode(feats, anchors_per_head, num_classes, row_offsets)
    for plan in plans:
        args, strides_c, anchors = [], [], []
        for row in plan.rows:
            f = feats[row.head]
            a = anchors_per_head[row.head]
            args += [f.data_ptr(), f.stride(0), f.stride(1), f.stride(2),
                     f.shape[1], f.shape[2], len(a), row.anchor0,
                     row.row_offset, row.first_block, row.tiles,
                     int(row.dense)]
            strides_c.append(float(strides[row.head]))
            anchors += [float(v) for wh in a for v in wh]
        with torch.cuda.device(out.device):
            rc = lib.yolo_decode_full(
                (ctypes.c_longlong * len(args))(*args),
                (ctypes.c_float * len(strides_c))(*strides_c), len(plan.rows),
                (ctypes.c_float * len(anchors))(*anchors), len(anchors) // 2,
                int(feats[plan.rows[0].head].dtype == torch.bfloat16),
                plan.blocks, num_classes, out.shape[1], out.data_ptr(),
                _stream(out.device))
        check_launch(rc, "K3")
    return len(plans)


def decode_head(feat: torch.Tensor, anchors: Anchors, stride: int,
                num_classes: int) -> torch.Tensor:
    """K3 for one head: its NHWC map (B, gy, gx, ≥A·(5+C)), float32 or
    bf16 → (B, gy·gx·A, 5+C) float32: center-xywh boxes in net pixels,
    sigmoid objectness and classes, cell-major (``cell·A + anchor``). The
    map widens to float32 before any math.

    CUDA tensor: launches the K3 kernel with a one-head table on the
    current stream (counted in ``decode_head.launches``) or raises. CPU
    tensor: the plain version (``ops.decode.decode_head`` on the float32
    map)."""
    _check_head(feat, anchors, num_classes)
    if _check_device(feat, "K3"):
        return plain_decode.decode_head(feat.float(), anchors, stride,
                                        num_classes)
    b, gy, gx, _ = feat.shape
    out = torch.empty((b, gy * gx * len(anchors), 5 + num_classes),
                      dtype=torch.float32, device=feat.device)
    decode_head.launches += launch_full_decode(
        [feat], [anchors], [stride], num_classes, [0], out)
    return out


decode_head.launches = 0


def decode_all(feats: Sequence[torch.Tensor],
               anchors_per_head: Sequence[Anchors], strides: Sequence[int],
               num_classes: int) -> torch.Tensor:
    """K3 over every head → (B, N, 5+C) float32, heads in cfg order (the
    reference layout), written in place: no concat follows.

    CUDA tensors: ONE launch of the K3 kernel for all the heads (counted in
    ``decode_all.launches``; one per ``Darknet(x)`` call) or raises. CPU
    tensors: the plain version head by head."""
    for f, a in zip(feats, anchors_per_head):
        _check_head(f, a, num_classes)
    offsets = candidate_offsets(feats, anchors_per_head)
    if _check_device(feats[0], "K3"):
        return plain_decode.decode_all([f.float() for f in feats],
                                       anchors_per_head, strides, num_classes)
    out = torch.empty((feats[0].shape[0], offsets[-1], 5 + num_classes),
                      dtype=torch.float32, device=feats[0].device)
    decode_all.launches += launch_full_decode(
        feats, anchors_per_head, strides, num_classes, offsets[:-1], out)
    return out


decode_all.launches = 0
