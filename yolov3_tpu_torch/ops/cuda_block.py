"""K6: fused int8 residual block (1×1 → 3×3 → shortcut) — the block plan,
the tile plan, the CUDA wrapper and its plain version.

Port of ``yolov3_tpu/ops/pallas_block.py``. darknet53's residual bottlenecks
(a 1×1 conv halving channels, a 3×3 conv restoring them, a linear
``[shortcut]`` back to the block input) run, on the int8 activation carrier,
as one kernel launch per block (``csrc/block_int8.cu``): unfused, each block
writes and re-reads the mid activation and the 3×3 output and re-reads the
block input; fused, device-memory traffic is read-input + write-output.

:func:`fused_block_plan` has the JAX package's graph rules and
``DEFAULT_MAX_CIN``, so both packages fuse the same blocks.
``plan_geometry``, ``pad_chain_input`` and ``slice_chain_output`` of the
reference are the TPU's VMEM fit and padded chain layout and have no
counterpart: the port's kernel takes the plain (B, H, W, C) NHWC int8
tensor of any H, W and masks the image edges in its loads, so a chain of
blocks is simply consecutive launches.

The kernel runs both integer products on the int8 tensor cores (``wgmma``
s8, int32 sums): a thread block owns a ``tile_h`` × 8 tile of output pixels
(:func:`plan_block_tiles`), computes the 1×1 on its halo into an int8 mid
tile in shared memory and the 3×3 as an implicit GEMM over that tile, with
w2 streamed from L2 in steps of 128 bytes of K. ``wgmma`` takes int8
operands K-major only, so :func:`pack_block_weights` stores w1 as
(cmid_p, C) and w2 as (C, 9·cmid_p) rows, cmid_p = cmid rounded up to 64,
zero where cmid ends. The kernel takes C ∈ {128, 256} and cmid a multiple
of 16 up to 256 (:func:`check_block_domain`): every block
:func:`fused_block_plan` selects in the shipped cfgs. Bound: operations
(14.2 G int8 operations a yolov3@416 B=8 block of C = 256: 7.2 µs at the
card's peak); what holds it back is the work no product overlaps, the
copies and the 1×1 before the 3×3 and the epilogue after it
(``csrc/block_int8.cu``, ``tools/ablate_block.py``).

**Numerics contract**: the kernel mimics the unfused int8-carrier walk
(``quant.forward_features_int8_carrier``) op for op, including the
intermediate quantization of the 3×3 output to its calibrated scale before
the shortcut add. The integer products are exact (int32 sums far below
2^31, whatever order the tensor cores add in) and the epilogues are the
separate float32 operations eager PyTorch runs (no FMA contraction, round
half to even), so :func:`residual_block_int8` equals
:func:`residual_block_int8_reference` exactly on the card. Against the JAX
kernel the reference's own contract holds: differences only at
requantization ties, at most one quantization step.

For a CUDA tensor :func:`residual_block_int8` launches the kernel on the
current stream (counted in ``residual_block_int8.launches``) or raises; for
a CPU tensor, and only then, it runs the plain version.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..graph import Graph
from . import int8_conv
from ._build import check_launch, load_kernels, sm_count

# Blocks with c_in above this stay unfused: the reference fuses only the
# early, bandwidth-bound stages (c_in 128 / 256), and the port keeps the
# same plan so both packages run the same program.
DEFAULT_MAX_CIN = 256
CHANNELS = (128, 256)  # C: the 3x3's wgmma N, and whole 128-byte K tiles
CMID_MULTIPLE, CMID_MAX = 16, 256
TILE_HEIGHTS = (8, 16)  # output rows a block: one or two warpgroups
TILE_W = 8              # K6_TW: one 8-pixel core matrix a tile row
SMEM_LIMIT = 232448     # K6_SMEM_LIMIT: the 227 KB a block may use
_STAGES = 3             # K6_STAGES: w2 steps in the ring
_OUT_KINDS = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def fused_block_plan(graph: Graph, qparams, tensor_scales,
                     max_cin: int = DEFAULT_MAX_CIN) -> Dict[int, Dict]:
    """Static residual-block detection for the int8-carrier walk.

    Returns {start index a: {"cin", "cmid", "cout", "cp"}} for every
    (1×1 conv at a, 3×3 conv at a+1, shortcut at a+2) triple the fused
    kernel takes over: both convs quantized, leaky, stride 1, the shortcut
    linear and wired (a+1, a−1), neither conv output needed elsewhere,
    c_out == c_in a multiple of 128 and ≤ ``max_cin``, c_mid ≥ 32, and
    calibrated scales present for the input, mid and 3×3 tensors. ``cp``
    (c_mid on the 128 boundary) is kept so the plan compares equal to the
    JAX package's; the port's kernel pads nothing.
    """
    needed = graph.needed_outputs
    nodes = graph.nodes
    plan: Dict[int, Dict] = {}
    for a in range(1, len(nodes) - 2):
        n1, n2, n3 = nodes[a], nodes[a + 1], nodes[a + 2]
        if not (n1.kind == "convolutional" and n1.size == 1
                and n1.stride == 1 and n1.activation == "leaky"
                and n1.inputs == (a - 1,)
                and "wq" in qparams.get(a, {})):
            continue
        if not (n2.kind == "convolutional" and n2.size == 3
                and n2.stride == 1 and n2.pad and n2.activation == "leaky"
                and n2.inputs == (a,) and "wq" in qparams.get(a + 1, {})):
            continue
        if not (n3.kind == "shortcut" and n3.inputs == (a + 1, a - 1)
                and n3.activation == "linear"):
            continue
        if a in needed or (a + 1) in needed:
            continue
        cin = nodes[a - 1].out_channels
        cmid, cout = n1.out_channels, n2.out_channels
        if cin % 128 or cout != cin or cin > max_cin or cmid < 32:
            continue
        if not {a - 1, a, a + 1} <= tensor_scales.keys():
            continue
        plan[a] = {"cin": cin, "cmid": cmid, "cout": cout,
                   "cp": _round_up(cmid, 128)}
    return plan


def _cmid_padded(cmid: int) -> int:
    return _round_up(cmid, 64)


def pack_block_weights(wq1: torch.Tensor, wq2: torch.Tensor):
    """The int8 HWIO weights of the 1×1 (1, 1, C, cmid) and the 3×3
    (3, 3, cmid, C) as K6's K-major operands: ``w1k`` (cmid_p, C), row n
    the weights of mid channel n; ``w2k`` (C, ksteps·128), row o holding
    output channel o's weights at K = tap·cmid_p + mid channel, ksteps =
    ceil(9·cmid_p / 128). Zero past cmid and past 9·cmid_p."""
    cin, cmid = wq1.shape[2], wq1.shape[3]
    cp = _cmid_padded(cmid)
    w1k = torch.zeros((cp, cin), dtype=torch.int8, device=wq1.device)
    w1k[:cmid] = wq1.reshape(cin, cmid).t()
    w2 = torch.zeros((9, cp, cin), dtype=torch.int8, device=wq2.device)
    w2[:, :cmid] = wq2.reshape(9, cmid, cin)
    w2k = torch.zeros((cin, _round_up(9 * cp, 128)), dtype=torch.int8,
                      device=wq2.device)
    w2k[:, :9 * cp] = w2.reshape(9 * cp, cin).t()
    return w1k, w2k


def check_block_domain(c: int, cmid: int) -> None:
    """Raise unless K6 takes a block of ``c`` channels and ``cmid`` mid
    channels: C ∈ {128, 256}, cmid a multiple of 16 up to 256."""
    if c not in CHANNELS or cmid % CMID_MULTIPLE or not 0 < cmid <= CMID_MAX:
        raise ValueError(
            f"K6 takes C in {CHANNELS} and cmid a multiple of "
            f"{CMID_MULTIPLE} up to {CMID_MAX}, got C={c}, cmid={cmid}")


def block_smem_bytes(tile_h: int, c: int, cmid: int) -> int:
    """Dynamic shared memory of a K6 block (``k6_smem_bytes`` in
    ``csrc/block_int8.cu``): alignment slack, the x halo (rows padded to a
    multiple of 64), w1, the w2 ring, the mid tile, four float vectors."""
    cp = _cmid_padded(cmid)
    halo = (tile_h + 2) * (TILE_W + 2)
    return (1024 + c * _round_up(halo, 64) + cp * c + _STAGES * c * 128
            + cp * halo + 4 * (2 * cp + 2 * c))


def plan_block_tiles(b: int, h: int, w: int, c: int, cmid: int,
                     sm_count: int) -> int:
    """Output rows of K6's tiles (``tile_h`` × 8, grid ceil(W/8) ×
    ceil(H/tile_h) × B) on a card with ``sm_count`` multiprocessors: 16,
    or 8 while every 8 × 8 tile gets a multiprocessor of its own (K5's
    rule: a smaller tile re-reads w2 from L2 twice as often per pixel and
    pays only when it puts idle multiprocessors to work), or where 16 rows
    do not fit a block's shared memory."""
    check_block_domain(c, cmid)
    tiles8 = b * -(-h // 8) * -(-w // TILE_W)
    for th in ((8,) if tiles8 <= sm_count else (16, 8)):
        if block_smem_bytes(th, c, cmid) <= SMEM_LIMIT:
            return th
    raise ValueError(f"K6's tile for C={c}, cmid={cmid} exceeds a block's "
                     f"{SMEM_LIMIT} bytes of shared memory")


def prepare_block_params(qp1: Dict, qp2: Dict, s_in: float, s_mid: float,
                         cache: Optional[Dict] = None, key=None) -> Dict:
    """A block's operands for the kernel and for its plain version.

    ``qp1`` / ``qp2``: the 1×1 and 3×3 convs' int8 qparams ({"wq" HWIO
    int8, "sw" (C,) f32, "b" (C,) f32}). The dequant vectors bake the input
    scales (``sw·float32(s)``, the product ``quant._conv_int8_core`` forms),
    so the kernel's epilogues are a multiply and an add. ``w1k`` / ``w2k``
    are the kernel's K-major weights (:func:`pack_block_weights`); ``wq1``
    / ``wq2`` are the int8 weights as given (no copy), from which the plain
    version builds its conv operands at its first call. With ``cache`` (a dict) and
    ``key`` the result is kept and reused while the scales are the same."""
    if cache is not None and key in cache:
        got = cache[key]
        if got["s_in"] == s_in and got["s_mid"] == s_mid:
            return got
    wq1, wq2 = qp1["wq"], qp2["wq"]
    cin, cmid = wq1.shape[2], wq1.shape[3]
    if (wq1.shape[:2] != (1, 1) or wq2.shape[:3] != (3, 3, cmid)
            or wq2.shape[3] != cin):
        raise ValueError(f"not a residual bottleneck: 1×1 weight "
                         f"{tuple(wq1.shape)}, 3×3 weight {tuple(wq2.shape)}")
    w1k, w2k = pack_block_weights(wq1, wq2)
    bp = {
        "s_in": s_in, "s_mid": s_mid, "cin": cin, "cmid": cmid,
        "w1k": w1k, "w2k": w2k,
        "deq1": (qp1["sw"] * float(np.float32(s_in))).contiguous(),
        "b1": qp1["b"].float().contiguous(),
        "deq2": (qp2["sw"] * float(np.float32(s_mid))).contiguous(),
        "b2": qp2["b"].float().contiguous(),
        "wq1": wq1, "wq2": wq2,
    }
    if cache is not None:
        cache[key] = bp
    return bp


def _round_clip(f: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(f), -127, 127)


def _check(x: torch.Tensor, bp: Dict, emit_q: bool, s_out, carrier_dtype):
    if x.dim() != 4 or x.dtype != torch.int8 or x.shape[3] != bp["cin"]:
        raise ValueError(f"x must be int8 NHWC (B, H, W, {bp['cin']}), got "
                         f"{tuple(x.shape)} {x.dtype}")
    if emit_q and s_out is None:
        raise ValueError("emit_q needs the output scale s_out")
    if not emit_q and carrier_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"carrier_dtype must be bfloat16 or float32, got "
                         f"{carrier_dtype}")


def residual_block_int8_reference(x: torch.Tensor, bp: Dict, *, s_in: float,
                                  s_mid: float, s_mid2: float,
                                  s_out: Optional[float], emit_q: bool,
                                  carrier_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch K6: the unfused walk's operations on one block, in its
    order: exact int8 convs (``ops.int8_conv``), float32 epilogues as
    separate multiplies and adds, ``torch.round`` (half to even) at every
    quantize site."""
    _check(x, bp, emit_q, s_out, carrier_dtype)
    if "op1" not in bp:  # the kernel never reads these: built on first use
        bp["op1"] = int8_conv.weight_operand(bp["wq1"])
        bp["op2"] = int8_conv.weight_operand(bp["wq2"])
    m1 = int8_conv.conv_int8(x, bp["op1"], 1, 0)
    y1 = F.leaky_relu(m1.float() * bp["deq1"] + bp["b1"], 0.1)
    midq = _round_clip(y1 * (1.0 / s_mid)).to(torch.int8)
    m2 = int8_conv.conv_int8(midq, bp["op2"], 1, 1)
    y2 = F.leaky_relu(m2.float() * bp["deq2"] + bp["b2"], 0.1)
    y2 = _round_clip(y2 * (1.0 / s_mid2)) * s_mid2
    y = y2 + x.float() * s_in
    if emit_q:
        return _round_clip(y * (1.0 / s_out)).to(torch.int8)
    return y.to(carrier_dtype)


def residual_block_int8(x: torch.Tensor, bp: Dict, *, s_in: float,
                        s_mid: float, s_mid2: float, s_out: Optional[float],
                        emit_q: bool, carrier_dtype=torch.bfloat16
                        ) -> torch.Tensor:
    """Fused int8 residual block of the NHWC int8 tensor ``x`` (B, H, W, C)
    at scale ``s_in`` with the operands ``bp``
    (:func:`prepare_block_params`, built for the same ``s_in`` / ``s_mid``).
    ``s_mid`` / ``s_mid2``: the calibrated scales of the 1×1 and 3×3
    outputs. Returns (B, H, W, C): int8 at ``s_out`` when ``emit_q``, else
    ``carrier_dtype``.

    CUDA tensor: launches K6 on the current stream or raises. CPU tensor:
    the plain version."""
    _check(x, bp, emit_q, s_out, carrier_dtype)
    if bp["s_in"] != s_in or bp["s_mid"] != s_mid:
        raise ValueError("block operands were prepared for other scales")
    kw = dict(s_in=s_in, s_mid=s_mid, s_mid2=s_mid2, s_out=s_out,
              emit_q=emit_q, carrier_dtype=carrier_dtype)
    if x.device.type == "cpu":
        return residual_block_int8_reference(x, bp, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"K6 runs on CUDA or CPU tensors, got {x.device}")
    b, h, w, c = x.shape
    cmid = bp["cmid"]
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("K6 needs a contiguous, 16-byte aligned NHWC input")
    if any(bp[k].device != x.device for k in ("w1k", "w2k", "deq1", "b2")):
        raise ValueError("K6 needs x and the block operands on one device")
    tile_h = plan_block_tiles(b, h, w, c, cmid, sm_count(x.get_device()))
    out_dtype = torch.int8 if emit_q else carrier_dtype
    out = torch.empty((b, h, w, c), dtype=out_dtype, device=x.device)
    lib = load_kernels()
    with torch.cuda.device(x.device):
        rc = lib.yolo_residual_block_int8(
            x.data_ptr(), bp["w1k"].data_ptr(), bp["w2k"].data_ptr(),
            bp["deq1"].data_ptr(), bp["b1"].data_ptr(), bp["deq2"].data_ptr(),
            bp["b2"].data_ptr(), b, h, w, c, cmid, 1.0 / s_mid, 1.0 / s_mid2,
            s_mid2, s_in, (1.0 / s_out if emit_q else 1.0),
            _OUT_KINDS[out_dtype], out.data_ptr(), tile_h,
            torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(rc, "residual_block_int8")
    residual_block_int8.launches += 1
    return out


residual_block_int8.launches = 0
