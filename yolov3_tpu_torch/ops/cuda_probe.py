"""The diagnostic tools' kernels (T1, T2, T3a–e): CUDA wrappers and their
plain versions.

Port of the seven Pallas kernels in the JAX package's ``tools/``
(``csrc/probe.cu`` has the kernels and their design):

========  ==========================================  =====================
kernel    replaces                                    wrapper
========  ==========================================  =====================
T1        ``tools/bench_int8_dot.py :: make_dot``     :func:`dot_step`
T2        ``tools/bench_pallas_dot.py :: timed_grid`` :func:`dot_grid`
T3a       ``tools/probe_block.py :: probe_int8_dot``  :func:`probe_int8_dot`
T3b       ``probe_block.py :: probe_round``           :func:`probe_round`
T3c       ``probe_block.py :: probe_roll``            :func:`probe_roll`
T3d       ``probe_block.py :: probe_mask``            :func:`probe_mask`
T3e       ``probe_block.py :: probe_epilogue``        :func:`probe_epilogue`
========  ==========================================  =====================

T1 and T3a are tiled matrix products through shared memory on one of four
cores (:data:`CORES`): the int8 tensor cores by ``mma.sync`` and by
``wgmma`` (what K6 runs), the integer lanes by ``__dp4a``, and the bf16
tensor cores by ``wgmma``; T2 is a bf16 product with both projections on
``wgmma``, its (K, N) operand read MN-major as it lies, tiled by
:func:`plan_grid_tiles`.
:func:`dot_product` is T1's kernel in T3a's store mode for any core: the
bare product, the function a library call computes. They are bound by
operations at the large shapes and by the launch and the serial finish at
the small ones; the operands stay in L2. T3b, T3d and T3e run K6's own
``__device__`` functions (``csrc/block_int8_common.cuh``) and are bound by
the launch at their sizes.

Every wrapper launches its kernel on the current stream for a CUDA tensor
(counted in ``<wrapper>.launches``) or raises; for a CPU tensor, and only
then, it runs the plain version beside it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..precision import tf32
from ..weights import resolve_device
from ._build import check_launch, load_kernels

# core name -> CORE_* in csrc/probe.cu
CORES = {"mma_s8": 0, "dp4a_s8": 1, "wgmma_s8": 3, "wgmma_bf16": 4}
TILE = 64              # PD_BM = PD_BN in csrc/probe.cu
_STORE, _PROJECT = 0, 1
CARRY_STEP = 1e-24     # how far one step's result moves the carry


def _core_for(dtype: torch.dtype, core: Optional[str]) -> str:
    if core is None:
        core = "wgmma_s8" if dtype == torch.int8 else "wgmma_bf16"
    if core not in CORES:
        raise ValueError(f"core must be one of {sorted(CORES)}, got {core!r}")
    if (dtype == torch.int8) != core.endswith("_s8") or dtype not in (
            torch.int8, torch.bfloat16):
        raise ValueError(f"core {core!r} does not take {dtype} operands")
    return core


def _check_dot(lhs: torch.Tensor, rhs: torch.Tensor) -> Tuple[int, int, int]:
    if (lhs.dim() != 2 or rhs.dim() != 2 or lhs.shape[1] != rhs.shape[0]
            or lhs.dtype != rhs.dtype or lhs.device != rhs.device):
        raise ValueError(f"need (M, K) and (K, N) of one type on one device, "
                         f"got {tuple(lhs.shape)} {lhs.dtype} and "
                         f"{tuple(rhs.shape)} {rhs.dtype}")
    m, k = lhs.shape
    n = rhs.shape[1]
    if lhs.device.type == "cuda":
        if (k * lhs.element_size()) % 16 or n % 8:
            raise ValueError(f"the dot kernels need K in 16-byte units and N "
                             f"in eights, got K={k} {lhs.dtype}, N={n}")
        for t in (lhs, rhs):
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError("the dot kernels need contiguous, 16-byte "
                                 "aligned operands")
    elif lhs.device.type != "cpu":
        raise ValueError(f"CUDA or CPU tensors, got {lhs.device}")
    return m, k, n


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def dot_operands(m: int, k: int, n: int, dtype: torch.dtype,
                 rng: np.random.Generator, device=None, small: bool = True):
    """(carry, lhs, rhs, p1, p2) for one (M, K, N), made with numpy as the
    JAX tools make them: int8 in [-4, 4] (``small``) or over the full range,
    bf16 standard normal; projections normal(0, 1e-3); a zero carry."""
    device = resolve_device(device)
    if dtype == torch.int8:
        lo, hi = (-4, 5) if small else (-127, 128)
        lhs = torch.from_numpy(rng.integers(lo, hi, (m, k)).astype(np.int8))
        rhs = torch.from_numpy(rng.integers(lo, hi, (k, n)).astype(np.int8))
    else:
        lhs = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32)).to(dtype)
        rhs = torch.from_numpy(rng.normal(0, 1, (k, n)).astype(np.float32)).to(dtype)
    p1 = torch.from_numpy(rng.normal(0, 1e-3, (8, m)).astype(np.float32))
    p2 = torch.from_numpy(rng.normal(0, 1e-3, (n, 128)).astype(np.float32))
    carry = torch.zeros((8, 128), dtype=torch.float32)
    return tuple(t.to(device) for t in (
        carry, lhs, rhs, p1.to(torch.bfloat16), p2.to(torch.bfloat16)))


# ------------------------------------------------------------ the products

def shift_rhs(rhs: torch.Tensor, carry: float) -> torch.Tensor:
    """The (K, N) operand moved by the carry, as T1's kernel stages it: int8
    through int32 with wrap-around (the carry truncated to an integer), bf16
    plus the carry rounded to bf16."""
    if rhs.dtype == torch.int8:
        return (rhs.to(torch.int32) + int(carry)).to(torch.int8)
    c = torch.tensor(carry, dtype=torch.float32).to(torch.bfloat16).float()
    return (rhs.float() + c.to(rhs.device)).to(torch.bfloat16)


def dot_reference(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Plain product: int8 → exact int32, bf16 → float32 sums. On the CPU an
    int8 product is an int32 matmul; on the card (where PyTorch has no
    integer matmul) it is the float64 product, exact since
    |sum| ≤ 127²·K < 2^53."""
    if lhs.dtype == torch.int8:
        if lhs.device.type == "cpu":
            return lhs.to(torch.int32) @ rhs.to(torch.int32)
        return (lhs.double() @ rhs.double()).to(torch.int32)
    with tf32(False):
        return lhs.float() @ rhs.float()


def _consume(acc: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor
             ) -> torch.Tensor:
    """out = bf16(p1 · bf16(acc)) · p2 with float32 sums: (8, 128)."""
    with tf32(False):
        proj = p1.float() @ acc.to(torch.bfloat16).float()
        return proj.to(torch.bfloat16).float() @ p2.float()


def dot_step_reference(carry: torch.Tensor, lhs: torch.Tensor,
                       rhs: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                       steps: int = 1) -> torch.Tensor:
    """Plain T1: ``steps`` dependent dots; returns the last (8, 128)."""
    c = float(carry.reshape(-1)[0])
    out = None
    for _ in range(steps):
        out = _consume(dot_reference(lhs, shift_rhs(rhs, c)), p1, p2)
        c = float(np.float32(c) + np.float32(float(out[0, 0]))
                  * np.float32(CARRY_STEP))
    return out


def _check_projections(m: int, n: int, p1: torch.Tensor, p2: torch.Tensor,
                       like: torch.Tensor) -> None:
    for t, shape in ((p1, (8, m)), (p2, (n, 128))):
        if (tuple(t.shape) != shape or t.dtype != torch.bfloat16
                or t.device != like.device or not t.is_contiguous()):
            raise ValueError(f"projection must be contiguous bf16 {shape} on "
                             f"{like.device}, got {tuple(t.shape)} {t.dtype}")
    if like.device.type == "cuda" and m % 2:
        raise ValueError(f"the dot kernels read p1 in pairs: M={m} must be even")


def dot_step(carry: torch.Tensor, lhs: torch.Tensor, rhs: torch.Tensor,
             p1: torch.Tensor, p2: torch.Tensor, core: Optional[str] = None,
             steps: int = 1) -> torch.Tensor:
    """T1: (M, K)·(K, N) with every element consumed by the projections
    ``p1`` (8, M) and ``p2`` (N, 128) → (8, 128) float32. ``carry[0, 0]``
    (about 0) shifts ``rhs``; with ``steps`` > 1 that many dependent
    launches run back to back, each moving the carry by ``CARRY_STEP`` of
    its result, and the last result returns. ``core``: ``"wgmma_s8"``
    (the default), ``"mma_s8"`` or ``"dp4a_s8"`` for int8 operands,
    ``"wgmma_bf16"`` for bf16."""
    m, k, n = _check_dot(lhs, rhs)
    core = _core_for(lhs.dtype, core)
    _check_projections(m, n, p1, p2, lhs)
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if lhs.device.type == "cpu":
        return dot_step_reference(carry, lhs, rhs, p1, p2, steps)
    dev = lhs.device
    mt, nt = -(-m // TILE), -(-n // TILE)
    out = torch.empty((8, 128), dtype=torch.float32, device=dev)
    c = carry.reshape(-1)[:1].to(device=dev, dtype=torch.float32).clone()
    partial = torch.empty((mt, 8, n), dtype=torch.float32, device=dev)
    partial2 = torch.empty((nt, 8, 128), dtype=torch.float32, device=dev)
    counters = torch.zeros(1 + nt, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = load_kernels().yolo_probe_dot(
            lhs.data_ptr(), rhs.data_ptr(), p1.data_ptr(), p2.data_ptr(),
            c.data_ptr(), m, k, n, CORES[core], _PROJECT, out.data_ptr(),
            partial.data_ptr(), partial2.data_ptr(), counters.data_ptr(),
            steps, _stream(lhs))
    check_launch(rc, f"probe_dot ({core})")
    dot_step.launches += steps
    return out


dot_step.launches = 0


class GridTiles(NamedTuple):
    """The tiles of a T2 launch (``PgTiles`` in ``csrc/probe.cu``)."""
    block_m: int  # rows of the product a tile: 64 (one warpgroup) or 128 (two)
    block_n: int  # its columns: 128, or 256 under one warpgroup
    stages: int   # 64-deep K steps in the operand ring
    smem: int     # dynamic shared memory of a block, bytes
    resident: int  # blocks a multiprocessor's shared memory holds


GRID_STEP = 64             # PG_STEP: K elements of a ring stage
SMEM_PER_SM = 233472       # the H100's shared memory a multiprocessor
SMEM_RESERVED = 1024       # of it that CUDA reserves per resident block


def plan_grid_tiles(m: int, n: int) -> GridTiles:
    """T2's tile for an (M, K) · (K, N) product: 128 rows (two warpgroups
    sharing each (K, N) tile) above M = 64, else 64 rows with 256 columns
    where N exceeds 128, so that both operands are re-read from L2 as
    seldom as two resident blocks a multiprocessor allow (2 M K N (1/BN +
    1/BM) bytes a product; 128 x 256 would need 255 registers a thread).
    The ring takes three 64-deep K steps where a step is at most 32 KB,
    else two; the acc tile and p2's (BN, 128) rows reuse it."""
    block_m = 64 if m <= 64 else 128
    block_n = 256 if block_m == 64 and n > 128 else 128
    stage = block_m * 128 + GRID_STEP * block_n * 2
    stages = 3 if stage <= 32768 else 2
    ring = max(stages * stage, block_m * block_n * 2, block_n * 128 * 2)
    smem = 1024 + ring + (block_m // 64 + block_n // 64) * 1024
    return GridTiles(block_m, block_n, stages, smem,
                     SMEM_PER_SM // (smem + SMEM_RESERVED))


def grid_issued(m: int, k: int, n: int) -> Tuple[int, int, int]:
    """(M, K, N) as T2's tensor cores run them: M and N padded to the
    tile, K to the 16 of a product. The zero rows, columns and depth are
    the waste the tool exists to show."""
    t = plan_grid_tiles(m, n)
    return (-(-m // t.block_m) * t.block_m, -(-k // 16) * 16,
            -(-n // t.block_n) * t.block_n)


def dot_grid_reference(lhs, rhs, p1, p2, grid: int) -> torch.Tensor:
    """Plain T2: every grid step is the same product → (grid, 8, 128) bf16."""
    out = _consume(dot_reference(lhs, rhs), p1, p2).to(torch.bfloat16)
    return out[None].expand(grid, 8, 128).contiguous()


def launch_grid(lhs: torch.Tensor, rhs: torch.Tensor, p1: torch.Tensor,
                p2: torch.Tensor, grid: int, out: torch.Tensor,
                lib=None) -> None:
    """Launch T2's kernel over checked CUDA operands into ``out`` (grid, 8,
    128) bf16, tiled by :func:`plan_grid_tiles`. :func:`dot_grid`'s
    launcher; ``tools/ablate_phases`` times its builds through it (``lib``:
    a library other than the package's)."""
    (m, k), n = lhs.shape, rhs.shape[1]
    tiles = plan_grid_tiles(m, n)
    with torch.cuda.device(lhs.device):
        rc = (lib or load_kernels()).yolo_probe_dot_grid(
            lhs.data_ptr(), rhs.data_ptr(), p1.data_ptr(), p2.data_ptr(),
            m, k, n, grid, tiles.block_m, tiles.block_n, out.data_ptr(),
            _stream(lhs))
    check_launch(rc, "probe_dot_grid")


def dot_grid(lhs: torch.Tensor, rhs: torch.Tensor, p1: torch.Tensor,
             p2: torch.Tensor, grid: int) -> torch.Tensor:
    """T2: ``grid`` steps in one launch, each a bf16 (M, K)·(K, N) with
    float32 sums consumed as in T1 → (grid, 8, 128) bf16. On the card the
    steps are ``grid`` independent thread blocks, each one whole product on
    ``wgmma`` in :func:`plan_grid_tiles`' tiles."""
    m, k, n = _check_dot(lhs, rhs)
    if lhs.dtype != torch.bfloat16:
        raise ValueError(f"dot_grid takes bf16 operands, got {lhs.dtype}")
    _check_projections(m, n, p1, p2, lhs)
    if grid < 1:
        raise ValueError(f"grid must be >= 1, got {grid}")
    if lhs.device.type == "cpu":
        return dot_grid_reference(lhs, rhs, p1, p2, grid)
    out = torch.empty((grid, 8, 128), dtype=torch.bfloat16, device=lhs.device)
    launch_grid(lhs, rhs, p1, p2, grid, out)
    dot_grid.launches += 1
    return out


dot_grid.launches = 0


def _store(lhs: torch.Tensor, rhs: torch.Tensor, core: str, m: int, k: int,
           n: int, what: str) -> torch.Tensor:
    """T1's kernel in store mode on the card: (M, N) int32 or float32."""
    out_dtype = torch.int32 if lhs.dtype == torch.int8 else torch.float32
    out = torch.empty((m, n), dtype=out_dtype, device=lhs.device)
    with torch.cuda.device(lhs.device):
        rc = load_kernels().yolo_probe_dot(
            lhs.data_ptr(), rhs.data_ptr(), None, None, None, m, k, n,
            CORES[core], _STORE, out.data_ptr(), None, None, None, 1,
            _stream(lhs))
    check_launch(rc, f"{what} ({core})")
    return out


def dot_product(lhs: torch.Tensor, rhs: torch.Tensor,
                core: Optional[str] = None) -> torch.Tensor:
    """T1's kernel in store mode: the bare product (M, K)·(K, N), int8 →
    exact int32, bf16 → float32 sums, with no projection and no carry, on
    any of :data:`CORES` (the default as in :func:`dot_step`). It computes
    the function of ``torch._int_mm`` / ``torch.matmul``, so the two time
    alike things; with :func:`dot_step` it splits a T1 step into its
    product and its projections and finish."""
    m, k, n = _check_dot(lhs, rhs)
    core = _core_for(lhs.dtype, core)
    if lhs.device.type == "cpu":
        return dot_reference(lhs, rhs)
    out = _store(lhs, rhs, core, m, k, n, "dot_product")
    dot_product.launches += 1
    return out


dot_product.launches = 0


def probe_int8_dot(lhs: torch.Tensor, rhs: torch.Tensor,
                   core: str = "wgmma_s8") -> torch.Tensor:
    """T3a: int8 (M, K)·(K, N) → int32 (M, N), integer-exact. ``core``
    picks the tensor cores (``wgmma`` or ``mma.sync``) or ``__dp4a``."""
    m, k, n = _check_dot(lhs, rhs)
    if lhs.dtype != torch.int8:
        raise ValueError(f"probe_int8_dot takes int8 operands, got {lhs.dtype}")
    core = _core_for(lhs.dtype, core)
    if lhs.device.type == "cpu":
        return dot_reference(lhs, rhs)
    out = _store(lhs, rhs, core, m, k, n, "probe_int8_dot")
    probe_int8_dot.launches += 1
    return out


probe_int8_dot.launches = 0


# --------------------------------------------------------- the ingredients

def _check_f32(x: torch.Tensor, what: str) -> None:
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous float32, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"CUDA or CPU tensors, got {x.device}")


def probe_round_reference(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x), -127, 127)


def probe_round(x: torch.Tensor) -> torch.Tensor:
    """T3b: clip(round-half-even(x), −127, 127) of a float32 tensor: K6's
    requantizer (``k6_round_clip``)."""
    _check_f32(x, "x")
    if x.device.type == "cpu":
        return probe_round_reference(x)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = load_kernels().yolo_probe_round_clip(
            x.data_ptr(), out.data_ptr(), x.numel(), _stream(x))
    check_launch(rc, "probe_round_clip")
    probe_round.launches += 1
    return out


probe_round.launches = 0


def probe_roll_reference(x: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    return torch.stack([torch.roll(x32, 1, 1).to(torch.int8),
                        torch.roll(x32, -1, 1).to(torch.int8)])


def probe_roll(x: torch.Tensor) -> torch.Tensor:
    """T3c: int8 (P, R, L) → float32 → circular shift by +1 and by −1 along
    axis 1 → int8 (2, P, R, L). The card stages each (R, L) plane in shared
    memory, where K6 keeps the halo slab its column taps come from."""
    if x.dim() != 3 or x.dtype != torch.int8 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous int8 (P, R, L), got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.device.type == "cpu":
        return probe_roll_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"CUDA or CPU tensors, got {x.device}")
    p, r, lanes = x.shape
    if 4 * r * lanes > 227 * 1024:
        raise ValueError(f"a ({r}, {lanes}) float32 plane exceeds a block's "
                         f"shared memory")
    out = torch.empty((2, p, r, lanes), dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        rc = load_kernels().yolo_probe_roll(x.data_ptr(), out.data_ptr(), p,
                                            r, lanes, _stream(x))
    check_launch(rc, "probe_roll")
    probe_roll.launches += 1
    return out


probe_roll.launches = 0


def probe_mask_reference(th: int, ws: int, cp: int, h: int, w: int, hi: int,
                         device="cpu") -> torch.Tensor:
    rows1 = (th + 2) * ws
    flat = torch.arange(rows1, dtype=torch.int32, device=device)[:, None]
    gr = torch.div(flat, ws, rounding_mode="floor") + (hi * th - 1)
    gc = flat % ws
    valid = (gr >= 0) & (gr < h) & (gc < w)
    return valid.to(torch.int32).expand(rows1, cp).contiguous()


def probe_mask(th: int, ws: int, cp: int, h: int, w: int, hi: int,
               device=None) -> torch.Tensor:
    """T3d: the validity mask of row tile ``hi`` (``th`` rows and a one-row
    halo either side, slab width ``ws``) of an (h, w) image, from the flat
    row index: ``//``, ``%`` and three compares → int32 ((th+2)·ws, cp).
    K6's edge mask (``k6_slab_valid``). ``device=None`` is the card."""
    device = resolve_device(device)
    if device.type == "cpu":
        return probe_mask_reference(th, ws, cp, h, w, hi)
    rows1 = (th + 2) * ws
    out = torch.empty((rows1, cp), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        rc = load_kernels().yolo_probe_mask(
            out.data_ptr(), rows1, cp, ws, hi * th - 1, h, w,
            torch.cuda.current_stream(device).cuda_stream)
    check_launch(rc, "probe_mask")
    probe_mask.launches += 1
    return out


probe_mask.launches = 0


def probe_epilogue_reference(acc: torch.Tensor, deq: torch.Tensor,
                             b: torch.Tensor, inv: float) -> torch.Tensor:
    y = F.leaky_relu(acc.float() * deq + b, 0.1)
    return torch.clamp(torch.round(y * inv), -127, 127)


def probe_epilogue(acc: torch.Tensor, deq: torch.Tensor, b: torch.Tensor,
                   inv: float) -> torch.Tensor:
    """T3e: int32 (R, C) · deq (C,) + b (C,) → leaky 0.1 → round(y·inv) →
    clip, float32: K6's conv epilogue (``k6_dequant_leaky`` +
    ``k6_requant``), which must equal numpy float32 exactly (no FMA)."""
    if acc.dim() != 2 or acc.dtype != torch.int32 or not acc.is_contiguous():
        raise ValueError(f"acc must be contiguous int32 (R, C), got "
                         f"{tuple(acc.shape)} {acc.dtype}")
    for t, what in ((deq, "deq"), (b, "b")):
        _check_f32(t, what)
        if t.shape != (acc.shape[1],) or t.device != acc.device:
            raise ValueError(f"{what} must be ({acc.shape[1]},) on {acc.device}")
    if acc.device.type == "cpu":
        return probe_epilogue_reference(acc, deq, b, inv)
    if acc.device.type != "cuda":
        raise ValueError(f"CUDA or CPU tensors, got {acc.device}")
    out = torch.empty(acc.shape, dtype=torch.float32, device=acc.device)
    with torch.cuda.device(acc.device):
        rc = load_kernels().yolo_probe_epilogue(
            acc.data_ptr(), deq.data_ptr(), b.data_ptr(), float(inv),
            out.data_ptr(), acc.shape[0], acc.shape[1], _stream(acc))
    check_launch(rc, "probe_epilogue")
    probe_epilogue.launches += 1
    return out


probe_epilogue.launches = 0
