"""Microbenchmark: int8 dot throughput at the residual block's shapes, on the
tensor cores (``wgmma`` and ``mma.sync``) against the integer lanes
(``__dp4a``), with the same-shape bf16 dot on ``wgmma`` beside them.

Port of the JAX package's ``tools/bench_int8_dot.py``. It measured the
decision behind the fused residual block's redesign (K6 moved its two
products from ``__dp4a`` to ``wgmma`` s8) and keeps measuring the tile
products K6 is made of: M = the 64 or 100 pixels of a tile, K = C or
9 Cmid.

Clock: ``steps`` dependent launches inside one call (the carry of step s
shifts the small operand of step s + 1, so no step repeats another's work),
timed with CUDA events at two step counts and differenced, so what a call
costs whatever its length cancels. Every element of every product is consumed
(``ops/cuda_probe.py``). A share of the card's peak above 100% means the
harness is wrong, and ``main`` fails on it. ``torch._int_mm`` / ``torch.matmul``
at the same shape is printed as the library's time for the bare product (no
projections, no dependency); the port calls neither. ``step_floor_us`` reads
what a step costs with next to no product in it: shapes whose time is near
that floor measure the launch and the finish, not a core.

Run on a machine with the card: ``python -m yolov3_tpu_torch.tools.bench_int8_dot``.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..ops import cuda_probe
from ..weights import resolve_device
from .clock import differential_s, event_ms
from .traffic_model import BF16_FLOPS_PER_S, INT8_OPS_PER_S

# (M, K, N): the JAX tool's candidate formulations of the fused block on the
# TPU (152- and 304-grid), then the products of the port's own K6 tiles
SHAPES = (
    (2432, 192, 128), (2432, 576, 128), (2736, 128, 64), (2736, 128, 128),
    (1368, 256, 128), (1216, 384, 256), (1280, 384, 128), (1280, 768, 128),
    (2432, 128, 128), (2048, 512, 512),
    (100, 128, 64),     # K6 1x1 at C=128: a 10x10 halo tile
    (64, 576, 128),     # K6 3x3 at C=128: an 8x8 tile, K = 9 * 64
    (100, 256, 128),    # K6 1x1 at C=256
    (64, 1152, 256),    # K6 3x3 at C=256, K = 9 * 128
)
VARIANTS = (("int8 wgmma", torch.int8, "wgmma_s8", INT8_OPS_PER_S),
            ("int8 mma.sync", torch.int8, "mma_s8", INT8_OPS_PER_S),
            ("int8 __dp4a", torch.int8, "dp4a_s8", INT8_OPS_PER_S),
            ("bf16 wgmma", torch.bfloat16, "wgmma_bf16", BF16_FLOPS_PER_S))
LENS = (128, 1024)


def library_ms(lhs: torch.Tensor, rhs: torch.Tensor) -> float:
    """One PyTorch call for the bare product at this shape."""
    if lhs.dtype == torch.int8:
        return event_ms(lambda: torch._int_mm(lhs, rhs))
    return event_ms(lambda: torch.matmul(lhs, rhs))


# out = bf16(p1 . bf16(acc)) . p2: the kernel sums in another order than the
# plain matmuls, which can move each bf16 rounding of the projections by one
# ulp (2^-8 relative each, two roundings); relative to the largest output,
# plus a float32 floor
DOT_RTOL, DOT_ATOL = 2.0 ** -7, 1e-9


def check_shape(args, core: str) -> float:
    """T1 against its plain version on ``args`` (``dot_operands``): raises
    past the bar, returns the largest absolute difference."""
    got = cuda_probe.dot_step(*args, core=core)
    want = cuda_probe.dot_step_reference(*args)
    err = float((got - want).abs().max())
    bar = DOT_RTOL * float(want.abs().max()) + DOT_ATOL
    if not err <= bar or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{core} {tuple(args[1].shape)} x "
                             f"{tuple(args[2].shape)}: max |err| {err} "
                             f"against the plain version (bar {bar})")
    return err


def time_shape(args, core: str, peak: float, lens: Sequence[int] = LENS
               ) -> Dict[str, float]:
    """Seconds per dependent step of T1 on ``args``, differenced over two
    step counts; fails on a share of ``peak`` above 100%."""
    (m, k), n = args[1].shape, args[2].shape[1]
    per = differential_s(lambda steps: cuda_probe.dot_step(
        *args, core=core, steps=steps), lens)
    useful = 2 * m * k * n
    share = useful / per / peak
    if share > 1.0:
        raise AssertionError(
            f"{core} M={m} K={k} N={n}: {useful / per / 1e12:.1f} T/s is "
            f"{share:.0%} of the card's peak: the harness is measuring "
            f"something else than the dot")
    return {"us": per * 1e6, "tops": useful / per / 1e12, "share": share}


FLOOR_SHAPE = (8, 16, 8)   # the least product the kernels take: one tile


def step_floor_us(device=None, lens: Sequence[int] = LENS) -> float:
    """The clock's floor in microseconds: a dependent step of T1 on a product
    of ``FLOOR_SHAPE`` (the launch, the projections and their two-stage
    finish by the last block to arrive, with next to no product)."""
    device = resolve_device(device)
    args = cuda_probe.dot_operands(*FLOOR_SHAPE, torch.int8,
                                   np.random.default_rng(0), device)
    return differential_s(lambda steps: cuda_probe.dot_step(
        *args, core="mma_s8", steps=steps), lens) * 1e6


def main(shapes: Sequence[Tuple[int, int, int]] = SHAPES) -> int:
    device = resolve_device(None)  # raises without a card
    print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    rng = np.random.default_rng(0)
    floor = step_floor_us(device)
    print(f"floor at M, K, N = {FLOOR_SHAPE}: {floor:.2f} us per dependent "
          f"step", flush=True)
    for name, dtype, core, peak in VARIANTS:
        for m, k, n in shapes:
            args = cuda_probe.dot_operands(m, k, n, dtype, rng, device)
            check_shape(args, core)
            r = time_shape(args, core, peak)
            r["library_ms"] = library_ms(args[1], args[2])
            print(f"{name} M={m:4d} K={k:4d} N={n:3d}: {r['us']:7.2f} us/step "
                  f"({r['tops']:6.1f} T{'OP' if dtype == torch.int8 else 'FLOP'}"
                  f"/s useful, {r['share']:.1%} of peak; library "
                  f"{r['library_ms'] * 1e3:.2f} us)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
