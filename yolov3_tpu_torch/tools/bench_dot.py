"""Microbenchmark: what a bf16 tensor-core dot costs against its (M, K, N)
shape, and what off-size M and K waste.

Port of the JAX package's ``tools/bench_pallas_dot.py``, the input of the
fused conv's (K5) redesign: K5 is a product with M = 128 pixels of a tile,
K = 9 Cin and N = 128 output channels, and the question is how far below the
matrix unit's rate a dot falls when M or K are small or off the unit's size.

Clock: grid-differential. One launch runs ``grid`` steps (on the card:
``grid`` independent thread blocks, each one whole product with every
element consumed by two small projections); two grid sizes are timed with
CUDA events and differenced, so the launch cancels and the figure is the
time the whole card needs per product. ``torch.matmul`` at the same shape is
printed as the library's time for one bare product; the port does not call
it. A share of the card's peak above 100% fails.

The kernel runs every product on ``wgmma`` (``ops.cuda_probe.dot_grid``),
which takes 64 rows, N in its tile (``plan_grid_tiles``) and K in steps of
16: an M of 32 or a K of 72 is padded with zeros the tensor cores multiply
all the same. ``issued_share`` is the useful share of what they ran
(``grid_issued``), the waste the question is about.

Run on a machine with the card: ``python -m yolov3_tpu_torch.tools.bench_dot``.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..ops import cuda_probe
from ..weights import resolve_device
from .bench_int8_dot import DOT_ATOL, DOT_RTOL
from .clock import BF16_FLOPS_PER_S, differential_s, event_ms

# (M, K, N): the JAX tool's list, then K5's own products at yolov3's
# eligible layers (M = 128, K = 9 Cin, N = 128)
SHAPES = (
    (128, 128, 2944), (32, 128, 2944), (32, 72, 2944), (64, 384, 2560),
    (128, 384, 2560), (64, 288, 2560), (256, 384, 2560), (128, 768, 1280),
    (128, 288, 128),    # K5 at Cin = 32
    (128, 576, 128),    # K5 at Cin = 64
    (128, 1152, 128),   # K5 at Cin = 128
    (128, 2304, 128),   # K5 at Cin = 256
)
GRIDS = (4096, 16384)


def check_shape(args) -> float:
    """T2 against its plain version on ``args`` (lhs, rhs, p1, p2): raises
    past the bar, returns the largest absolute difference."""
    got = cuda_probe.dot_grid(*args, 3).float()
    want = cuda_probe.dot_grid_reference(*args, 3).float()
    err = float((got - want).abs().max())
    bar = 2 * DOT_RTOL * float(want.abs().max()) + DOT_ATOL  # + the bf16 store
    if not err <= bar or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{tuple(args[0].shape)} x {tuple(args[1].shape)}"
                             f": max |err| {err} against the plain version "
                             f"(bar {bar})")
    return err


def time_shape(args, grids: Sequence[int] = GRIDS) -> Dict[str, float]:
    """Seconds the card needs per product of T2 on ``args``, differenced
    over two grid sizes; fails on a share of the peak above 100%."""
    (m, k), n = args[0].shape, args[1].shape[1]
    per = differential_s(lambda g: cuda_probe.dot_grid(*args, g), grids)
    useful = 2 * m * k * n
    mp, kp, np_ = cuda_probe.grid_issued(m, k, n)
    share = useful / per / BF16_FLOPS_PER_S
    if share > 1.0:
        raise AssertionError(
            f"M={m} K={k} N={n}: {useful / per / 1e12:.1f} TFLOP/s is "
            f"{share:.0%} of the card's peak: the harness is measuring "
            f"something else than the dot")
    return {"us": per * 1e6, "tops": useful / per / 1e12, "share": share,
            "issued_share": useful / (2 * mp * kp * np_)}


def main(shapes: Sequence[Tuple[int, int, int]] = SHAPES) -> int:
    device = resolve_device(None)  # raises without a card
    print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    rng = np.random.default_rng(0)
    for m, k, n in shapes:
        args = cuda_probe.dot_operands(m, k, n, torch.bfloat16, rng,
                                       device)[1:]
        check_shape(args)
        r = time_shape(args)
        r["library_ms"] = event_ms(lambda: torch.matmul(args[0], args[1]))
        print(f"M={m:4d} K={k:4d} N={n}: {r['us']:7.2f} us/step "
              f"({r['tops']:6.1f} TFLOP/s useful, {r['share']:.1%} of peak, "
              f"{r['issued_share']:.1%} of the issued products useful; "
              f"library {r['library_ms'] * 1e3:.2f} us)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
