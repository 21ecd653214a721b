"""On-card bisection probe for the fused int8 residual-block kernel (K6).

Port of the JAX package's ``tools/probe_block.py``. K6's contract is that it
equals the unfused int8-carrier walk exactly; this tool isolates each
ingredient that contract rests on, ON THE CARD, against an exact host value:

  1. the int8 x int8 -> int32 dot (tensor cores by ``wgmma`` and by
     ``mma.sync``, and ``__dp4a``): exact?
  2. round / clip (the requantizer): half to even, as ``rintf``?
  3. the +1 / -1 row shifts through shared memory: value-exact?
  4. the ``//``, ``%`` edge-mask arithmetic: correct rows and columns?
  5. the float epilogue (multiply, add, leaky, requantize): equal to numpy
     float32, i.e. no fused multiply-add?
  6. full blocks (one tile through several images) against the plain version;
  7. fused against unfused CHAIN prefixes (k = 1, 3, 10 blocks) through the
     real int8-carrier walk at yolov3@320.

Probes 2, 4 and 5 run the ``__device__`` functions K6 itself runs
(``csrc/block_int8_common.cuh``). Expected on the card: 0 differences
everywhere (eager PyTorch has no cross-program contraction, and the library
builds with ``-fmad=false``).

Run on a machine with the card: ``python -m yolov3_tpu_torch.tools.probe_block``.
Every probe prints one line and returns its count of differing elements;
``main`` exits non-zero if any is not 0.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..ops import cuda_probe
from ..weights import resolve_device

REPO = Path(__file__).resolve().parents[2]
# the JAX tool's four shapes, then the shapes K6 runs (M = the 64 or 100
# pixels of a tile, K = C and 9 Cmid at C 128 / 256)
INT8_DOT_SHAPES = ((256, 128, 128), (2432, 576, 128), (880, 256, 128),
                   (480, 1152, 128),
                   (100, 128, 64), (64, 576, 128), (100, 256, 128),
                   (64, 1152, 256))
FULL_BLOCK_CASES = ((1, 8, 8), (1, 40, 40), (3, 40, 40), (2, 19, 19))
CHAIN_PREFIXES = (1, 3, 10)


def _say(msg: str) -> None:
    print(msg, flush=True)


def probe_int8_dot(device=None) -> int:
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    bad = 0
    for m, k, n in INT8_DOT_SHAPES:
        lhs = rng.integers(-127, 128, (m, k)).astype(np.int8)
        rhs = rng.integers(-127, 128, (k, n)).astype(np.int8)
        ref = lhs.astype(np.int64) @ rhs.astype(np.int64)
        for core in ("wgmma_s8", "mma_s8", "dp4a_s8"):
            out = cuda_probe.probe_int8_dot(torch.from_numpy(lhs).to(device),
                                            torch.from_numpy(rhs).to(device),
                                            core=core)
            d = np.abs(out.cpu().numpy().astype(np.int64) - ref)
            bad += int((d > 0).sum())
            _say(f"int8 dot ({core}) M={m} K={k} N={n}: maxdiff {d.max()} "
                 f"ndiff {(d > 0).sum()}/{d.size}")
    return bad


def round_inputs() -> np.ndarray:
    """Values straddling halves, negatives, large magnitudes: (8, 144)."""
    vals = np.concatenate([
        np.arange(-8, 8) + 0.5, np.arange(-8, 8) + 0.49999997,
        np.arange(-8, 8) + 0.50000003,
        np.linspace(-200, 200, 96).astype(np.float32)]).astype(np.float32)
    return np.tile(vals, (8, 1))


def probe_round(device=None) -> int:
    device = resolve_device(device)
    x = round_inputs()
    out = cuda_probe.probe_round(torch.from_numpy(x).to(device)).cpu().numpy()
    ref = np.clip(np.round(x), -127, 127)  # numpy: half to even
    d = np.abs(out - ref)
    first = [float(x[0, i]) for i in np.argwhere(d[0] > 0).ravel()[:6]]
    _say(f"round/clip: ndiff {(d > 0).sum()}/{d.size}; first bad inputs {first}")
    return int((d > 0).sum())


def probe_roll(device=None) -> int:
    device = resolve_device(device)
    x = np.random.default_rng(1).integers(-127, 128, (10, 48, 128)).astype(np.int8)
    out = cuda_probe.probe_roll(torch.from_numpy(x).to(device)).cpu().numpy()
    n0 = int((out[0] != np.roll(x, 1, axis=1)).sum())
    n1 = int((out[1] != np.roll(x, -1, axis=1)).sum())
    _say(f"roll +1: ndiff {n0}, roll -1: ndiff {n1}")
    return n0 + n1


def mask_reference(th: int, ws: int, cp: int, h: int, w: int, hi: int
                   ) -> np.ndarray:
    rows1 = (th + 2) * ws
    flat = np.arange(rows1)[:, None]
    gr = flat // ws + (hi * th - 1)
    gc = flat % ws
    ref = ((gr >= 0) & (gr < h) & (gc < w)).astype(np.int32)
    return np.broadcast_to(ref, (rows1, cp))


def probe_mask(device=None) -> int:
    """The edge mask of row tiles 0, 3 and 6, all three in one launch."""
    device = resolve_device(device)
    th, ws, cp, h, w = 6, 48, 128, 40, 40
    his = (0, 3, 6)
    out = cuda_probe.probe_masks(th, ws, cp, h, w, his, device=device)
    bad = 0
    for hi, got in zip(his, out.cpu().numpy()):
        ref = mask_reference(th, ws, cp, h, w, hi)
        nd = int((got != ref).sum())
        bad += nd
        _say(f"mask hi={hi}: ndiff {nd}/{ref.size}")
    return bad


def epilogue_inputs():
    """(acc int32 (256, 128), deq (128,), b (128,), inv) of the JAX tool."""
    rng = np.random.default_rng(2)
    acc = rng.integers(-2_000_000, 2_000_000, (256, 128)).astype(np.int32)
    deq = rng.uniform(1e-6, 1e-4, (1, 128)).astype(np.float32)[0]
    b = rng.normal(0, 0.05, (1, 128)).astype(np.float32)[0]
    return acc, deq, b, 1.0 / 0.017


def epilogue_reference(acc, deq, b, inv) -> np.ndarray:
    """The f32 multiply-add-leaky-quantize chain in numpy float32."""
    y = acc.astype(np.float32) * deq[None] + b[None]
    y = np.where(y > 0, y, np.float32(0.1) * y)
    return np.clip(np.round(y * np.float32(inv)), -127, 127)


def probe_epilogue(device=None) -> int:
    device = resolve_device(device)
    acc, deq, b, inv = epilogue_inputs()
    out = cuda_probe.probe_epilogue(*(torch.from_numpy(a).to(device)
                                      for a in (acc, deq, b)), inv)
    d = np.abs(out.cpu().numpy() - epilogue_reference(acc, deq, b, inv))
    _say(f"epilogue chain: ndiff {(d > 0).sum()}/{d.size} max {d.max()}")
    return int((d > 0).sum())


def probe_full_tiny(B: int = 1, H: int = 8, W: int = 8, device=None) -> int:
    """K6 against its plain version (which the CPU tests hold to the unfused
    walk). The default is a single tile; larger B / H run many thread blocks
    and the image-edge tiles."""
    from ..ops.cuda_block import (prepare_block_params, residual_block_int8,
                                  residual_block_int8_reference)

    device = resolve_device(device)
    rng = np.random.default_rng(3)
    cin, cmid = 128, 64

    def t(a, dtype):
        return torch.from_numpy(np.asarray(a).astype(dtype)).to(device)

    xq = t(rng.integers(-127, 128, (B, H, W, cin)), np.int8)
    qp1 = {"wq": t(rng.integers(-20, 21, (1, 1, cin, cmid)), np.int8),
           "sw": t(rng.uniform(1e-3, 1e-2, (cmid,)), np.float32),
           "b": t(rng.normal(0, 0.05, (cmid,)), np.float32)}
    qp2 = {"wq": t(rng.integers(-20, 21, (3, 3, cmid, cin)), np.int8),
           "sw": t(rng.uniform(1e-3, 1e-2, (cin,)), np.float32),
           "b": t(rng.normal(0, 0.05, (cin,)), np.float32)}
    s = dict(s_in=0.0123, s_mid=0.0145, s_mid2=0.0171, s_out=0.0162)
    bp = prepare_block_params(qp1, qp2, s["s_in"], s["s_mid"])
    chip = residual_block_int8(xq, bp, emit_q=True, **s)
    host = residual_block_int8_reference(xq, bp, emit_q=True, **s)
    c = chip.cpu().numpy().astype(np.int32)
    r = host.cpu().numpy().astype(np.int32)
    d = np.abs(c - r)
    _say(f"full block B={B} H={H} W={W}: ndiff {(d > 0).sum()}/{d.size} "
         f"max {d.max()}")
    if (d > 0).sum():
        _say("  sample diffs (b,h,w,c chip ref):")
        for i in np.argwhere(d > 0)[:8]:
            _say(f"    {i} {c[tuple(i)]} {r[tuple(i)]}")
    return int((d > 0).sum())


def probe_chain(device=None, net_size: int = 320, cfg: Optional[Path] = None,
                prefixes=CHAIN_PREFIXES) -> int:
    """Fused against unfused chain prefixes through the real int8-carrier
    walk at yolov3@320, random weights of seed 5. Returns the number of
    differing elements over all prefixes."""
    from ..graph import load_graph
    from ..ops.cuda_block import fused_block_plan
    from ..quant import (calibrate_tensors, forward_features_int8_carrier,
                         quantize_weights)
    from ..weights import fold_raw, params_from_jax, random_raw

    device = resolve_device(device)
    g = load_graph(cfg or REPO / "models" / "yolov3.cfg")
    params = params_from_jax(fold_raw(random_raw(g, seed=5)), device)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(0, 1, (2, net_size, net_size, 3))
                         .astype(np.float32)).to(device)
    bad = 0
    with torch.inference_mode():
        scales = calibrate_tensors(g, params, [x], precision="bf16")
        qparams = quantize_weights(g, params)
        ends = sorted(fused_block_plan(g, qparams, scales))
        for k in prefixes:
            last = ends[k - 1] + 3
            a, b = (forward_features_int8_carrier(
                g, qparams, scales, x, "bf16", upto=last,
                block_impl=impl)[-1].float() for impl in ("xla", "pallas"))
            d = (a - b).abs()
            nd = int((d > 0).sum())
            bad += nd
            m = float(d.max())
            _say(f"chain k={k}: frac {nd / d.numel():.5f} max {m:.4g} "
                 f"steps {m / scales[last - 1]:.1f}")
    return bad


def main() -> int:
    device = resolve_device(None)  # raises without a card
    _say(f"device: {torch.cuda.get_device_name(device)}")
    bad = (probe_int8_dot(device) + probe_round(device) + probe_roll(device)
           + probe_mask(device) + probe_epilogue(device))
    for case in FULL_BLOCK_CASES:
        bad += probe_full_tiny(*case, device=device)
    bad += probe_chain(device)
    _say(f"total differing elements: {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
