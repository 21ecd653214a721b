"""T3b and T3e, the probes of K6's requantizer and conv epilogue, timed by
CUDA graph replay at the tool's inputs and at K6's own epilogue size.

At the tool's inputs ((8, 144) floats; an int32 (256, 128) sum) both kernels
take about as long as a launch, so the launch floor stands beside them: one
float's ``zero_()``, PyTorch's fill kernel, a launch with next to no work
that no change to the port's kernels moves. K6 runs the same ``__device__``
functions on the sums of yolov3@416 B=8's first residual stage, 8 x 104 x
104 x 128 = 11,075,584 elements: 44.3 MB read and 44.3 MB written, over the
card's 50 MB L2, so bound by the device memory's rate. There
``dst.copy_(src)`` of the same 44.3 MB reads and writes the same bytes: the
rate the card reaches.

Every kernel is checked against its plain version on the same inputs before
it is timed; each time is :func:`replay_ms`, the statistic ``chip_smoke.py``
gives every T3 probe: the least of :data:`REPS` replays of a graph of
:data:`ITERS` calls (a single replay at these sizes moves by a microsecond
from one process to the next). ``python -m
yolov3_tpu_torch.tools.bench_requant`` prints the times, then one JSON line
of them; it needs the card. To compare two commits, run it from the root of
a ``git archive`` of each, in turns.
"""
from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np
import torch

from yolov3_tpu_torch.ops import cuda_probe
from yolov3_tpu_torch.tools import probe_block
from yolov3_tpu_torch.tools.clock import graph_ms

# K6's epilogue at yolov3@416 B=8: the 104 x 104 x 128 residual stage
K6_ROWS, K6_COLS = 8 * 104 * 104, 128
K6_ELEMENTS = K6_ROWS * K6_COLS
ITERS, REPS = 20, 5


def k6_round_input(seed: int = 18) -> np.ndarray:
    """K6's size of float32 values around its quantized levels: normal with
    a spread of 100 (a sixth past +-127), every third an exact half (a tie)."""
    x = np.random.default_rng(seed).normal(0, 100, K6_ELEMENTS)
    x[::3] = np.round(x[::3] * 2) / 2
    return x.astype(np.float32)


def k6_epilogue_inputs(seed: int = 18):
    """(acc int32 (86,528, 128), deq (128,), b (128,), inv): the tool's
    ranges at K6's size."""
    rng = np.random.default_rng(seed)
    acc = rng.integers(-2_000_000, 2_000_000, (K6_ROWS, K6_COLS)).astype(np.int32)
    deq = rng.uniform(1e-6, 1e-4, K6_COLS).astype(np.float32)
    b = rng.normal(0, 0.05, K6_COLS).astype(np.float32)
    return acc, deq, b, 1.0 / 0.017


def replay_ms(fn) -> float:
    """Device milliseconds a call of ``fn``: the least of :data:`REPS`
    replays of ``fn`` :data:`ITERS` times captured into one CUDA graph."""
    return graph_ms(fn, ITERS, reps=REPS)


def _checked_us(kernel, want: torch.Tensor, what: str) -> float:
    """``kernel()`` against ``want`` (0 differing elements), then its device
    microseconds by :func:`replay_ms`."""
    got = kernel()
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: {int((got != want).sum())} elements "
                             f"differ from the plain version")
    return replay_ms(kernel) * 1e3


def k6_cases(device) -> Dict[str, object]:
    """K6-sized inputs on ``device`` with their plain versions' outputs: T3b's
    ``x`` / ``want_round``, T3e's ``acc``, ``deq``, ``b``, ``inv`` /
    ``want_epilogue``."""
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    x = to(k6_round_input())
    acc, deq, b, inv = k6_epilogue_inputs()
    acc, deq, b = map(to, (acc, deq, b))
    return dict(x=x, want_round=cuda_probe.probe_round_reference(x), acc=acc,
                deq=deq, b=b, inv=inv,
                want_epilogue=cuda_probe.probe_epilogue_reference(
                    acc, deq, b, inv))


def measure(device=None, k6: Optional[Dict[str, object]] = None
            ) -> Dict[str, float]:
    """Microseconds by graph replay: T3b and T3e at the tool's inputs, the
    launch floor, then both at K6's size beside ``copy_`` of the same bytes.
    ``k6``: :func:`k6_cases` already on the card (built here when None)."""
    device = torch.device(device or "cuda")
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    cp = cuda_probe
    x = to(probe_block.round_inputs())
    acc, deq, b, inv = probe_block.epilogue_inputs()
    acc, deq, b = map(to, (acc, deq, b))
    one = torch.ones(1, device=device)
    k = k6 or k6_cases(device)
    dst = torch.empty_like(k["x"])
    return {
        "t3b_tool_us": _checked_us(lambda: cp.probe_round(x),
                                   cp.probe_round_reference(x), "T3b"),
        "t3e_tool_us": _checked_us(
            lambda: cp.probe_epilogue(acc, deq, b, inv),
            cp.probe_epilogue_reference(acc, deq, b, inv), "T3e"),
        "floor_us": _checked_us(lambda: one.zero_(), torch.zeros_like(one),
                                "the launch floor"),
        "t3b_k6_us": _checked_us(lambda: cp.probe_round(k["x"]),
                                 k["want_round"], "T3b at K6's size"),
        "t3e_k6_us": _checked_us(
            lambda: cp.probe_epilogue(k["acc"], k["deq"], k["b"], k["inv"]),
            k["want_epilogue"], "T3e at K6's size"),
        "copy_k6_us": _checked_us(lambda: dst.copy_(k["x"]), k["x"], "copy_"),
        "k6_bytes": 8 * K6_ELEMENTS,
    }


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("bench_requant times the kernels on a cuda device; "
                           "none is available")
    t = measure()
    print(f"{torch.cuda.get_device_name(0)}: " + ", ".join(
        f"{k} {v:.3f}" for k, v in t.items() if k.endswith("_us")))
    print(json.dumps(t))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
