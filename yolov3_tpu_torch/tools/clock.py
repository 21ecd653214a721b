"""Device clocks shared by the tools and ``chip_smoke.py``: CUDA events
around back-to-back work on the current stream, the same work captured
into a CUDA graph and replayed (device time alone, without the host's time
per call), and the two-size differential that cancels what a call costs
whatever its size (launch, the events themselves)."""
from __future__ import annotations

from typing import Callable, Sequence

import torch

# the card's published dense peaks (NVIDIA H100 SXM data sheet)
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12


def event_ms(fn: Callable[[], object], iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn: Callable[[], object], iters: int = 20, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn``: ``iters`` calls captured into one
    CUDA graph and replayed, so the host's time per call (about 25 us for a
    ctypes wrapper) does not count."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def differential_s(run: Callable[[int], object], sizes: Sequence[int],
                   reps: int = 3) -> float:
    """Seconds per unit of size: ``run(size)`` enqueues ``size`` units of
    work; the best of ``reps`` timings at each of the two sizes, differenced."""
    best = []
    for size in sizes:
        run(size)  # warm-up at this size
        best.append(min(event_ms(lambda: run(size), iters=1, warmup=0)
                        for _ in range(reps)))
    (s1, s2), (t1, t2) = sizes, best
    return (t2 - t1) * 1e-3 / (s2 - s1)
