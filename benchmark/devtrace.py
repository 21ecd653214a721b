"""The device trace of a ``--trace 1`` run, reduced to what the per-layer
readers and the result line need.

``torch.profiler`` (CUPTI) records every kernel, copy and fill on each card,
also inside a CUDA graph replay, and the host's operations; the harness
marks the traced window with a ``record_function`` range named
:data:`WINDOW`. Everything here is clipped to that range.
"""
from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

WINDOW = "benchmark.window"
TOP = 10
SCAN = 400  # host ranges looked back through to name a gap


@dataclass
class Trace:
    window_s: float
    busy_s: Dict[int, float]              # per card index
    kernel_s: Dict[str, float]            # device seconds by op name, all cards
    idle_gaps: List[Tuple[str, float]]    # idle seconds by what the host ran

    @property
    def mean_busy_s(self) -> float:
        return float(np.mean(list(self.busy_s.values()))) if self.busy_s else 0.0

    def time_matching(self, patterns: Sequence[str],
                      exclude: Sequence[str] = ()) -> float:
        """Device seconds of the ops whose names match any of ``patterns``
        (regular expressions, searched) and none of ``exclude``."""
        inc = [re.compile(p) for p in patterns]
        exc = [re.compile(p) for p in exclude]
        return sum(t for name, t in self.kernel_s.items()
                   if any(p.search(name) for p in inc)
                   and not any(p.search(name) for p in exc))

    def breakdown(self) -> dict:
        top = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n, t] for n, t in top],
                "idle_gaps": [[n, t] for n, t in self.idle_gaps[:TOP]]}


def _merge(iv: np.ndarray) -> np.ndarray:
    """Union of (start, end) intervals, sorted and disjoint."""
    if len(iv) == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0])]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out)


def reduce(prof, devices: Sequence[int]) -> Trace:
    """Reduce a stopped ``torch.profiler.profile`` to a :class:`Trace` over
    the cards ``devices``."""
    events = prof.profiler.kineto_results.events()
    cpu, dev = [], defaultdict(list)
    window = None
    for e in events:
        kind = str(e.device_type())
        start, dur = e.start_ns(), e.duration_ns()
        if kind.endswith("CUDA"):
            # the host's ranges are mirrored on the device's timeline
            if e.is_user_annotation() or e.name().startswith("benchmark."):
                continue
            dev[e.device_index()].append((e.name(), start, start + dur))
        elif kind.endswith("CPU"):
            if e.name() == WINDOW:
                window = (start, start + dur, e.start_thread_id())
            else:
                cpu.append((e.name(), start, start + dur, e.start_thread_id()))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    w0, w1, thread = window
    busy: Dict[int, float] = {}
    kernel_s: Dict[str, float] = defaultdict(float)
    merged0 = None
    for d in devices:
        clipped = [(n, max(s, w0), min(e, w1)) for n, s, e in dev.get(d, [])
                   if e > w0 and s < w1]
        for n, s, e in clipped:
            kernel_s[n] += (e - s) * 1e-9
        iv = _merge(np.asarray([(s, e) for _, s, e in clipped], dtype=np.float64))
        busy[d] = float((iv[:, 1] - iv[:, 0]).sum() * 1e-9) if len(iv) else 0.0
        if merged0 is None:
            merged0 = iv
    gaps = _label_gaps(merged0, w0, w1, [c for c in cpu if c[3] == thread])
    return Trace((w1 - w0) * 1e-9, busy, dict(kernel_s), gaps)


def _label_gaps(busy: np.ndarray, w0: int, w1: int, cpu) -> List[Tuple[str, float]]:
    """Idle stretches of the first card, each named by the innermost host
    operation of the harness's thread at its middle, summed by name,
    longest first."""
    edges = np.concatenate([[w0], busy.ravel() if busy is not None else [], [w1]])
    starts, ends = edges[0::2], edges[1::2]
    cpu = sorted(cpu, key=lambda c: c[1])
    cstart = np.asarray([c[1] for c in cpu], dtype=np.float64)
    out: Dict[str, float] = defaultdict(float)
    for s, e in zip(starts, ends):
        if e <= s:
            continue
        mid = 0.5 * (s + e)
        label = "host: outside any operation"
        last = int(np.searchsorted(cstart, mid, side="right")) - 1
        for k in range(last, max(last - SCAN, -1), -1):
            name, cs, ce, _ = cpu[k]
            if ce >= mid:  # the latest-starting range that encloses it
                label = name
                break
        out[label] += (e - s) * 1e-9
    return sorted(out.items(), key=lambda kv: -kv[1])
