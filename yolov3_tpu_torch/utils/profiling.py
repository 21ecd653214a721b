"""Per-stage timing + rolling FPS (reference's ``--show-fps`` overlay,
SURVEY.md §5.1, upgraded with structured stage timers), and the spans that
name each host stage of a call.

A :class:`span` times one stage on the host clock and adds its seconds to
the caller's stage dict. While a ``torch.profiler`` profile runs (the CLI's
``--profile DIR``, a traced benchmark run) tracing is on, and each span
also opens a ``record_function`` range named ``yolov3.<name>``, so the
stage lies in the profiler's trace on its own clock, and appends a
:class:`Span` to :data:`RECORD`, the process's record of the spans traced.
With no profile running a span costs two clock reads and a dict write: the
gate is the profiler's own switch, since a ``record_function`` range costs
about eight times a span that is off even with no profile running."""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, NamedTuple, Optional

import torch

PREFIX = "yolov3."
# True exactly while a torch.profiler profile is running
tracing = torch._C._autograd._profiler_enabled


class Span(NamedTuple):
    """One traced stage: host clock seconds (``time.perf_counter``), the
    name of the span open around it on its thread (None at the top), the id
    of the call it belongs to, and a tag (a replica's index)."""

    name: str
    start: float
    end: float
    parent: Optional[str]
    call: Optional[int]
    tag: Optional[int] = None


# the spans traced in this process, in the order they ended (the oldest go
# once a million are held)
RECORD: "deque[Span]" = deque(maxlen=1 << 20)
_calls = itertools.count(1)
_open = threading.local()  # .stack: (name, call) of the spans open on a thread


def new_call() -> int:
    """A fresh call id: the spans of one call share it."""
    return next(_calls)


class span:
    """``with span(name, stages, call, tag):`` times the block. ``stages``
    (a dict) gets the seconds added under ``name``; ``seconds`` holds them
    after the block. While tracing, the block is also the profiler range
    ``yolov3.<name>`` and a :class:`Span` in :data:`RECORD`, whose call is
    ``call`` or, where that is None, the call of the span open around it."""

    __slots__ = ("name", "stages", "call", "tag", "start", "seconds", "_range",
                 "_parent")

    def __init__(self, name: str, stages: Optional[Dict[str, float]] = None,
                 call: Optional[int] = None, tag: Optional[int] = None):
        self.name, self.stages, self.call, self.tag = name, stages, call, tag
        self.seconds = 0.0

    def __enter__(self) -> "span":
        self._range = None
        if tracing():
            stack = getattr(_open, "stack", None)
            if stack is None:
                stack = _open.stack = []
            self._parent = stack[-1] if stack else (None, None)
            if self.call is None:
                self.call = self._parent[1]
            stack.append((self.name, self.call))
            self._range = torch.profiler.record_function(PREFIX + self.name)
            self._range.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        end = time.perf_counter()
        self.seconds = end - self.start
        if self.stages is not None:
            self.stages[self.name] = self.stages.get(self.name, 0.0) + self.seconds
        if self._range is not None:
            self._range.__exit__(*exc)
            _open.stack.pop()
            RECORD.append(Span(self.name, self.start, end, self._parent[0],
                               self.call, self.tag))


class FPSCounter:
    """Rolling-window frames/sec."""

    def __init__(self, window: int = 30):
        self._ticks = deque(maxlen=window)

    def tick(self):
        self._ticks.append(time.perf_counter())

    def fps(self) -> float:
        if len(self._ticks) < 2:
            return 0.0
        span = self._ticks[-1] - self._ticks[0]
        return (len(self._ticks) - 1) / span if span > 0 else 0.0

    def overlay(self, frame):
        import cv2

        cv2.putText(frame, f"{self.fps():.1f} FPS", (8, 24),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.8, (0, 255, 0), 2, cv2.LINE_AA)
        return frame


class StageTimers:
    """Accumulating named stage timers (preproc/forward/nms/draw…)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def stage(self, name: str) -> span:
        self.counts[name] = self.counts.get(name, 0) + 1
        return span(name, self.totals)

    def summary(self) -> Dict[str, float]:
        return {name: self.totals[name] / max(self.counts[name], 1)
                for name in self.totals}

    def report(self) -> str:
        return " | ".join(f"{k}: {v * 1e3:.2f} ms" for k, v in self.summary().items())
