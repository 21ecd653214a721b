"""Per-stage timing + rolling FPS (reference's ``--show-fps`` overlay,
SURVEY.md §5.1, upgraded with structured stage timers; pair with
``torch.profiler`` for device-side traces)."""
from __future__ import annotations

import time
from collections import deque
from contextlib import contextmanager
from typing import Dict


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

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, float]:
        return {name: self.totals[name] / max(self.counts[name], 1)
                for name in self.totals}

    def report(self) -> str:
        return " | ".join(f"{k}: {v * 1e3:.2f} ms" for k, v in self.summary().items())
