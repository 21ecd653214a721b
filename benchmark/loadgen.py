"""The one load generator: drives the program with a traffic mix read from
``traffic/<name>.json``.

A mix names its ``driver``, a file of its own, ``drivers/<driver>.py``,
whose ``Driver`` (a :class:`Driver`) makes the calls, and its numbers:

* ``pipelined``: one producer feeds ``PipelinedDetector(depth).submit``
  with batches of ``batch`` frames of ``frame_hw`` and takes the batches it
  hands back (a closed loop: the producer waits whenever ``depth`` batches
  are in flight);
* ``sync``: one caller makes synchronous ``Detector.detect_batch`` calls
  of ``batch`` frames, each after the last returned (a closed loop).

A new kind of traffic is a new file there, and a new mix of a kind a new
file under ``traffic/``.

Batch ``k`` is frames ``k * batch .. k * batch + batch - 1`` of a pool of
``pool`` distinct frames made from the seed (``pool`` a multiple of
``batch``), cycled; ``sample`` of the frames the window served are compared
with the reference afterwards. Every seed gives the same sizes and the same
number of frames; only the pixels differ.
"""
from __future__ import annotations

import importlib.util
import re
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

import numpy as np

HERE = Path(__file__).resolve().parent
WARM_BATCHES = 3  # batches run before the window, after the program's capture


@dataclass
class Served:
    """What the window's calls returned: per served frame, its pool index
    and the program's detections; per call, host seconds and stage split."""

    frames: List[int] = field(default_factory=list)
    detections: List[object] = field(default_factory=list)
    latencies_s: List[float] = field(default_factory=list)
    h2d_s: List[float] = field(default_factory=list)
    submitted: int = 0   # frames sent inside the window
    returned: int = 0    # frames whose detections came back inside the window
    calls: int = 0


class Driver:
    """What every driver shares: the pool's batches in turn, and what the
    window served. A driver adds ``warm()`` (before the window),
    ``step()`` (one call, or one submission) and ``finish()`` (after it)."""

    def __init__(self, detector, pool: np.ndarray, traffic: Dict):
        self.det, self.pool, self.batch = detector, pool, int(traffic["batch"])
        if len(pool) % self.batch:
            raise ValueError("the pool must hold whole batches")
        self.k = 0
        self.served = Served()
        self.in_window = False

    def _next(self):
        lo = (self.k * self.batch) % len(self.pool)
        self.k += 1
        ids = np.arange(lo, lo + self.batch)
        return ids, self.pool[lo:lo + self.batch]

    def _keep(self, ids, dets, in_window: bool) -> None:
        self.served.frames.extend(int(i) for i in ids)
        self.served.detections.extend(dets)
        if in_window:
            self.served.returned += len(ids)


def driver(detector, pool, traffic) -> Driver:
    """The driver the mix names: ``drivers/<driver>.py``'s ``Driver``."""
    name = str(traffic["driver"])
    path = HERE / "drivers" / f"{name}.py"
    if not re.fullmatch(r"[A-Za-z0-9_]+", name) or not path.is_file():
        raise ValueError(f"unknown driver {name!r}: no {path}")
    spec = importlib.util.spec_from_file_location(f"driver_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Driver(detector, pool, traffic)


def run_window(drv: Driver, seconds: float) -> float:
    """Drive the program for ``seconds`` of host time; returns the window's
    length."""
    drv.in_window = True
    t0 = time.perf_counter()
    now = t0
    while now - t0 < seconds:
        drv.step()
        now = time.perf_counter()
    drv.in_window = False
    return now - t0


def sample_frames(served: Served, n: int, seed: int) -> List[int]:
    """``n`` distinct served frames drawn from the seed, and the frame the
    program gave the most detections."""
    distinct = sorted(set(served.frames))
    rng = np.random.default_rng(int(seed) % (2 ** 63))
    pick = set(rng.choice(distinct, size=min(n, len(distinct)),
                          replace=False).tolist())
    counts = [len(d.class_prob) for d in served.detections]
    pick.add(served.frames[int(np.argmax(counts))])
    return sorted(pick)
