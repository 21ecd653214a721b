"""One caller makes synchronous ``Detector.detect_batch`` calls, each after
the last returned: a closed loop, each call's latency and staging span
kept."""
import time

from torch.profiler import record_function

from loadgen import WARM_BATCHES
from loadgen import Driver as Base


class Driver(Base):
    def warm(self) -> None:
        for _ in range(WARM_BATCHES):
            self.step(keep=False)

    def step(self, keep: bool = True) -> None:
        ids, frames = self._next()
        t = time.perf_counter()
        with record_function("benchmark.detect_batch"):
            dets = self.det.detect_batch(frames)
        lat = time.perf_counter() - t
        if self.in_window:
            self.served.submitted += len(ids)
            self.served.calls += 1
            self.served.latencies_s.append(lat)
            self.served.h2d_s.append(self.det.last_stage_s["h2d_s"])
        if keep:
            self._keep(ids, dets, self.in_window)

    def finish(self) -> None:
        pass
