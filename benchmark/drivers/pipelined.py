"""One producer feeds ``PipelinedDetector(depth).submit`` with batches and
takes the batches it hands back: a closed loop, the producer waits whenever
``depth`` batches are in flight."""
from collections import deque

from torch.profiler import record_function

from loadgen import WARM_BATCHES
from loadgen import Driver as Base


class Driver(Base):
    def __init__(self, detector, pool, traffic):
        super().__init__(detector, pool, traffic)
        from yolov3_tpu_torch.inference import PipelinedDetector

        self.pipe = PipelinedDetector(detector, depth=int(traffic["depth"]))
        self.queue: deque = deque()

    def warm(self) -> None:
        for _ in range(WARM_BATCHES + self.pipe.depth):
            self.step(keep=False)
        for _ in self.pipe.flush():
            self.queue.popleft()
        # refill the pipeline so that the window starts in its steady state
        for _ in range(self.pipe.depth):
            self.step(keep=False)

    def step(self, keep: bool = True) -> None:
        ids, frames = self._next()
        with record_function("benchmark.submit"):
            done = self.pipe.submit(frames)
        self.queue.append(ids)
        if self.in_window:
            self.served.submitted += len(ids)
            self.served.calls += 1
        for dets in done:
            done_ids = self.queue.popleft()
            if keep:
                self._keep(done_ids, dets, self.in_window)

    def finish(self) -> None:
        for dets in self.pipe.flush():
            self._keep(self.queue.popleft(), dets, False)
