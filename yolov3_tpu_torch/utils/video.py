"""Threaded video I/O (reference ``VideoGetter``/``VideoShower``, SURVEY.md §2.9).

Same design as the reference: a daemon capture thread pumping the newest
camera frame into an attribute (latest-frame-wins — deliberate frame dropping
for real-time; the handoff is a benign single-writer/single-reader attribute
swap, SURVEY.md §5.2), and a display thread keeping ``cv2.imshow`` off the
compute thread. cv2 releases the GIL inside native calls, so all three
threads genuinely overlap.
"""
from __future__ import annotations

import threading
import time


class VideoGetter:
    """Camera/stream capture thread; ``.frame`` always holds the newest frame."""

    def __init__(self, src=0):
        import cv2

        self.stream = cv2.VideoCapture(src)
        if not self.stream.isOpened():
            raise RuntimeError(f"could not open video source {src!r}")
        ok, self.frame = self.stream.read()
        self.stopped = not ok
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> "VideoGetter":
        self._thread.start()
        return self

    def _run(self):
        while not self.stopped:
            ok, frame = self.stream.read()
            if not ok:
                self.stopped = True
                break
            self.frame = frame  # atomic attribute swap; latest wins
        self.stream.release()

    def stop(self):
        self.stopped = True


class VideoShower:
    """Display thread: shows whatever ``.frame`` currently is; ``q`` quits."""

    def __init__(self, frame=None, window_name: str = "video"):
        self.frame = frame
        self.window_name = window_name
        self.stopped = False
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> "VideoShower":
        self._thread.start()
        return self

    def _run(self):
        import cv2

        try:
            while not self.stopped:
                if self.frame is None:
                    time.sleep(0.005)
                    continue
                cv2.imshow(self.window_name, self.frame)
                if cv2.waitKey(1) & 0xFF == ord("q"):
                    self.stopped = True
            cv2.destroyWindow(self.window_name)
        except cv2.error:
            # headless environment (no display): stop cleanly instead of
            # dying silently and stranding the detect loop
            self.stopped = True

    def stop(self):
        self.stopped = True
