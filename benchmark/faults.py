"""Faults planted under the timed path, to show that ``correct`` catches
them (the tests on the CPU, ``limits.py --fault`` on the card). Each takes
a ``monkeypatch``-like ``setattr(obj, name, value)`` and breaks the program
where its answers are produced:

* ``drop_half``: half of each batch's answers left out (empty);
* ``alter_one``: each image's first answer moved by twice its width, its
  score set to 0.99;
* ``stale``: each call hands back the previous call's answers (a result
  buffer read before the device wrote it), so every frame gets another's;
* ``swap_replicas``: on a data mesh, the first card's answers stand in for
  every card's (the exchange between cards left out).
"""
from __future__ import annotations

import numpy as np


def drop_half(setattr_):
    from yolov3_tpu_torch.inference import Detection, Detector

    unpack = Detector._unpack

    def half(self, res, src_hw):
        out = unpack(self, res, src_hw)
        empty = Detection(np.zeros((0, 4), np.float32), np.zeros(0, np.float32),
                          np.zeros(0, np.int32))
        return out[:len(out) // 2] + [empty] * (len(out) - len(out) // 2)

    setattr_(Detector, "_unpack", half)


def alter_one(setattr_):
    from yolov3_tpu_torch.inference import Detector

    unpack = Detector._unpack

    def altered(self, res, src_hw):
        out = unpack(self, res, src_hw)
        for d in out:
            if len(d.class_prob):
                w = d.bbox_tlbr[0, 2] - d.bbox_tlbr[0, 0]
                d.bbox_tlbr[0, [0, 2]] += 2 * w + 4
                d.class_prob[0] = 0.99
        return out

    setattr_(Detector, "_unpack", altered)


def stale(setattr_):
    from yolov3_tpu_torch.inference import Detector

    unpack = Detector._unpack
    last = []

    def previous(self, res, src_hw):
        out = unpack(self, res, src_hw)
        prev = last[0] if last and len(last[0]) == len(out) else out
        last[:] = [out]
        return prev

    setattr_(Detector, "_unpack", previous)


def swap_replicas(setattr_):
    from yolov3_tpu_torch.inference import _Shards
    from yolov3_tpu_torch.parallel.sharding import merge_batch

    def first_only(self):
        first = self[0].cpu()
        return merge_batch([first for _ in self], self.scan)

    setattr_(_Shards, "cpu", first_only)


FAULTS = {f.__name__: f for f in (drop_half, alter_one, stale, swap_replicas)}
