"""The readers of the program's spans (``dispatch_ms.cams8``,
``unpack_ms.cams8``, ``host_ms.stream``) on a hand-made span record: the
medians they state, and None on an empty record or a program that keeps
none."""
from collections import deque

import pytest

import harness
from yolov3_tpu_torch.utils import profiling
from yolov3_tpu_torch.utils.profiling import Span

READERS = ("dispatch_ms.cams8", "unpack_ms.cams8", "host_ms.stream")


def _calls(stages_ms):
    """A record of calls, each a list of (name, milliseconds) at the top of
    the call, one after the other; every lookup holds a nested capture of
    1 s that no reader may count."""
    rec = deque()
    t = 100.0
    for call, stages in enumerate(stages_ms, start=1):
        for name, ms in stages:
            if name == "lookup":
                rec.append(Span("capture", t, t + 1.0, "lookup", call))
            rec.append(Span(name, t, t + ms * 1e-3, None, call))
            t += ms * 1e-3
    return rec


@pytest.fixture
def record(monkeypatch):
    def use(rec):
        monkeypatch.setattr(profiling, "RECORD", rec)
    return use


def test_sync_call_readers(record):
    record(_calls([
        [("pad", 0.1), ("lookup", 0.05), ("stage", 1.5), ("launch", 0.3),
         ("fetch", 6.0), ("unpack", 0.4)],
        [("pad", 0.1), ("lookup", 0.07), ("stage", 1.4), ("launch", 0.5),
         ("fetch", 6.1), ("unpack", 0.2)],
        [("pad", 0.1), ("lookup", 0.06), ("stage", 1.6), ("launch", 0.9),
         ("fetch", 6.2), ("unpack", 0.9)],
    ]))
    # lookup + launch: 0.35, 0.57, 0.96
    assert harness.read_metric("dispatch_ms.cams8", None) == pytest.approx(0.57)
    assert harness.read_metric("unpack_ms.cams8", None) == pytest.approx(0.4)


def test_stream_reader_counts_whole_batches_without_the_wait(record):
    submit = [("pad", 0.2), ("pin", 4.0), ("lookup", 0.05), ("stage", 0.1),
              ("launch", 0.3), ("d2h", 0.05)]
    record(_calls([
        [("wait", 20.0), ("unpack", 1.0)],          # submitted before the window
        submit + [("wait", 18.0), ("unpack", 1.0)],  # 5.7 ms
        submit + [("wait", 19.0), ("unpack", 2.0)],  # 6.7 ms
        [(n, 2 * ms) for n, ms in submit] + [("wait", 1.0), ("unpack", 1.0)],
        submit,                                     # handed back after it
    ]))
    # 5.7, 6.7 and 10.4 ms: the median of the three whole batches
    assert harness.read_metric("host_ms.stream", None) == pytest.approx(6.7)


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read(record, monkeypatch, name):
    record(deque())
    assert harness.read_metric(name, None) is None
    monkeypatch.delattr(profiling, "RECORD")  # a program that keeps none
    assert harness.read_metric(name, None) is None
