"""The spans at the host stage boundaries of the port's Detector calls
(``yolov3_tpu_torch.utils.profiling.span``) and the program-cache counters,
on the CPU: no span and no profiler range with no profile running; under
``torch.profiler`` every stage of a call in order, under one call id, each
the profiler range ``yolov3.<name>``; ``last_stage_s`` computed from the
same spans; a ``PipelinedDetector`` batch's spans under one id across
submit and materialize; one ``stage`` span a replica on a mesh; the cache's
hits, misses and evictions."""
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from yolov3_tpu_torch import Darknet, Detector
from yolov3_tpu_torch import native
from yolov3_tpu_torch.inference import PipelinedDetector
from yolov3_tpu_torch.parallel.sharding import make_mesh
from yolov3_tpu_torch.utils import profiling
from yolov3_tpu_torch.utils.profiling import RECORD, StageTimers, span
from yolov3_tpu_torch.weights import fold_raw, random_raw

torch.set_num_threads(1)

SMALL = str(Path(__file__).parent / "data" / "port_small.cfg")
SYNC = ["pad", "lookup", "stage", "launch", "fetch", "unpack"]


def _frames(seed, n, hw=(90, 120)):
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3),
                                                dtype=np.uint8)


def _detector(mesh=None):
    net = Darknet(SMALL, precision="highest", device="cpu")
    net.set_params(fold_raw(random_raw(net.graph, seed=2)))
    return Detector(net, prob_thresh=0.05, max_results=32, mesh=mesh)


def _traced(fn):
    """(what ``fn()`` returns, the spans it recorded, the names of the
    profiler's ``yolov3.*`` ranges) under a CPU profile."""
    RECORD.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = [e.name for e in prof.events()
              if e.name.startswith(profiling.PREFIX)]
    return out, list(RECORD), ranges


def _top(spans, call):
    """The call's spans at the top (no span around them), by start."""
    return sorted((s for s in spans if s.call == call and s.parent is None),
                  key=lambda s: s.start)


def test_no_span_and_no_range_without_a_profile(monkeypatch):
    det = _detector()
    frames = _frames(0, 2)
    det.detect_batch(frames)  # the program built

    def refused(name):
        raise AssertionError(f"a profiler range {name!r} with no profile")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    RECORD.clear()
    det.detect_batch(frames)
    PipelinedDetector(det, depth=1).submit(frames)
    assert not profiling.tracing() and not RECORD
    assert set(det.last_stage_s) == {"h2d_s", "dispatch_s", "device_fetch_s"}


def test_a_traced_call_records_its_stages_in_order():
    det = _detector()
    frames = _frames(1, 2)
    _, spans, ranges = _traced(lambda: det.detect_batch(frames))
    (call,) = {s.call for s in spans}
    top = _top(spans, call)
    assert [s.name for s in top] == SYNC
    for a, b in zip(top, top[1:]):
        assert a.start <= a.end <= b.start  # in order, not overlapping
    # the first call builds its program: a child of the lookup
    (capture,) = [s for s in spans if s.name == "capture"]
    lookup = top[1]
    assert capture.parent == "lookup" and capture.call == call
    assert lookup.start <= capture.start <= capture.end <= lookup.end
    assert sorted(ranges) == sorted(profiling.PREFIX + s.name for s in spans)

    # a second call: a hit, the same stages, no capture
    _, spans, _ = _traced(lambda: det.detect_batch(frames))
    assert [s.name for s in sorted(spans, key=lambda s: s.start)] == SYNC
    assert len({s.call for s in spans}) == 1 and {s.call for s in spans} != {call}


def test_last_stage_s_from_the_spans():
    det = _detector()
    frames = _frames(2, 2)
    det.detect_batch(frames)
    _, spans, _ = _traced(lambda: det.detect_batch(frames))
    sec = {s.name: s.end - s.start for s in spans}
    assert det.last_stage_s == {
        "h2d_s": sec["stage"],
        "dispatch_s": sec["lookup"] + sec["launch"],
        "device_fetch_s": sec["fetch"] + sec["unpack"]}
    assert list(det.last_stage_s) == ["h2d_s", "dispatch_s", "device_fetch_s"]


def test_detect_mixed_letterbox_is_a_span_of_the_call():
    if not native.available():
        pytest.skip("the host loader does not build here (no g++)")
    det = _detector()
    frames = [f for f in _frames(3, 2, (50, 70))] + [_frames(4, 1)[0]]
    _, spans, _ = _traced(lambda: det.detect_mixed(frames))
    (call,) = {s.call for s in spans}
    assert [s.name for s in _top(spans, call)] == ["letterbox"] + SYNC
    letterbox = next(s for s in spans if s.name == "letterbox")
    assert det.last_stage_s["preprocess_s"] == letterbox.end - letterbox.start
    assert list(det.last_stage_s) == ["preprocess_s", "h2d_s", "dispatch_s",
                                      "device_fetch_s"]


def test_pipelined_batches_keep_one_id_from_submit_to_materialize():
    det = _detector()
    pipe = PipelinedDetector(det, depth=1)
    batches = [_frames(10 + i, 2) for i in range(3)]

    def run():
        done = []
        for b in batches:
            done += pipe.submit(b)
        return done + pipe.flush()

    done, spans, _ = _traced(run)
    assert len(done) == 3
    calls = sorted({s.call for s in spans})
    assert len(calls) == 3
    for call in calls:
        assert [s.name for s in _top(spans, call)] == [
            "pad", "lookup", "stage", "launch", "wait", "unpack"]


def test_a_mesh_call_stages_each_replica_in_a_span():
    det = _detector(make_mesh(2, devices=[torch.device("cpu")] * 2))
    frames = _frames(5, 4)
    det.detect_batch(frames)
    _, spans, _ = _traced(lambda: det.detect_batch(frames))
    replicas = sorted((s for s in spans if s.parent == "stage"),
                      key=lambda s: s.tag)
    (outer,) = [s for s in spans if s.name == "stage" and s.parent is None]
    assert [(s.name, s.tag, s.call) for s in replicas] == [
        ("stage", 0, outer.call), ("stage", 1, outer.call)]
    assert outer.start <= replicas[0].start and replicas[1].end <= outer.end
    assert det.last_stage_s["h2d_s"] == outer.end - outer.start


def test_program_cache_counts_hits_misses_and_evictions():
    det = _detector()
    det._pipeline_capacity = 2
    a, b, c = (_frames(20 + i, 1, hw) for i, hw in
               enumerate([(90, 120), (60, 80), (48, 64)]))
    for frames in (a, b, a, c, b, a, c):
        det.detect_batch(frames)
    # a miss, b miss, a hit, c miss (b out), b miss (a out), a miss (c out),
    # c miss (b out)
    counts = det.cache_counts
    assert (counts["hit"], counts["miss"], counts["evict"]) == (1, 6, 4)
    assert counts["capture_s"] > 0
    assert len(det._pipelines) == 2


def test_an_evicted_program_is_a_span_under_the_capture():
    det = _detector()
    det._pipeline_capacity = 1
    det.detect_batch(_frames(30, 1))
    _, spans, _ = _traced(lambda: det.detect_batch(_frames(31, 1, (60, 80))))
    (evict,) = [s for s in spans if s.name == "evict"]
    (capture,) = [s for s in spans if s.name == "capture"]
    assert evict.parent == "capture" and evict.call == capture.call
    assert det.cache_counts["evict"] == 1


def test_stage_timers_are_spans():
    timers = StageTimers()

    def run():
        for _ in range(2):
            with timers.stage("draw"):
                pass

    _, spans, ranges = _traced(run)
    assert [s.name for s in spans] == ["draw", "draw"]
    assert ranges == [profiling.PREFIX + "draw"] * 2
    assert timers.counts == {"draw": 2}
    assert timers.totals["draw"] == pytest.approx(
        sum(s.end - s.start for s in spans), abs=1e-12)


def test_a_span_feeds_its_stage_dict_and_nests():
    stages = {}
    with span("outer", stages, call=7) as outer:
        with span("inner", stages):
            pass
    assert outer.seconds == stages["outer"] > 0 and "inner" in stages
    _, spans, _ = _traced(lambda: _nest(stages))
    inner, outer = spans  # the record keeps the order the spans ended in
    assert (inner.parent, inner.call) == ("outer", 9)
    assert (outer.parent, outer.call) == (None, 9)


def _nest(stages):
    with span("outer", stages, call=9):
        with span("inner", stages):
            pass
