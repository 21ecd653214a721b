"""The Detector's program cache on the CPU, against the JAX package's.

The reference compiles one program per (batch, source shape, channel order,
quantization state) and keeps them in an LRU (``yolov3_tpu/inference.py``
``_pipeline`` / ``_finalize`` / ``_cache_pipeline``); the port caches one
program per the same key plus the identity of its weights (a captured CUDA
graph reads them through the pointers it saw). On the CPU a program is the
eager closure, so the keys, the eviction order and the route warnings are
visible here and are held to the reference's on one sequence of calls; the
results through the cache are held to the eager ``_run`` on every route, to
a fresh Detector after new weights or a new quantization state, and, with
``scan``, to the same sub-batches run one call each.
"""
import gc
import importlib
import logging
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from yolov3_tpu import native as jnative
from yolov3_tpu.inference import Detector as JDetector
from yolov3_tpu.model import Darknet as JDarknet
from yolov3_tpu_torch import Darknet, Detector
from yolov3_tpu_torch import native
from yolov3_tpu_torch.inference import programs_to_evict
from yolov3_tpu_torch.weights import fold_raw, random_raw

torch.set_num_threads(1)

DATA = Path(__file__).parent / "data"
SMALL = str(DATA / "port_small.cfg")
WIDE = str(DATA / "port_wide.cfg")
BLOCK = str(DATA / "port_block.cfg")


def _frames(seed, n, hw):
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3),
                                                dtype=np.uint8)


def _keys(det):
    """The cached keys apart from their identity parts: (batch, source
    shape, channel order, quantized)."""
    return [(k[0], tuple(k[1]), bool(k[2]), k[3] is not None)
            for k in det._pipelines]


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.class_idx, w.class_idx)
        np.testing.assert_array_equal(g.class_prob, w.class_prob)
        np.testing.assert_array_equal(g.bbox_tlbr, w.bbox_tlbr)


def _close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.class_idx, w.class_idx)
        np.testing.assert_allclose(g.class_prob, w.class_prob, atol=5e-5)
        np.testing.assert_allclose(g.bbox_tlbr, w.bbox_tlbr, atol=0.1)


def test_keys_eviction_and_warnings_match_the_reference(monkeypatch, caplog):
    """One sequence of calls through both packages' Detectors with an LRU
    of 3: batch, source shape, ``detect_batch`` against
    ``detect_preletterboxed`` (channel order), ``detect_mixed`` without the
    host loader (groups padded to powers of two), a repeated key, and a
    quantization. After every call both caches hold the same keys in the
    same order; both warn once per program built ("pallas-fused" on a graph
    the gate refuses)."""
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(jnative, "available", lambda: False)
    net = Darknet(SMALL, precision="highest", device="cpu")
    params = fold_raw(random_raw(net.graph, seed=2))
    net.set_params(params)
    jnet = JDarknet(SMALL, precision="highest").set_params(params)
    kw = dict(prob_thresh=0.05, max_results=32, decode_impl="pallas-fused")
    det, jdet = Detector(net, **kw), JDetector(jnet, **kw)
    det._pipeline_capacity = jdet._pipeline_capacity = 3
    a, b = _frames(1, 2, (90, 120)), _frames(2, 1, (90, 120))
    canvases = _frames(3, 2, (64, 64))
    mixed = list(_frames(4, 3, (50, 70))) + [b[0]]
    calls = [("detect_batch", a), ("detect_batch", b),
             ("detect_preletterboxed", canvases), ("detect_batch", a),
             ("detect_mixed", mixed), ("quantize", a), ("detect_batch", a),
             ("detect_preletterboxed", canvases)]
    seen = []
    with caplog.at_level(logging.WARNING):
        for name, x in calls:
            if name == "quantize":
                jnet.quantize_int8(x[..., ::-1])
                net.set_quantized(
                    {i: {k: np.asarray(v) for k, v in qp.items()}
                     for i, qp in jnet.qparams.items()},
                    jnet.act_scales, jnet.act_zeros, jnet.qcarrier)
                continue
            args = (x, [(64, 64)] * len(x)) if name == "detect_preletterboxed" else (x,)
            got, want = getattr(det, name)(*args), getattr(jdet, name)(*args)
            if not net.quantized:
                _close(got, want)
            assert _keys(det) == _keys(jdet), name
            seen.append(_keys(det))
    assert seen[3] == [(1, (90, 120), True, False), (2, (64, 64), False, False),
                       (2, (90, 120), True, False)]          # a hit moves last
    # detect_mixed: the (50, 70) group padded to 4 evicts the oldest key,
    # the lone (90, 120) frame comes back as a new entry
    assert seen[4] == [(2, (90, 120), True, False), (4, (50, 70), True, False),
                       (1, (90, 120), True, False)]
    assert seen[-1][-2:] == [(2, (90, 120), True, True),
                             (2, (64, 64), False, True)]
    warned = {name: sum("head-fused decode not applicable" in r.getMessage()
                        for r in caplog.records if r.name == name)
              for name in ("yolov3_tpu", "yolov3_tpu_torch")}
    assert warned["yolov3_tpu_torch"] == warned["yolov3_tpu"] == 7


def _int8(cfg, seed=6, **qkw):
    net = Darknet(cfg, precision="bf16", device="cpu")
    net.set_params(fold_raw(random_raw(net.graph, seed=seed)))
    net.quantize_int8(_frames(seed, 2, (48, 48)), **qkw)
    return net


ROUTES = {
    "K1": lambda: (Darknet(WIDE, device="cpu"), {}),
    "K1 bf16 + K5": lambda: (Darknet(WIDE, precision="bf16", conv_impl="pallas",
                                     device="cpu"), {}),
    "K4": lambda: (Darknet(WIDE, precision="bf16", device="cpu"),
                   dict(decode_impl="pallas-fused")),
    "K4 + K5": lambda: (Darknet(WIDE, precision="bf16", conv_impl="pallas",
                                device="cpu"), dict(decode_impl="pallas-fused")),
    "xla": lambda: (Darknet(WIDE, precision="highest", device="cpu"),
                    dict(decode_impl="xla")),
    "xla + K5": lambda: (Darknet(WIDE, conv_impl="pallas", device="cpu"),
                         dict(decode_impl="xla")),
    "int8 K6 + K1": lambda: (_int8(BLOCK), dict(block_impl="pallas")),
    "int8 K6 + K4": lambda: (_int8(WIDE), dict(block_impl="pallas",
                                               decode_impl="pallas-fused")),
    "int8 + xla": lambda: (_int8(BLOCK), dict(decode_impl="xla")),
    "int8 asymmetric": lambda: (_int8(BLOCK, act_scheme="asymmetric"),
                                dict(block_impl="pallas")),
    "int8 bf16 carrier": lambda: (_int8(BLOCK, carrier="bf16"), {}),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_program_equals_eager_run(route):
    """Through the cached program (what ``detect_batch`` runs) and through
    the eager ``_run``: the same packed results, on every route."""
    net, kw = ROUTES[route]()
    if not net.quantized:
        net.set_params(fold_raw(random_raw(net.graph, seed=4)))
    det = Detector(net, prob_thresh=0.1, **kw)
    frames = _frames(5, 2, (40, 50))
    prog = det._pipeline(2, (40, 50))
    got = prog(prog.stage(frames, det.device))
    assert torch.equal(got, det._run(det._stage(frames)))
    assert prog.route == det.route and det._pipeline(2, (40, 50)) is prog
    _same(det.detect_batch(frames), det._unpack(got, (40, 50)))


def test_new_weights_after_a_program_give_a_fresh_detectors_results():
    net = Darknet(SMALL, precision="highest", device="cpu")
    net.set_params(fold_raw(random_raw(net.graph, seed=1)))
    det = Detector(net, prob_thresh=0.05)
    frames = _frames(6, 2, (64, 64))
    first = det.detect_batch(frames)
    params = fold_raw(random_raw(net.graph, seed=9))
    net.set_params(params)
    after = det.detect_batch(frames)
    fresh = Darknet(SMALL, precision="highest", device="cpu").set_params(params)
    _same(after, Detector(fresh, prob_thresh=0.05).detect_batch(frames))
    assert len(det._pipelines) == 2          # the new weights are a new key
    with pytest.raises(AssertionError):
        _same(after, first)


def test_new_quantization_after_a_program_gives_a_fresh_detectors_results(
        tmp_path):
    """quantize_int8 and load_quantized (through set_quantized) after a
    program was built: each state's own results, never the earlier
    state's."""
    frames = _frames(7, 2, (48, 48))
    net = _int8(BLOCK)
    det = Detector(net, prob_thresh=0.1, block_impl="pallas")
    sym = det.detect_batch(frames)
    net.save_quantized(tmp_path / "sym.npz")
    requantize = dict(calibration_frames=_frames(8, 2, (48, 48)),
                      act_scheme="asymmetric")
    net.quantize_int8(**requantize)
    asym = det.detect_batch(frames)
    fresh = _int8(BLOCK).quantize_int8(**requantize)
    _same(asym, Detector(fresh, prob_thresh=0.1,
                         block_impl="pallas").detect_batch(frames))
    net.load_quantized(tmp_path / "sym.npz")
    _same(det.detect_batch(frames), sym)
    fresh.save_quantized(tmp_path / "asym.npz")     # load → set_quantized
    net.load_quantized(tmp_path / "asym.npz")
    _same(det.detect_batch(frames), asym)
    assert len(det._pipelines) == 4


@pytest.mark.parametrize("scan", [2, 3])
def test_scan_program_equals_sub_batches(scan):
    """``scan=k`` runs ONE program over k sub-batches (the reference's
    ``lax.scan``): the results of the same sub-batches run one call each, in
    order, with the batch padded to a multiple of k."""
    net = Darknet(SMALL, precision="highest", device="cpu")
    net.set_params(fold_raw(random_raw(net.graph, seed=3)))
    frames = _frames(9, 5, (64, 64))
    det = Detector(net, prob_thresh=0.05, scan=scan)
    got = det.detect_batch(frames)
    sub = -(-len(frames) // scan)
    one = Detector(net, prob_thresh=0.05)
    padded = np.concatenate([frames, np.zeros((sub * scan - len(frames),
                                               64, 64, 3), np.uint8)])
    want = [d for i in range(scan)
            for d in one.detect_batch(padded[i * sub:(i + 1) * sub])]
    _same(got, want[:len(frames)])
    assert _keys(det) == [(sub * scan, (64, 64), True, False)]


def test_a_dropped_detector_frees_its_programs_at_once():
    """A program's closure holds no reference to its Detector: dropping the
    Detector frees its programs by reference counting, not at a later
    collection (on the card, a graph freed by the collector inside another
    program's capture would break that capture)."""
    net = Darknet(SMALL, precision="highest", device="cpu")
    net.set_params(fold_raw(random_raw(net.graph, seed=1)))
    det = Detector(net, prob_thresh=0.05)
    det.detect_batch(_frames(10, 1, (64, 64)))
    (prog,) = det._pipelines.values()
    ref = weakref.ref(prog)
    del prog
    collecting = gc.isenabled()
    gc.disable()
    try:
        del det
        assert ref() is None
    finally:
        if collecting:
            gc.enable()


@pytest.mark.parametrize("sizes,need,budget,free,want", [
    ([10, 20], 30, None, None, 0),        # the CPU: no device bytes
    ([], 500, 100, 0, 0),                 # nothing left to evict
    ([10, 20], 30, 100, 1000, 0),         # fits the budget and the card
    ([10, 20], 70, 100, 1000, 0),         # exactly the budget
    ([40, 30, 20], 25, 100, 1000, 1),     # over the budget by 15
    ([40, 30, 20], 90, 100, 1000, 3),     # only the new program fits
    ([10, 10, 10], 25, 1000, 5, 2),       # the card's free memory is short
    ([10, 20], 200, 100, 1000, 2),        # larger than the budget alone
    ([50, 5, 5], 45, 100, 1000, 1),       # the oldest is the largest
])
def test_programs_to_evict(sizes, need, budget, free, want):
    """The byte policy: the fewest least recently used programs whose
    eviction brings the held bytes plus the need within the budget and the
    free bytes up to the need."""
    assert programs_to_evict(sizes, need, budget, free) == want


def test_the_cache_makes_room_before_warm_up_and_before_capture(monkeypatch):
    """``_cache_pipeline`` as on the card, with fake programs whose warm-up
    needs fixed bytes: before a warm-up it evicts for the largest cached
    program of the same batch, after it for the measured need, least
    recently used first; a hit evicts nothing; the count limit still
    holds."""
    inference = importlib.import_module("yolov3_tpu_torch.inference")
    need = {(8, (100, 100)): 30, (8, (200, 200)): 50, (8, (300, 300)): 45,
            (16, (100, 100)): 60}
    free, events = [1000], []

    class Fake:
        def __init__(self, key, route, run, keep, device):
            self.key, self.route = key, route
            self.need, self.nbytes = need[key[:2]], 0
            events.append(("warm-up", key[:2], _held()))

        def capture(self):
            self.nbytes = self.need
            events.append(("capture", self.key[:2], _held()))

        def close(self):
            events.append(("evict", self.key[:2]))

    monkeypatch.setattr(inference, "_CapturedProgram", Fake)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (free[0], 1000))
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    net = Darknet(SMALL, precision="highest", device="cpu")
    net.set_params(fold_raw(random_raw(net.graph, seed=1)))
    det = Detector(net, prob_thresh=0.05)
    assert det._pipeline_budget is None          # the CPU: count only
    det.device, det._pipeline_budget = torch.device("cuda", 0), 100

    def _held():
        return [k[:2] for k in det._pipelines]

    def add(batch, hw):
        det._cache_pipeline((batch, hw, True, None, 0), lambda f: None)

    add(8, (100, 100))
    add(8, (200, 200))                           # 30 + 50: both fit
    add(8, (300, 300))       # estimate 50: 80 + 50 > 100, the oldest goes
    assert events[-3:] == [("evict", (8, (100, 100))),
                           ("warm-up", (8, (300, 300)), [(8, (200, 200))]),
                           ("capture", (8, (300, 300)), [(8, (200, 200))])]
    assert sum(p.nbytes for p in det._pipelines.values()) == 95
    events.clear()
    add(16, (100, 100))      # no batch-16 estimate; the warm-up says 60
    assert events == [("warm-up", (16, (100, 100)),
                       [(8, (200, 200)), (8, (300, 300))]),
                      ("evict", (8, (200, 200))), ("evict", (8, (300, 300))),
                      ("capture", (16, (100, 100)), [])]
    events.clear()
    free[0] = 20             # 60 + 30 fit the budget, not the card
    add(8, (100, 100))
    assert events == [("warm-up", (8, (100, 100)), [(16, (100, 100))]),
                      ("evict", (16, (100, 100))),
                      ("capture", (8, (100, 100)), [])]
    events.clear()
    free[0], det._pipeline_budget, det._pipeline_capacity = 1000, 10 ** 6, 2
    add(8, (200, 200))
    add(8, (300, 300))                           # the count limit of 2
    assert ("evict", (8, (100, 100))) in events
    assert _held() == [(8, (200, 200)), (8, (300, 300))]
