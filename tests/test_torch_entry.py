"""The Detector's entry-point methods on the CPU against the JAX package's
Detector on the same frames and weights at precision "highest":
``detect_mixed`` (both branches), ``detect_preletterboxed``, ``scan``,
``PipelinedDetector``, the one-shot cache, ``warmup``, the stage keys and
``load_weights(cache=True)``. Bars: the golden bars of the pipeline tests
(count and classes exact, scores within 5e-5, boxes within 0.1 px)."""
import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

from yolov3_tpu import native as jnative
from yolov3_tpu.inference import Detector as JDetector
from yolov3_tpu.model import Darknet as JDarknet
from yolov3_tpu_torch import Darknet, Detector, inference as one_shot
from yolov3_tpu_torch import native as tnative
from yolov3_tpu_torch.weights import (fold_raw, load_weights_cached,
                                      random_raw, write_weights)

torch.set_num_threads(1)
# the package exports the function ``inference``, which hides the module
tinference = importlib.import_module("yolov3_tpu_torch.inference")

DATA = Path(__file__).parent / "data"
SMALL_CFG = str(DATA / "port_small.cfg")
KW = dict(prob_thresh=0.05, iou_thresh=0.45, net_hw=(64, 64), max_results=64)
SHAPES = [(90, 120), (64, 80), (90, 120), (100, 70)]


def _same(got, want, exact=False):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g.class_idx) == len(w.class_idx)
        np.testing.assert_array_equal(g.class_idx, w.class_idx)
        if exact:
            np.testing.assert_array_equal(g.class_prob, w.class_prob)
            np.testing.assert_array_equal(g.bbox_tlbr, w.bbox_tlbr)
        else:
            np.testing.assert_allclose(g.class_prob, w.class_prob, atol=5e-5)
            np.testing.assert_allclose(g.bbox_tlbr, w.bbox_tlbr, atol=0.1)


@pytest.fixture(scope="module")
def params():
    net = Darknet(SMALL_CFG, precision="highest", device="cpu")
    return fold_raw(random_raw(net.graph, seed=12))


@pytest.fixture(scope="module")
def net(params):
    return Darknet(SMALL_CFG, precision="highest", device="cpu").set_params(params)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in SHAPES]


@pytest.fixture(scope="module")
def jax_results(params, frames):
    """The JAX Detector's answers, computed once: detect_mixed through the
    C++ loader, detect_mixed through the per-shape groups, and detect_batch
    on four same-shape frames."""
    jdet = JDetector(JDarknet(SMALL_CFG, precision="highest").set_params(params), **KW)
    assert jnative.available()
    out = {"mixed": jdet.detect_mixed(frames),
           "stage_keys_mixed": set(jdet.last_stage_s)}
    same = np.stack([frames[0], frames[2], frames[0][::-1].copy(),
                     frames[2][:, ::-1].copy()])
    out["batch"] = jdet.detect_batch(same)
    out["stage_keys_batch"] = set(jdet.last_stage_s)
    out["same"] = same
    real = jnative.available
    jnative.available = lambda: False
    try:
        out["grouped"] = jdet.detect_mixed(frames)
    finally:
        jnative.available = real
    assert sum(len(d.class_idx) for d in out["mixed"]) > 0
    return out


def test_detect_mixed_native_matches_jax(net, frames, jax_results):
    assert tnative.available()
    det = Detector(net, **KW)
    got = det.detect_mixed(frames)
    _same(got, jax_results["mixed"])
    assert set(det.last_stage_s) == jax_results["stage_keys_mixed"] == {
        "preprocess_s", "h2d_s", "dispatch_s", "device_fetch_s"}


def test_detect_mixed_without_loader_matches_jax(net, frames, jax_results,
                                                 monkeypatch):
    """The per-shape branch: same-shape groups padded to a power of two."""
    monkeypatch.setattr(tnative, "available", lambda: False)
    det = Detector(net, **KW)
    batches = []
    real = det.detect_batch
    monkeypatch.setattr(det, "detect_batch",
                        lambda b: batches.append(b.shape) or real(b))
    got = det.detect_mixed(frames)
    _same(got, jax_results["grouped"])
    assert sorted(batches) == [(1, 64, 80, 3), (1, 100, 70, 3), (2, 90, 120, 3)]
    three = [frames[0]] * 3
    batches.clear()
    assert len(det.detect_mixed(three)) == 3
    assert batches == [(4, 90, 120, 3)]  # 3 pads to the next power of two


def test_detect_preletterboxed_equals_detect_mixed(net, frames, jax_results):
    det = Detector(net, **KW)
    canvases = det._build_canvases(frames)
    assert canvases.shape == (4, 64, 64, 3) and canvases.dtype == np.uint8
    got = det.detect_preletterboxed(canvases, [f.shape[:2] for f in frames])
    assert set(det.last_stage_s) == {"h2d_s", "dispatch_s", "device_fetch_s"}
    _same(got, det.detect_mixed(frames), exact=True)
    _same(got, jax_results["mixed"])


def test_stretch_mode_canvases(net, frames):
    det = Detector(net, resize_mode="stretch", **KW)
    canvases = det._build_canvases(frames)
    assert canvases.shape == (4, 64, 64, 3)
    for c, f in zip(canvases, frames):
        np.testing.assert_array_equal(
            c, tnative.stretch_batch_native(f[None], (64, 64))[0])
    assert len(det.detect_mixed(frames)) == 4


def test_detect_batch_matches_jax_and_stage_keys(net, jax_results):
    det = Detector(net, **KW)
    _same(det.detect_batch(jax_results["same"]), jax_results["batch"])
    assert set(det.last_stage_s) == jax_results["stage_keys_batch"] == {
        "h2d_s", "dispatch_s", "device_fetch_s"}
    assert all(v >= 0 for v in det.last_stage_s.values())


@pytest.mark.parametrize("scan", [2, 4])
@pytest.mark.parametrize("n", [4, 5])
def test_scan_equals_unscanned(net, jax_results, scan, n):
    """scan=k pads the batch to a multiple of k, runs k sub-batches and
    returns the unscanned results, in order, exactly."""
    batch = np.concatenate([jax_results["same"], jax_results["same"][:1]])[:n]
    want = Detector(net, **KW).detect_batch(batch)
    det = Detector(net, scan=scan, **KW)
    runs = []
    real = det._body     # one sub-batch's device work inside the program

    def body(bgr, route):
        run = real(bgr, route)
        return lambda f: runs.append(f.shape[0]) or run(f)

    det._body = body
    got = det.detect_batch(batch)
    assert len(got) == n
    _same(got, want, exact=True)
    assert len(runs) == scan and sum(runs) == -(-n // scan) * scan
    canv = det._build_canvases(list(batch))
    _same(det.detect_preletterboxed(canv, [batch.shape[1:3]] * n),
          Detector(net, **KW).detect_preletterboxed(canv, [batch.shape[1:3]] * n),
          exact=True)


def test_pipelined_detector_order_and_equality(net, jax_results):
    det = Detector(net, **KW)
    rng = np.random.default_rng(9)
    batches = [rng.integers(0, 256, (2, 48 + 8 * (i % 2), 64, 3), dtype=np.uint8)
               for i in range(5)]
    want = [det.detect_batch(b) for b in batches]
    pipe = tinference.PipelinedDetector(det, depth=2)
    got, in_flight = [], []
    for b in batches:
        done = pipe.submit(b)
        in_flight.append(len(pipe._inflight))
        got.extend(done)
    assert in_flight == [1, 2, 2, 2, 2]  # never more than depth
    assert len(got) == 3
    got.extend(pipe.flush())
    assert pipe.flush() == []
    assert len(got) == 5
    for g, w in zip(got, want):
        _same(g, w, exact=True)
    assert pipe.submit(np.zeros((0, 48, 64, 3), np.uint8)) == []
    single = pipe.submit(batches[0][0]) + pipe.flush()  # (H, W, 3) frame
    _same(single[0], want[0][:1], exact=True)


def test_oneshot_cache_is_lru_bounded(net, jax_results):
    tinference._ONESHOT_DETECTORS.clear()
    frame = jax_results["same"][:1]
    for i in range(10):
        one_shot(net, frame, prob_thresh=0.05 + 0.01 * i)
    cache = tinference._ONESHOT_DETECTORS
    assert len(cache) == tinference._ONESHOT_CAPACITY == 8
    newest = next(reversed(cache))
    det = cache[newest]
    out = one_shot(net, frame, prob_thresh=0.05 + 0.01 * 9)
    assert cache[newest] is det and len(cache) == 8
    first = (id(net), 0.05, 0.3, "letterbox")
    assert first not in cache  # the oldest entries were evicted
    boxes, probs, classes = out[0]
    assert boxes.shape[1] == 4 and len(probs) == len(classes)
    cache.clear()


def test_warmup_both_routes(net):
    det = Detector(net, **KW)
    assert det.warmup(2, (90, 120)) is det
    assert (90, 120) in det._interp
    det.last_stage_s = None
    det.warmup(2, (90, 120), host_preprocessed=True)
    assert set(det.last_stage_s) == {"h2d_s", "dispatch_s", "device_fetch_s"}


def test_float_frames_are_refused(net, frames):
    det = Detector(net, **KW)
    with pytest.raises(TypeError, match="uint8"):
        det.detect_mixed([frames[0].astype(np.float32) / 255])
    assert det.detect_mixed([]) == []


def test_multi_device_arguments_fail_loudly(net):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Detector(net, mesh=object(), **KW)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Detector(net, partition="spatial", **KW)
    with pytest.raises(ValueError, match="partition"):
        Detector(net, partition="rows", **KW)
    with pytest.raises(ValueError, match="nms_impl"):
        Detector(net, nms_impl="cub", **KW)
    with pytest.raises(ValueError, match="scan"):
        Detector(net, scan=0, **KW)


@pytest.mark.parametrize("nms_impl", ["xla", "pallas"])
def test_nms_impl_names_run_alike(net, jax_results, nms_impl):
    det = Detector(net, nms_impl=nms_impl, **KW)
    assert det.nms_impl == nms_impl
    _same(det.detect_batch(jax_results["same"]), jax_results["batch"])


def test_load_weights_cached_twice(tmp_path, params):
    from yolov3_tpu.weights import load_weights_cached as jcached
    from yolov3_tpu.graph import load_graph as jload_graph

    net = Darknet(SMALL_CFG, precision="highest", device="cpu")
    path = tmp_path / "small.weights"
    write_weights(path, net.graph, random_raw(net.graph, seed=12))
    net.load_weights(path, cache=True)
    files = list((tmp_path / ".param_cache").glob("*.npz"))
    assert len(files) == 1
    stamp = files[0].stat().st_mtime_ns
    again = Darknet(SMALL_CFG, precision="highest", device="cpu")
    again.load_weights(path, cache=True)   # served from the cache file
    assert [f.stat().st_mtime_ns for f in
            (tmp_path / ".param_cache").glob("*.npz")] == [stamp]
    plain = Darknet(SMALL_CFG, precision="highest", device="cpu").load_weights(path)
    for idx, p in plain.params.items():
        for key in ("w", "b"):
            assert torch.equal(again.params[idx][key], p[key])
            assert torch.equal(net.params[idx][key], p[key])
    # one cache for both packages: same key, same arrays
    cached = load_weights_cached(path, net.graph)
    jc = jcached(path, jload_graph(SMALL_CFG))
    assert cached.keys() == jc.keys() == params.keys()
    for idx in cached:
        for key in ("w", "b"):
            np.testing.assert_array_equal(cached[idx][key], jc[idx][key])
            np.testing.assert_array_equal(cached[idx][key], params[idx][key])
    assert len(list((tmp_path / ".param_cache").glob("*"))) == 1
