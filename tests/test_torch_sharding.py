"""The port's batch-DP on a single-controller mesh
(``yolov3_tpu_torch/parallel/sharding.py``) on CPU shards, against the JAX
package's ``sharded_pipeline`` on the 8 virtual CPU devices of
``tests/conftest.py`` (the inputs of ``tests/test_sharding.py``: tiny@160,
frames 96x128 and 192x256), and the port's mesh ``Detector`` against its
single-device ``Detector`` bit for bit on every entry point, the server's
``--devices``, and the dry run's printed survivors."""
import contextlib
import io
import json
import threading
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from yolov3_tpu.graph import load_graph as jload_graph
from yolov3_tpu.parallel.sharding import batch_sharding as jbatch_sharding
from yolov3_tpu.parallel.sharding import make_mesh as jmake_mesh
from yolov3_tpu.parallel.sharding import shard_params as jshard_params
from yolov3_tpu.parallel.sharding import sharded_pipeline as jsharded_pipeline
from yolov3_tpu_torch import Darknet, Detector
from yolov3_tpu_torch import native as tnative
from yolov3_tpu_torch import serve as tserve
from yolov3_tpu_torch.graph import load_graph
from yolov3_tpu_torch.inference import PipelinedDetector, detect_in_video
from yolov3_tpu_torch.parallel import collectives
from yolov3_tpu_torch.parallel.dryrun import dryrun_multichip
from yolov3_tpu_torch.parallel.sharding import (batch_sharding, make_mesh,
                                                merge_batch, replicate,
                                                shard_params,
                                                sharded_pipeline, split_batch)
from yolov3_tpu_torch.weights import (fold_raw, params_from_jax, random_raw,
                                      write_weights)

torch.set_num_threads(1)

MODELS = Path(__file__).parent.parent / "models"
TINY = str(MODELS / "yolov3-tiny.cfg")
CPU = torch.device("cpu")


def _mesh(n):
    return make_mesh(n, devices=[CPU] * n)


def _frames(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _net(seed=0, **kw):
    net = Darknet(TINY, device="cpu", **kw)
    return net.set_params(fold_raw(random_raw(net.graph, seed=seed)))


def _identical(got, want):
    assert len(got) == len(want) > 0
    assert sum(len(d.class_idx) for d in want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.class_idx, w.class_idx)
        np.testing.assert_array_equal(g.class_prob, w.class_prob)
        np.testing.assert_array_equal(g.bbox_tlbr, w.bbox_tlbr)


def _in_chunks(detect, frames, b):
    """``detect`` on consecutive chunks of ``b`` frames, the batch a
    replica runs (cuDNN and the CPU's bf16 convs pick their algorithm by
    batch, so a replica is held to the single device at its own batch)."""
    out = []
    for i in range(0, len(frames), b):
        out += detect(frames[i:i + b])
    return out


def _same_results(got, want):
    """The reference's mesh bars: valid and classes exact, boxes within
    1e-3, scores within 1e-4."""
    valid = np.asarray(want.valid)
    assert valid.any()
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-4, rtol=1e-4)


def test_mesh_construction():
    mesh = _mesh(8)
    assert mesh.shape == {"data": 8} and mesh.size == 8
    assert mesh.axis_names == ("data",)
    with pytest.raises(ValueError, match="only 8 visible"):
        make_mesh(16, devices=[CPU] * 8)
    visible = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"only {visible} visible"):
        make_mesh(visible + 1)
    assert make_mesh(2, devices=["cpu", "cpu", "cpu"]).devices == (CPU, CPU)


def test_shard_params_copies_once_per_device():
    params = params_from_jax(fold_raw(random_raw(load_graph(TINY), seed=0)),
                             "cpu")
    shards = shard_params(params, _mesh(4))
    # every shard on the params' own device: the caller's tree, no copy
    assert len(shards) == 4 and all(s is params for s in shards)


def test_batch_and_replicated_placement():
    x = torch.arange(16.0).reshape(8, 2)
    parts = batch_sharding(_mesh(4), 4).place(x)
    assert [p.tolist() for p in parts] == [x[2 * i:2 * i + 2].tolist()
                                           for i in range(4)]
    assert all(p is x for p in replicate(_mesh(4)).place(x))
    with pytest.raises(ValueError, match="does not split"):
        batch_sharding(_mesh(3)).place(x)


@pytest.mark.parametrize("scan", [1, 2, 3])
def test_split_and_merge_follow_the_reference_stack(scan):
    """Replica r holds rows [r·b, (r+1)·b) of every sub-batch, as the
    reference's (scan, B, ...) stack sharded on its second axis; merging
    the replicas restores submission order."""
    n, b = 4, 2
    frames = np.arange(scan * n * b)
    parts = split_batch(frames, n, scan)
    stack = frames.reshape(scan, n * b)
    for r, part in enumerate(parts):
        np.testing.assert_array_equal(part, stack[:, r * b:(r + 1) * b].ravel())
    merged = merge_batch([torch.from_numpy(p) for p in parts], scan)
    np.testing.assert_array_equal(merged.numpy(), frames)


@pytest.fixture(scope="module")
def tiny_params():
    return fold_raw(random_raw(jload_graph(TINY), seed=0))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_pipeline_matches_jax(tiny_params, n):
    frames = _frames(1, (8, 96, 128, 3))
    jparams = jax.tree.map(jnp.asarray, tiny_params)
    jmesh = jmake_mesh(n)
    want = jsharded_pipeline(jload_graph(TINY), jmesh, net_hw=(160, 160),
                             prob_thresh=0.2, top_k=32)(
        jshard_params(jparams, jmesh),
        jax.device_put(jnp.asarray(frames), jbatch_sharding(jmesh, 4)))
    run = sharded_pipeline(load_graph(TINY), _mesh(n), net_hw=(160, 160),
                           prob_thresh=0.2, top_k=32)
    collectives.reset_counts()
    got = run(params_from_jax(tiny_params, "cpu"), frames)
    assert sum(collectives.counts.values()) == 0   # zero cross-shard traffic
    assert tuple(got.boxes.shape) == (8, 32, 4)
    _same_results(got, want)


def test_scanned_sharded_pipeline_matches_jax(tiny_params):
    """scan=2 on a 4-shard mesh: a (scan, B, ...) stack in, results with
    the same leading axes out."""
    stack = _frames(2, (2, 8, 96, 128, 3))
    jmesh = jmake_mesh(4)
    want = jsharded_pipeline(jload_graph(TINY), jmesh, net_hw=(160, 160),
                             prob_thresh=0.2, top_k=32, scan=2)(
        jshard_params(jax.tree.map(jnp.asarray, tiny_params), jmesh),
        jax.device_put(jnp.asarray(stack), NamedSharding(jmesh,
                                                         P(None, "data"))))
    got = sharded_pipeline(load_graph(TINY), _mesh(4), net_hw=(160, 160),
                           prob_thresh=0.2, top_k=32, scan=2)(
        params_from_jax(tiny_params, "cpu"), stack)
    assert tuple(got.boxes.shape) == (2, 8, 32, 4)
    _same_results(got, want)


@pytest.mark.parametrize("decode_impl", ["pallas", "pallas-fused", "xla"])
def test_batch_dp_equals_the_single_device_detector(decode_impl):
    """Each route on a 4-shard mesh, 6 frames (padded to 8): the replicas'
    merged results equal one Detector's on the same frames, bit for bit;
    the cached program equals the eager ``_run``; no collective runs."""
    kw = dict(prob_thresh=0.3, net_hw=(160, 160), decode_impl=decode_impl)
    det = Detector(_net(), mesh=_mesh(4), **kw)
    frames = _frames(2, (6, 96, 128, 3))
    collectives.reset_counts()
    got = det.detect_batch(frames)
    assert sum(collectives.counts.values()) == 0
    assert len(got) == 6 and det.route == decode_impl
    _identical(got, _in_chunks(Detector(_net(), **kw).detect_batch, frames, 2))
    padded, _ = det._pad_batch(frames)
    assert padded.shape[0] == 8
    eager = det._run(det._stage(padded)).cpu()
    packed, _, _ = det._detect(frames, (96, 128), None)
    assert torch.equal(eager, packed)
    (key,) = det._pipelines
    assert key[0] == 8 and key[-1] == det.mesh
    assert len(det._pipelines[key].replicas) == 4


@pytest.mark.parametrize("decode_impl", ["pallas", "pallas-fused"])
def test_int8_on_mesh(decode_impl):
    """A quantized net on a mesh (int8 carrier, K1 or K4 decode): every
    replica runs the int8 walk on its shard's qparams and operands, equal
    to the single-device Detector at the replica's batch bit for bit."""
    calib = _frames(3, (8, 240, 320, 3))

    def make(mesh):
        net = _net(5)
        net.quantize_int8(calib, net_hw=(160, 160))
        return Detector(net, prob_thresh=0.3, net_hw=(160, 160), mesh=mesh,
                        decode_impl=decode_impl)

    det_m, det_1 = make(_mesh(4)), make(None)
    frames = _frames(4, (4, 240, 320, 3))
    _identical(det_m.detect_batch(frames),
               _in_chunks(det_1.detect_batch, frames, 1))
    params, qparams, operands = det_m._replicas()
    net = det_m.net
    # shards on the net's device share its weights, state and operands
    assert all(q is net.qparams for q in qparams)
    assert all(o is net.qoperands for o in operands)
    assert all(p is net.params for p in params)


def test_new_weights_on_a_mesh_make_new_replicas():
    """``set_params`` after a mesh call: the next call copies the new
    weights to the shards and runs a new program, equal to a fresh
    Detector's."""
    kw = dict(prob_thresh=0.3, net_hw=(160, 160))
    det = Detector(_net(0), mesh=_mesh(2), **kw)
    frames = _frames(3, (2, 96, 128, 3))
    det.detect_batch(frames)
    old = det._replicas()[0][0]
    det.net.set_params(fold_raw(random_raw(det.net.graph, seed=1)))
    got = det.detect_batch(frames)
    assert det._replicas()[0][0] is det.net.params is not old
    assert len(det._pipelines) == 2
    _identical(got, _in_chunks(Detector(_net(1), **kw).detect_batch, frames, 1))


def test_replica_caches_live_on_their_replica_device():
    """Every lazy cache a replica's program reads is keyed by, or lives on,
    that replica's device: the interpolation matrices, the int8 operands
    (built from the replica's own qparams) and the decode's anchors."""
    from yolov3_tpu_torch.ops.decode import _ANCHOR_WH

    net = _net(5)
    net.quantize_int8(_frames(3, (4, 240, 320, 3)), net_hw=(160, 160))
    det = Detector(net, prob_thresh=0.3, net_hw=(160, 160), mesh=_mesh(2),
                   decode_impl="xla")
    det.detect_batch(_frames(4, (2, 240, 320, 3)))
    run = det._sharded(det.bgr)
    params, qparams, operands = det._replicas()
    for r, d in enumerate(det.mesh.devices):
        run.replica(qparams[r], d, operands[r])(
            torch.from_numpy(_frames(5, (1, 240, 320, 3))).to(d))
        assert operands[r].qparams is qparams[r]
        leaves = [t for tree in (params[r], qparams[r]) for p in tree.values()
                  for t in p.values()]
        leaves += [t for op in operands[r]._conv.values() for t in op.values()
                   if isinstance(t, torch.Tensor)]
        assert leaves and all(t.device == d for t in leaves)
    for d, cache in run._interp.items():
        assert cache.device == d and cache
        assert all(m.device == d for mats in cache.values() for m in mats)
    assert all(key[2] == CPU for key in _ANCHOR_WH)


def test_mesh_mixed_preletterboxed_and_pipelined_pad_paths():
    """detect_preletterboxed / detect_mixed / PipelinedDetector on an
    8-shard mesh pad a batch of 3 and equal the single-device Detector."""
    kw = dict(prob_thresh=0.3, net_hw=(160, 160))
    det, one = Detector(_net(6), mesh=_mesh(8), **kw), Detector(_net(6), **kw)
    canvases = _frames(4, (3, 160, 160, 3))
    _identical(det.detect_preletterboxed(canvases, [(240, 320)] * 3),
               _in_chunks(lambda c: one.detect_preletterboxed(c, [(240, 320)]),
                          canvases, 1))
    rng = np.random.default_rng(4)
    mixed = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
             for h, w in [(240, 320), (120, 200), (160, 160)]]
    _identical(det.detect_mixed(mixed), _in_chunks(one.detect_mixed, mixed, 1))
    if tnative.available():
        assert det.last_stage_s["preprocess_s"] >= 0
    pipe = PipelinedDetector(det, depth=1)
    batches = [_frames(s, (3, 240, 320, 3)) for s in (7, 8)]
    done = pipe.submit(batches[0]) + pipe.submit(batches[1]) + pipe.flush()
    assert len(done) == 2
    for got, frames in zip(done, batches):
        _identical(got, _in_chunks(one.detect_batch, frames, 1))


def test_scan_on_mesh():
    """scan=2 on a 4-shard mesh: 10 frames padded to 16 (scan x mesh),
    each replica's sub-batches in one program, merged back in submission
    order."""
    kw = dict(prob_thresh=0.3, net_hw=(160, 160))
    det = Detector(_net(), mesh=_mesh(4), scan=2, **kw)
    frames = _frames(6, (10, 96, 128, 3))
    got = det.detect_batch(frames)
    assert len(got) == 10 and det._pad_batch(frames)[0].shape[0] == 16
    _identical(got, _in_chunks(Detector(_net(), **kw).detect_batch, frames, 2))


def test_detect_in_video_on_mesh(tmp_path):
    import cv2

    vid = tmp_path / "in.avi"
    w = cv2.VideoWriter(str(vid), cv2.VideoWriter_fourcc(*"MJPG"), 10.0,
                        (128, 96))
    for i in range(5):
        w.write(_frames(i, (96, 128, 3)))
    w.release()
    det = Detector(_net(), prob_thresh=0.3, mesh=_mesh(4), net_hw=(160, 160))
    assert detect_in_video(det, str(vid), show=False, frame_batch=1) == 5
    assert {k[0] for k in det._pipelines} == {4}   # one frame padded to 4


def test_serve_devices_round_trip(tmp_path, monkeypatch):
    """``serve --devices 2 --device cpu``: a batch-DP Detector behind the
    micro-batcher (a batch of 3: the request and two copies, padded by the
    Detector to 4), one request's detections equal to a single-device
    Detector's at the replica's batch of 2."""
    import cv2

    net = _net(33)
    wpath = tmp_path / "t.weights"
    write_weights(wpath, net.graph, random_raw(net.graph, seed=33))
    img = _frames(9, (240, 320, 3))
    ok, png = cv2.imencode(".png", img)
    assert ok
    seen = {}
    real_serve = tserve.serve

    def serve(detector, names, host, port, warmup, **kw):
        srv = real_serve(detector, names, "127.0.0.1", 0, warmup, **kw)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.server_address[1]}/detect",
                data=png.tobytes(), method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                seen["reply"] = (r.status, json.loads(r.read()))
        finally:
            tserve.shutdown_gracefully(srv)
            thread.join(timeout=10)
        seen["detector"] = detector

        class Served:
            def serve_forever(self):
                pass

        return Served()

    drained = threading.Event()
    drained.set()
    monkeypatch.setattr(tserve, "serve", serve)
    monkeypatch.setattr(tserve, "install_graceful_shutdown",
                        lambda server: drained)
    with contextlib.redirect_stdout(io.StringIO()):
        tserve.main(["--weights", str(wpath), "--config", TINY, "--device",
                     "cpu", "--devices", "2", "--net-size", "160",
                     "--precision", "highest",
                     "--prob-thresh", "0.3", "--warmup-hw", "240x320",
                     "--batch-window", "5", "--max-batch", "3"])
    det = seen["detector"]
    assert det.mesh.size == 2 and det.partition == "data"
    assert {k[0] for k in det._pipelines} == {4}
    status, body = seen["reply"]
    assert status == 200
    one = Darknet(TINY, "highest", device="cpu").load_weights(wpath)
    want = Detector(one, prob_thresh=0.3,
                    net_hw=(160, 160)).detect_mixed([img, img])[0]
    assert len(body["detections"]) == len(want.class_idx) > 0
    for d, cls, s, box in zip(body["detections"], want.class_idx,
                              want.class_prob, want.bbox_tlbr):
        assert (d["class_id"], d["score"]) == (cls, round(float(s), 4))
        assert d["bbox_tlbr"] == [round(float(v), 2) for v in box]


def test_dryrun_multichip_prints_the_reference_survivors(capsys):
    """The dry run on 8 CPU shards prints what the reference's printed on
    its 8-device mesh (``MULTICHIP_r05.json``)."""
    dryrun_multichip(8, device="cpu")
    want = json.loads((Path(__file__).parent.parent
                       / "MULTICHIP_r05.json").read_text())["tail"]
    assert capsys.readouterr().out == want
