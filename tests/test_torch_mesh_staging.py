"""Staging a batch-DP call (``inference._MeshProgram``: every replica's
slice staged, then every replica queued) on CPU shards: ten consecutive
mesh calls on distinct frames, each bit-equal to the single-device
Detector at each replica's batch and within the reference's bars of the
JAX package's mesh Detector (on the virtual CPU devices of
``tests/conftest.py``), at ``scan`` 1 and 2; a padded batch; the caller's
array overwritten as soon as a call or a submission returns;
``PipelinedDetector`` on a mesh; each replica's slice contiguous and equal
to the reference's shard of the batch; the stage split's keys; and
``tools.bench_mesh``'s checks."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from yolov3_tpu.inference import Detector as JDetector
from yolov3_tpu.model import Darknet as JDarknet
from yolov3_tpu.parallel.sharding import make_mesh as jmake_mesh
from yolov3_tpu_torch import Darknet, Detector
from yolov3_tpu_torch.inference import PipelinedDetector, _Shards
from yolov3_tpu_torch.parallel.sharding import make_mesh, split_batch
from yolov3_tpu_torch.tools import bench_mesh
from yolov3_tpu_torch.weights import fold_raw, random_raw

torch.set_num_threads(1)

TINY = str(Path(__file__).parent.parent / "models" / "yolov3-tiny.cfg")
CPU = torch.device("cpu")
KW = dict(prob_thresh=0.3, net_hw=(160, 160))
SRC = (96, 128)


def _frames(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _params():
    return fold_raw(random_raw(Darknet(TINY, device="cpu").graph, seed=0))


def _net(params):
    return Darknet(TINY, precision="highest", device="cpu").set_params(params)


def _mesh(n):
    return make_mesh(n, devices=[CPU] * n)


def _identical(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.class_idx, w.class_idx)
        np.testing.assert_array_equal(g.class_prob, w.class_prob)
        np.testing.assert_array_equal(g.bbox_tlbr, w.bbox_tlbr)


def _in_chunks(detect, frames, b):
    out = []
    for i in range(0, len(frames), b):
        out += detect(frames[i:i + b])
    return out


def _within_reference_bars(got, want):
    """The reference's Detector bars: counts and classes exact, scores
    within 5e-5, boxes within 0.1 px."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.class_idx, w.class_idx)
        np.testing.assert_allclose(g.class_prob, w.class_prob, atol=5e-5)
        np.testing.assert_allclose(g.bbox_tlbr, w.bbox_tlbr, atol=0.1)


@pytest.mark.parametrize("scan", [1, 2])
def test_ten_mesh_calls_equal_one_device_and_the_jax_mesh(scan):
    """Ten consecutive calls of a 2-shard mesh on distinct frames, all from
    ONE caller array that is overwritten as soon as each call returns: each
    call bit-equal to one device at each replica's batch (B/n, or its
    sub-batches of B/(scan·n)), the first and the last within the
    reference's bars of the JAX mesh Detector on the same frames."""
    params = _params()
    det = Detector(_net(params), mesh=_mesh(2), scan=scan, **KW)
    one = Detector(_net(params), **KW)
    jdet = JDetector(JDarknet(TINY, precision="highest").set_params(params),
                     mesh=jmake_mesh(2), scan=scan, **KW)
    b = 4 // (2 * scan)
    buf = np.empty((4, *SRC, 3), np.uint8)
    found = 0
    for i in range(10):
        buf[...] = _frames(100 + i, buf.shape)
        frames = buf.copy()
        got = det.detect_batch(buf)
        buf[...] = 255 - buf      # the caller reuses its array at once
        _identical(got, _in_chunks(one.detect_batch, frames, b))
        if i in (0, 9):
            _within_reference_bars(got, jdet.detect_batch(frames))
        found += sum(len(d.class_idx) for d in got)
    assert found > 0
    (key,) = det._pipelines
    assert len(det._pipelines[key].replicas) == 2


def test_padded_batch_on_a_mesh():
    """B=7 on 2 shards pads to 8 with a zero frame: replica 1 runs frames
    4-6 and the pad, equal to one device on the same 4 frames, three calls
    in a row; the pad's results are dropped."""
    params = _params()
    det = Detector(_net(params), mesh=_mesh(2), **KW)
    one = Detector(_net(params), **KW)
    for seed in (20, 21, 22):
        frames = _frames(seed, (7, *SRC, 3))
        padded, n_real = det._pad_batch(frames)
        assert padded.shape[0] == 8 and n_real == 7
        got = det.detect_batch(frames)
        assert len(got) == 7
        _identical(got, (one.detect_batch(padded[:4])
                         + one.detect_batch(padded[4:])[:3]))
    assert {k[0] for k in det._pipelines} == {8}


def test_pipelined_detector_on_a_mesh_equals_the_synchronous_calls():
    """``PipelinedDetector(depth=2)`` on a 2-shard mesh, fed from ONE array
    that the caller overwrites as soon as each ``submit`` returns: the
    results come back in submission order, ``depth`` submissions later,
    and equal the synchronous mesh calls on the same frames."""
    params = _params()
    det = Detector(_net(params), mesh=_mesh(2), **KW)
    sync = Detector(_net(params), mesh=_mesh(2), **KW)
    batches = [_frames(30 + i, (4, *SRC, 3)) for i in range(5)]
    want = [sync.detect_batch(f) for f in batches]
    pipe = PipelinedDetector(det, depth=2)
    buf = np.empty_like(batches[0])
    done = []
    for i, frames in enumerate(batches):
        buf[...] = frames
        back = pipe.submit(buf)
        buf[...] = 0
        assert len(back) == (1 if i >= 2 else 0)
        done += back
        assert len(pipe._inflight) <= 2
    done += pipe.flush()
    assert len(done) == len(want)
    for got, w in zip(done, want):
        _identical(got, w)


@pytest.mark.parametrize("n,scan,b", [(4, 1, 2), (4, 2, 2), (4, 2, 1),
                                      (2, 2, 1)])
def test_replica_slices_are_contiguous_reference_shards(n, scan, b):
    """Each replica's slice as a mesh call stages it (``split_batch``),
    over three batches: contiguous, b = 1 under ``scan=2`` included (where
    the reshape alone is a strided view, which torch would gather on its
    intra-op threads before the copy to the card), equal to the
    reference's shard, a ``(scan, B/scan, ...)`` stack placed over n
    devices on its second axis, and the same for a tensor batch."""
    jmesh = jmake_mesh(n)
    shape = (scan * n * b, 6, 10, 3)
    for seed in (40, 41, 42):
        frames = _frames(seed, shape)
        stack = frames.reshape(scan, n * b, *shape[1:])
        placed = jax.device_put(jnp.asarray(stack),
                                NamedSharding(jmesh, P(None, "data")))
        shards = sorted(placed.addressable_shards,
                        key=lambda s: s.index[1].start or 0)
        parts = split_batch(frames, n, scan)
        tensors = split_batch(torch.from_numpy(frames), n, scan)
        for part, tensor, shard in zip(parts, tensors, shards):
            assert part.shape == (scan * b, *shape[1:])
            assert part.flags.c_contiguous and tensor.is_contiguous()
            want = np.asarray(shard.data).reshape(part.shape)
            np.testing.assert_array_equal(part, want)
            np.testing.assert_array_equal(tensor.numpy(), want)


def test_stage_split_on_a_mesh():
    """A mesh call gives the stage keys a single-device call gives, each
    non-negative, and times each of its stages; the program stages one
    input a replica and returns one result a replica."""
    det = Detector(_net(_params()), mesh=_mesh(2), **KW)
    frames = _frames(50, (4, *SRC, 3))
    det.detect_batch(frames)
    stages = det.last_stage_s
    assert set(stages) == {"h2d_s", "dispatch_s", "device_fetch_s"}
    assert all(v >= 0 for v in stages.values())
    det.detect_preletterboxed(_frames(51, (4, 160, 160, 3)), [SRC] * 4)
    assert set(det.last_stage_s) == set(stages)
    _, _, st = det._detect(frames, SRC, None)
    assert list(st) == ["pad", "lookup", "stage", "launch", "fetch"]
    assert all(v >= 0 for v in st.values())
    prog = det._pipeline(4, SRC)
    staged = prog.stage(frames, det.device)
    assert [tuple(x.shape) for x in staged] == [(2, *SRC, 3)] * 2
    res = prog(staged)
    assert isinstance(res, _Shards) and len(res) == 2
    assert tuple(res.cpu().shape) == (4, det.max_results, 6)


def test_bench_mesh_checks_on_cpu_shards(capsys, monkeypatch):
    """``tools.bench_mesh --device cpu`` at tiny@96, B=4 of 60x80: every
    route's replicas held to one device at their batch, no time reported."""
    for name, value in (("CFG", "yolov3-tiny.cfg"), ("SIZE", 96),
                        ("BATCH", 4), ("SRC_HW", (60, 80))):
        monkeypatch.setattr(bench_mesh, name, value)
    out = bench_mesh.main(["--device", "cpu", "--calls", "2"])
    assert [r["route"] for r in out["rows"]] == list(bench_mesh.ROUTES)
    for row in out["rows"]:
        assert row["shards"] == 2
        assert row["replica_batch"] == 4 // (2 * row["scan"])
        assert row["call_ms_mesh"] is None and row["h2d_ms_one"] is None
    assert out["cards"] is None and out["size"] == 96
    one = bench_mesh.main(["--device", "cpu", "--calls", "1", "--route",
                           "scan=2 bf16 + K1"])
    assert [r["route"] for r in one["rows"]] == ["scan=2 bf16 + K1"]
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("{")
