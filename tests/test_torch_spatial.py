"""The port's spatial partitioning (``yolov3_tpu_torch/parallel/spatial.py``)
on CPU shards against the JAX package's on the 8 virtual CPU devices of
``tests/conftest.py``, on the inputs of ``tests/test_spatial.py``: the
planner equal to the reference's on every shipped cfg, size and mesh; the
halo conv and pool exact against the full-map ops; the banded walk and the
row-sharded pipeline within the reference's bars; the collectives a call
issues; the spatial ``Detector``, its refusals, and ``--spatial N`` on the
command line."""
import contextlib
import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

from yolov3_tpu.__main__ import main as jmain
from yolov3_tpu.graph import Node as JNode
from yolov3_tpu.graph import load_graph as jload_graph
from yolov3_tpu.model import forward_features as jforward_features
from yolov3_tpu.parallel.sharding import shard_map
from yolov3_tpu.parallel.spatial import SPACE_AXIS as JSPACE_AXIS
from yolov3_tpu.parallel.spatial import _node_feasible as j_node_feasible
from yolov3_tpu.parallel.spatial import \
    forward_features_spatial as jforward_features_spatial
from yolov3_tpu.parallel.spatial import make_spatial_mesh as jmake_spatial_mesh
from yolov3_tpu.parallel.spatial import plan_spatial as jplan_spatial
from yolov3_tpu.parallel.spatial import spatial_pipeline as jspatial_pipeline
from yolov3_tpu_torch import Darknet, Detector
from yolov3_tpu_torch.__main__ import main
from yolov3_tpu_torch.graph import Node, load_graph
from yolov3_tpu_torch.model import _conv, _maxpool, forward_features
from yolov3_tpu_torch.parallel import collectives
from yolov3_tpu_torch.parallel.sharding import make_mesh, shard_params
from yolov3_tpu_torch.parallel.spatial import (_conv_sharded,
                                               _maxpool_sharded,
                                               _node_feasible,
                                               forward_features_spatial,
                                               make_spatial_mesh,
                                               plan_spatial, spatial_pipeline)
from yolov3_tpu_torch.weights import (fold_raw, params_from_jax, random_raw,
                                      write_weights)

torch.set_num_threads(1)

MODELS = Path(__file__).parent.parent / "models"
CFGS = {"yolov3": MODELS / "yolov3.cfg", "tiny": MODELS / "yolov3-tiny.cfg",
        "spp": MODELS / "yolov3-spp.cfg"}
TINY = str(CFGS["tiny"])
CPU = torch.device("cpu")


def _mesh(n):
    return make_spatial_mesh(n, devices=[CPU] * n)


def _bands(x, n):
    """The rows of x (B, H, ...) as n bands, shard order."""
    h = x.shape[1] // n
    return [x[:, i * h:(i + 1) * h] for i in range(n)]


def _net(seed, **kw):
    net = Darknet(TINY, device="cpu", **kw)
    return net.set_params(fold_raw(random_raw(net.graph, seed=seed)))


@pytest.mark.parametrize("cfg,size,n", [
    (cfg, size, n) for cfg in CFGS for size in (160, 320, 416, 608)
    for n in (2, 4, 8)])
def test_plan_equals_the_reference(cfg, size, n):
    """Crossover, both FLOP fractions and the channel roles, exactly."""
    want = jplan_spatial(jload_graph(CFGS[cfg]), n, (size, size))
    got = plan_spatial(load_graph(CFGS[cfg]), n, (size, size))
    assert (got.n_shards, got.crossover, got.sharded_flop_frac, got.roles,
            got.total_sharded_flop_frac) == (
        want.n_shards, want.crossover, want.sharded_flop_frac, want.roles,
        want.total_sharded_flop_frac)


@pytest.mark.parametrize("kw,h_in,n,want", [
    # the reference's pair: darknet's size-2 pool (lo = 0) bands, a
    # low-padded stride == size pool does not
    (dict(kind="maxpool", out_channels=4, downsample=2, size=2, stride=2,
          padding=1), 32, 4, True),
    (dict(kind="maxpool", out_channels=4, downsample=4, size=4, stride=4,
          padding=3), 32, 4, False),
    (dict(kind="maxpool", out_channels=4, downsample=1, size=3, stride=1,
          padding=2), 8, 4, True),
    (dict(kind="convolutional", out_channels=8, downsample=1, filters=8,
          size=3, stride=1, pad=1), 4, 4, True),
    (dict(kind="convolutional", out_channels=8, downsample=2, filters=8,
          size=3, stride=2, pad=1), 12, 4, False),   # odd band
    (dict(kind="convolutional", out_channels=8, downsample=1, filters=8,
          size=3, stride=1, pad=0), 32, 4, False),   # unpadded
    (dict(kind="convolutional", out_channels=8, downsample=1, filters=8,
          size=1, stride=1), 6, 4, False),           # rows do not divide
    (dict(kind="yolo", out_channels=255, downsample=32), 32, 4, False),
    (dict(kind="route", out_channels=8, downsample=1), 32, 4, True),
])
def test_node_feasibility(kw, h_in, n, want):
    assert _node_feasible(Node(index=0, inputs=(-1,), **kw), h_in, n) is want
    assert j_node_feasible(JNode(index=0, inputs=(-1,), **kw), h_in, n) is want


def test_plan_rejects_bad_configs():
    g = load_graph(CFGS["yolov3"])
    with pytest.raises(ValueError, match="not divisible"):
        plan_spatial(g, 5, (608, 608))
    with pytest.raises(ValueError, match=">= 2 devices"):
        plan_spatial(g, 1, (608, 608))
    with pytest.raises(ValueError, match="unknown tail"):
        spatial_pipeline(g, _mesh(2), (608, 608), tail="rows")


@pytest.mark.parametrize("stride", [1, 2])
def test_halo_conv_exact(stride):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 32, 16, 4)).astype(
        np.float32)).permute(0, 3, 1, 2)
    w = torch.from_numpy((rng.standard_normal((3, 3, 4, 8)) * 0.1).astype(
        np.float32)).permute(3, 2, 0, 1).contiguous()
    b = torch.from_numpy((rng.standard_normal((8,)) * 0.1).astype(np.float32))
    node = Node(index=0, kind="convolutional", inputs=(-1,), out_channels=8,
                downsample=stride, filters=8, size=3, stride=stride, pad=1,
                activation="leaky")
    bands = [t.permute(0, 3, 1, 2) for t in _bands(x.permute(0, 2, 3, 1), 4)]
    collectives.reset_counts()
    out = torch.cat(_conv_sharded(bands, [w] * 4, [b] * 4, node, 4), 2)
    assert torch.equal(out, _conv(x, w, b, node))
    assert collectives.counts["rows_from_above"] == 1
    assert collectives.counts["rows_from_below"] == (stride == 1)


@pytest.mark.parametrize("size,stride,padding", [(2, 1, 1), (2, 2, 1),
                                                 (3, 1, 2)])
def test_halo_maxpool_exact(size, stride, padding):
    # negative values: the -inf edge fill must beat the exchange's zeros
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal((2, 16, 8, 4)) - 2.0).astype(
        np.float32)).permute(0, 3, 1, 2)
    node = Node(index=0, kind="maxpool", inputs=(-1,), out_channels=4,
                downsample=stride, size=size, stride=stride, padding=padding)
    bands = [t.permute(0, 3, 1, 2) for t in _bands(x.permute(0, 2, 3, 1), 4)]
    out = torch.cat(_maxpool_sharded(bands, node, 4), 2)
    assert torch.equal(out, _maxpool(x, node))


def _jax_banded(g, params, x, n, plan, roles):
    """The reference's banded walk under shard_map (tests/test_spatial.py)."""
    local_h = x.shape[1] // n

    def body(params, x):
        row0 = lax.axis_index(JSPACE_AXIS) * local_h
        xl = lax.dynamic_slice_in_dim(x, row0, local_h, axis=1)
        return tuple(jforward_features_spatial(
            g, params, xl, n_shards=n, crossover=plan.crossover,
            precision="highest", channel_roles=roles))

    return shard_map(body, mesh=jmake_spatial_mesh(n), in_specs=(P(), P()),
                     out_specs=P(), check_rep=False)(params, x)


@pytest.mark.parametrize("cfg,n,tail", [("tiny", 4, "replicated"),
                                        ("tiny", 4, "channel"),
                                        ("yolov3", 2, "channel")])
def test_banded_features(cfg, n, tail):
    """Head maps of the banded walk (halo convs, the crossover gather,
    route / shortcut sources fetched across it, the channel-pair tail)
    against the port's full walk and the JAX package's walk, at the
    reference's bars. The JAX side is its banded walk for tiny and its
    full walk for yolov3 (the banded form of which takes the reference's
    own test 90 s to compile)."""
    g = load_graph(CFGS[cfg])
    np_params = fold_raw(random_raw(g, seed=2))
    x = np.random.default_rng(3).random((1, 160, 160, 3)).astype(np.float32)
    mesh = _mesh(n)
    plan = plan_spatial(g, n, (160, 160))
    assert 0 < plan.crossover < len(g.nodes)
    roles = dict(plan.roles) if tail == "channel" else None
    params = params_from_jax(np_params, "cpu")
    xt = torch.from_numpy(x)
    heads = forward_features_spatial(
        g, shard_params(params, mesh), _bands(xt, n), n_shards=n,
        crossover=plan.crossover, precision="highest", channel_roles=roles)
    full = forward_features(g, params, xt, precision="highest")
    jparams = jax.tree.map(jnp.asarray, np_params)
    if cfg == "tiny":
        ref = _jax_banded(jload_graph(CFGS[cfg]), jparams, jnp.asarray(x), n,
                          plan, roles)
    else:
        ref = jforward_features(jload_graph(CFGS[cfg]), jparams,
                                jnp.asarray(x), precision="highest")
    assert len(heads) == len(full) == len(ref)
    for h, f, r in zip(heads, full, ref):
        np.testing.assert_allclose(h.numpy(), f.numpy(), atol=2e-4, rtol=1e-4)
        np.testing.assert_allclose(h.numpy(), np.asarray(r), atol=2e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("n,tail", [(2, "channel"), (4, "channel"),
                                    (4, "replicated"), (8, "channel")])
def test_spatial_pipeline_matches_jax(n, tail):
    """The row-sharded pipeline (K1c's plain version, K2's) against the
    JAX package's on its n-device mesh: valid and classes exact, boxes
    within 1e-3, scores within 1e-4."""
    np_params = fold_raw(random_raw(load_graph(TINY), seed=4))
    frames = np.random.default_rng(5).integers(0, 256, (2, 96, 128, 3),
                                               dtype=np.uint8)
    kw = dict(net_hw=(160, 160), prob_thresh=0.2, top_k=32,
              precision="highest", tail=tail)
    want = jspatial_pipeline(jload_graph(TINY), jmake_spatial_mesh(n), **kw)(
        jax.tree.map(jnp.asarray, np_params), jnp.asarray(frames))
    got = spatial_pipeline(load_graph(TINY), _mesh(n), **kw)(
        params_from_jax(np_params, "cpu"), frames)
    valid = np.asarray(want.valid)
    assert valid.any() and tuple(got.boxes.shape) == (2, 32, 4)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("tail", ["channel", "replicated"])
def test_collectives_a_call(tail):
    """The reference's collective schedule, counted per call: halos by
    neighbour exchange, 1 to 6 gathers (the crossover and route sources
    crossing it), one psum per planned row conv on the channel tail and
    none on the replicated one."""
    g = load_graph(TINY)
    plan = plan_spatial(g, 4, (160, 160))
    n_rows = sum(1 for _, role in plan.roles if role == "row")
    run = spatial_pipeline(g, _mesh(4), (160, 160), top_k=16, tail=tail)
    params = params_from_jax(fold_raw(random_raw(g, seed=4)), "cpu")
    collectives.reset_counts()
    run(params, np.zeros((1, 96, 128, 3), np.uint8))
    counts = collectives.counts
    assert counts["rows_from_above"] >= 1 and counts["rows_from_below"] >= 1
    assert 1 <= counts["all_gather"] <= 6
    assert n_rows >= 1
    assert counts["psum"] == (n_rows if tail == "channel" else 0)


@pytest.fixture(scope="module")
def tiny_weights(tmp_path_factory):
    path = tmp_path_factory.mktemp("spatial") / "t.weights"
    g = load_graph(TINY)
    write_weights(path, g, random_raw(g, seed=7))
    return path


def test_detector_spatial_partition(tiny_weights):
    """Detector(mesh=make_spatial_mesh(4), partition="spatial") on 3
    frames (no divisibility demand) against the single-device Detector and
    the JAX package's spatial Detector: counts and classes exact, boxes
    within 1e-3; the cached program equal to the eager ``_run``."""
    from yolov3_tpu.inference import Detector as JDetector
    from yolov3_tpu.model import Darknet as JDarknet

    kw = dict(prob_thresh=0.3, net_hw=(160, 160))
    det = Detector(Darknet(TINY, device="cpu").load_weights(tiny_weights),
                   mesh=_mesh(4), partition="spatial", **kw)
    one = Detector(Darknet(TINY, device="cpu").load_weights(tiny_weights),
                   **kw)
    jdet = JDetector(JDarknet(TINY).load_weights(tiny_weights),
                     mesh=jmake_spatial_mesh(4), partition="spatial", **kw)
    frames = np.random.default_rng(8).integers(0, 256, (3, 96, 128, 3),
                                               dtype=np.uint8)
    got = det.detect_batch(frames)
    assert len(got) == 3 and sum(len(d.class_idx) for d in got) > 0
    for want in (one.detect_batch(frames), jdet.detect_batch(frames)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.class_idx, b.class_idx)
            np.testing.assert_allclose(a.bbox_tlbr, b.bbox_tlbr, atol=1e-3)
    eager = det._run(det._stage(frames)).cpu()
    packed, _, _ = det._detect(frames, (96, 128), None)
    assert torch.equal(eager, packed)
    (key,) = det._pipelines
    assert key[0] == 3 and key[-1] == det.mesh


def test_detector_spatial_route_gates(caplog):
    """On a spatial mesh the head-fused decode runs "pallas" (the reference
    shards the head convs), with its warning; K5 convs run on F.conv2d."""
    det = Detector(_net(7, conv_impl="pallas"), prob_thresh=0.3,
                   net_hw=(160, 160), mesh=_mesh(2), partition="spatial",
                   decode_impl="pallas-fused")
    with caplog.at_level("WARNING", logger="yolov3_tpu_torch"):
        det.detect_batch(np.zeros((1, 96, 128, 3), np.uint8))
    assert det.route == "pallas"
    text = caplog.text
    assert "not applicable here (spatial)" in text
    assert "does not support conv_impl='pallas'" in text


def test_detector_spatial_rejects_bad_configs():
    net = _net(7)
    with pytest.raises(ValueError, match="make_spatial_mesh"):
        Detector(net, mesh=make_mesh(4, devices=[CPU] * 4),
                 partition="spatial")
    with pytest.raises(ValueError, match="unknown partition"):
        Detector(net, mesh=_mesh(4), partition="pipeline")
    det = Detector(net, mesh=_mesh(4), partition="spatial",
                   net_hw=(160, 160))
    calib = np.random.default_rng(9).integers(0, 256, (8, 96, 128, 3),
                                              dtype=np.uint8)
    net.quantize_int8(calib, net_hw=(160, 160))
    with pytest.raises(ValueError, match="out of scope"):
        Detector(net, mesh=_mesh(4), partition="spatial")
    with pytest.raises(ValueError, match="out of scope"):  # quantized after
        det.detect_batch(calib[:1])
    with pytest.raises(RuntimeError, match="needs loaded weights"):
        Detector(Darknet(TINY, device="cpu"), mesh=_mesh(2),
                 partition="spatial")


def test_cli_spatial_json_equals_the_jax_cli(tmp_path, tiny_weights):
    """``--spatial 2 --device cpu`` writes the COCO JSON the JAX CLI's
    ``--spatial 2`` writes (precision "highest", the golden bars)."""
    import cv2

    img = tmp_path / "img.png"
    assert cv2.imwrite(str(img), np.random.default_rng(10).integers(
        0, 256, (120, 160, 3), dtype=np.uint8))
    argv = ["--config", TINY, "--weights", str(tiny_weights), "--no-show",
            "--precision", "highest", "--net-size", "160", "--prob-thresh",
            "0.3", "--no-compile-cache", "--image", str(img), "--spatial",
            "2", "--save-json"]
    with contextlib.redirect_stdout(io.StringIO()):
        assert jmain(argv + [str(tmp_path / "j.json")]) == 0
        assert main(argv + [str(tmp_path / "t.json"), "--device", "cpu"]) == 0
    got = json.loads((tmp_path / "t.json").read_text())
    want = json.loads((tmp_path / "j.json").read_text())
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g["image_id"], g["category_id"]) == (w["image_id"],
                                                     w["category_id"])
        assert abs(g["score"] - w["score"]) <= 5e-5 + 1e-5
        np.testing.assert_allclose(g["bbox"], w["bbox"], atol=0.1 + 0.01)
