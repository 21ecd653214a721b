"""K4, the head-conv-fused packed decode: its plain version against the JAX
package's Pallas kernel (interpret mode on the CPU), the route gate against
the JAX gate, the Detector's "pallas-fused" route against its "pallas"
route, the bf16 kernel's tile plan and the inputs its wrapper refuses."""
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu import model as jmodel
from yolov3_tpu.graph import load_graph as jload_graph
from yolov3_tpu.ops.pallas_decode import decode_packed_head_fused_pallas
from yolov3_tpu_torch import Darknet, Detector, forward_packed_fused
from yolov3_tpu_torch import model as tmodel
from yolov3_tpu_torch.graph import load_graph
from yolov3_tpu_torch.ops import cuda_decode
from yolov3_tpu_torch.weights import fold_raw, params_from_jax, random_raw

torch.set_num_threads(1)

WIDE_CFG = str(Path(__file__).parent / "data" / "port_wide.cfg")
ANCHORS = ((10.0, 13.0), (33.0, 23.0), (116.0, 90.0))


def _assert_records_close(got, want):
    """The bars of the JAX package's fused-vs-unfused test: the two sides
    sum the head projection in different orders, so scores agree within
    atol 1e-5 / rtol 1e-4, boxes where both keep the candidate within
    5e-3 px, and the data-independent candidate lane exactly."""
    np.testing.assert_allclose(got[..., 4], want[..., 4], atol=1e-5, rtol=1e-4)
    m = (got[..., 4] > 0) & (want[..., 4] > 0)
    assert m.any()
    np.testing.assert_allclose(got[m][:, :4], want[m][:, :4], atol=5e-3,
                               rtol=1e-4)
    np.testing.assert_array_equal(got[..., 6], want[..., 6])


@pytest.mark.parametrize("cin,g", [(128, 4), (128, 8), (256, 4), (256, 8)])
def test_k4_plain_matches_pallas(cin, g):
    rng = np.random.default_rng(cin + g)
    x = rng.normal(0, 1, (2, g, g, cin)).astype(np.float32)
    w = rng.normal(0, 1 / np.sqrt(cin), (cin, 255)).astype(np.float32)
    bias = rng.normal(0, 0.1, 255).astype(np.float32)
    # the JAX kernel takes lane-padded (Cin, 256) weights; the port's are
    # the head conv's (Cout, Cin) with no padding
    w_pad = np.zeros((cin, 256), np.float32)
    w_pad[:, :255] = w
    b_pad = np.zeros(256, np.float32)
    b_pad[:255] = bias
    want_p, want_s = decode_packed_head_fused_pallas(
        jnp.asarray(x), jnp.asarray(w_pad), jnp.asarray(b_pad), ANCHORS, 32,
        80, prob_thresh=0.2, head_offset=7, precision="highest")
    got = cuda_decode.decode_packed_fused_head(
        torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(w.T)),
        torch.from_numpy(bias), ANCHORS, 32, 80, prob_thresh=0.2,
        head_offset=7)[:, 7:].numpy()
    want = np.asarray(want_p)
    assert got.shape == want.shape == (2, 3 * g * g, 8)
    np.testing.assert_array_equal(np.asarray(want_s), want[..., 4])
    _assert_records_close(got, want)


def test_forward_packed_fused_matches_jax():
    g = load_graph(WIDE_CFG)
    params_np = fold_raw(random_raw(g, seed=3))
    x = np.random.default_rng(8).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    jp = {k: {n: jnp.asarray(v) for n, v in p.items()} for k, p in params_np.items()}
    want_p, _ = jmodel.forward_packed_fused(jload_graph(WIDE_CFG), jp,
                                            jnp.asarray(x), prob_thresh=0.2,
                                            precision="highest")
    got_p, got_s = forward_packed_fused(g, params_from_jax(params_np, device="cpu"),
                                        torch.from_numpy(x), prob_thresh=0.2,
                                        precision="highest")
    assert torch.equal(got_s, got_p[..., 4])
    _assert_records_close(got_p.numpy(), np.asarray(want_p))


def _bad_activation(graph):
    """The JAX test's ineligible graph: a head conv with a leaky activation."""
    hc = graph.yolo_nodes[0].inputs[0]
    nodes = list(graph.nodes)
    nodes[hc] = dataclasses.replace(nodes[hc], activation="leaky")
    return dataclasses.replace(graph, nodes=tuple(nodes))


def test_fused_heads_eligible_matches_jax(cfg_paths):
    paths = dict(cfg_paths, port_wide=WIDE_CFG,
                 port_small=str(Path(WIDE_CFG).with_name("port_small.cfg")))
    want = {"yolov3": True, "yolov3-tiny": True, "yolov3-spp": True,
            "port_wide": True, "port_small": False}
    for name, path in paths.items():
        assert tmodel.fused_heads_eligible(load_graph(path)) == want[name], name
        assert jmodel.fused_heads_eligible(jload_graph(path)) == want[name], name
    tiny = cfg_paths["yolov3-tiny"]
    assert not tmodel.fused_heads_eligible(_bad_activation(load_graph(tiny)))
    assert not jmodel.fused_heads_eligible(_bad_activation(jload_graph(tiny)))


def test_detector_fused_route_matches_pallas_route(cfg_paths):
    """yolov3 at 128x128: "pallas-fused" (K4) against "pallas" (head conv
    then K1) — same counts and classes, scores and boxes within the fused
    projection's summation-order bars (the JAX package's e2e test)."""
    net = Darknet(cfg_paths["yolov3"], precision="highest", device="cpu")
    net.set_params(fold_raw(random_raw(net.graph, seed=13)))
    frames = np.random.default_rng(6).integers(0, 256, (2, 240, 320, 3),
                                               dtype=np.uint8)
    det_p = Detector(net, prob_thresh=0.3, net_hw=(128, 128), decode_impl="pallas")
    det_f = Detector(net, prob_thresh=0.3, net_hw=(128, 128),
                     decode_impl="pallas-fused")
    assert (det_p.route, det_f.route) == ("pallas", "pallas-fused")
    rp, rf = det_p.detect_batch(frames), det_f.detect_batch(frames)
    assert sum(len(a.class_prob) for a in rp) > 0
    for a, b in zip(rp, rf):
        assert len(a.class_prob) == len(b.class_prob)
        oa = np.argsort(-a.class_prob, kind="stable")
        ob = np.argsort(-b.class_prob, kind="stable")
        np.testing.assert_allclose(a.class_prob[oa], b.class_prob[ob],
                                   atol=1e-5, rtol=1e-4)
        np.testing.assert_array_equal(a.class_idx[oa], b.class_idx[ob])
        np.testing.assert_allclose(a.bbox_tlbr[oa], b.bbox_tlbr[ob],
                                   atol=5e-3, rtol=1e-3)


def test_detector_route_gates(caplog):
    """The JAX package's graph-shape gates, with its warning texts:
    "pallas-fused" on an ineligible graph runs "pallas"; more than 4 anchors
    per head runs "xla"."""
    from yolov3_tpu_torch.inference import decode_route

    small = load_graph(str(Path(WIDE_CFG).with_name("port_small.cfg")))
    with caplog.at_level("WARNING", logger="yolov3_tpu_torch"):
        assert decode_route(small, "pallas-fused") == "pallas"
    assert "head-fused decode not applicable here (graph shape)" in caplog.text
    wide = load_graph(WIDE_CFG)
    assert decode_route(wide, "pallas-fused") == "pallas-fused"
    yn = wide.yolo_nodes[0]
    five = dataclasses.replace(yn, anchors=yn.anchors + yn.anchors[:2])
    nodes = list(wide.nodes)
    nodes[yn.index] = five
    many = dataclasses.replace(wide, nodes=tuple(nodes))
    caplog.clear()
    with caplog.at_level("WARNING", logger="yolov3_tpu_torch"):
        assert decode_route(many, "pallas-fused") == "xla"
        assert decode_route(many, "pallas") == "xla"
    assert "pallas decode supports <=4 anchors/head" in caplog.text
    assert decode_route(many, "xla") == "xla"
    with pytest.raises(ValueError, match="decode_impl"):
        decode_route(wide, "triton")


def test_k4_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(1, 4, 4, 96)
    w, b = torch.zeros(24, 96), torch.zeros(24)
    with pytest.raises(ValueError, match="Cin % 128"):
        cuda_decode.decode_packed_fused_head(x, w, b, ANCHORS, 32, 3)
    x = torch.zeros(1, 4, 4, 128)
    with pytest.raises(ValueError, match="head weights"):
        cuda_decode.decode_packed_fused_head(x, w, b, ANCHORS, 32, 3)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        cuda_decode.decode_packed_fused_head(
            x.to("meta"), torch.zeros(24, 128), b, ANCHORS, 32, 3)
    with pytest.raises(ValueError, match="not eligible"):
        g = load_graph(str(Path(WIDE_CFG).with_name("port_small.cfg")))
        forward_packed_fused(g, {}, torch.zeros(1, 64, 64, 3), 0.1)


# (M = B·g², Cin) of yolov3's three heads at 416 and 608, batch 1 and 8
HEADS = {(size, bsz): [(bsz * (size // s) ** 2, cin)
                       for s, cin in ((32, 1024), (16, 512), (8, 256))]
         for size in (416, 608) for bsz in (1, 8)}


@pytest.mark.parametrize("size,bsz,want", [
    # (block_m, resident) per head, and the grid: ceil(M / block_m) x 3
    (416, 8, [((64, 1), 66), ((128, 1), 129), ((128, 2), 507)]),
    (416, 1, [((64, 1), 9), ((64, 1), 33), ((64, 2), 129)]),
    (608, 8, [((128, 1), 69), ((128, 1), 273), ((128, 2), 1083)]),
    (608, 1, [((64, 1), 18), ((64, 1), 69), ((128, 2), 138)]),
])
def test_k4_tile_plan(size, bsz, want):
    """plan_fused_tiles on an H100 (132 multiprocessors): 64-row tiles while
    each of them gets a multiprocessor, two resident blocks at Cin 256."""
    for (m, cin), ((block_m, resident), grid) in zip(HEADS[size, bsz], want):
        t = cuda_decode.plan_fused_tiles(m, 85, 3, cin, 132)
        assert (t.block_m, t.n_tile, t.resident) == (block_m, 96, resident)
        assert -(-m // t.block_m) * 3 == grid


@pytest.mark.parametrize("classes,n_tile", [
    (80, 96), (20, 32), (1, 32), (27, 32), (28, 64), (123, 128), (124, 192),
    (187, 192), (188, 256), (251, 256), (252, 256), (601, 256)])
def test_k4_tile_columns(classes, n_tile):
    """5 + C rounded up to a multiple of 32 (one warpgroup's N, at most
    128), above 128 to a multiple of 64 (two warpgroups, 64-row tiles, one
    resident block), at most 256 (above it the kernel runs pieces)."""
    t = cuda_decode.plan_fused_tiles(21632, 5 + classes, 3, 256, 132)
    assert t.n_tile == n_tile >= min(5 + classes, 256)
    if n_tile > 128:
        assert (t.block_m, t.resident) == (64, 1)
    else:  # two blocks' two-step rings fit 228 KB up to 128 + 96 rows
        assert (t.block_m, t.resident) == (128, 2 if n_tile <= 96 else 1)


@pytest.mark.parametrize("size,bsz", [(416, 8), (416, 1), (608, 8), (608, 1)])
def test_k4_tile_plan_float32(size, bsz):
    """At float32 (split TF32) the plan takes the bf16 kernel's tile rows
    and columns, and one resident block: the ring of split weights leaves
    no room for a second."""
    for m, cin in HEADS[size, bsz]:
        t16 = cuda_decode.plan_fused_tiles(m, 85, 3, cin, 132)
        t32 = cuda_decode.plan_fused_tiles(m, 85, 3, cin, 132, 4)
        assert (t32.block_m, t32.n_tile, t32.resident) == (t16.block_m,
                                                           t16.n_tile, 1)


def test_k4_check_float32_rows_on_16_bytes():
    """The float32 kernel reads channel rows in 16-byte pieces too: strides
    that are multiples of 4 elements and a 16-byte aligned base pass (a
    pixel stride of 260 floats is 1,040 bytes), a base 8 bytes in or a
    pixel stride of 258 is refused; 5 + C above 256 passes at float32 as
    at bf16 (the kernel runs it in pieces), rows off 16 bytes are refused
    at any class count."""
    wide = torch.zeros(2, 4, 4, 512)
    cuda_decode.check_fused_mma_input(wide[..., 128:384], 80, 3)
    cuda_decode.check_fused_mma_input(torch.zeros(2, 4, 4, 260)[..., :256],
                                      80, 3)
    for bad in (wide[..., 2:258], torch.zeros(2, 4, 4, 258)[..., :256],
                wide[..., ::2]):
        for classes in (80, 601):
            with pytest.raises(ValueError, match="16-byte pieces"):
                cuda_decode.check_fused_mma_input(bad, classes, 3)
    cuda_decode.check_fused_mma_input(wide, 252, 3)
    cuda_decode.check_fused_mma_input(wide, 601, 3)


def test_k4_plan_and_check_refuse_wide_anchors():
    """Any class count passes, as the route gate's does: 5 + C = 257 plans
    a 256-column tile of 64 rows (two pieces), 251, 252 and 601 classes
    pass the check; more than 64 anchors is still refused."""
    t = cuda_decode.plan_fused_tiles(1352, 257, 3, 1024, 132)
    assert (t.block_m, t.n_tile, t.resident) == (64, 256, 1)
    x = torch.zeros(1, 4, 4, 128, dtype=torch.bfloat16)
    for classes in (251, 252, 601):
        cuda_decode.check_fused_mma_input(x, classes, 3)
    for classes in (80, 601):
        with pytest.raises(ValueError, match="at most 64 anchors"):
            cuda_decode.check_fused_mma_input(x, classes, 65)


@pytest.mark.parametrize("elem_size", [2, 4])
@pytest.mark.parametrize("per,cin", [(257, 1024), (606, 128), (606, 256),
                                     (606, 1024), (1005, 512)])
def test_k4_plans_any_class_count_in_pieces(per, cin, elem_size):
    """Above 256 columns an anchor the plan takes the widest tile, 256
    columns of 64 rows and one resident block, at both operand types; the
    kernel runs ceil((5 + C) / 256) pieces of it. The check takes the 606
    columns of Open Images' 601 classes at both types and refuses more
    than 64 anchors."""
    for m in (16, 1352, 21632):
        t = cuda_decode.plan_fused_tiles(m, per, 3, cin, 132, elem_size)
        assert (t.block_m, t.n_tile, t.resident) == (64, 256, 1)
    dtype = torch.bfloat16 if elem_size == 2 else torch.float32
    x = torch.zeros(2, 4, 4, cin, dtype=dtype)
    cuda_decode.check_fused_mma_input(x, per - 5, 3)
    with pytest.raises(ValueError, match="at most 64 anchors"):
        cuda_decode.check_fused_mma_input(x, per - 5, 65)
    with pytest.raises(ValueError, match="16-byte pieces"):
        cuda_decode.check_fused_mma_input(
            torch.zeros(2, 4, 4, cin + 8, dtype=dtype)[..., 2:cin + 2],
            per - 5, 3)


OPEN_IMAGES = 601  # darknet's yolov3-openimages.cfg


def _open_images_head(rng, cin, tie_anchor=1, ties=(100, 400, 600)):
    """A 601-class head's weights (Cout, Cin) and bias, random but for one
    anchor whose classes ``ties`` have zero weights and the same large bias:
    their logits equal it exactly in any summation order, and every cell
    of that anchor has a tie for its max across the kernel's 256-column
    pieces (columns 105, 405, 605)."""
    per = 5 + OPEN_IMAGES
    w = rng.normal(0, 1 / np.sqrt(cin), (3 * per, cin)).astype(np.float32)
    bias = rng.normal(0, 0.1, 3 * per).astype(np.float32)
    for k in ties:
        w[tie_anchor * per + 5 + k] = 0.0
        bias[tie_anchor * per + 5 + k] = 8.0
    return w, bias


def test_k4_plain_matches_pallas_open_images():
    """K4's plain version on a 601-class head (5 + C = 606 columns an
    anchor) against the JAX kernel in interpret mode, Cin 128, a 4x4 map,
    B=2, with the bars of ``test_k4_plain_matches_pallas``; the class lane
    equal wherever the top two logits are further apart than 1e-4, and on
    the tied anchor the first of the tied classes."""
    rng = np.random.default_rng(601)
    cin, g, per = 128, 4, 5 + OPEN_IMAGES
    x = rng.normal(0, 1, (2, g, g, cin)).astype(np.float32)
    w, bias = _open_images_head(rng, cin)
    c_pad = -(-3 * per // 128) * 128
    w_pad = np.zeros((cin, c_pad), np.float32)
    w_pad[:, :3 * per] = w.T
    b_pad = np.zeros(c_pad, np.float32)
    b_pad[:3 * per] = bias
    want_p, want_s = decode_packed_head_fused_pallas(
        jnp.asarray(x), jnp.asarray(w_pad), jnp.asarray(b_pad), ANCHORS, 32,
        OPEN_IMAGES, prob_thresh=0.2, head_offset=5, precision="highest")
    got = cuda_decode.decode_packed_fused_head(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
        ANCHORS, 32, OPEN_IMAGES, prob_thresh=0.2, head_offset=5)[:, 5:].numpy()
    want = np.asarray(want_p)
    assert got.shape == want.shape == (2, 3 * g * g, 8)
    np.testing.assert_array_equal(np.asarray(want_s), want[..., 4])
    _assert_records_close(got, want)
    # the class lane where the top two logits stand apart
    logits = (x.reshape(-1, cin).astype(np.float64) @ w.T.astype(np.float64)
              + bias).reshape(2, g * g, 3, per)[..., 5:]
    top2 = np.sort(logits, axis=-1)[..., -2:]
    apart = (top2[..., 1] - top2[..., 0] > 1e-4).transpose(0, 2, 1).reshape(
        2, 3 * g * g)
    assert apart.sum() >= 2 * 2 * g * g  # the two untied anchors
    np.testing.assert_array_equal(got[..., 5][apart], want[..., 5][apart])
    tied = slice(g * g, 2 * g * g)  # anchor 1's records
    np.testing.assert_array_equal(got[:, tied, 5], 100.0)
    np.testing.assert_array_equal(want[:, tied, 5], 100.0)


def test_k4_check_refuses_rows_off_16_bytes():
    """The bf16 kernel reads channel rows in 16-byte pieces: a channel
    slice that starts on the grid passes, one 8 bytes in, a pixel stride of
    260 elements or a channel stride other than 1 is refused."""
    wide = torch.zeros(2, 4, 4, 512, dtype=torch.bfloat16)
    cuda_decode.check_fused_mma_input(wide[..., 128:384], 80, 3)
    cuda_decode.check_fused_mma_input(wide[:, 1:], 80, 3)
    odd = torch.zeros(2, 4, 4, 260, dtype=torch.bfloat16)
    for bad in (wide[..., 4:260], odd[..., :256], wide[..., ::2]):
        with pytest.raises(ValueError, match="16-byte pieces"):
            cuda_decode.check_fused_mma_input(bad, 80, 3)


def test_k4_cpu_path_runs_what_the_kernel_refuses():
    """The refusals are the kernel's: on the CPU the wrapper runs the plain
    version, misaligned or wide, as before."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(0, 1, (1, 2, 2, 260)).astype(np.float32)
                         ).to(torch.bfloat16)[..., 4:132]
    w = torch.from_numpy(rng.normal(0, 0.1, (3 * 257, 128)).astype(np.float32))
    bias = torch.zeros(3 * 257)
    got = cuda_decode.decode_packed_fused_head(x, w, bias, ANCHORS, 32, 252)
    want = cuda_decode.decode_packed_fused_head_reference(x, w, bias, ANCHORS,
                                                          32, 252)
    assert torch.equal(got, want) and got.shape == (1, 12, 8)
