"""K1 (packed decode): the port's ``decode_packed`` (plain path on the CPU)
against ``yolov3_tpu.ops.pallas_decode.decode_packed_pallas`` (the Pallas
kernel, which runs in interpret mode on the CPU backend by itself)."""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu.ops.pallas_decode import decode_packed_pallas
from yolov3_tpu_torch.ops import cuda_decode

torch.set_num_threads(1)

ANCHORS = [((10.0, 14.0), (23.0, 27.0), (37.0, 58.0)),
           ((81.0, 82.0), (135.0, 169.0), (344.0, 319.0))]
STRIDES = [32, 16]
GRIDS = [5, 10]


def _heads(num_classes, seed):
    """Two head maps (B=2) with tie-heavy class logits (1/8 grid) and box
    logits past the exp clamp at 60."""
    rng = np.random.default_rng(seed)
    per = 5 + num_classes
    heads = []
    for g in GRIDS:
        f = rng.normal(0, 2, (2, g, g, 3 * per)).astype(np.float32)
        f = f.reshape(2, g, g, 3, per)
        f[..., 5:] = np.round(f[..., 5:] * 8) / 8            # exact ties
        big = rng.uniform(0, 1, f[..., 2:4].shape) < 0.05
        f[..., 2:4] = np.where(big, rng.uniform(60, 90, big.shape), f[..., 2:4])
        heads.append(np.ascontiguousarray(f.reshape(2, g, g, 3 * per)))
    return heads


@pytest.mark.parametrize("num_classes", [3, 80])
@pytest.mark.parametrize("prob_thresh", [0.0, 0.3])
def test_decode_packed_matches_pallas(num_classes, prob_thresh):
    heads = _heads(num_classes, seed=num_classes)
    want_p, want_s = decode_packed_pallas(
        [jnp.asarray(h) for h in heads], ANCHORS, STRIDES, num_classes,
        prob_thresh=prob_thresh)
    want_p, want_s = np.asarray(want_p), np.asarray(want_s)
    got_p, got_s = cuda_decode.decode_packed(
        [torch.from_numpy(h) for h in heads], ANCHORS, STRIDES, num_classes,
        prob_thresh=prob_thresh)
    got_p, got_s = got_p.numpy(), got_s.numpy()
    assert got_p.shape == want_p.shape == (2, 3 * (25 + 100), 8)
    # class, candidate index and the spare lane: exact
    np.testing.assert_array_equal(got_p[..., 5:], want_p[..., 5:])
    # the threshold's zero pattern: exact
    np.testing.assert_array_equal(got_s == 0, want_s == 0)
    np.testing.assert_array_equal(got_s, got_p[..., 4])
    # float lanes: sigmoid/exp implementations differ in the last ulps
    np.testing.assert_allclose(got_p[..., :5], want_p[..., :5],
                               rtol=1e-6, atol=1e-4)
    assert np.isfinite(got_p).all()


def test_decode_head_takes_strided_channel_padded_map():
    """A channel-padded map (TPU lane padding, or any stride) decodes to the
    same records as the tight map — the wrapper reads channels 0..A·(5+C)."""
    h = _heads(3, seed=7)[0]
    padded = np.zeros((*h.shape[:3], 128), np.float32)
    padded[..., :h.shape[3]] = h
    a = cuda_decode.decode_packed_head(torch.from_numpy(h), ANCHORS[0], 32, 3,
                                       prob_thresh=0.2, head_offset=11)
    b = cuda_decode.decode_packed_head(torch.from_numpy(padded), ANCHORS[0],
                                       32, 3, prob_thresh=0.2, head_offset=11)
    assert a.shape == (2, 11 + 75, 8)  # rows < head_offset: other heads'
    assert torch.equal(a[:, 11:], b[:, 11:])
    np.testing.assert_array_equal(a[0, 11:, 6].numpy(), np.arange(11, 86))


def test_decode_wrapper_rejects_what_the_kernel_does_not_take():
    h = torch.zeros(1, 5, 5, 24)
    with pytest.raises(ValueError, match="channels"):
        cuda_decode.decode_packed_head(h, ANCHORS[0], 32, 80)
    with pytest.raises(TypeError):
        cuda_decode.decode_packed_head(h.double(), ANCHORS[0], 32, 3)
    with pytest.raises(ValueError, match="payload"):
        cuda_decode.decode_packed_head(h, ANCHORS[0], 32, 3,
                                       out=torch.empty(1, 10, 8))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        cuda_decode.decode_packed_head(h.to("meta"), ANCHORS[0], 32, 3)


MODELS = Path(__file__).parent.parent / "models"


def _graph_heads(cfg, size, batch, dtype=torch.bfloat16):
    """Uninitialised contiguous head maps at ``cfg``'s shapes for a
    ``size`` input, with its anchors, strides and class count."""
    from yolov3_tpu_torch.graph import load_graph

    g = load_graph(MODELS / cfg)
    anchors = [n.anchors for n in g.yolo_nodes]
    ncls = g.yolo_nodes[0].classes
    feats = [torch.empty((batch, size // s, size // s, len(a) * (5 + ncls)),
                         dtype=dtype)
             for a, s in zip(anchors, g.head_strides())]
    return feats, anchors, list(g.head_strides()), ncls


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("size", [320, 416, 608])
@pytest.mark.parametrize("cfg", ["yolov3.cfg", "yolov3-tiny.cfg",
                                 "yolov3-spp.cfg"])
def test_plan_decode_covers_every_cell_once(cfg, size, batch):
    """K1's head table: one launch for a graph's heads; each head's blocks
    follow the previous head's in order; block t takes cells [t·TC,
    (t+1)·TC) of the head's flattened (image, cell) index, so every
    (image, cell) is decoded by exactly one block; contiguous maps take the
    dense path; anchors and candidate offsets follow the heads in order."""
    feats, anchors, _, ncls = _graph_heads(cfg, size, batch)
    offsets = cuda_decode.candidate_offsets(feats, anchors)
    (plan,) = cuda_decode.plan_decode(feats, anchors, ncls, offsets)
    assert plan.tile_cells == 32
    assert plan.group == cuda_decode.K1_GROUP[torch.bfloat16] == 2
    assert [r.head for r in plan.rows] == list(range(len(feats)))
    first = anchor0 = 0
    for row, f, a in zip(plan.rows, feats, anchors):
        m = batch * f.shape[1] * f.shape[2]
        assert row.dense
        assert (row.first_block, row.anchor0) == (first, anchor0)
        assert row.head_offset == offsets[row.head]
        covered = np.zeros(row.blocks * plan.tile_cells, np.int64)
        for t in range(row.blocks):
            covered[t * plan.tile_cells:(t + 1) * plan.tile_cells] += 1
        assert (covered[:m] == 1).all() and row.blocks == -(-m // plan.tile_cells)
        first += row.blocks
        anchor0 += len(a)
    assert plan.blocks == first
    assert offsets[-1] == sum(len(a) * f.shape[1] * f.shape[2]
                              for f, a in zip(feats, anchors))


def test_plan_decode_dense_or_strided():
    """The dense path (one contiguous tile copied in 16-byte pieces) only
    for a channels-last map whose pixel stride is the A·(5+C) channels
    decoded, with rows and images packed and a 16-byte aligned base; a
    channel-padded map, a sliced view or a misaligned base are strided."""
    need = 3 * (5 + 80)
    dense = torch.zeros(2, 13, 13, need)
    padded = torch.zeros(2, 13, 13, 264)
    flat = torch.zeros(2 * 13 * 13 * need + 1)
    views = {
        "contiguous": (dense, True),
        "contiguous B=1": (torch.zeros(1, 13, 13, need), True),
        "channel-padded": (padded, False),
        "channel-padded slice": (padded[..., :need], False),
        "sliced rows": (torch.zeros(2, 15, 13, need)[:, 1:14], False),
        "sliced columns": (torch.zeros(2, 13, 16, need)[:, :, 2:15], False),
        "misaligned base": (flat[1:].view(2, 13, 13, need), False),
        "channels-first": (torch.zeros(2, need, 13, 13).permute(0, 2, 3, 1),
                           False),
    }
    for name, (f, want) in views.items():
        assert cuda_decode.dense_map(f, 3, 80) is want, name
        (plan,) = cuda_decode.plan_decode([f], [ANCHORS[0]], 80, [0])
        assert plan.rows[0].dense is want, name


def test_plan_decode_splits_what_one_table_cannot_hold():
    """A launch's table holds heads of one map type, at most K1_MAX_HEADS
    heads and MAX_ANCHORS anchors; rows too wide for 32 staged cells take
    16; wider ones raise."""
    f32, bf16 = torch.zeros(1, 4, 4, 24), torch.zeros(1, 4, 4, 24,
                                                      dtype=torch.bfloat16)
    a3 = ANCHORS[0]
    plans = cuda_decode.plan_decode([f32, f32, bf16, bf16], [a3] * 4, 3,
                                    [0, 48, 96, 144])
    assert [[r.head for r in p.rows] for p in plans] == [[0, 1], [2, 3]]
    assert [r.anchor0 for r in plans[1].rows] == [0, 3]
    plans = cuda_decode.plan_decode([f32] * 10, [a3] * 10, 3, list(range(10)))
    assert [len(p.rows) for p in plans] == [cuda_decode.K1_MAX_HEADS, 2]
    many = [(1.0, 1.0)] * 40
    feats = [torch.zeros(1, 2, 2, 40 * 8)] * 2
    assert len(cuda_decode.plan_decode(feats, [many] * 2, 3, [0, 160])) == 2
    wide = torch.zeros(1, 2, 2, 2 * (5 + 1000))
    (plan,) = cuda_decode.plan_decode([wide], [a3[:2]], 1000, [0])
    assert plan.tile_cells == 16
    with pytest.raises(ValueError, match="shared"):
        cuda_decode.plan_decode([torch.zeros(1, 2, 2, 4 * (5 + 4000))],
                                [[(1.0, 1.0)] * 4], 4000, [0])
    with pytest.raises(ValueError, match="lanes"):
        cuda_decode.plan_decode([f32], [a3], 3, [0], group=3)


def _one_launch(feats, anchors, strides, num_classes, prob_thresh, compact):
    """The one-launch route as the kernel addresses it, from the plain
    records: each block of the plan fills the slots of its tile's cells
    (slot = image·N + head_offset + anchor·gy·gx + cell), and no slot is
    written twice."""
    offsets = cuda_decode.candidate_offsets(feats, anchors)
    b = feats[0].shape[0]
    out = torch.full((b, offsets[-1], 8), float("nan"))
    writes = torch.zeros((b, offsets[-1]), dtype=torch.int64)
    for plan in cuda_decode.plan_decode(feats, anchors, num_classes, offsets):
        for row in plan.rows:
            f = feats[row.head]
            a = anchors[row.head]
            cells = f.shape[1] * f.shape[2]
            rec = cuda_decode.decode_packed_head_reference(
                f, a, strides[row.head], num_classes, prob_thresh,
                row.head_offset)
            for t in range(row.blocks):
                g = torch.arange(t * plan.tile_cells,
                                 min((t + 1) * plan.tile_cells, b * cells))
                img, cell = g // cells, g % cells
                for k in range(len(a)):
                    out[img, row.head_offset + k * cells + cell] = \
                        rec[img, k * cells + cell]
                    writes[img, row.head_offset + k * cells + cell] += 1
    assert bool((writes == 1).all())
    if compact:
        return out[..., :4], out[..., 4], out[..., 5].to(torch.int32)
    return out


@pytest.mark.parametrize("padded", [False, True], ids=["dense", "strided"])
@pytest.mark.parametrize("num_classes", [3, 80])
def test_one_launch_route_matches_pallas(num_classes, padded):
    """decode_packed / decode_compact, and the one-launch route laid out by
    plan_decode, against the Pallas kernels (interpret mode on the CPU)."""
    from yolov3_tpu.ops.pallas_decode import decode_compact_pallas

    heads = _heads(num_classes, seed=num_classes + 1)
    feats = [torch.from_numpy(h) for h in heads]
    if padded:
        feats = [torch.nn.functional.pad(f, (0, 8))[..., :f.shape[3]]
                 for f in feats]
    want_p, _ = decode_packed_pallas([jnp.asarray(h) for h in heads], ANCHORS,
                                     STRIDES, num_classes, prob_thresh=0.25)
    want_c = decode_compact_pallas([jnp.asarray(h) for h in heads], ANCHORS,
                                   STRIDES, num_classes, prob_thresh=0.25)
    got_p, got_s = cuda_decode.decode_packed(feats, ANCHORS, STRIDES,
                                             num_classes, prob_thresh=0.25)
    one = _one_launch(feats, ANCHORS, STRIDES, num_classes, 0.25, False)
    assert torch.equal(one, got_p)
    want_p = np.asarray(want_p)
    np.testing.assert_array_equal(got_p[..., 5:].numpy(), want_p[..., 5:])
    np.testing.assert_allclose(got_p[..., :5].numpy(), want_p[..., :5],
                               rtol=1e-6, atol=1e-4)
    got_c = cuda_decode.decode_compact(feats, ANCHORS, STRIDES, num_classes,
                                       prob_thresh=0.25)
    for g, o in zip(got_c, _one_launch(feats, ANCHORS, STRIDES, num_classes,
                                       0.25, True)):
        assert torch.equal(g, o)
    boxes, scores, classes = (np.asarray(w) for w in want_c)
    np.testing.assert_array_equal(got_c[2].numpy(), classes)
    np.testing.assert_array_equal(got_c[1].numpy() == 0, scores == 0)
    np.testing.assert_allclose(got_c[0].numpy(), boxes, rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got_c[1].numpy(), scores, rtol=1e-6, atol=1e-4)
