"""K3 (full decode) and the K1 layout variants on the CPU.

K3's plain version against ``decode_head_pallas`` (interpret mode) and the
JAX plain decode; K1n (``decode_packed_head_pallas_noT``) and K1r
(``decode_packed_head_pallas(out_rows=True)``) compute K1's records in
other TPU layouts, and map onto the port's one K1: their records (interpret
mode) against the port's.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu.ops import decode as jdecode
from yolov3_tpu.ops.pallas_decode import (decode_all_pallas,
                                          decode_head_pallas,
                                          decode_packed_head_pallas,
                                          decode_packed_head_pallas_noT)
from yolov3_tpu_torch import Darknet
from yolov3_tpu_torch.ops import cuda_decode
from yolov3_tpu_torch.ops import decode as plain_decode
from yolov3_tpu_torch.weights import fold_raw, random_raw

torch.set_num_threads(1)

ANCHORS = [((10.0, 14.0), (23.0, 27.0), (37.0, 58.0)),
           ((81.0, 82.0), (135.0, 169.0), (344.0, 319.0))]
STRIDES = [32, 16]
GRIDS = [(5, 5), (10, 8)]


def _heads(num_classes, seed):
    """Two head maps (B=2), one of them not square, with tie-heavy class
    logits and box logits past the exp clamp at 60."""
    rng = np.random.default_rng(seed)
    per = 5 + num_classes
    heads = []
    for gy, gx in GRIDS:
        f = rng.normal(0, 2, (2, gy, gx, 3, per)).astype(np.float32)
        f[..., 5:] = np.round(f[..., 5:] * 8) / 8
        big = rng.uniform(0, 1, f[..., 2:4].shape) < 0.05
        f[..., 2:4] = np.where(big, rng.uniform(60, 90, big.shape), f[..., 2:4])
        heads.append(np.ascontiguousarray(f.reshape(2, gy, gx, 3 * per)))
    return heads


@pytest.mark.parametrize("num_classes", [3, 80])
def test_decode_head_matches_pallas_and_plain_jax(num_classes):
    """sigmoid / exp implementations differ in the last ulps between the
    frameworks: rtol 1e-6 (+ 1e-4 px near zero); shapes and order exact."""
    for h, a, s in zip(_heads(num_classes, seed=num_classes), ANCHORS, STRIDES):
        got = cuda_decode.decode_head(torch.from_numpy(h), a, s, num_classes)
        want = np.asarray(decode_head_pallas(jnp.asarray(h), a, s, num_classes,
                                             interpret=True))
        plain = np.asarray(jdecode.decode_head(jnp.asarray(h), a, s, num_classes))
        assert got.shape == want.shape == (2, h.shape[1] * h.shape[2] * 3,
                                           5 + num_classes)
        assert got.dtype == torch.float32 and np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)
        np.testing.assert_allclose(got.numpy(), plain, rtol=1e-6, atol=1e-4)


def test_decode_all_matches_pallas_and_is_the_plain_version_on_cpu():
    heads = _heads(4, seed=11)
    got = cuda_decode.decode_all([torch.from_numpy(h) for h in heads], ANCHORS,
                                 STRIDES, 4)
    want = np.asarray(decode_all_pallas([jnp.asarray(h) for h in heads], ANCHORS,
                                        STRIDES, 4, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)
    cuda_decode.decode_head.launches = 0
    same = plain_decode.decode_all([torch.from_numpy(h) for h in heads], ANCHORS,
                                   STRIDES, 4)
    assert torch.equal(got, same) and cuda_decode.decode_head.launches == 0


def test_decode_head_bf16_map_widens_exactly():
    h = torch.from_numpy(_heads(3, seed=5)[0]).bfloat16()
    got = cuda_decode.decode_head(h, ANCHORS[0], 32, 3)
    assert got.dtype == torch.float32
    assert torch.equal(got, plain_decode.decode_head(h.float(), ANCHORS[0], 32, 3))
    # a channel-padded map decodes its first A·(5+C) channels
    padded = torch.zeros(2, 5, 5, 128)
    padded[..., :24] = h.float()
    assert torch.equal(cuda_decode.decode_head(padded, ANCHORS[0], 32, 3), got)


def test_decode_head_validation():
    h = torch.zeros(1, 5, 5, 24)
    with pytest.raises(ValueError, match="channels"):
        cuda_decode.decode_head(h, ANCHORS[0], 32, 80)
    with pytest.raises(TypeError):
        cuda_decode.decode_head(h.double(), ANCHORS[0], 32, 3)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        cuda_decode.decode_head(h.to("meta"), ANCHORS[0], 32, 3)


def test_darknet_call_runs_the_full_decode_wrapper():
    """``Darknet(x)`` decodes through ``ops.cuda_decode.decode_all`` (K3 on
    the card, its plain version here)."""
    from pathlib import Path

    cfg = Path(__file__).parent / "data" / "port_small.cfg"
    net = Darknet(cfg, precision="highest", device="cpu")
    net.set_params(fold_raw(random_raw(net.graph, seed=2)))
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (2, 64, 64, 3)).astype(np.float32))
    out = net(x)
    assert out.shape == (2, 3 * (8 * 8 + 16 * 16), 5 + net.graph.yolo_nodes[0].classes)
    assert cuda_decode.decode_head.launches == 0


def _records(fn, h, a, s, num_classes, prob, off, **kw):
    payload, scores = fn(jnp.asarray(h), a, s, num_classes, prob_thresh=prob,
                         head_offset=off, interpret=True, **kw)
    return np.asarray(payload), np.asarray(scores)


@pytest.mark.parametrize("variant", ["noT", "out_rows"])
@pytest.mark.parametrize("num_classes,prob", [(3, 0.0), (80, 0.3)])
def test_k1_layout_variants_match_port_k1(variant, num_classes, prob):
    """K1n / K1r records against the port's K1: class, candidate and spare
    lanes exact, the threshold's zero pattern exact, float lanes to the
    frameworks' sigmoid/exp ulps."""
    fn = (decode_packed_head_pallas_noT if variant == "noT"
          else decode_packed_head_pallas)
    kw = {} if variant == "noT" else {"out_rows": True}
    off = 0
    for h, a, s in zip(_heads(num_classes, seed=20 + num_classes), ANCHORS,
                       STRIDES):
        if h.shape[1] != h.shape[2]:
            h = np.ascontiguousarray(h[:, :8])  # the TPU variants take square grids
        want_p, want_s = _records(fn, h, a, s, num_classes, prob, off, **kw)
        got = cuda_decode.decode_packed_head(torch.from_numpy(h), a, s,
                                             num_classes, prob_thresh=prob,
                                             head_offset=off).numpy()[:, off:]
        assert got.shape == want_p.shape
        np.testing.assert_array_equal(got[..., 5:], want_p[..., 5:])
        np.testing.assert_array_equal(got[..., 4] == 0, want_s == 0)
        np.testing.assert_allclose(got[..., :5], want_p[..., :5], rtol=1e-6,
                                   atol=1e-4)
        off += got.shape[1]


# ---------------------------------------------------------------- K3's plan

PER80 = 85
YOLO_ANCHORS = [((116.0, 90.0), (156.0, 198.0), (373.0, 326.0)),
                ((30.0, 61.0), (62.0, 45.0), (59.0, 119.0)),
                ((10.0, 13.0), (16.0, 30.0), (33.0, 23.0))]


def _meta_heads(b, grids, channels=3 * PER80, dtype=torch.float32):
    return [torch.empty((b, g, g, channels), dtype=dtype, device="meta")
            for g in grids]


@pytest.mark.parametrize("b,size", [(8, 416), (1, 608), (8, 608)])
def test_k3_plan_head_table(b, size):
    """One launch for the three heads: a row each, in cfg order, with its
    first block after the previous head's, its blocks an image, its first
    anchor and its first output row in the concatenated (B, N, 85) tensor;
    dense maps read as one range."""
    grids = [size // 32, size // 16, size // 8]
    feats = _meta_heads(b, grids)
    offsets = cuda_decode.candidate_offsets(feats, YOLO_ANCHORS)
    plans = cuda_decode.plan_full_decode(feats, YOLO_ANCHORS, 80, offsets[:-1])
    assert len(plans) == 1
    (plan,) = plans
    first = 0
    for h, (row, g) in enumerate(zip(plan.rows, grids)):
        seg = g * g * 3 * PER80
        assert row.head == h and row.dense and row.anchor0 == 3 * h
        assert row.segment == seg
        assert row.tiles == -(-seg // cuda_decode.K3_TILE)
        assert row.first_block == first
        assert row.row_offset == 3 * sum(gg * gg for gg in grids[:h])
        first += b * row.tiles
    assert plan.blocks == first
    assert offsets[-1] == 3 * sum(g * g for g in grids)  # 10647 / 22743
    if size == 608:
        assert [r.tiles for r in plan.rows] == [23, 90, 360]


def test_k3_plan_dense_flag_and_splits():
    """A channel-padded map and a channel-slice view take the strided path;
    a bf16 head after a float32 one starts a second launch; more than
    K3_MAX_HEADS heads or MAX_ANCHORS anchors split the table."""
    dense = torch.zeros(2, 5, 5, 24)
    padded = torch.zeros(2, 5, 5, 32)
    sliced = torch.zeros(2, 5, 5, 40)[..., 8:32]
    anchors = [ANCHORS[0]] * 3
    rows = cuda_decode.plan_full_decode([dense, padded, sliced], anchors, 3,
                                        [0, 75, 150])[0].rows
    assert [r.dense for r in rows] == [True, False, False]
    plans = cuda_decode.plan_full_decode([dense, dense.bfloat16()],
                                         anchors[:2], 3, [0, 75])
    assert [len(p.rows) for p in plans] == [1, 1]
    assert plans[1].rows[0].first_block == 0
    many = cuda_decode.plan_full_decode([dense] * 9, [ANCHORS[0]] * 9, 3,
                                        list(range(0, 9 * 75, 75)))
    assert [len(p.rows) for p in many] == [8, 1]
    wide = [((1.0, 1.0),) * 40] * 2
    feats = [torch.zeros(1, 2, 2, 40 * 8)] * 2
    assert len(cuda_decode.plan_full_decode(feats, wide, 3, [0, 160])) == 2


def test_k3_plan_64_bit_bases_32_bit_offsets():
    """A block's output base is a 64-bit element offset, b·N·(5+C) past 2^31
    at yolov3@608 B=2048; the offsets inside a block and a segment stay
    32-bit; a segment of 2^31 elements or more raises."""
    grids = [19, 38, 76]
    feats = _meta_heads(2048, grids)
    offsets = cuda_decode.candidate_offsets(feats, YOLO_ANCHORS)
    (plan,) = cuda_decode.plan_full_decode(feats, YOLO_ANCHORS, 80,
                                           offsets[:-1])
    last = plan.rows[-1]
    base = ((2047 * offsets[-1] + last.row_offset) * PER80
            + (last.tiles - 1) * cuda_decode.K3_TILE)
    assert base >= 2 ** 31 and plan.blocks < 2 ** 31
    assert all(r.segment < 2 ** 31 for r in plan.rows)
    huge = [torch.empty((1, 4096, 4096, 255), device="meta")]
    with pytest.raises(ValueError, match="2\\^31"):
        cuda_decode.plan_full_decode(huge, YOLO_ANCHORS[:1], 80, [0])


def _magic(d):
    """``k3_magic`` of csrc/decode_full.cu: (m, s) with n / d = (n·m) >> s
    for 0 <= n < 2^31."""
    ceil_log2 = max(0, (d - 1).bit_length())
    return (1 << (31 + ceil_log2)) // d + 1, 31 + ceil_log2


def _magic_div(n, d):
    m, s = _magic(d)
    assert 0 <= n < 2 ** 31 and m < 2 ** 32
    return (n * m) >> s


@pytest.mark.parametrize("d", [1, 2, 3, 7, 13, 19, 76, 85, 255, 256, 257, 768,
                               1020, 65535, 123457, 2 ** 20 + 1])
def test_k3_magic_division_is_exact(d):
    """The multiply-shift K3 finds a thread's first element with: exact
    floor division for every numerator below 2^31, the multiplier inside 32
    bits (checked at the edges of each quotient and at random)."""
    rng = np.random.default_rng(d)
    ns = set(rng.integers(0, 2 ** 31, 2000).tolist())
    for q in [0, 1, 2, (2 ** 31 - 1) // d] + rng.integers(
            0, (2 ** 31 - 1) // d + 1, 200).tolist():
        ns.update(x for x in (q * d - 1, q * d, q * d + d - 1)
                  if 0 <= x < 2 ** 31)
    ns.add(2 ** 31 - 1)
    for n in ns:
        assert _magic_div(n, d) == n // d


def _emulate_k3(plan, feats, per, n_total, threads=256):
    """The kernel's index arithmetic for every block of ``plan``, replayed
    in numpy: per output element the (image, column, row, anchor, channel)
    the block's counters give it and the input element it reads (flat index
    into its map's storage); -1 where no block wrote."""
    b = feats[0].shape[0]
    shape = (b * n_total * per,)
    got = {key: np.full(shape, -1, np.int64) for key in
           ("head", "x", "y", "a", "k", "src")}
    tile = cuda_decode.K3_TILE
    for blk in range(plan.blocks):
        row = [r for r in plan.rows if r.first_block <= blk][-1]
        f = feats[row.head]
        gx = f.shape[2]
        n_a = row.segment // (f.shape[1] * gx * per)
        need = n_a * per
        bi = blk - row.first_block
        img = bi // row.tiles
        lo = (bi - img * row.tiles) * tile
        length = min(tile, row.segment - lo)
        out0 = (img * n_total + row.row_offset) * per + lo
        sb, sy, sx, _ = f.stride()
        sc, sr = threads // need, threads % need
        sa, sk = sr // per, sr % per
        sy_, sx_ = sc // gx, sc % gx
        for tid in range(threads):
            e = lo + tid
            cell = _magic_div(e, need)
            ch = e - cell * need
            a = _magic_div(ch, per)
            k = ch - a * per
            y = _magic_div(cell, gx)
            x = cell - y * gx
            for i in range(tid, length, threads):
                pos = out0 + i
                assert got["head"][pos] == -1, "written twice"
                got["head"][pos] = row.head
                got["x"][pos], got["y"][pos] = x, y
                got["a"][pos], got["k"][pos] = a, k
                # the staged element: dense maps copy the range as it lies
                if row.dense:
                    got["src"][pos] = img * sb + lo + i
                else:
                    c = (lo + i) // need
                    got["src"][pos] = (img * sb + (c // gx) * sy
                                       + (c % gx) * sx + (lo + i) % need)
                k += sk
                carry = k >= per
                k -= per if carry else 0
                a += sa + carry
                carry = a >= n_a
                a -= n_a if carry else 0
                x += sx_ + carry
                carry = x >= gx
                x -= gx if carry else 0
                y += sy_ + carry
    return got


@pytest.mark.parametrize("num_classes", [3, 80])
def test_k3_block_arithmetic_covers_the_output_once(num_classes):
    """Replaying the kernel's block and counter arithmetic from the plan:
    every element of the concatenated output is written once, with the cell,
    anchor and channel of its reference position, from the input element
    at that position (dense, channel-padded and sliced maps)."""
    per = 5 + num_classes
    need = 3 * per
    feats = [torch.zeros(2, 5, 5, need),                       # dense
             torch.zeros(2, 10, 8, need + 16),                 # padded
             torch.zeros(2, 7, 3, need + 24)[..., 8:8 + need]]  # sliced
    anchors = [ANCHORS[0], ANCHORS[1], ANCHORS[0]]
    offsets = cuda_decode.candidate_offsets(feats, anchors)
    (plan,) = cuda_decode.plan_full_decode(feats, anchors, num_classes,
                                           offsets[:-1])
    assert [r.dense for r in plan.rows] == [True, False, False]
    n_total = offsets[-1]
    got = _emulate_k3(plan, feats, per, n_total)
    assert (got["head"] >= 0).all()
    for h, f in enumerate(feats):
        bsz, gy, gx, _ = f.shape
        idx = np.arange(bsz * gy * gx * 3 * per)
        img = idx // (gy * gx * 3 * per)
        rest = idx % (gy * gx * 3 * per)
        cell, ch = rest // need, rest % need
        pos = (img * n_total + offsets[h]) * per + rest
        sb, sy, sx, _ = f.stride()
        np.testing.assert_array_equal(got["head"][pos], h)
        np.testing.assert_array_equal(got["x"][pos], cell % gx)
        np.testing.assert_array_equal(got["y"][pos], cell // gx)
        np.testing.assert_array_equal(got["a"][pos], ch // per)
        np.testing.assert_array_equal(got["k"][pos], ch % per)
        np.testing.assert_array_equal(
            got["src"][pos], img * sb + (cell // gx) * sy + (cell % gx) * sx
            + ch)


@pytest.mark.parametrize("layout", ["padded", "sliced"])
def test_decode_all_non_dense_maps_match_pallas(layout):
    """``decode_all`` on a channel-padded map and on a channel-slice view
    (pixel stride above A·(5+C)) against ``decode_all_pallas`` on the same
    values packed; the plain version takes the map's first A·(5+C)
    channels."""
    heads = _heads(4, seed=13)
    per3 = 3 * 9
    maps = []
    for h in heads:
        t = torch.from_numpy(h)
        if layout == "padded":
            big = torch.full(t.shape[:3] + (per3 + 5,), 7.0)
            big[..., :per3] = t
            maps.append(big)
        else:
            big = torch.full(t.shape[:3] + (per3 + 11,), -3.0)
            big[..., 6:6 + per3] = t
            maps.append(big[..., 6:6 + per3])
        assert not cuda_decode.dense_map(maps[-1], 3, 4)
    got = cuda_decode.decode_all(maps, ANCHORS, STRIDES, 4)
    want = np.asarray(decode_all_pallas([jnp.asarray(h) for h in heads],
                                        ANCHORS, STRIDES, 4, interpret=True))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)
    dense = cuda_decode.decode_all([torch.from_numpy(h) for h in heads],
                                   ANCHORS, STRIDES, 4)
    assert torch.equal(got, dense)


def test_decode_all_is_one_launch_by_its_plan():
    """``decode_all`` promises one K3 launch for a graph's heads: its plan
    over every shipped cfg's head maps has one table, at float32 and bf16,
    B=1 and 8, 320 to 608; the CPU launches nothing."""
    from yolov3_tpu_torch.graph import load_graph

    models = Path(__file__).resolve().parents[1] / "models"
    for cfg in ("yolov3.cfg", "yolov3-tiny.cfg", "yolov3-spp.cfg"):
        graph = load_graph(models / cfg)
        anchors = [n.anchors for n in graph.yolo_nodes]
        ncls = graph.yolo_nodes[0].classes
        for size in (320, 416, 608):
            for b in (1, 8):
                for dtype in (torch.float32, torch.bfloat16):
                    feats = [torch.empty((b, size // s, size // s,
                                          len(a) * (5 + ncls)), dtype=dtype,
                                         device="meta")
                             for a, s in zip(anchors, graph.head_strides())]
                    offs = cuda_decode.candidate_offsets(feats, anchors)
                    assert len(cuda_decode.plan_full_decode(
                        feats, anchors, ncls, offs[:-1])) == 1
    cuda_decode.decode_all.launches = cuda_decode.decode_head.launches = 0
    heads = [torch.from_numpy(h) for h in _heads(3, seed=2)]
    cuda_decode.decode_all(heads, ANCHORS, STRIDES, 3)
    assert cuda_decode.decode_all.launches == 0
    assert cuda_decode.decode_head.launches == 0
