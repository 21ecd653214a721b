"""Packed-payload NMS: the port's ``batched_nms_packed`` (K2's plain path on
the CPU) against ``yolov3_tpu.ops.nms.batched_nms_packed`` with both of the
JAX package's suppressions (XLA blocked loop and the Pallas kernel in
interpret mode). Outputs must be bit-identical."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu.ops import nms as jnms
from yolov3_tpu_torch.ops import cuda_nms
from yolov3_tpu_torch.ops import nms as tnms

torch.set_num_threads(1)


def _payload(det, thresh):
    """(N, 5+C) cxywh/obj/class-prob rows → packed payload (1, N, 8) with
    thresholded scores, as the decode kernel emits it."""
    n = det.shape[0]
    half = det[:, 2:4] * 0.5
    boxes = np.concatenate([det[:, :2] - half, det[:, :2] + half], 1)
    score = det[:, 4] * det[:, 5:].max(1)
    masked = np.where(score >= thresh, score, 0.0).astype(np.float32)
    cls = det[:, 5:].argmax(1).astype(np.float32)
    payload = np.concatenate(
        [boxes, masked[:, None], cls[:, None],
         np.arange(n, dtype=np.float32)[:, None], np.zeros((n, 1))], 1)
    return payload.astype(np.float32)[None]


def _random_det(rng, n, classes, size=416, quantize=False):
    cx = rng.uniform(0, size, (n, 1))
    cy = rng.uniform(0, size, (n, 1))
    wh = rng.uniform(8, size / 3, (n, 2))
    obj = rng.uniform(0, 1, (n, 1))
    cls = rng.uniform(0, 1, (n, classes))
    det = np.concatenate([cx, cy, wh, obj, cls], 1)
    if quantize:  # massive score ties and exact duplicates
        det[:, 4:] = np.round(det[:, 4:] * 4) / 4
        det[:, :4] = np.round(det[:, :4] / 16) * 16
    return det.astype(np.float32)


def _cases():
    rng = np.random.default_rng(2024)
    cases = {
        "random": (_payload(np.concatenate(
            [_random_det(rng, 400, 6), _random_det(rng, 400, 6)]), 0.2), 0.4, 128, 0),
        "ties": (_payload(_random_det(rng, 600, 3, quantize=True), 0.1), 0.45, 256, 0),
        "over_k": (_payload(_random_det(rng, 1200, 4), 0.01), 0.4, 64, 0),
        "compact": (_payload(_random_det(rng, 3000, 10), 0.25), 0.45, 256, 32),
        "none_pass": (_payload(_random_det(rng, 300, 5), 1.5), 0.3, 64, 16),
    }
    # same-class duplicates and a suppression ladder across 32-bit words
    n = 192
    x0 = np.arange(n, dtype=np.float32) * 4.0
    ladder = np.zeros((1, n, 8), np.float32)
    ladder[0, :, 0], ladder[0, :, 2], ladder[0, :, 3] = x0, x0 + 40.0, 40.0
    ladder[0, :, 4] = np.linspace(0.9, 0.5, n)
    ladder[0, :, 6] = np.arange(n)
    ladder[0, ::7, 5] = 1.0  # a second class interleaved
    cases["ladder"] = (ladder, 0.3, 192, 0)
    dup = np.zeros((1, 4, 8), np.float32)
    dup[0, :, :4] = [75, 75, 125, 125]
    dup[0, :, 4] = [0.81, 0.72, 0.81, 0.5]
    dup[0, :, 5] = [0, 0, 1, 0]
    dup[0, :, 6] = np.arange(4)
    cases["duplicates"] = (dup, 0.3, 4, 0)
    # a two-image batch
    b = np.concatenate([_payload(_random_det(rng, 500, 8), 0.3),
                        _payload(_random_det(rng, 500, 8), 0.3)])
    cases["batch2"] = (b, 0.4, 128, 0)
    return cases


CASES = _cases()


@pytest.mark.parametrize("group", [2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_batched_nms_packed_bit_identical(case, group):
    payload, iou, top_k, max_results = CASES[case]
    scores = np.ascontiguousarray(payload[..., 4])
    got = tnms.batched_nms_packed(torch.from_numpy(payload),
                                  torch.from_numpy(scores), iou_thresh=iou,
                                  top_k=top_k, max_results=max_results,
                                  select_group=group)
    for impl in ("xla", "pallas"):
        want = jnms.batched_nms_packed(
            jnp.asarray(payload), jnp.asarray(scores), iou_thresh=iou,
            top_k=top_k, impl=impl, interpret=impl == "pallas",
            max_results=max_results, select_group=group)
        for name in ("boxes", "scores", "classes", "valid"):
            np.testing.assert_array_equal(
                getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                err_msg=f"{case} {impl} {name}")
        assert got.classes.dtype == torch.int32
    if case == "duplicates":
        # score order: the tied 0.81 pair (class 0 first by index, then the
        # class-1 twin, not suppressed across classes), then the two class-0
        # duplicates it suppresses
        assert got.valid[0].tolist() == [True, True, False, False]
        assert got.classes[0].tolist() == [0, 1, -1, -1]


def test_suppress_reference_matches_jax_scalar_greedy():
    """K2's plain version ≡ the JAX package's scalar greedy on the same
    score-sorted boxes (valid holes included)."""
    from yolov3_tpu.ops.nms import _greedy_suppress, iou_matrix

    rng = np.random.default_rng(5)
    det = _random_det(rng, 256, 4)
    boxes = _payload(det, 0.0)[0, :, :4]
    classes = det[:, 5:].argmax(1).astype(np.int32)
    valid = rng.uniform(0, 1, 256) > 0.2
    want = np.asarray(_greedy_suppress(
        iou_matrix(jnp.asarray(boxes)),
        jnp.asarray(classes[:, None] == classes[None, :]),
        jnp.asarray(valid), 0.35))
    got = cuda_nms.suppress(torch.from_numpy(boxes)[None],
                            torch.from_numpy(classes)[None],
                            torch.from_numpy(valid)[None], 0.35)
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_pack_unpack_roundtrip():
    payload, iou, top_k, _ = CASES["random"]
    res = tnms.batched_nms_packed(torch.from_numpy(payload),
                                  torch.from_numpy(payload[..., 4].copy()),
                                  iou_thresh=iou, top_k=top_k)
    assert torch.equal(res.valid, res.scores > 0)
    back = tnms.unpack_results(tnms.pack_results(res).numpy())
    for name in ("boxes", "scores", "classes", "valid"):
        np.testing.assert_array_equal(getattr(res, name).numpy(),
                                      getattr(back, name))


def test_auto_top_k_matches(cfg_paths):
    from yolov3_tpu.graph import load_graph

    for name in ("yolov3", "yolov3-tiny"):
        g = load_graph(cfg_paths[name])
        for hw in ((320, 320), (416, 416), (608, 608)):
            assert tnms.auto_top_k(g, hw) == jnms.auto_top_k(g, hw)


def test_suppress_wrapper_rejects_bad_input():
    boxes = torch.zeros(1, 8, 4)
    classes = torch.zeros(1, 8, dtype=torch.int32)
    valid = torch.ones(1, 8, dtype=torch.bool)
    with pytest.raises(ValueError, match="classes"):
        cuda_nms.suppress(boxes, classes.long(), valid, 0.3)
    with pytest.raises(ValueError, match="valid"):
        cuda_nms.suppress(boxes, classes, valid.int(), 0.3)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        cuda_nms.suppress(boxes.to("meta"), classes.to("meta"),
                          valid.to("meta"), 0.3)
    with pytest.raises(ValueError, match="group"):
        tnms._select_pairmax_payload(torch.zeros(1, 8, 8), torch.zeros(1, 8),
                                     4, group=1)


def _k2_case(name):
    """(boxes (1, K, 4), classes (1, K), valid (1, K)) numpy, score-sorted
    by construction, for the conflict-bits tests."""
    rng = np.random.default_rng(K2_CASES.index(name) + 7)
    k = {"k1": 1, "k31": 31, "k33": 33, "k300": 300, "k512": 512}.get(name, 300)
    det = _random_det(rng, k, 3, quantize=name == "ties")
    boxes = _payload(det, 0.0)[0, :, :4]
    classes = det[:, 5:].argmax(1).astype(np.int32)
    valid = rng.uniform(0, 1, k) > 0.15
    if name == "ties":  # quantized boxes: exact duplicates and shared edges
        boxes = np.concatenate([boxes, boxes[:20]])[:k]
    elif name == "nonfinite":
        boxes[rng.uniform(0, 1, k) < 0.05, 1] = np.nan
        big = rng.uniform(0, 1, k) < 0.1
        c = (boxes[big, :2] + boxes[big, 2:]) / 2
        boxes[big] = np.concatenate([c - 3e28, c + 3e28], 1)  # areas overflow
        boxes[rng.uniform(0, 1, k) < 0.03, 2] = np.inf
    elif name == "invalid":
        valid[:] = False
    elif name == "disjoint":
        i = np.arange(k)
        x, y = (i % 20) * 21.0, (i // 20) * 21.0
        boxes = np.stack([x, y, x + 20, y + 20], 1)
        classes[:] = 0
        valid[:] = True
    return (boxes.astype(np.float32)[None], classes[None], valid[None])


K2_CASES = ("k1", "k31", "k33", "k300", "k512", "ties", "nonfinite",
            "invalid", "disjoint")


@pytest.mark.parametrize("k", [1, 31, 32, 33, 64, 65, 300, 512, 1024])
def test_conflict_bits_layout(k):
    """The packed triangle in the kernel's layout: rows of row_words(K)
    words (a multiple of four); bit t of word w of row i is conflict(i,
    32 w + t) on the words the kernel writes (from the row's 64-row
    diagonal tile to the last tile), zero past K and on every other word."""
    rng = np.random.default_rng(k)
    xy = rng.uniform(0, 200, (2, k, 2))
    boxes = torch.from_numpy(np.concatenate(
        [xy, xy + rng.uniform(10, 60, (2, k, 2))], -1).astype(np.float32))
    classes = torch.from_numpy(rng.integers(0, 2, (2, k)).astype(np.int32))
    bits = cuda_nms.conflict_bits_reference(boxes, classes, 0.2)
    rw = cuda_nms.row_words(k)
    assert rw % 4 == 0 and 32 * rw >= k > 32 * (rw - 4)
    assert bits.shape == (2, k, rw) and bits.dtype == torch.int32
    mask = cuda_nms.written_words(k)
    tiles = -(-k // 64)
    for i in {0, k // 2, k - 1}:
        assert mask[i].tolist() == [2 * (i // 64) <= w < 2 * tiles
                                    for w in range(rw)]
    words = bits.numpy().astype(np.int64) & 0xFFFFFFFF
    unpacked = (words[..., None] >> np.arange(32)) & 1          # (2, k, rw, 32)
    full = cuda_nms.conflict_matrix(boxes, classes, 0.2).numpy()
    want = np.zeros((2, k, 32 * rw), bool)
    want[..., :k] = full
    want = want.reshape(2, k, rw, 32) & mask.numpy()[None, :, :, None]
    np.testing.assert_array_equal(unpacked.astype(bool), want)
    assert cuda_nms.bits_blocks(8, k) == 8 * tiles * (tiles + 1) // 2


@pytest.mark.parametrize("iou", [0.3, 0.6])
@pytest.mark.parametrize("case", K2_CASES)
def test_conflict_bits_walk_matches_greedy(case, iou):
    """The kernel's skip walk over the packed triangle (walk_reference on
    conflict_bits_reference) keeps what K2's plain version and the JAX
    package's scalar greedy keep."""
    from yolov3_tpu.ops.nms import _greedy_suppress, iou_matrix

    boxes, classes, valid = _k2_case(case)
    tb, tc, tv = (torch.from_numpy(a) for a in (boxes, classes, valid))
    walked = cuda_nms.walk_reference(
        cuda_nms.conflict_bits_reference(tb, tc, iou), tv)
    plain = cuda_nms.suppress_reference(tb, tc, tv, iou)
    want = np.asarray(_greedy_suppress(
        iou_matrix(jnp.asarray(boxes[0])),
        jnp.asarray(classes[0][:, None] == classes[0][None, :]),
        jnp.asarray(valid[0]), iou))
    np.testing.assert_array_equal(walked[0].numpy(), want)
    np.testing.assert_array_equal(plain[0].numpy(), want)
    keep, bits = cuda_nms.suppress_bits(tb, tc, tv, iou)  # CPU: plain versions
    assert torch.equal(keep, plain)
    assert torch.equal(bits, cuda_nms.conflict_bits_reference(tb, tc, iou))
    if case == "invalid":
        assert not want.any()
    if case == "disjoint":
        assert want.all()
