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
