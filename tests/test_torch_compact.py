"""The compact route: ``batched_nms`` / ``batched_nms_compact`` bit-identical
to the JAX package's, K1c's plain version against the Pallas compact decode
(interpret mode on the CPU), and the Detector's ``decode_impl="xla"`` route
against the JAX Detector's."""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu.inference import Detector as JDetector
from yolov3_tpu.model import Darknet as JDarknet
from yolov3_tpu.ops import nms as jnms
from yolov3_tpu.ops.pallas_decode import decode_compact_pallas
from yolov3_tpu_torch import Darknet, Detector, forward_compact
from yolov3_tpu_torch.ops import cuda_decode
from yolov3_tpu_torch.ops import nms as tnms
from yolov3_tpu_torch.weights import fold_raw, random_raw

torch.set_num_threads(1)

DATA = Path(__file__).parent / "data"
MODELS = Path(__file__).parent.parent / "models"
SMALL_CFG = str(DATA / "port_small.cfg")
ANCHORS = [((10.0, 14.0), (23.0, 27.0), (37.0, 58.0)),
           ((81.0, 82.0), (135.0, 169.0), (344.0, 319.0))]
STRIDES = [32, 16]


def _random_det(rng, n, classes, size=416, quantize=False):
    """(n, 5+C) decoded rows: center-xywh, objectness, class probs."""
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


def _compact(det):
    """(B, N, 5+C) rows → the compact decode's (tlbr boxes, scores, classes)."""
    half = det[..., 2:4] * 0.5
    boxes = np.concatenate([det[..., :2] - half, det[..., :2] + half], -1)
    return (boxes.astype(np.float32),
            (det[..., 4] * det[..., 5:].max(-1)).astype(np.float32),
            det[..., 5:].argmax(-1).astype(np.int32))


def _cases():
    rng = np.random.default_rng(77)
    return {
        # det (B, N, 5+C), prob_thresh, iou_thresh, top_k, max_results
        "random": (np.stack([_random_det(rng, 800, 6), _random_det(rng, 800, 6)]),
                   0.2, 0.4, 128, 0),
        "ties": (_random_det(rng, 600, 3, quantize=True)[None], 0.1, 0.45, 256, 0),
        "over_k": (_random_det(rng, 1201, 4)[None], 0.01, 0.4, 64, 0),
        "compact": (_random_det(rng, 3000, 10)[None], 0.25, 0.45, 256, 32),
    }


CASES = _cases()


def _assert_same(got, want, msg):
    for name in ("boxes", "scores", "classes", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=f"{msg} {name}")
    assert got.classes.dtype == torch.int32


@pytest.mark.parametrize("select", ["pairmax-2", "pairmax-4", "pairmax-8", "topk"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_batched_nms_compact_bit_identical(case, select):
    det, prob, iou, top_k, max_results = CASES[case]
    impl, _, group = select.partition("-")
    group = int(group or 2)
    boxes, scores, classes = _compact(det)
    kw = dict(prob_thresh=prob, iou_thresh=iou, top_k=top_k,
              max_results=max_results, select_impl=impl, select_group=group)
    got = tnms.batched_nms_compact(torch.from_numpy(boxes),
                                   torch.from_numpy(scores),
                                   torch.from_numpy(classes), **kw)
    want = jnms.batched_nms_compact(jnp.asarray(boxes), jnp.asarray(scores),
                                    jnp.asarray(classes), **kw)
    _assert_same(got, want, f"{case} {select}")


@pytest.mark.parametrize("case", ["random", "ties", "over_k"])
def test_batched_nms_bit_identical(case):
    det, prob, iou, top_k, _ = CASES[case]
    got = tnms.batched_nms(torch.from_numpy(det), prob_thresh=prob,
                           iou_thresh=iou, top_k=top_k)
    want = jnms.batched_nms(jnp.asarray(det), prob_thresh=prob,
                            iou_thresh=iou, top_k=top_k)
    _assert_same(got, want, case)


def test_select_pairmax_direct_form_above_exact_index_limit(monkeypatch):
    """Past the f32-exact candidate index (N ≥ 2^24) the selection takes
    the direct top-k form; with the limit lowered, that form gives the JAX
    selection's results bit for bit."""
    det, prob, _, top_k, _ = CASES["ties"]
    boxes, scores, classes = _compact(det)
    masked = np.where(scores >= prob, scores, 0.0).astype(np.float32)
    want = jnms._select_pairmax(jnp.asarray(boxes), jnp.asarray(masked),
                                jnp.asarray(classes), top_k)
    direct, called = tnms._select_topk, []
    monkeypatch.setattr(tnms, "EXACT_INDEX_LIMIT", 16)
    monkeypatch.setattr(tnms, "_select_topk",
                        lambda *a: called.append(1) or direct(*a))
    got = tnms._select_pairmax(torch.from_numpy(boxes), torch.from_numpy(masked),
                               torch.from_numpy(classes), top_k)
    assert called
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("prob_thresh", [0.0, 0.3])
def test_k1c_plain_matches_pallas_compact_decode(prob_thresh):
    rng = np.random.default_rng(3)
    heads = []
    for g in (5, 10):
        f = rng.normal(0, 2, (2, g, g, 3, 85)).astype(np.float32)
        f[..., 4:] = np.round(f[..., 4:] * 8) / 8            # exact ties
        big = rng.uniform(0, 1, f[..., 2:4].shape) < 0.05
        f[..., 2:4] = np.where(big, rng.uniform(60, 90, big.shape), f[..., 2:4])
        heads.append(f.reshape(2, g, g, 255))
    want = [np.asarray(a) for a in decode_compact_pallas(
        [jnp.asarray(h) for h in heads], ANCHORS, STRIDES, 80,
        prob_thresh=prob_thresh)]
    got = [t.numpy() for t in cuda_decode.decode_compact(
        [torch.from_numpy(h) for h in heads], ANCHORS, STRIDES, 80,
        prob_thresh=prob_thresh)]
    assert [g.shape for g in got] == [w.shape for w in want]
    assert got[2].dtype == np.int32
    np.testing.assert_array_equal(got[2], want[2])            # classes
    np.testing.assert_array_equal(got[1] == 0, want[1] == 0)  # threshold
    # sigmoid / exp differ in the last ulps between XLA's CPU backend and torch
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-4)


def test_k1c_wrapper_rejects_what_the_kernel_does_not_take():
    h = torch.zeros(1, 5, 5, 24)
    bad = (torch.empty(1, 10, 4), torch.empty(1, 10), torch.empty(1, 10))
    with pytest.raises(ValueError, match="compact outputs"):
        cuda_decode.decode_compact_head(h, ANCHORS[0], 32, 3, out=bad)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        cuda_decode.decode_compact_head(h.to("meta"), ANCHORS[0], 32, 3)


@pytest.mark.parametrize("cfg,net_hw", [(SMALL_CFG, (64, 64)),
                                        (str(MODELS / "yolov3-tiny.cfg"), (160, 160))],
                         ids=["small@64", "tiny@160"])
def test_detector_xla_route_matches_jax(cfg, net_hw):
    net = Darknet(cfg, precision="highest", device="cpu")
    params = fold_raw(random_raw(net.graph, seed=12))
    net.set_params(params)
    frames = np.random.default_rng(4).integers(0, 256, (2, 90, 120, 3),
                                               dtype=np.uint8)
    kw = dict(prob_thresh=0.1, iou_thresh=0.45, net_hw=net_hw,
              max_results=64, decode_impl="xla")
    det = Detector(net, **kw)
    assert det.route == "xla"
    got = det.detect_batch(frames)
    jnet = JDarknet(cfg, precision="highest").set_params(params)
    want = JDetector(jnet, **kw).detect_batch(frames)
    assert sum(len(d.class_idx) for d in want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.class_idx, w.class_idx)
        np.testing.assert_allclose(g.class_prob, w.class_prob, atol=5e-5)
        np.testing.assert_allclose(g.bbox_tlbr, w.bbox_tlbr, atol=0.1)


def test_compact_routes_same_detection_sets(cfg_paths):
    """forward_compact through the plain decode (cell-major) and through
    K1c (anchor-major) give the same detection sets after NMS."""
    net = Darknet(cfg_paths["yolov3-tiny"], device="cpu")
    net.set_params(fold_raw(random_raw(net.graph, seed=12)))
    x = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 1, (2, 160, 160, 3)).astype(np.float32))
    sets = []
    for impl in ("xla", "pallas"):
        out = forward_compact(net.graph, net.params, x, decode_impl=impl)
        res = tnms.batched_nms_compact(*out, prob_thresh=0.3, top_k=256)
        arr = tnms.unpack_results(tnms.pack_results(res).numpy())
        sets.append([{(tuple(np.round(b, 3)), int(c), round(float(s), 5))
                      for b, s, c, v in zip(arr.boxes[i], arr.scores[i],
                                            arr.classes[i], arr.valid[i]) if v}
                     for i in range(2)])
    assert sets[0] == sets[1] and all(sets[0])
