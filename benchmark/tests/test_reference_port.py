"""The plain reference against the program on the CPU, at small sizes, on
the same weights and frames (made by ``inputs`` from a seed): the letterbox,
the head maps of the float32 walk and the detections of a whole call."""
import numpy as np
import pytest
import torch

import check
import inputs
from reference import int8, yolo

torch.set_num_threads(2)


@pytest.fixture
def dense(monkeypatch):
    # more candidates over the threshold at these sizes
    monkeypatch.setattr(inputs, "CANDIDATE_SHARE", 0.05)


def port_net(cfg, weights, precision=None):
    from yolov3_tpu_torch import Darknet

    return Darknet(str(cfg), precision=precision, device="cpu").set_params(
        inputs.as_folded_hwio(weights))


@pytest.mark.parametrize("hw", [(72, 96), (96, 60), (96, 96)])
def test_letterbox_matches_port(tiny_cfg, hw):
    from yolov3_tpu_torch.ops.preprocess import preprocess

    frames = inputs.make_frames(3, hw, 5, 0, "cpu")
    want = preprocess(torch.from_numpy(frames).flip(-1), (96, 96))
    got = yolo.letterbox(torch.from_numpy(frames), (96, 96)).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, want, atol=2e-6, rtol=0)


@pytest.mark.parametrize("which", ["tiny_cfg", "small_cfg"])
def test_head_maps_match_port(which, request):
    from yolov3_tpu_torch.model import forward_features

    cfg = request.getfixturevalue(which)
    net = yolo.read_cfg(cfg)
    weights = inputs.make_weights(yolo, net, 3, "cpu")
    x = torch.rand(2, net.height, net.width, 3, generator=torch.Generator().manual_seed(0))
    pnet = port_net(cfg, weights)
    want = forward_features(pnet.graph, pnet.params, x, precision="highest")
    got = yolo.forward(net, weights, x.permute(0, 3, 1, 2))
    assert len(got) == len(want) == len(net.heads)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.permute(0, 2, 3, 1), w, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("which", ["tiny_cfg", "small_cfg"])
def test_detections_match_port(which, request, dense):
    from yolov3_tpu_torch import Detector

    cfg = request.getfixturevalue(which)
    net = yolo.read_cfg(cfg)
    weights = inputs.make_weights(yolo, net, 4, "cpu")
    det = Detector(port_net(cfg, weights, "highest"), prob_thresh=0.05,
                   iou_thresh=0.3, top_k=256, max_results=128, device="cpu")
    frames = inputs.make_frames(4, (48, 64), 9, 0, "cpu")
    got = det.detect_batch(frames)
    want, dec = yolo.detect(net, weights, torch.from_numpy(frames), 0.05, 0.3,
                            256, 128)
    total = 0
    for i, (g, w) in enumerate(zip(got, want)):
        order = np.argsort(-g.class_prob, kind="stable")
        np.testing.assert_array_equal(g.class_idx[order], w.classes)
        np.testing.assert_allclose(g.class_prob[order], w.scores, atol=1e-5)
        np.testing.assert_allclose(g.bbox_tlbr[order], w.boxes, atol=2e-3)
        total += len(w.scores)
        cands = check.candidates(dec, i, (48, 64), (net.height, net.width))
        assert check.det_gaps(yolo.Detections(g.bbox_tlbr, g.class_prob,
                                              g.class_idx), cands).max() < 1e-4
    assert total > 10


def test_int8_state_matches_port(small_cfg):
    """The quantized walk's state, recomputed by ``reference.int8`` from the
    same weights and calibration frames, against the port's
    ``quantize_int8``: the same convolutions on integers, the same rounded
    weights, biases corrected alike, most scales equal and every one within two bf16
    steps (the two calibration walks round in bf16 in their own order)."""
    from yolov3_tpu_torch import Darknet

    net = yolo.read_cfg(small_cfg)
    weights = inputs.make_weights(yolo, net, 7, "cpu")
    calib = inputs.make_frames(8, (48, 64), 7, 1, "cpu")
    pnet = Darknet(str(small_cfg), precision="bf16", device="cpu").set_params(
        inputs.as_folded_hwio(weights))
    pnet.quantize_int8(np.ascontiguousarray(calib[..., ::-1]),
                       act_scheme="symmetric")
    qw, walk = int8.quantize(net, weights,
                             yolo.letterbox(torch.from_numpy(calib), (64, 64)))
    assert walk.plan.quantized == {i for i, q in pnet.qparams.items() if "wq" in q}
    bias_gap = []
    for i in walk.plan.quantized:
        qp = pnet.qparams[i]
        want = (qp["wq"].float() * qp["sw"]).permute(3, 2, 0, 1)
        torch.testing.assert_close(qw[i][0], want, rtol=0, atol=1e-7)
        bias_gap.append(float((qw[i][1] - qp["b"]).abs().max()))
    # a correction moves with the scale of the input it measures
    assert max(bias_gap) < 0.05
    rel = np.array([walk.scales[i] / pnet.act_scales[i] - 1 for i in walk.scales])
    assert np.abs(rel).max() <= 2 ** -6 and (rel == 0).mean() > 0.5
