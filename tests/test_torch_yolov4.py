"""YOLOv4 (``models/yolov4.cfg``, AlexeyAB/darknet's ``cfg/yolov4.cfg``)
through the port: the lowered graph against the published structure and
conv work, the benchmark's copy of the cfg, and the port's ``Detector``
against the benchmark's plain reference ``benchmark/reference/yolov4.py``
on the CPU at 128 x 128 in float32, with the reference's Mish and
``scale_x_y`` each shown to matter at the comparison's tolerance."""
import importlib.util
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from yolov3_tpu_torch import Darknet, Detector
from yolov3_tpu_torch.config import parse_config
from yolov3_tpu_torch.graph import load_graph

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
CFG = ROOT / "models" / "yolov4.cfg"
if str(BENCH) not in sys.path:  # reference.yolo, inputs, counts
    sys.path.append(str(BENCH))

import counts  # noqa: E402
import inputs  # noqa: E402

SIZE = 128
SEED = 2 ** 31 + 25
# The port's float32 walk and the reference's differ only in how Mish is
# evaluated (F.mish against x * tanh(softplus(x))) and in the order of a
# few float32 sums, a few float32 ulps a layer; through 110 convs that
# moves a score by under 1e-5 and a box corner by under 2e-3 pixels of a
# 480 x 640 frame. Leaving out the heads' scale_x_y moves centres by up to
# (s - 1) / 2 of a cell, pixels; replacing Mish by leaky moves every map.
SCORE_ATOL = 1e-5
BOX_ATOL = 2e-3


def _reference():
    spec = importlib.util.spec_from_file_location(
        "reference.yolov4", BENCH / "reference" / "yolov4.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules.setdefault("reference.yolov4", mod)
    spec.loader.exec_module(mod)
    return mod


ref = _reference()


def test_cfg_lowers_to_the_published_structure():
    graph = load_graph(CFG)
    convs = graph.conv_nodes
    assert len(graph.nodes) == 162 and len(convs) == 110
    assert Counter(n.activation for n in convs) == {"mish": 72, "leaky": 35,
                                                    "linear": 3}
    assert sum(n.kind == "shortcut" for n in graph.nodes) == 23
    assert [n.index for n in graph.yolo_nodes] == [139, 150, 161]
    assert graph.head_strides() == (8, 16, 32)
    assert graph.head_scales() == (1.2, 1.1, 1.05)
    assert [n.kind for n in graph.nodes if n.kind == "maxpool"] == ["maxpool"] * 3
    assert counts.image_ops(ref.read_cfg(CFG), 608) == 128_389_482_496
    # the [yolo] sections' training keys are read, and the port ignores them
    yolo = [b for b in parse_config(CFG) if b["type"] == "yolo"]
    assert [b["scale_x_y"] for b in yolo] == [1.2, 1.1, 1.05]
    assert {b["nms_kind"] for b in yolo} == {"greedynms"}
    assert all(b["iou_thresh"] == 0.213 and b["beta_nms"] == 0.6 for b in yolo)


def test_benchmark_copy_is_byte_equal():
    assert (BENCH / "configs" / "yolov4.cfg").read_bytes() == CFG.read_bytes()


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The cfg at 128 x 128, its seeded weights (``inputs.make_weights``
    through the reference), two frames, the port's detections (float32,
    ``decode_impl="pallas"``: K1's plain version on the CPU) and the
    reference's walk of the same frames."""
    path = tmp_path_factory.mktemp("yolov4") / "yolov4-128.cfg"
    path.write_text(CFG.read_text().replace("width=608", f"width={SIZE}")
                    .replace("height=608", f"height={SIZE}"))
    net = ref.read_cfg(path)
    weights = inputs.make_weights(ref, net, SEED, "cpu")
    frames = inputs.make_frames(2, (96, 128), SEED, 0, "cpu")
    pnet = Darknet(str(path), precision="highest", device="cpu").set_params(
        inputs.as_folded_hwio(weights))
    det = Detector(pnet, prob_thresh=0.05, iou_thresh=0.3, top_k=512,
                   max_results=128, decode_impl="pallas", device="cpu")
    assert det.route == "pallas"
    got = det.detect_batch(frames)
    x = ref.letterbox(torch.from_numpy(frames), (net.height, net.width))
    with torch.inference_mode():
        maps = ref.forward(net, weights, x)
    return dict(net=net, weights=weights, frames=frames, got=got, maps=maps)


def _detections(net, maps, frames, scales=None):
    """The reference's detections from its head maps (``ref.detect``'s
    last steps), with the heads' ``scale_x_y`` or the given ``scales``."""
    dec = ref.decode(net, maps, scales)
    score, cls = dec.scores
    out = []
    for i in range(len(frames)):
        bx, sc, cl = (dec.boxes[i].numpy(), score[i].numpy(), cls[i].numpy())
        keep = ref.select(bx, sc, cl, 0.05, 0.3, 512, 128)
        out.append((ref.unletterbox(bx[keep], frames.shape[1:3],
                                    (net.height, net.width)),
                    sc[keep], cl[keep]))
    return out


def _gap(got, want) -> float:
    """The largest score or box-corner difference, or inf where the
    detection sets differ in size or classes."""
    worst = 0.0
    for g, (boxes, scores, classes) in zip(got, want):
        if len(g.class_prob) != len(scores):
            return float("inf")
        order = np.argsort(-g.class_prob, kind="stable")
        if not np.array_equal(g.class_idx[order], classes):
            return float("inf")
        worst = max(worst, float(np.abs(g.class_prob[order] - scores).max(
            initial=0.0) / SCORE_ATOL), float(np.abs(
                g.bbox_tlbr[order] - boxes).max(initial=0.0) / BOX_ATOL))
    return worst


def test_detector_matches_the_reference(small):
    want = _detections(small["net"], small["maps"], small["frames"])
    assert sum(len(s) for _, s, _ in want) >= 10
    got = small["got"]
    for g, (boxes, scores, classes) in zip(got, want):
        order = np.argsort(-g.class_prob, kind="stable")
        np.testing.assert_array_equal(g.class_idx[order], classes)
        np.testing.assert_allclose(g.class_prob[order], scores, rtol=0,
                                   atol=SCORE_ATOL)
        np.testing.assert_allclose(g.bbox_tlbr[order], boxes, rtol=0,
                                   atol=BOX_ATOL)
    assert _gap(got, want) <= 1.0


def test_reference_via_detect_is_its_walk_and_decode(small):
    """``ref.detect``, as the benchmark calls it, gives the same detections
    as the walk and decode above."""
    dets, _ = ref.detect(small["net"], small["weights"],
                         torch.from_numpy(small["frames"]), 0.05, 0.3, 512, 128)
    want = _detections(small["net"], small["maps"], small["frames"])
    for d, (boxes, scores, classes) in zip(dets, want):
        np.testing.assert_array_equal(d.boxes, boxes)
        np.testing.assert_array_equal(d.scores, scores)
        np.testing.assert_array_equal(d.classes, classes)


@pytest.mark.parametrize("left_out", ["scale_x_y", "mish"])
def test_the_comparison_sees_what_is_left_out(small, left_out, monkeypatch):
    """The reference without the heads' scale_x_y (every s = 1), or with
    Mish replaced by leaky, disagrees with the port beyond the tolerance:
    the test above holds the port to both."""
    net, frames = small["net"], small["frames"]
    if left_out == "scale_x_y":
        want = _detections(net, small["maps"], frames, [1.0] * len(net.heads))
    else:
        monkeypatch.setattr(ref, "mish", lambda x: torch.nn.functional.leaky_relu(
            x, 0.1))
        x = ref.letterbox(torch.from_numpy(frames), (net.height, net.width))
        with torch.inference_mode():
            maps = ref.forward(net, small["weights"], x)
        want = _detections(net, maps, frames)
    assert _gap(small["got"], want) > 1.0
