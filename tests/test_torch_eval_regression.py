"""The end-to-end accuracy scalar of ``tests/test_eval_regression.py``
through the port: the same frozen fixture (``tests/data/eval_golden.json``:
tiny@192 on 8 structured frames, ground truth the JAX package's fp32
``precision="highest"`` Detector output), the same scorer and frames
through the port's copies (``yolov3_tpu_torch.tools.eval_coco.evaluate``,
``yolov3_tpu_torch.tools.gen_eval_golden``, held to the originals by
``tests/test_torch_eval.py``), run through the port's ``Darknet(...,
device="cpu")`` and ``Detector``, which serves each call from its cached
program:

* fp32 reproduces the ground truth: mAP50 == mAP50_95 == 1.0 exactly;
* int8, symmetric and asymmetric activation schemes, clear the fixture's
  pinned floors.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from yolov3_tpu_torch import Darknet, Detector
from yolov3_tpu_torch.graph import load_graph
from yolov3_tpu_torch.tools.eval_coco import evaluate
from yolov3_tpu_torch.tools.gen_eval_golden import (CFG, NET_HW, SEED,
                                                    detections_to_dicts,
                                                    make_frames)
from yolov3_tpu_torch.weights import random_raw, write_weights

torch.set_num_threads(1)

FIXTURE = Path(__file__).parent / "data" / "eval_golden.json"


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    fx = json.loads(FIXTURE.read_text())
    gt = {int(i): {int(c): np.asarray(b, np.float64)
                   for c, b in per.items()}
          for i, per in fx["gt"].items()}
    wpath = tmp_path_factory.mktemp("w") / "eval.weights"
    g = load_graph(CFG)
    write_weights(wpath, g, random_raw(g, seed=SEED))
    frames = make_frames(fx["seed"], n=fx["n_images"], hw=fx["img_hw"],
                         cell=fx["cell"])
    return fx, gt, wpath, frames


def _score(net, fx, gt, frames):
    det = Detector(net, prob_thresh=fx["prob_thresh"],
                   iou_thresh=fx["iou_thresh"], net_hw=NET_HW)
    res = evaluate(detections_to_dicts(det.detect_batch(frames)), gt)
    assert len(det._pipelines) == 1       # the call ran its cached program
    return res


def test_fp32_pipeline_reproduces_golden_map(setup):
    fx, gt, wpath, frames = setup
    net = Darknet(CFG, precision="highest", device="cpu").load_weights(wpath)
    res = _score(net, fx, gt, frames)
    # the ground truth is the reference pipeline's own frozen output: below
    # 1.0 a detection moved past IoU 0.95, changed class, appeared or
    # disappeared
    assert res["mAP50"] == 1.0, res
    assert res["mAP50_95"] == 1.0, res


@pytest.mark.parametrize("act_scheme", ["symmetric", "asymmetric"])
def test_int8_pipeline_clears_pinned_map_floor(setup, act_scheme):
    """Calibrated on the evaluation frames, as the reference's test does;
    both activation schemes must clear the same pinned floors."""
    fx, gt, wpath, frames = setup
    net = Darknet(CFG, precision=None, device="cpu").load_weights(wpath)
    net.quantize_int8(frames, net_hw=NET_HW, act_scheme=act_scheme)
    res = _score(net, fx, gt, frames)
    assert res["mAP50"] >= fx["int8_mAP50_floor"], res
    assert res["mAP50_95"] >= fx["int8_mAP50_95_floor"], res
