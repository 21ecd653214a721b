"""The port's evaluation tools against the reference's ``tools/eval_coco.py``
and ``tools/gen_eval_golden.py`` (CPU).

* The numpy scorer of ``yolov3_tpu_torch/tools/eval_coco.py`` is a copy:
  every function has the original's source, and both give the same numbers,
  exactly, on seeded random detections and ground truth.
* ``tests/test_eval.py``'s cases rerun against the port's copy and the
  port's ``run_model_on_coco(..., device="cpu")``.
* ``run_model_on_coco`` gives the reference's mAP to 1e-6 on one synthetic
  COCO set (tiny@192, the eval fixture's frames, jittered ground truth),
  with a ``top_k`` of 16 and the 2x-top-k audit forced.
* The CLI's ``--save-json`` scores offline (``--detections``) as the
  reference's scorer scores the same file.
* ``gen_eval_golden`` run through the port reproduces
  ``tests/data/eval_golden.json``: the same threshold, images and classes,
  boxes within the golden bar (0.1 px).
"""
import inspect
import json
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from tools import eval_coco as jeval
from tools import gen_eval_golden as jgolden
from yolov3_tpu_torch.__main__ import main as cli_main
from yolov3_tpu_torch.graph import load_graph
from yolov3_tpu_torch.inference import Detection
from yolov3_tpu_torch.tools import eval_coco as teval
from yolov3_tpu_torch.tools import gen_eval_golden as tgolden
from yolov3_tpu_torch.utils.export import save_detections_json
from yolov3_tpu_torch.weights import random_raw, write_weights

torch.set_num_threads(1)

FIXTURE = Path(__file__).parent / "data" / "eval_golden.json"
SCORER = ("box_iou_matrix", "average_precision", "match_detections",
          "evaluate", "load_coco_gt", "score_detections_file")


@pytest.mark.parametrize("name", SCORER)
def test_scorer_copies_equal_their_originals(name):
    assert (inspect.getsource(getattr(teval, name))
            == inspect.getsource(getattr(jeval, name)))


@pytest.mark.parametrize("name", ["make_frames", "detections_to_dicts",
                                  "gt_from_dicts"])
def test_fixture_helpers_equal_their_originals(name):
    assert (inspect.getsource(getattr(tgolden, name))
            == inspect.getsource(getattr(jgolden, name)))


def test_fixture_constants_equal_the_originals():
    for name in ("SEED", "N_IMAGES", "IMG_HW", "CELL", "NET_HW", "IOU_THRESH",
                 "INT8_SEEDS", "FLOOR_MARGIN"):
        assert getattr(tgolden, name) == getattr(jgolden, name), name
    assert tgolden.CFG.resolve() == jgolden.CFG.resolve()


def _random_sets(seed, n_img=6, n_cls=4):
    """Seeded detections and ground truth: jittered copies of the ground
    truth, misses, false positives and an image with no ground truth."""
    rng = np.random.default_rng(seed)
    gt, det = {}, {}
    for img in range(n_img):
        gt[img], det[img] = {}, {}
        for c in range(n_cls):
            m = int(rng.integers(0, 5))
            tl = rng.uniform(0, 200, (m, 2))
            boxes = np.concatenate([tl, tl + rng.uniform(5, 80, (m, 2))], 1)
            if img < n_img - 1:
                gt[img][c] = boxes
            k = int(rng.integers(0, m + 3))
            jitter = rng.normal(0, 4, (m, 4))
            extra = rng.uniform(0, 250, (max(k - m, 0), 4))
            extra[:, 2:] = extra[:, :2] + rng.uniform(5, 60, (len(extra), 2))
            db = np.concatenate([boxes + jitter, extra])[:k]
            if k:
                det[img][c] = (db, rng.uniform(0, 1, k))
    return det, gt


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scorer_gives_the_originals_numbers(seed):
    det, gt = _random_sets(seed)
    got, want = teval.evaluate(det, gt), jeval.evaluate(det, gt)
    assert got == want
    a = np.random.default_rng(seed).uniform(0, 100, (7, 4))
    a[:, 2:] += a[:, :2]
    np.testing.assert_array_equal(teval.box_iou_matrix(a, a[:3]),
                                  jeval.box_iou_matrix(a, a[:3]))
    scores = np.random.default_rng(seed).uniform(0, 1, 9)
    matched = np.random.default_rng(seed + 9).uniform(0, 1, 9) < 0.5
    assert (teval.average_precision(scores, matched, 6)
            == jeval.average_precision(scores, matched, 6))
    np.testing.assert_array_equal(
        teval.match_detections(a, scores[:7], a[2:5] + 1.0, 0.5),
        jeval.match_detections(a, scores[:7], a[2:5] + 1.0, 0.5))


def _case_iou_matrix_basics():
    a = np.array([[0, 0, 10, 10]], np.float32)
    b = np.array([[0, 0, 10, 10], [5, 5, 15, 15], [20, 20, 30, 30]],
                 np.float32)
    iou = teval.box_iou_matrix(a, b)
    np.testing.assert_allclose(iou[0], [1.0, 25 / 175, 0.0], atol=1e-6)


def _case_perfect_detector_ap_is_one():
    gt = {0: {0: np.array([[0, 0, 10, 10], [20, 20, 40, 40]], np.float32)}}
    det = {0: {0: (np.array([[0, 0, 10, 10], [20, 20, 40, 40]], np.float32),
                   np.array([0.9, 0.8]))}}
    res = teval.evaluate(det, gt)
    assert res["mAP50"] == 1.0
    assert res["mAP50_95"] == 1.0


def _case_no_detections_ap_zero():
    gt = {0: {0: np.array([[0, 0, 10, 10]], np.float32)}}
    assert teval.evaluate({}, gt)["mAP50"] == 0.0


def _case_false_positives_reduce_precision():
    gt = {0: {0: np.array([[0, 0, 10, 10]], np.float32)}}
    det = {0: {0: (np.array([[50, 50, 60, 60], [0, 0, 10, 10]], np.float32),
                   np.array([0.95, 0.9]))}}
    assert 0.4 < teval.evaluate(det, gt)["mAP50"] < 0.6


def _case_localization_quality_separates_thresholds():
    gt = {0: {0: np.array([[0, 0, 100, 100]], np.float32)}}
    det = {0: {0: (np.array([[0, 0, 100, 80]], np.float32),  # IoU = 0.8
                   np.array([0.9]))}}
    res = teval.evaluate(det, gt)
    assert res["mAP50"] == 1.0
    assert 0.5 < res["mAP50_95"] < 0.75


def _case_greedy_matching_one_gt_per_det():
    gt_boxes = np.array([[0, 0, 10, 10]], np.float32)
    det_boxes = np.array([[0, 0, 10, 10], [1, 1, 11, 11]], np.float32)
    matched = teval.match_detections(det_boxes, np.array([0.9, 0.8]),
                                     gt_boxes, 0.5)
    assert matched.tolist() == [True, False]


def _case_ap_handles_empty_class():
    assert np.isnan(teval.average_precision(np.zeros(0), np.zeros(0, bool), 0))
    assert teval.average_precision(np.zeros(0), np.zeros(0, bool), 3) == 0.0


def _case_multi_class_macro_average():
    gt = {0: {0: np.array([[0, 0, 10, 10]], np.float32),
              1: np.array([[20, 20, 30, 30]], np.float32)}}
    det = {0: {0: (np.array([[0, 0, 10, 10]], np.float32), np.array([0.9])),
               1: (np.array([[90, 90, 99, 99]], np.float32), np.array([0.9]))}}
    assert abs(teval.evaluate(det, gt)["mAP50"] - 0.5) < 1e-6


SCORER_CASES = {n[len("_case_"):]: f for n, f in list(globals().items())
                if n.startswith("_case_")}


@pytest.mark.parametrize("case", sorted(SCORER_CASES))
def test_scorer_cases_of_the_reference(case):
    """``tests/test_eval.py``'s constructed cases, against the port's copy."""
    SCORER_CASES[case]()


def test_score_detections_file_offline(tmp_path):
    """Offline scoring of a --save-json-style file: file-name image ids,
    contiguous ids, unknown images counted; sparse COCO ids with
    ``category_ids="coco"``; a false positive drags AP below 1."""
    ann = {
        "categories": [{"id": 1}, {"id": 3}, {"id": 7}],
        "images": [{"id": 10, "file_name": "a.jpg"},
                   {"id": 11, "file_name": "b.jpg"}],
        "annotations": [
            {"image_id": 10, "category_id": 3, "bbox": [5, 5, 20, 10]},
            {"image_id": 11, "category_id": 7, "bbox": [0, 0, 8, 8]},
            {"image_id": 11, "category_id": 7, "bbox": [40, 40, 6, 12],
             "iscrowd": 1},
        ],
    }
    ann_path = tmp_path / "ann.json"
    ann_path.write_text(json.dumps(ann))
    dets = [
        {"image_id": "a.jpg", "category_id": 1, "bbox": [5, 5, 20, 10],
         "score": 0.9},
        {"image_id": "b.jpg", "category_id": 2, "bbox": [0, 0, 8, 8],
         "score": 0.8},
        {"image_id": "missing.jpg", "category_id": 0, "bbox": [0, 0, 1, 1],
         "score": 0.5},
    ]
    det_path = tmp_path / "dets.json"
    det_path.write_text(json.dumps(dets))
    res = teval.score_detections_file(det_path, ann_path)
    assert res["mAP50"] == 1.0 and res["mAP50_95"] == 1.0
    assert res["skipped_entries"] == 1
    dets_coco = [
        {"image_id": 10, "category_id": 3, "bbox": [5, 5, 20, 10],
         "score": 0.9},
        {"image_id": 11, "category_id": 7, "bbox": [0, 0, 8, 8],
         "score": 0.8},
        {"image_id": 11, "category_id": 99, "bbox": [0, 0, 1, 1],
         "score": 0.5},
    ]
    det_path.write_text(json.dumps(dets_coco))
    res = teval.score_detections_file(det_path, ann_path, category_ids="coco")
    assert res["mAP50"] == 1.0
    assert res["skipped_entries"] == 1
    dets_fp = dets[:2] + [{"image_id": "a.jpg", "category_id": 1,
                           "bbox": [100, 100, 5, 5], "score": 0.95}]
    det_path.write_text(json.dumps(dets_fp))
    assert teval.score_detections_file(det_path, ann_path)["mAP50"] < 1.0


def test_save_json_roundtrips_through_offline_scoring(tmp_path):
    """The port's exporter and the port's offline scorer agree on the bbox
    convention (tlbr → xywh → tlbr): GT made from the same detections
    scores 1.0."""
    rng = np.random.default_rng(0)
    results, ann_images, ann_list = {}, [], []
    for k in range(3):
        tl = rng.uniform(0, 100, (4, 2))
        wh = rng.uniform(5, 50, (4, 2))
        boxes = np.concatenate([tl, tl + wh], axis=1).astype(np.float32)
        cls = rng.integers(0, 5, 4)
        results[f"img{k}.jpg"] = Detection(
            bbox_tlbr=boxes,
            class_prob=rng.uniform(0.3, 1.0, 4).astype(np.float32),
            class_idx=cls.astype(np.int32))
        ann_images.append({"id": k, "file_name": f"img{k}.jpg"})
        for b, c in zip(boxes, cls):
            ann_list.append({"image_id": k, "category_id": int(c) + 1,
                             "bbox": [float(b[0]), float(b[1]),
                                      float(b[2] - b[0]),
                                      float(b[3] - b[1])]})
    det_path = tmp_path / "dets.json"
    save_detections_json(det_path, results)
    ann_path = tmp_path / "ann.json"
    ann_path.write_text(json.dumps({
        "categories": [{"id": i + 1} for i in range(5)],
        "images": ann_images, "annotations": ann_list}))
    res = teval.score_detections_file(det_path, ann_path)
    assert res["skipped_entries"] == 0
    assert res["mAP50"] == 1.0 and res["mAP50_95"] == 1.0


@pytest.fixture(scope="module")
def tiny_weights(tmp_path_factory):
    g = load_graph(tgolden.CFG)
    path = tmp_path_factory.mktemp("w") / "tiny.weights"
    write_weights(path, g, random_raw(g, seed=12))
    return path


def _coco_dir(root, shapes, seed, cat_ids, boxes=None):
    """Images of ``shapes`` and one box of ``cat_ids[0]`` each (plus a crowd
    box of ``cat_ids[-1]``, dropped), or ``boxes`` ({img: {cls: tlbr}})."""
    img_dir = root / "imgs"
    img_dir.mkdir()
    rng = np.random.default_rng(seed)
    images, anns = [], []
    for i, hw in enumerate(shapes):
        frame = (hw if isinstance(hw, np.ndarray) else
                 rng.integers(0, 256, (*hw, 3), dtype=np.uint8))
        name = f"im{i}.png"
        cv2.imwrite(str(img_dir / name), frame)
        images.append({"id": 100 + i, "file_name": name,
                       "height": frame.shape[0], "width": frame.shape[1]})
        per = boxes[i] if boxes is not None else {0: [[10, 10, 90, 70]]}
        for c, bs in per.items():
            for x0, y0, x1, y1 in np.asarray(bs, np.float64).tolist():
                anns.append({"id": len(anns), "image_id": 100 + i,
                             "category_id": cat_ids[c], "iscrowd": 0,
                             "bbox": [x0, y0, x1 - x0, y1 - y0]})
        anns.append({"id": len(anns), "image_id": 100 + i,
                     "category_id": cat_ids[-1], "iscrowd": 1,
                     "bbox": [50, 50, 40, 40]})
    ann_path = root / "ann.json"
    ann_path.write_text(json.dumps({
        "images": images, "annotations": anns,
        "categories": [{"id": c, "name": str(c)} for c in cat_ids]}))
    return img_dir, ann_path


def test_run_model_on_coco_end_to_end(tmp_path, tiny_weights):
    """Sparse category ids, mixed image sizes, crowd boxes skipped: finite
    mAP numbers."""
    img_dir, ann = _coco_dir(tmp_path, [(240, 320), (300, 300)], 0, [18, 3])
    res = teval.run_model_on_coco(img_dir, ann, tgolden.CFG, tiny_weights,
                                  prob_thresh=0.3, batch_size=2, device="cpu")
    assert 0.0 <= res["mAP50"] <= 1.0
    assert 0.0 <= res["mAP50_95"] <= res["mAP50"] + 1e-9


def test_run_model_on_coco_int8(tmp_path, tiny_weights):
    """``quantize_int8=N``: calibration on the first N images, then the
    int8-carrier tier scored."""
    img_dir, ann = _coco_dir(tmp_path, [(200, 200)], 3, [7])
    res = teval.run_model_on_coco(img_dir, ann, tgolden.CFG, tiny_weights,
                                  prob_thresh=0.3, batch_size=1,
                                  quantize_int8=1, device="cpu")
    assert 0.0 <= res["mAP50"] <= 1.0
    assert np.isfinite(res["mAP50_95"])


def test_eval_cli_main(tmp_path, tiny_weights, capsys):
    """``main(argv)`` in process prints the mAP JSON line."""
    img_dir, ann = _coco_dir(tmp_path, [(240, 320)], 0, [1])
    teval.main(["--images", str(img_dir), "--annotations", str(ann),
                "--config", str(tgolden.CFG), "--weights", str(tiny_weights),
                "--prob-thresh", "0.3", "--batch-size", "2", "--device",
                "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"mAP50", "mAP50_95"}


@pytest.fixture(scope="module")
def coco_192(tmp_path_factory):
    """The eval fixture's frames as a COCO directory at tiny@192 (square
    frames: the letterbox is the identity), the fixture's ground truth
    jittered by 2 px with a fifth of the boxes dropped (so mAP50_95 is not
    1), under sparse category ids; the fixture's weights."""
    root = tmp_path_factory.mktemp("coco")
    fx = json.loads(FIXTURE.read_text())
    rng = np.random.default_rng(5)
    boxes = {}
    for i, per in fx["gt"].items():
        boxes[int(i)] = {}
        for c, bs in per.items():
            bs = np.asarray(bs) + rng.normal(0, 2, (len(bs), 4))
            boxes[int(i)][int(c)] = bs[rng.uniform(0, 1, len(bs)) > 0.2]
    frames = tgolden.make_frames(fx["seed"])
    cat_ids = [1 + c + c // 11 for c in range(80)]
    img_dir, ann = _coco_dir(root, list(frames), 0, cat_ids, boxes)
    cfg = root / "tiny192.cfg"
    cfg.write_text(tgolden.CFG.read_text().replace("width=416", "width=192")
                   .replace("height=416", "height=192"))
    wpath = root / "eval.weights"
    g = load_graph(tgolden.CFG)
    write_weights(wpath, g, random_raw(g, seed=tgolden.SEED))
    return img_dir, ann, cfg, wpath


def test_run_model_on_coco_equals_the_reference(coco_192):
    """One synthetic set through both packages' ``run_model_on_coco`` at
    "highest", ``top_k`` 16 and the 2x-top-k audit forced: the same mAP50
    / mAP50_95 to 1e-6, the same saturation counts and audit deltas."""
    img_dir, ann, cfg, wpath = coco_192
    kw = dict(prob_thresh=0.005, iou_thresh=0.45, batch_size=8,
              precision="highest", top_k=16, audit="always")
    got = teval.run_model_on_coco(img_dir, ann, cfg, wpath, **kw,
                                  device="cpu")
    want = jeval.run_model_on_coco(img_dir, ann, cfg, wpath, **kw)
    assert 0.0 < got["mAP50_95"] < got["mAP50"] < 1.0
    for key in ("mAP50", "mAP50_95"):
        assert abs(got[key] - want[key]) <= 1e-6, (key, got, want)
    assert got["saturated_images"] == want["saturated_images"]
    assert got["near_saturated_images"] == want["near_saturated_images"]
    assert got["audit"]["top_k"] == want["audit"]["top_k"] == 32
    assert got["audit"]["sample_images"] == want["audit"]["sample_images"] == 8
    assert got["audit"]["mAP50_delta"] > 0     # 16 candidates truncate
    for key in ("mAP50_delta", "mAP50_95_delta"):
        assert abs(got["audit"][key] - want["audit"][key]) <= 1e-6


def test_truncation_audit_auto_triggers(tmp_path):
    """With a ``top_k`` small enough to saturate (random weights pass
    thousands of candidates at 0.05), the auto audit re-runs the saturated
    image at 2x top_k and reports the mAP deltas."""
    g = load_graph(tgolden.CFG)
    wpath = tmp_path / "t.weights"
    write_weights(wpath, g, random_raw(g, seed=21))
    img_dir, ann = _coco_dir(tmp_path, [(240, 320)], 7, [1])
    res = teval.run_model_on_coco(img_dir, ann, tgolden.CFG, wpath,
                                  prob_thresh=0.05, batch_size=1, top_k=4,
                                  device="cpu")
    assert res["saturated_images"] >= 1
    audit = res["audit"]
    assert audit["top_k"] == 8 and audit["sample_images"] == 1
    assert np.isfinite(audit["mAP50_delta"])
    assert np.isfinite(audit["mAP50_95_delta"])


def test_save_json_scores_offline_as_online(coco_192, tmp_path, capsys):
    """The port's CLI ``--image-dir --save-json`` on the set, then the
    tool's ``--detections`` mode: the reference's scorer gives the same
    numbers on the same file, and they equal the online run's up to the
    file's rounding (boxes to 0.01 px, scores to 1e-5)."""
    img_dir, ann, cfg, wpath = coco_192
    saved = tmp_path / "dets.json"
    cli_main(["--image-dir", str(img_dir), "--save-json", str(saved),
              "--config", str(cfg), "--weights", str(wpath), "--precision",
              "highest", "--prob-thresh", "0.005", "--iou-thresh", "0.45",
              "--top-k", "1024", "--max-results", "0", "--batch-size", "8",
              "--device", "cpu", "--no-show"])
    capsys.readouterr()
    teval.main(["--detections", str(saved), "--annotations", str(ann)])
    offline = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = jeval.score_detections_file(saved, ann)
    assert offline == {"mAP50": round(want["mAP50"], 4),
                       "mAP50_95": round(want["mAP50_95"], 4),
                       "mode": "offline"}
    online = teval.run_model_on_coco(img_dir, ann, cfg, wpath, 0.005, 0.45,
                                     8, None, "highest", 1024, device="cpu")
    assert abs(online["mAP50"] - want["mAP50"]) <= 1e-3
    assert abs(online["mAP50_95"] - want["mAP50_95"]) <= 1e-3


def test_gen_eval_golden_reproduces_the_frozen_fixture(tmp_path):
    """``gen_eval_golden.main --out`` through the port, on the CPU: the
    threshold lands in the same score gap (within a hundredth of it), the
    same images and classes, the same box count per class, every golden
    box matched within 0.1 px; the int8 floors it chose are written."""
    out = tmp_path / "eval_golden.json"
    tgolden.main(["--out", str(out), "--device", "cpu"])
    got, want = json.loads(out.read_text()), json.loads(FIXTURE.read_text())
    for key in ("seed", "n_images", "img_hw", "cell", "net_hw", "iou_thresh"):
        assert got[key] == want[key], key
    assert (abs(got["prob_thresh"] - want["prob_thresh"])
            < 0.01 * want["threshold_margin"])
    assert got["gt"].keys() == want["gt"].keys()
    for i, per in want["gt"].items():
        assert got["gt"][i].keys() == per.keys(), i
        for c, boxes in per.items():
            g, w = np.asarray(got["gt"][i][c]), np.asarray(boxes)
            assert g.shape == w.shape, (i, c)
            err = np.abs(g[:, None] - w[None]).max(-1).min(0).max()
            assert err <= 0.1, (i, c, err)
    assert 0.0 < got["int8_mAP50_95_floor"] <= got["int8_mAP50_floor"] < 1.0
