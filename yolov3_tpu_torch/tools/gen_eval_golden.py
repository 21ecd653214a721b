"""Regenerate the end-to-end accuracy fixture through the port.

Port of ``tools/gen_eval_golden.py``: synthetic weights + a fixed synthetic
image set + the numpy mAP of ``tools/eval_coco.py`` (the port's copy) make
ONE pinned scalar. Ground truth is the float32 ``precision="highest"``
Detector's own output on the fixture images, so

  * float32 re-run against the ground truth must score mAP == 1.0 (any
    decode / NMS / preprocess regression that moves a detection breaks it);
  * the int8 pipeline against the same ground truth gives a calibration
    quality scalar, held to floors chosen here from a sweep over
    calibration seeds (the least over the seeds minus a margin).

The frozen fixture ``tests/data/eval_golden.json`` was made by the JAX
package's generator and stays as it is; this one writes only where
``--out`` says, and ``tests/test_torch_eval.py`` holds what it writes to the
frozen file (threshold, images, classes, boxes)::

    python -m yolov3_tpu_torch.tools.gen_eval_golden --out eval_golden.json \\
        [--device cuda|cuda:N|cpu]

The constants, ``make_frames``, ``detections_to_dicts``, ``gt_from_dicts``
and ``pick_threshold`` are the original's; 8 structured images at a 192
net keep the int8 run short while pooling about 4.3k candidates into the
mAP.
"""
from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path

import numpy as np

from .eval_coco import evaluate

REPO = Path(__file__).resolve().parents[2]
CFG = REPO / "models" / "yolov3-tiny.cfg"
SEED = 777
N_IMAGES = 8
IMG_HW = 192          # square frames: letterbox == pure resize, no pad
CELL = 16             # blocky low-frequency structure (uniform noise washes
                      # out through the conv stack into near-constant scores)
NET_HW = (192, 192)
IOU_THRESH = 0.45
INT8_SEEDS = (777, 778, 779)  # floor = min over seeds - margin
FLOOR_MARGIN = 0.04


def make_frames(seed: int, n: int = N_IMAGES, hw: int = IMG_HW,
                cell: int = CELL) -> np.ndarray:
    """Deterministic structured uint8 frames (blocky random fields)."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (n, hw // cell, hw // cell, 3),
                         dtype=np.uint8)
    return np.repeat(np.repeat(small, cell, axis=1), cell, axis=2)


def detections_to_dicts(results):
    """Detector output list → eval_coco's {img: {cls: (boxes, scores)}}."""
    dets = {}
    for i, r in enumerate(results):
        d = {}
        for c in np.unique(r.class_idx):
            m = r.class_idx == c
            d[int(c)] = (np.asarray(r.bbox_tlbr[m], np.float64),
                         np.asarray(r.class_prob[m], np.float64))
        dets[i] = d
    return dets


def gt_from_dicts(dets):
    return {i: {c: b for c, (b, s) in d.items()} for i, d in dets.items()}


def pick_threshold(net, frames, lo=0.30, hi=0.40, target_lo=30,
                   target_hi=90):
    """Gap-maximizing threshold (gen_golden's trick, pooled across images):
    place prob_thresh in the largest score gap whose pass-count per image
    lands in [target_lo, target_hi] — well under top_k, so the NMS
    truncation contract never engages and the fixture has zero
    truncation-order sensitivity."""
    from ..inference import Detector

    det = Detector(net, prob_thresh=0.01, iou_thresh=IOU_THRESH,
                   net_hw=NET_HW, top_k=512, max_results=512)
    res = det.detect_batch(frames)
    pooled = np.sort(np.concatenate(
        [np.asarray(r.class_prob, np.float64) for r in res]))[::-1]
    n = len(frames)
    band = pooled[(pooled > lo) & (pooled < hi)]
    # candidate cut positions whose mean pass-count/img is in range
    counts = np.arange(1, len(band) + 1)
    ok = (counts / n >= target_lo) & (counts / n <= target_hi)
    if not ok.any():
        raise SystemExit(f"no cut in band ({len(band)} candidates in "
                         f"[{lo},{hi}]); widen the band or re-seed")
    gaps = band[:-1] - band[1:]
    valid = np.where(ok[:-1])[0]
    i = valid[np.argmax(gaps[valid])]
    return float((band[i] + band[i + 1]) / 2), float(gaps[i])


def make_fixture(device=None) -> dict:
    """The fixture's dict, computed by the port on ``device`` (the card
    unless ``"cpu"``)."""
    from ..graph import load_graph
    from ..inference import Detector
    from ..model import Darknet
    from ..weights import random_raw, write_weights

    g = load_graph(CFG)
    with tempfile.TemporaryDirectory() as tmp:
        wpath = Path(tmp) / "eval.weights"
        write_weights(wpath, g, random_raw(g, seed=SEED))
        frames = make_frames(SEED)

        net = Darknet(CFG, precision="highest", device=device)
        net.load_weights(wpath)
        prob_thresh, margin = pick_threshold(net, frames)
        print(f"prob_thresh={prob_thresh:.6f} (gap {margin:.2e})")

        det = Detector(net, prob_thresh=prob_thresh, iou_thresh=IOU_THRESH,
                       net_hw=NET_HW)
        res = det.detect_batch(frames)
        counts = [len(r.class_prob) for r in res]
        print("fp32 survivors/img:", counts)
        if max(counts) >= 128:
            raise SystemExit("survivor set hit max_results: raise the "
                             "threshold")
        dets = detections_to_dicts(res)
        gt = gt_from_dicts(dets)
        self_eval = evaluate(dets, gt)
        if not (self_eval["mAP50"] == 1.0 and self_eval["mAP50_95"] == 1.0):
            raise SystemExit(f"float32 against its own output: {self_eval}")

        # int8 floor sweep: same weights/images, independent PTQ runs
        int8_maps = []
        for s in INT8_SEEDS:
            qnet = Darknet(CFG, precision=None, device=device)
            qnet.load_weights(wpath)
            # different calibration image sets exercise calibration
            # robustness; seed SEED reproduces the test's exact run
            qnet.quantize_int8(make_frames(s), net_hw=NET_HW)
            qdet = Detector(qnet, prob_thresh=prob_thresh,
                            iou_thresh=IOU_THRESH, net_hw=NET_HW)
            e = evaluate(detections_to_dicts(qdet.detect_batch(frames)), gt)
            int8_maps.append((e["mAP50"], e["mAP50_95"]))
            print(f"int8 calib-seed {s}: mAP50={e['mAP50']:.4f} "
                  f"mAP50_95={e['mAP50_95']:.4f}")

    floor50 = min(m for m, _ in int8_maps) - FLOOR_MARGIN
    floor5095 = min(m for _, m in int8_maps) - FLOOR_MARGIN
    return {
        "seed": SEED,
        "n_images": N_IMAGES,
        "img_hw": IMG_HW,
        "cell": CELL,
        "net_hw": list(NET_HW),
        "prob_thresh": prob_thresh,
        "threshold_margin": margin,
        "iou_thresh": IOU_THRESH,
        "int8_mAP50_floor": round(floor50, 4),
        "int8_mAP50_95_floor": round(floor5095, 4),
        "int8_sweep": {str(s): list(np.round(m, 4))
                       for s, m in zip(INT8_SEEDS, int8_maps)},
        "gt": {str(i): {str(c): np.round(b, 3).tolist()
                        for c, b in per.items()}
               for i, per in gt.items()},
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True,
                    help="where to write the fixture JSON")
    ap.add_argument("--device", default=None,
                    help="cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)
    from ..__main__ import _resolve_device

    fixture = make_fixture(_resolve_device(args.device))
    out = Path(args.out)
    out.write_text(json.dumps(fixture, indent=1))
    n_boxes = sum(len(b) for per in fixture["gt"].values()
                  for b in per.values())
    print(f"wrote {out}: {n_boxes} GT boxes, int8 floors "
          f"{fixture['int8_mAP50_floor']:.4f}/"
          f"{fixture['int8_mAP50_95_floor']:.4f}")


if __name__ == "__main__":
    main()
