"""COCO-style detection evaluation through the port: mAP@0.5 and
mAP@[0.5:0.95].

Port of ``tools/eval_coco.py``. The numpy scorer (``box_iou_matrix``,
``average_precision``, ``match_detections``, ``evaluate``, ``load_coco_gt``,
``score_detections_file``) is a copy of the original's, held equal to it by
``tests/test_torch_eval.py``; ``run_model_on_coco`` runs the port's
``Darknet`` / ``Detector`` (``detect_mixed`` batches, every call through a
cached program) on the card unless ``device="cpu"``. Offline mode scores a
COCO-results file (the CLI's ``--save-json``) with no model::

    python -m yolov3_tpu_torch.tools.eval_coco --images val2017/ \
        --annotations instances_val2017.json --config models/yolov3.cfg \
        --weights yolov3.weights [--limit 500] [--device cuda|cuda:N|cpu]
    python -m yolov3_tpu_torch.tools.eval_coco --detections dets.json \
        --annotations instances_val2017.json
"""
from __future__ import annotations

import argparse
import json
from collections import defaultdict
from pathlib import Path

import numpy as np


def box_iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU between (N, 4) and (M, 4) tlbr boxes → (N, M)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(br - tl, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.prod(np.clip(a[:, 2:] - a[:, :2], 0, None), axis=1)
    area_b = np.prod(np.clip(b[:, 2:] - b[:, :2], 0, None), axis=1)
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


def average_precision(scores, matched, n_gt: int) -> float:
    """COCO-style 101-point interpolated AP for one class/threshold.

    scores: (N,) detection confidences; matched: (N,) bool true-positive
    flags (each GT matched at most once, greedy by score); n_gt: GT count.
    """
    if n_gt == 0:
        return float("nan")
    if len(scores) == 0:
        return 0.0
    order = np.argsort(-scores, kind="stable")
    tp = np.asarray(matched, dtype=np.float64)[order]
    fp = 1.0 - tp
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(fp)
    recall = tp_cum / n_gt
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
    # precision envelope + 101-point sampling (COCO convention)
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    recall_points = np.linspace(0, 1, 101)
    idx = np.searchsorted(recall, recall_points, side="left")
    prec_at = np.where(idx < len(precision), precision[np.minimum(idx, len(precision) - 1)], 0.0)
    return float(prec_at.mean())


def match_detections(det_boxes, det_scores, gt_boxes, iou_thresh):
    """Greedy score-ordered matching; returns (N,) bool matched flags."""
    matched = np.zeros(len(det_boxes), dtype=bool)
    if len(gt_boxes) == 0 or len(det_boxes) == 0:
        return matched
    iou = box_iou_matrix(np.asarray(det_boxes), np.asarray(gt_boxes))
    taken = np.zeros(len(gt_boxes), dtype=bool)
    for i in np.argsort(-np.asarray(det_scores), kind="stable"):
        j = int(np.argmax(iou[i] * ~taken))
        if iou[i, j] >= iou_thresh and not taken[j]:
            matched[i] = True
            taken[j] = True
    return matched


def evaluate(detections, ground_truth, iou_thresholds=None):
    """detections / ground_truth: {image_id: {class_id: (boxes, scores?)}}.

    detections[img][cls] = (boxes (N,4) tlbr, scores (N,));
    ground_truth[img][cls] = boxes (M,4) tlbr.
    Returns dict with per-class AP@0.5, mAP@0.5 and mAP@[.5:.95].
    """
    if iou_thresholds is None:
        iou_thresholds = np.arange(0.5, 1.0, 0.05)
    classes = sorted({c for g in ground_truth.values() for c in g}
                     | {c for d in detections.values() for c in d})
    ap_per_class = {}
    for cls in classes:
        aps = []
        for thr in iou_thresholds:
            scores_all, matched_all, n_gt = [], [], 0
            for img, gts in ground_truth.items():
                gt = np.asarray(gts.get(cls, np.zeros((0, 4))))
                n_gt += len(gt)
                det = detections.get(img, {}).get(cls)
                if det is None:
                    continue
                boxes, scores = det
                m = match_detections(boxes, scores, gt, thr)
                scores_all.append(np.asarray(scores))
                matched_all.append(m)
            # detections on images with no GT entry at all are false positives
            for img, dets in detections.items():
                if img not in ground_truth and cls in dets:
                    boxes, scores = dets[cls]
                    scores_all.append(np.asarray(scores))
                    matched_all.append(np.zeros(len(scores), dtype=bool))
            scores_cat = np.concatenate(scores_all) if scores_all else np.zeros(0)
            matched_cat = (np.concatenate(matched_all) if matched_all
                           else np.zeros(0, dtype=bool))
            aps.append(average_precision(scores_cat, matched_cat, n_gt))
        ap_per_class[cls] = aps
    valid = [c for c in classes if not np.isnan(ap_per_class[c][0])]
    map50 = float(np.mean([ap_per_class[c][0] for c in valid])) if valid else 0.0
    map5095 = (float(np.mean([np.nanmean(ap_per_class[c]) for c in valid]))
               if valid else 0.0)
    return {"AP50_per_class": {c: ap_per_class[c][0] for c in classes},
            "mAP50": map50, "mAP50_95": map5095}


def load_coco_gt(ann_path, limit=None):
    """Parse a COCO annotation JSON → (gt, cat_to_idx, images).

    gt: {image_id: {contiguous class idx: [tlbr, ...]}} (crowd boxes
    dropped); cat_to_idx maps the sparse COCO category ids to contiguous
    darknet class indices; images is the (optionally limited) images list.
    """
    coco = json.loads(Path(ann_path).read_text())
    # COCO category ids are sparse; map to contiguous darknet class indices
    cat_ids = sorted({c["id"] for c in coco["categories"]})
    cat_to_idx = {cid: i for i, cid in enumerate(cat_ids)}

    gt = defaultdict(lambda: defaultdict(list))
    for ann in coco["annotations"]:
        if ann.get("iscrowd"):
            continue
        x, y, w, h = ann["bbox"]
        gt[ann["image_id"]][cat_to_idx[ann["category_id"]]].append(
            [x, y, x + w, y + h])
    images = coco["images"][:limit] if limit else coco["images"]
    return gt, cat_to_idx, images


def score_detections_file(det_path, ann_path, category_ids="contiguous",
                          limit=None):
    """Offline scoring: a COCO-results detections JSON vs a COCO annotation
    file — the standard decoupled inference→eval workflow (run the CLI with
    ``--save-json dets.json`` on the val images, then score here without
    re-running the model).

    ``image_id`` entries may be numeric COCO ids or file names (mapped via
    the annotation's ``images[]`` list — the ``--save-json`` convention).
    ``category_ids="contiguous"`` (default) reads the model's contiguous
    class indices (``--save-json``); ``"coco"`` reads sparse COCO category
    ids (official results files). Entries whose image or category can't be
    resolved are counted in ``skipped_entries``, not silently dropped.
    """
    gt, cat_to_idx, images = load_coco_gt(ann_path, limit)
    name_to_id = {i["file_name"]: i["id"] for i in images}
    keep = {i["id"] for i in images}
    raw = json.loads(Path(det_path).read_text())
    by_img = defaultdict(lambda: defaultdict(lambda: ([], [])))
    skipped = 0
    for d in raw:
        img = d["image_id"]
        if isinstance(img, str):
            if img not in name_to_id:
                skipped += 1
                continue
            img = name_to_id[img]
        elif img not in keep:
            skipped += 1
            continue
        cls = d["category_id"]
        if category_ids == "coco":
            if cls not in cat_to_idx:
                skipped += 1
                continue
            cls = cat_to_idx[cls]
        x, y, w, h = d["bbox"]
        by_img[img][cls][0].append([x, y, x + w, y + h])
        by_img[img][cls][1].append(float(d["score"]))
    detections = {img: {c: (np.asarray(b, np.float64), np.asarray(s))
                        for c, (b, s) in per.items()}
                  for img, per in by_img.items()}
    out = evaluate(detections, {i: g for i, g in gt.items() if i in keep})
    out["skipped_entries"] = skipped
    return out


def run_model_on_coco(images_dir, ann_path, cfg, weights, prob_thresh=0.005,
                      iou_thresh=0.45, batch_size=16, limit=None,
                      precision=None, top_k=1024, audit="auto",
                      audit_sample=32, quantize_int8=0, device=None):
    """Run the port's Detector over a COCO image directory and score it
    against ``ann_path``; ``device`` (last, as in the port's entry points)
    is the card unless ``"cpu"`` is asked for. Returns the ``evaluate``
    dict with ``saturated_images``, ``near_saturated_images`` and, when the
    truncation audit ran, ``audit``."""
    import cv2

    from ..inference import Detector
    from ..model import Darknet

    gt, cat_to_idx, images = load_coco_gt(ann_path, limit)

    net = Darknet(cfg, precision=precision, device=device).load_weights(
        weights)
    if quantize_int8:
        # accuracy harness for the int8 serving tier: PTQ-calibrate on the
        # first N eval images (the same distribution being scored), then
        # every detection below — including the truncation audit — runs the
        # int8-carrier pipeline the serving fast path uses
        calib = []
        for info in images:
            f = cv2.imread(str(Path(images_dir) / info["file_name"]))
            if f is not None:
                calib.append(f[..., ::-1])  # BGR→RGB, native size
            if len(calib) >= quantize_int8:
                break
        if not calib:
            raise ValueError(f"no readable calibration images in "
                             f"{images_dir}")
        net.quantize_int8(calib)
    # max_results must not cap below top_k: mAP at low thresholds counts the
    # full survivor set (COCO's own 100-det cap is NOT applied here).
    # top_k defaults to 1024 here (vs the serving default 512): at
    # prob_thresh=0.005 dense scenes with trained weights can exceed 512
    # candidates, and NMS truncates to the top-K by score (exact-top-K
    # truncation is tested in tests/test_nms.py) — a too-small K silently
    # drops low-score tails and skews mAP. Saturation signals (both
    # ONE-SIDED: they prove truncation but cannot prove its absence,
    # because suppression usually shrinks the survivor set well below K
    # even when >K candidates passed the threshold):
    #   saturated_images      — survivor count == top_k (truncation certain)
    #   near_saturated_images — survivors >= 7/8 * top_k (strong hint)
    # A nonzero count means raise --top-k; a zero count is NOT proof of no
    # truncation — for a rigorous audit, re-run a sample at 2x --top-k and
    # check the mAP is stable.
    det = Detector(net, prob_thresh=prob_thresh, iou_thresh=iou_thresh,
                   top_k=top_k, max_results=0)

    detections = {}
    saturated = [0, 0]  # [exact, near]
    sat_ids = []        # image ids that hit/approached the cap (audit sample)
    frames, metas = [], []

    def to_by_cls(r):
        by_cls = defaultdict(lambda: ([], []))
        for box, score, cls in zip(r.bbox_tlbr, r.class_prob, r.class_idx):
            by_cls[int(cls)][0].append(box)
            by_cls[int(cls)][1].append(float(score))
        return {c: (np.asarray(b), np.asarray(s))
                for c, (b, s) in by_cls.items()}

    def flush():
        if not frames:
            return
        results = det.detect_mixed(frames)
        for (img_id,), r in zip(metas, results):
            if len(r.bbox_tlbr) >= top_k:
                saturated[0] += 1
                sat_ids.append(img_id)
            elif len(r.bbox_tlbr) >= top_k - top_k // 8:
                saturated[1] += 1
                sat_ids.append(img_id)
            detections[img_id] = to_by_cls(r)
        frames.clear()
        metas.clear()

    id_to_file = {}
    for info in images:
        path = Path(images_dir) / info["file_name"]
        frame = cv2.imread(str(path))
        if frame is None:
            continue
        id_to_file[info["id"]] = path
        frames.append(frame)
        metas.append((info["id"],))
        if len(frames) >= batch_size:
            flush()
    flush()

    gt_np = {img: {c: np.asarray(b) for c, b in cls.items()}
             for img, cls in gt.items()}
    out = evaluate(detections, gt_np)
    out["saturated_images"] = saturated[0]
    out["near_saturated_images"] = saturated[1]
    if saturated[0] or saturated[1]:
        print(f"WARNING: {saturated[0]} image(s) hit and {saturated[1]} "
              f"approached the top_k={top_k} candidate cap "
              f"(truncation-audit re-run follows)", flush=True)

    # Truncation audit: the saturation signals are
    # one-sided — they prove truncation but cannot prove its absence. On any
    # nonzero count (audit="auto") or unconditionally (audit="always"),
    # re-run a sample at 2× top-k and report the resulting mAP delta in the
    # output instead of advising a manual re-run. A near-zero delta means
    # the truncated tail carried no mAP mass; a material delta means raise
    # --top-k and re-run the full set.
    run_audit = audit == "always" or (audit == "auto"
                                      and (saturated[0] or saturated[1]))
    if run_audit:
        sample_ids = (sat_ids or list(id_to_file))[:audit_sample]
        sample_ids = [i for i in sample_ids if i in id_to_file]
        if sample_ids:
            det2 = Detector(net, prob_thresh=prob_thresh,
                            iou_thresh=iou_thresh, top_k=2 * top_k,
                            max_results=0)
            sample_frames = [cv2.imread(str(id_to_file[i]))
                             for i in sample_ids]
            redone = det2.detect_mixed(sample_frames)
            detections2 = dict(detections)
            for img_id, r in zip(sample_ids, redone):
                detections2[img_id] = to_by_cls(r)
            out2 = evaluate(detections2, gt_np)
            out["audit"] = {
                "sample_images": len(sample_ids),
                "top_k": 2 * top_k,
                "mAP50_delta": round(out2["mAP50"] - out["mAP50"], 6),
                "mAP50_95_delta": round(out2["mAP50_95"] - out["mAP50_95"],
                                        6),
            }
            if abs(out["audit"]["mAP50_delta"]) > 1e-4:
                print(f"WARNING: 2x-top-k audit moved mAP50 by "
                      f"{out['audit']['mAP50_delta']:+.4f} — top_k={top_k} "
                      f"is truncating mAP mass; raise --top-k and re-run "
                      f"the full set", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--images")
    ap.add_argument("--annotations", required=True)
    ap.add_argument("--config", default="models/yolov3.cfg")
    ap.add_argument("--weights")
    ap.add_argument("--detections", metavar="JSON", default=None,
                    help="offline mode: score this COCO-results detections "
                         "file (e.g. the CLI's --save-json output) against "
                         "--annotations without running the model "
                         "(--images/--weights not needed)")
    ap.add_argument("--category-ids", choices=("contiguous", "coco"),
                    default="contiguous",
                    help="category-id convention of --detections: "
                         "contiguous model indices (--save-json, default) "
                         "or sparse COCO ids (official results files)")
    ap.add_argument("--prob-thresh", type=float, default=0.005)
    ap.add_argument("--iou-thresh", type=float, default=0.45)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--precision", default=None)
    ap.add_argument("--top-k", type=int, default=1024,
                    help="NMS candidate cap per image; candidates beyond the "
                         "top-K by score are truncated. Raise whenever "
                         "saturated/near_saturated counts are nonzero; zero "
                         "counts do NOT prove no truncation (the signals are "
                         "one-sided) — the 2x-top-k audit measures it")
    ap.add_argument("--audit", choices=("auto", "always", "off"),
                    default="auto",
                    help="2x-top-k truncation audit: 'auto' re-runs the "
                         "saturated images at 2x --top-k whenever the "
                         "saturation counters are nonzero; 'always' audits a "
                         "sample unconditionally; 'off' disables")
    ap.add_argument("--quantize-int8", type=int, default=0, metavar="N",
                    help="evaluate the int8 PTQ serving tier: calibrate on "
                         "the first N eval images (32 is plenty), then score "
                         "the int8-carrier pipeline — THE accuracy check for "
                         "the int8 speed numbers")
    ap.add_argument("--device", default=None,
                    help="cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)

    if args.detections:
        res = score_detections_file(args.detections, args.annotations,
                                    category_ids=args.category_ids,
                                    limit=args.limit)
    else:
        from ..__main__ import _resolve_device

        if not args.images or not args.weights:
            ap.error("--images and --weights are required unless "
                     "--detections is given")
        res = run_model_on_coco(args.images, args.annotations, args.config,
                                args.weights, args.prob_thresh,
                                args.iou_thresh, args.batch_size, args.limit,
                                args.precision, args.top_k, audit=args.audit,
                                quantize_int8=args.quantize_int8,
                                device=_resolve_device(args.device))
    line = {"mAP50": round(res["mAP50"], 4),
            "mAP50_95": round(res["mAP50_95"], 4)}
    if args.detections:
        line["mode"] = "offline"
        if res.get("skipped_entries"):
            line["skipped_entries"] = res["skipped_entries"]
    if args.quantize_int8:
        line["precision"] = "int8"
    if "audit" in res:
        line["audit"] = res["audit"]
    print(json.dumps(line))


if __name__ == "__main__":
    main()
