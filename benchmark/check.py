"""The comparison that decides ``correct``.

The program's detections for a frame (what a timed call returned) are held
against the plain reference's float32 walk of the same frame with the same
weights (``reference.yolo``), by the numbers the configuration's ``limits``
name, each with its limit there. The first, ``det_gap``, is the mean over
the compared images of each image's gap, the larger of

* its widest detection gap: each detection the program returned, against
  the reference candidate that agrees with it best over every cell and
  anchor of every head, reads the larger of its box's distance from that
  candidate's (largest coordinate difference over the candidate's longer
  side, source pixels) and its score's distance from the reference's (the
  score of its class there, and how far that lies below the reference's
  best class there);
* the share of its sure reference detections (scoring at least
  ``SURE_SCORE_FACTOR`` x the threshold) that no program detection of any
  class covers, none lying within ``COVER_SIDE`` of the larger box's longer
  side (plus a pixel) in every coordinate. Any class, since rounding moves
  the best of 80 nearly equal class scores, and loosely, since such a move
  can hand the cell to a class whose neighbour then suppresses it.

Both directions, so that answers altered, left out or spurious all read;
a share, not a flag, since rounding moves a few scores across the
threshold. The widest image gap, ``det_gap_max``, is reported beside it:
under bf16 rounding its tail comes within a factor of two of the float8
control's least, so no limit separates the two on it.

A second number, ``sure_miss``, asks whether what should be there is
there, tighter about place and looser about score. It is the largest of
three shares over the compared images:

* the strong reference detections (scoring at least
  ``STRONG_SCORE_FACTOR`` x the threshold) that no program detection of
  any class overlaps at more than the configuration's IoU threshold;
* the strong program detections that no reference candidate scoring at
  least ``WEAK_SCORE_FACTOR`` x the threshold overlaps so (a candidate
  under the threshold: rounding that moves a logit by one or two lifts
  such a cell over it, as the int8 tier does on about twice as many cells
  as the float walk);
* the images that lose more than ``LOST_SHARE`` of their sure reference
  detections (by the cover above).

A strong detection survives a rounding that moves scores by tens of
percent, and a box that suppression removes overlaps the box that removed
it by more than that threshold. A box wholly in the letterbox's padding,
clipped to nothing, counts on neither side. The first two shares are
pooled over the images and taken of at least ``MIN_STRONG`` detections,
so that a run with few strong detections does not read one miss as a
large share.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np

from reference.yolo import Decoded, Detections, iou, unletterbox

SURE_SCORE_FACTOR = 1.25
COVER_SIDE = 0.75
STRONG_SCORE_FACTOR = 3.0
WEAK_SCORE_FACTOR = 0.2
MIN_STRONG = 20  # a share of strong detections counts at least this many
LOST_SHARE = 0.5
COMPARED = ("det_gap", "sure_miss")


@dataclass
class Candidates:
    """One image's reference candidates in source pixels."""

    boxes: np.ndarray  # (N, 4)
    obj: np.ndarray    # (N,)
    cls: np.ndarray    # (N, C)


def candidates(dec: Decoded, i: int, src_hw, net_hw) -> Candidates:
    return Candidates(unletterbox(dec.boxes[i].cpu().numpy(), src_hw, net_hw),
                      dec.obj[i].cpu().numpy(), dec.cls[i].cpu().numpy())


def det_gaps(port: Detections, cand: Candidates) -> np.ndarray:
    """Each program detection's gap to the reference candidate that agrees
    with it best (module docstring)."""
    if len(port.scores) == 0:
        return np.zeros(0)
    side = np.maximum(cand.boxes[:, 2:] - cand.boxes[:, :2], 1.0).max(axis=1)
    best = cand.obj * cand.cls.max(axis=1)
    gaps = []
    for box, score, c in zip(port.boxes, port.scores, port.classes):
        if not 0 <= int(c) < cand.cls.shape[1]:
            gaps.append(np.inf)
            continue
        box_gap = np.abs(cand.boxes - box).max(axis=1) / side
        ref = cand.obj * cand.cls[:, int(c)]
        score_gap = np.maximum(np.abs(ref - score), best - ref)
        gaps.append(np.maximum(box_gap, score_gap).min())
    gaps = np.asarray(gaps, dtype=np.float64)
    return np.where(np.isnan(gaps), np.inf, gaps)


def left_out(port: Detections, ref: Detections, prob_thresh: float) -> int:
    """How many sure reference detections no program detection covers
    (module docstring)."""
    sure = ref.boxes[ref.scores >= SURE_SCORE_FACTOR * prob_thresh]
    if len(sure) == 0 or len(port.scores) == 0:
        return len(sure)
    a, b = sure[:, None, :], port.boxes[None, :, :]
    side = np.maximum((a[..., 2:] - a[..., :2]).max(-1),
                      (b[..., 2:] - b[..., :2]).max(-1))
    near = np.abs(a - b).max(-1) <= COVER_SIDE * side + 1.0
    return int((~near.any(axis=1)).sum())


def has_area(boxes: np.ndarray) -> np.ndarray:
    """Boxes that keep some of the frame once clipped to it (one lying
    wholly in the letterbox's padding keeps none)."""
    return ((boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
            if len(boxes) else np.zeros(0, bool))


def not_overlapped(a: Detections, b: Detections, min_score: float,
                   iou_thresh: float) -> tuple:
    """(how many of ``a``'s detections scoring at least ``min_score``, and
    keeping some of the frame, no detection of ``b``, of any class and
    score, overlaps at more than ``iou_thresh``; how many so strong ``a``
    has)."""
    strong = a.boxes[(a.scores >= min_score) & has_area(a.boxes)]
    if len(strong) == 0 or len(b.scores) == 0:
        return len(strong), len(strong)
    near = (iou(strong, b.boxes) > iou_thresh).any(axis=1)
    return int((~near).sum()), len(strong)


@dataclass
class Readings:
    det_gap: float
    det_gap_max: float
    images: int
    detections: int
    reference_detections: int
    left_out: int
    sure_miss: float = 0.0
    strong: tuple = (0, 0)  # strong detections: the reference's, the program's
    missed: tuple = (0, 0)  # of those, the ones no box or candidate overlaps
    images_lost: int = 0
    per_image: List[tuple] = field(default_factory=list)  # (widest, left out, sure)

    def numbers(self) -> Dict[str, float]:
        return {k: getattr(self, k) for k in COMPARED}


def compare(port: Sequence[Detections], ref: Sequence[Detections],
            cands: Sequence[Candidates], prob_thresh: float,
            iou_thresh: float) -> Readings:
    widest: List[float] = []
    per_image = []
    n = n_ref = lost = images_lost = 0
    missed = np.zeros(2, np.int64)  # strong and not overlapped: reference's, program's
    strong = np.zeros(2, np.int64)
    for p, r, c in zip(port, ref, cands):
        g = det_gaps(p, c)
        k = left_out(p, r, prob_thresh)
        sure = int((r.scores >= SURE_SCORE_FACTOR * prob_thresh).sum())
        per_image.append((float(g.max()) if len(g) else 0.0, k, sure))
        widest.append(max(per_image[-1][0], k / sure if sure else 0.0))
        n, n_ref, lost = n + len(p.scores), n_ref + len(r.scores), lost + k
        images_lost += bool(sure) and k > LOST_SHARE * sure
        score = c.obj * c.cls.max(axis=1)
        near = score >= WEAK_SCORE_FACTOR * prob_thresh
        weak = Detections(c.boxes[near], score[near], c.cls[near].argmax(axis=1))
        for j, (a, b) in enumerate(((r, p), (p, weak))):
            m, t = not_overlapped(a, b, STRONG_SCORE_FACTOR * prob_thresh,
                                  iou_thresh)
            missed[j] += m
            strong[j] += t
    if not widest:
        return Readings(0.0, 0.0, 0, 0, 0, 0)
    sure_miss = max(images_lost / len(port),
                    *(missed / np.maximum(strong, MIN_STRONG)).tolist())
    return Readings(float(np.mean(widest)), max(widest), len(port), n, n_ref,
                    lost, float(sure_miss), tuple(strong.tolist()),
                    tuple(missed.tolist()), int(images_lost), per_image)


def verdict(readings: Readings, limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number the configuration's ``limits`` name beside its limit; a
    number passes at or under it."""
    got = readings.numbers()
    return {k: {"value": got[k], "limit": v, "ok": bool(got[k] <= v)}
            for k, v in limits.items()}
