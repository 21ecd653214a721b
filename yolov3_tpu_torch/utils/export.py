"""Detection export — COCO-results-style JSON.

The reference prints boxes and draws overlays but offers no
machine-readable output (SURVEY.md §2.10); production pipelines want the
standard COCO results list (one dict per detection) that evaluation
tooling — including this repo's ``tools/eval_coco.py`` — consumes
directly.

``category_id`` is the model's CONTIGUOUS class index (0..C−1, the
darknet convention this framework uses end-to-end), with the class name
alongside when names are loaded. Submitting to the official COCO server
needs the sparse 80→91 category-id remap, which depends on the
annotation file — ``tools/eval_coco.py`` derives it from the annotations
(``cat_to_idx``) rather than hardcoding it here.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence


def to_coco_dicts(results: Dict[str, "Detection"],
                  class_names: Optional[Sequence[str]] = None) -> List[dict]:
    """{image name: Detection} → flat COCO-results list.

    COCO bbox convention is ``[x, y, width, height]`` in source-image
    pixels (the Detection's ``bbox_tlbr`` is already rescaled/clipped to
    the source frame by the pipeline).
    """
    out: List[dict] = []
    for image_id in sorted(results):
        det = results[image_id]
        for box, prob, cls in zip(det.bbox_tlbr, det.class_prob,
                                  det.class_idx):
            x1, y1, x2, y2 = (float(v) for v in box)
            entry = {
                "image_id": image_id,
                "category_id": int(cls),
                "bbox": [round(x1, 2), round(y1, 2),
                         round(x2 - x1, 2), round(y2 - y1, 2)],
                "score": round(float(prob), 5),
            }
            if class_names is not None:
                entry["category_name"] = class_names[int(cls)]
            out.append(entry)
    return out


def save_detections_json(path, results: Dict[str, "Detection"],
                         class_names: Optional[Sequence[str]] = None) -> int:
    """Write the COCO-results list for ``results`` to ``path``; returns the
    number of detection entries written."""
    dicts = to_coco_dicts(results, class_names)
    Path(path).write_text(json.dumps(dicts, indent=1))
    return len(dicts)
