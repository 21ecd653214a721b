"""Box/label drawing on BGR frames (reference ``draw_boxes``, SURVEY.md §2.10)."""
from __future__ import annotations

from typing import List, Optional, Sequence


def load_class_names(path) -> List[str]:
    """Read a darknet ``.names`` file (one class per line, e.g. coco.names)."""
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def _class_color(idx: int):
    """Deterministic distinct-ish BGR color per class id."""
    golden = 0.61803398875
    import colorsys

    h = (idx * golden) % 1.0
    r, g, b = colorsys.hsv_to_rgb(h, 0.85, 0.95)
    return (int(b * 255), int(g * 255), int(r * 255))


def draw_boxes(frame, detection, class_names: Optional[Sequence[str]] = None,
               thickness: int = 2):
    """Draw one image's detections in place (cv2 rectangles + labels)."""
    import cv2

    for (x1, y1, x2, y2), prob, cls in zip(
            detection.bbox_tlbr, detection.class_prob, detection.class_idx):
        color = _class_color(int(cls))
        p1, p2 = (int(x1), int(y1)), (int(x2), int(y2))
        cv2.rectangle(frame, p1, p2, color, thickness)
        label = (class_names[int(cls)] if class_names and 0 <= int(cls) < len(class_names)
                 else str(int(cls)))
        text = f"{label} {prob:.2f}"
        (tw, th), baseline = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
        ty = max(p1[1] - 4, th + 4)
        cv2.rectangle(frame, (p1[0], ty - th - baseline), (p1[0] + tw, ty + baseline),
                      color, -1)
        cv2.putText(frame, text, (p1[0], ty), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                    (0, 0, 0), 1, cv2.LINE_AA)
    return frame
