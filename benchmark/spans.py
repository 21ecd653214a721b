"""The program's own spans, for the per-layer readers whose source is
``program_span``. ``yolov3_tpu_torch.utils.profiling`` records a span at
each host stage of a Detector call while a ``torch.profiler`` profile runs,
which in a run is the traced window alone (``harness.measure`` starts the
profile after the warm-up and stops it before ``drv.finish()``). A program
that keeps no such record gives None, and so does an empty one."""
from collections import defaultdict
from typing import Dict, Iterable, Optional

import numpy as np


def by_call() -> Optional[Dict[int, Dict[str, float]]]:
    """{call id: {stage: seconds}} of the spans the program recorded at the
    top of its calls (no span of the program around them: a program
    built on a miss, or a mesh replica's staging, counts in its parent's
    stage); None where the program records none."""
    try:
        from yolov3_tpu_torch.utils import profiling
    except ImportError:
        return None
    spans = list(getattr(profiling, "RECORD", ()))
    if not spans:
        return None
    calls: Dict[int, Dict[str, float]] = defaultdict(dict)
    for s in spans:
        if s.parent is None and s.call is not None:
            stages = calls[s.call]
            stages[s.name] = stages.get(s.name, 0.0) + (s.end - s.start)
    return dict(calls)


def median_ms(values: Iterable[float]) -> Optional[float]:
    values = list(values)
    return float(np.median(values) * 1e3) if values else None
