"""Readers that several per-layer metrics share: each metric keeps its own
file in ``metrics/`` (the manifest finds a metric by its name there), and
where two metrics read the same quantity in different cells the file is
one line, ``from readers import <reader> as read``."""
import numpy as np

import counts


def idle_pct(run):
    """Share of the traced window in which no kernel, copy or fill ran on
    the card (mean over the cards used), from the profiler's device trace."""
    t = run.trace
    if t is None or not t.busy_s:
        return None
    return 100.0 * (1.0 - t.mean_busy_s / t.window_s)


def h2d_ms(run):
    """Median host->device staging time of the window's calls, the
    program's own span ``Detector.last_stage_s["h2d_s"]``."""
    h2d = run.served.h2d_s
    return float(np.median(h2d) * 1e3) if h2d else None


def mfu_pct(run):
    """The whole step's share of the cards' peak: the least time the frames
    served in the traced window need at the published peaks of the units
    their convolutions run on in the configuration's ``tier``
    (``counts.image_peak_s``), over the window, per card."""
    cfg = run.cell.config
    if run.trace is None or not run.served.returned:
        return None
    need = run.served.returned * counts.image_peak_s(run.net, cfg["width"],
                                                      cfg["tier"])
    return 100.0 * need / (run.trace.window_s * run.cell.chips)


def images_per_s(run):
    """Frames whose detections came back inside the window, over the window
    (host clock), across every card used."""
    return run.served.returned / run.window_s
