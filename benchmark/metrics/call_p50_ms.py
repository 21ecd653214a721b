"""Median latency of every synchronous call in the window (host clock,
from the call to its detections in host memory)."""
import numpy as np


def read(run):
    lat = run.served.latencies_s
    return float(np.percentile(lat, 50) * 1e3) if lat else None
