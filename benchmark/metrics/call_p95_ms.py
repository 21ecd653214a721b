"""95th percentile latency of every synchronous call in the window (host
clock; the tail of all calls, not of chunks)."""
import numpy as np


def read(run):
    lat = run.served.latencies_s
    return float(np.percentile(lat, 95) * 1e3) if lat else None
