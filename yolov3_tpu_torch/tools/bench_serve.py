"""Serving under load: single-request latency and concurrent throughput
through the port's real HTTP stack (``yolov3_tpu_torch.serve``).

Port of ``tools/bench_serve.py``. The server is stood up in-process (the
code path of ``python -m yolov3_tpu_torch.serve``) and driven by threaded
HTTP clients posting one JPEG:

* sequential mode (1 client, no micro-batching): per-request latency
  p50 / p90 / p95 / p99;
* concurrent mode (``--clients`` threads, ``--window-ms``, ``--max-batch``):
  req/s, latency percentiles, the coalesced batch sizes of the timed run
  scraped from the server's own ``/metrics``
  (``yolov3_device_batches_total``) and their mean fill.

Both modes carry the server's per-stage split from ``/stats``. Every device
batch the micro-batcher runs is padded to ``--max-batch``, so one program
per source shape serves it; the server's warm-up captures that program and
a warm burst replays it before the timed run. A program captured inside the
timed run (a capture charged to a client's latency: a miss of the
Detector's program cache) raises.

    python -m yolov3_tpu_torch.tools.bench_serve --config models/yolov3.cfg \\
        --size 416 [--clients 16 --requests 8 --window-ms 5 --max-batch 8] \\
        [--precision bf16|highest|default] [--quantize-int8] \\
        [--device cuda|cuda:N|cpu]

Prints one JSON line per mode (sequential first, then concurrent unless
``--sequential-only``); ``main`` returns them.
"""
from __future__ import annotations

import argparse
import json
import tempfile
import threading
import time
import urllib.request
from pathlib import Path
from typing import List

import numpy as np

REPO = Path(__file__).resolve().parents[2]


def _jpeg_bytes(hw=(720, 1280), seed=0):
    import cv2

    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
    ok, buf = cv2.imencode(".jpg", img)
    if not ok:
        raise RuntimeError("cv2.imencode failed")
    return bytes(buf)


def _post(url, data, timeout=120.0):
    req = urllib.request.Request(url, data=data, method="POST",
                                 headers={"Content-Type": "image/jpeg"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        payload = json.loads(r.read())
    return (time.perf_counter() - t0) * 1e3, payload


def _stages(base):
    """The server's own per-request stage attribution (/stats)."""
    with urllib.request.urlopen(base + "/stats", timeout=30) as r:
        return json.loads(r.read()).get("stages", {})


def _metrics(base):
    with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
        return r.read().decode()


def _batch_hist(metrics_text):
    """Parse the coalesced-batch-size distribution from /metrics."""
    hist = {}
    for line in metrics_text.splitlines():
        if line.startswith("yolov3_device_batches_total{"):
            # yolov3_device_batches_total{size="16"} 12
            size = line.split('size="')[1].split('"')[0]
            hist[size] = int(float(line.rsplit(" ", 1)[1]))
    return hist


def run_load(base, jpeg, clients, per_client):
    lat = []
    errs = [0]
    lock = threading.Lock()

    def client(ci):
        for _ in range(per_client):
            try:
                ms, _ = _post(base + "/detect", jpeg)
            except Exception:  # noqa: BLE001 - a failed request is counted
                with lock:
                    errs[0] += 1
                continue
            with lock:
                lat.append(ms)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    return lat, errs[0], wall


def pct(lat):
    qs = (("p50_ms", 50), ("p90_ms", 90), ("p95_ms", 95), ("p99_ms", 99))
    if not lat:  # all requests failed: report it, don't crash numpy
        return {k: None for k, _ in qs}
    return {k: round(float(np.percentile(lat, q)), 3) for k, q in qs}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="models/yolov3-tiny.cfg")
    ap.add_argument("--size", type=int, default=416)
    ap.add_argument("--precision", default="bf16",
                    choices=("default", "highest", "bf16"))
    ap.add_argument("--quantize-int8", action="store_true",
                    help="serve the int8 tier (calibrated on random "
                         "frames: a throughput measurement only)")
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--requests", type=int, default=8,
                    help="requests per client in concurrent mode")
    ap.add_argument("--seq-requests", type=int, default=20)
    ap.add_argument("--window-ms", type=float, default=5.0)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--max-results", type=int, default=128,
                    help="Detector max_results (post-NMS survivors "
                         "returned per image)")
    ap.add_argument("--src-hw", default="720x1280")
    ap.add_argument("--sequential-only", action="store_true")
    ap.add_argument("--concurrent-only", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default), cuda:N or cpu")
    return ap


def main(argv=None) -> List[dict]:
    args = parser().parse_args(argv)
    import torch

    from ..__main__ import _resolve_device
    from ..graph import load_graph
    from ..inference import Detector
    from ..model import Darknet
    from ..serve import serve, shutdown_gracefully
    from ..weights import random_raw, write_weights

    device = _resolve_device(args.device)
    cfg = REPO / args.config
    g = load_graph(cfg)
    precision = None if args.precision == "default" else args.precision
    with tempfile.TemporaryDirectory() as tmp:
        wpath = Path(tmp) / "serve.weights"
        write_weights(wpath, g, random_raw(g, seed=0))
        net = Darknet(cfg, precision=precision,
                      device=device).load_weights(wpath)
    net_hw = (args.size, args.size)
    if args.quantize_int8:
        rng = np.random.default_rng(5)
        net.quantize_int8(rng.integers(0, 256, (8, *net_hw, 3),
                                       dtype=np.uint8), net_hw=net_hw)
    src_hw = tuple(int(v) for v in args.src_hw.split("x"))
    jpeg = _jpeg_bytes(src_hw)
    name = (f"{g.name}@{args.size} "
            f"{'int8' if args.quantize_int8 else args.precision}")
    kind = ("cpu" if device.type == "cpu"
            else torch.cuda.get_device_name(device))

    def start(batch_window_s, max_batch):
        det = Detector(net, prob_thresh=0.3, net_hw=net_hw,
                       max_results=args.max_results)
        srv = serve(det, host="127.0.0.1", port=0, warmup_hw=src_hw,
                    batch_window_s=batch_window_s, max_batch=max_batch)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        return det, srv, thread, f"http://127.0.0.1:{srv.server_address[1]}"

    def measure(det, base, clients, per_client):
        """The timed run: latencies, errors and wall seconds; raises if a
        program was captured inside it."""
        misses = det.cache_counts["miss"]
        lat, errs, wall = run_load(base, jpeg, clients, per_client)
        if det.cache_counts["miss"] != misses:
            raise RuntimeError(f"{name}: a program was captured inside the "
                               "timed run; the warm-up missed its key")
        return lat, errs, wall

    def stop(srv, thread):
        shutdown_gracefully(srv)
        thread.join(timeout=30)

    out = []
    if not args.concurrent_only:
        det, srv, thread, base = start(0.0, 1)
        try:
            _post(base + "/detect", jpeg)  # warm
            lat, errs, wall = measure(det, base, 1, args.seq_requests)
            row = {"mode": "sequential", "server": name, "device": kind,
                   "max_results": args.max_results,
                   "src_hw": args.src_hw, "requests": len(lat),
                   "errors": errs, **pct(lat),
                   "req_s": round(len(lat) / wall, 3),
                   "stages": _stages(base)}
        finally:
            stop(srv, thread)
        print(json.dumps(row), flush=True)
        out.append(row)

    if not args.sequential_only:
        det, srv, thread, base = start(args.window_ms / 1e3, args.max_batch)
        try:
            _post(base + "/detect", jpeg)
            # a warm burst: every batch the timed run coalesces replays a
            # program captured before it (the batcher pads to max_batch)
            run_load(base, jpeg, args.clients, 2)
            hist0 = _batch_hist(_metrics(base))
            lat, errs, wall = measure(det, base, args.clients, args.requests)
            hist = {s: n - hist0.get(s, 0)
                    for s, n in _batch_hist(_metrics(base)).items()
                    if n - hist0.get(s, 0)}
            batches = sum(hist.values())
            row = {"mode": "concurrent", "server": name, "device": kind,
                   "clients": args.clients, "window_ms": args.window_ms,
                   "max_batch": args.max_batch, "src_hw": args.src_hw,
                   "max_results": args.max_results,
                   "requests": len(lat), "errors": errs,
                   **pct(lat), "req_s": round(len(lat) / wall, 3),
                   "batch_size_hist_le": hist,
                   "mean_fill": (sum(int(s) * n for s, n in hist.items())
                                 / batches if batches else None),
                   "stages": _stages(base)}
        finally:
            stop(srv, thread)
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


if __name__ == "__main__":
    main()
