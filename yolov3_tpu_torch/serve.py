"""Minimal production-style serving endpoint over a :class:`Detector`.

Stdlib-only HTTP server: POST an encoded image (JPEG/PNG bytes) to ``/detect``
→ JSON detections in source-image pixels. Startup runs the pipeline once
(`Detector.warmup`) so the first request pays neither the kernels' build nor
cuDNN's initialization. Port of ``yolov3_tpu/serve.py``: the same endpoints,
JSON, stage keys and metric names, so both servers read alike.

    python -m yolov3_tpu_torch.serve --config models/yolov3.cfg \
        --weights models/yolov3.weights --port 8500 [--precision bf16]

    curl -s --data-binary @dog.jpg localhost:8500/detect | jq .

Endpoints: ``POST /detect`` (image bytes → detections),
``GET /healthz`` (readiness), ``GET /stats`` (JSON counters/latency +
per-stage attribution: decode/queue-wait per request, the Detector's
preprocess/h2d/dispatch/device-fetch split per device batch),
``GET /metrics`` (Prometheus text: latency histogram, per-stage summaries,
error counters, coalesced-batch-size distribution, queue depth, uptime).

Two modes:

* default — single-threaded handler: one card, one pipeline;
* ``--batch-window MS`` — threaded server + **micro-batching**: concurrent
  requests coalesce for up to MS milliseconds (max ``--max-batch``) into one
  device batch via the host-letterboxed pipeline — the standard
  accelerator-serving pattern (small latency tax, large throughput gain
  under concurrency).
"""
from __future__ import annotations

import json
import os
import queue as queue_mod
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer, ThreadingHTTPServer
from typing import Optional

import numpy as np


class GracefulThreadingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer whose ``server_close`` JOINS in-flight handler
    threads (``daemon_threads=False`` + ``block_on_close``) instead of
    abandoning them — the property graceful drain needs: after
    ``shutdown()`` stops the accept loop, ``server_close()`` returns only
    once every accepted request has been answered."""

    daemon_threads = False
    block_on_close = True


# latency histogram bucket upper bounds in SECONDS (Prometheus `le`
# semantics: cumulative, observation counted in every bucket >= it); spans
# single requests of a few milliseconds up to multi-second cold paths
_LAT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0)


class _Stats:
    """Thread-safe counters (handlers run concurrently in threaded mode)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests = 0
        self.errors = 0
        self.total_latency = 0.0
        self.started = time.time()
        self.lat_buckets = [0] * (len(_LAT_BUCKETS) + 1)  # last = +Inf
        self.batch_sizes: dict = {}  # coalesced device batch size -> count
        # per-stage attribution: sum/count of seconds per stage name.
        # decode_s/queue_wait_s are per REQUEST;
        # preprocess_s/h2d_s/dispatch_s/device_fetch_s (Detector.last_stage_s)
        # are per DEVICE BATCH — counts differ under micro-batching.
        self.stage_sum: dict = {}
        self.stage_count: dict = {}

    def record_stages(self, stages: dict):
        with self._lock:
            for k, v in stages.items():
                self.stage_sum[k] = self.stage_sum.get(k, 0.0) + v
                self.stage_count[k] = self.stage_count.get(k, 0) + 1

    def stage_summary(self) -> dict:
        """{stage: {mean_ms, count}} — the /stats JSON form."""
        with self._lock:
            return {k: {"mean_ms": round(self.stage_sum[k] * 1e3
                                         / self.stage_count[k], 3),
                        "count": self.stage_count[k]}
                    for k in sorted(self.stage_sum)}

    def record(self, latency: float):
        import bisect

        with self._lock:
            self.requests += 1
            self.total_latency += latency
            self.lat_buckets[bisect.bisect_left(_LAT_BUCKETS, latency)] += 1

    def record_error(self):
        with self._lock:
            self.errors += 1

    def record_batch(self, n: int):
        with self._lock:
            self.batch_sizes[n] = self.batch_sizes.get(n, 0) + 1

    def prometheus(self, queue_depth: Optional[int] = None) -> str:
        """Prometheus text exposition (version 0.0.4) of every metric —
        what a production scraper consumes; /stats stays the human-readable
        JSON summary."""
        with self._lock:
            req, err = self.requests, self.errors
            lat_sum = self.total_latency
            buckets = list(self.lat_buckets)
            sizes = dict(self.batch_sizes)
            st_sum = dict(self.stage_sum)
            st_cnt = dict(self.stage_count)
            uptime = time.time() - self.started
        out = [
            "# HELP yolov3_requests_total Successful /detect requests.",
            "# TYPE yolov3_requests_total counter",
            f"yolov3_requests_total {req}",
            "# HELP yolov3_errors_total Failed /detect requests.",
            "# TYPE yolov3_errors_total counter",
            f"yolov3_errors_total {err}",
            "# HELP yolov3_request_latency_seconds End-to-end /detect "
            "latency.",
            "# TYPE yolov3_request_latency_seconds histogram",
        ]
        cum = 0
        for bound, n in zip(_LAT_BUCKETS, buckets):
            cum += n
            out.append(f'yolov3_request_latency_seconds_bucket'
                       f'{{le="{bound}"}} {cum}')
        out.append(f'yolov3_request_latency_seconds_bucket{{le="+Inf"}} '
                   f'{cum + buckets[-1]}')
        out.append(f"yolov3_request_latency_seconds_sum {lat_sum:.6f}")
        out.append(f"yolov3_request_latency_seconds_count {req}")
        out += [
            "# HELP yolov3_device_batches_total Coalesced device batches "
            "by size (micro-batching).",
            "# TYPE yolov3_device_batches_total counter",
        ]
        for size in sorted(sizes):
            out.append(f'yolov3_device_batches_total{{size="{size}"}} '
                       f'{sizes[size]}')
        if st_sum:
            out += [
                "# HELP yolov3_stage_seconds Per-stage serving time: "
                "decode_s/queue_wait_s per request; preprocess_s/h2d_s/"
                "dispatch_s/device_fetch_s per device batch (the device work "
                "is queued asynchronously, so its time shows in "
                "device_fetch_s).",
                "# TYPE yolov3_stage_seconds summary",
            ]
            for k in sorted(st_sum):
                out.append(f'yolov3_stage_seconds_sum{{stage="{k}"}} '
                           f'{st_sum[k]:.6f}')
                out.append(f'yolov3_stage_seconds_count{{stage="{k}"}} '
                           f'{st_cnt[k]}')
        if queue_depth is not None:
            out += [
                "# HELP yolov3_queue_depth Requests waiting in the "
                "micro-batch queue.",
                "# TYPE yolov3_queue_depth gauge",
                f"yolov3_queue_depth {queue_depth}",
            ]
        out += [
            "# HELP yolov3_uptime_seconds Seconds since server start.",
            "# TYPE yolov3_uptime_seconds gauge",
            f"yolov3_uptime_seconds {uptime:.1f}",
        ]
        return "\n".join(out) + "\n"


class MicroBatcher:
    """Coalesces concurrent detect requests into device batches.

    Requests enqueue (frame, Event, slot); a worker thread collects up to
    ``max_batch`` frames within ``window_s`` of the first arrival and runs
    one host-letterboxed device step for all of them. Callers block on their
    Event (with timeout) and read their slot.
    """

    class Overloaded(RuntimeError):
        """Queue full — reject fast (HTTP 503) instead of queueing forever."""

    def __init__(self, detector, window_s: float = 0.005,
                 max_batch: int = 16, stats: Optional[_Stats] = None):
        self.detector = detector
        self.window_s = float(window_s)
        self.max_batch = int(max_batch)
        self.stats = stats
        # bounded queue = backpressure: overload rejects immediately rather
        # than growing queue depth/threads/decoded-frame memory without limit
        self._q: "queue_mod.Queue" = queue_mod.Queue(maxsize=4 * max_batch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def detect(self, frame, timeout: float = 120.0):
        if self._stop.is_set():
            raise RuntimeError("batcher stopped")
        done = threading.Event()
        slot: dict = {}
        try:
            self._q.put_nowait((frame, done, slot, time.perf_counter()))
        except queue_mod.Full:
            raise MicroBatcher.Overloaded("serving queue full") from None
        if not done.wait(timeout):
            raise TimeoutError("detection timed out")
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot["result"]

    def _run(self):
        while True:
            try:
                first = self._q.get(timeout=0.1)
            except queue_mod.Empty:
                if self._stop.is_set():
                    return
                continue
            batch = [first]
            deadline = time.perf_counter() + self.window_s
            while len(batch) < self.max_batch and not self._stop.is_set():
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=remaining))
                except queue_mod.Empty:
                    break
            frames = [item[0] for item in batch]
            # pad to the single warmed batch shape. This is the JAX
            # package's policy, kept so that both servers answer alike; its
            # reason there was one compiled TPU program per batch size, which
            # does not hold here. Whether un-padded batches or a
            # power-of-two ladder serve better on the card is a measurement
            # for later work.
            pad = self.max_batch - len(frames)
            if pad:
                frames = frames + [frames[-1]] * pad
            if self.stats is not None:
                self.stats.record_batch(len(batch))  # real requests, not pad
                now = time.perf_counter()
                for item in batch:  # enqueue → batch-assembled, per request
                    self.stats.record_stages({"queue_wait_s": now - item[3]})
            try:
                results = self.detector.detect_mixed(frames)[:len(batch)]
                if self.stats is not None and self.detector.last_stage_s:
                    # one observation per device batch (not per request)
                    self.stats.record_stages(self.detector.last_stage_s)
                for (_, done, slot, _), res in zip(batch, results):
                    slot["result"] = res
                    done.set()
            except Exception as e:  # noqa: BLE001 - worker boundary
                for _, done, slot, _ in batch:
                    slot["error"] = str(e)
                    done.set()

    def stop(self):
        """Stop the worker; fail anything still queued instead of leaving
        callers blocked until their timeout."""
        self._stop.set()
        self._thread.join(timeout=5.0)
        while True:
            try:
                _, done, slot, _ = self._q.get_nowait()
            except queue_mod.Empty:
                break
            slot["error"] = "batcher stopped"
            done.set()

    def drain(self, timeout: float = 60.0):
        """Graceful drain: keep the worker running until every already-
        enqueued request is answered, then stop. Unlike :meth:`stop`, no
        accepted request is failed (unless the timeout expires). New
        ``detect()`` calls during/after the drain fail fast."""
        deadline = time.monotonic() + timeout
        while not self._q.empty() and time.monotonic() < deadline:
            time.sleep(0.005)
        # queue empty -> the worker is at most one batch from idle; stop()
        # lets it finish that batch (the worker only exits between batches)
        self._stop.set()
        self._thread.join(timeout=max(0.0, deadline - time.monotonic()) + 5.0)
        self.stop()  # idempotent: fails stragglers only on timeout


def make_handler(detector, class_names, stats: _Stats,
                 batcher: Optional[MicroBatcher] = None):
    class Handler(BaseHTTPRequestHandler):
        # per-connection socket timeout: a client that opens a request and
        # never sends the body would otherwise pin a (non-daemon) handler
        # thread forever, which server_close() then joins indefinitely and
        # the graceful drain can never finish
        timeout = 30

        def log_message(self, fmt, *args):  # route through logging, not stderr
            import logging

            logging.getLogger("yolov3_tpu_torch.serve").info(fmt, *args)

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok"})
            elif self.path == "/metrics":
                depth = (batcher._q.qsize() if batcher is not None else None)
                body = stats.prometheus(queue_depth=depth).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/stats":
                mean = (stats.total_latency / stats.requests
                        if stats.requests else 0.0)
                self._json(200, {
                    "requests": stats.requests, "errors": stats.errors,
                    "mean_latency_ms": round(mean * 1e3, 2),
                    # per-stage attribution (decode/queue_wait per request;
                    # preprocess/h2d/dispatch/device_fetch per device batch)
                    "stages": stats.stage_summary(),
                    "uptime_s": round(time.time() - stats.started, 1)})
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/detect":
                self._json(404, {"error": "unknown path"})
                return
            try:  # only /detect decodes images: the rest serves without cv2
                import cv2
            except ImportError as e:
                stats.record_error()
                self._json(500, {"error": f"cannot decode images: {e}"})
                return
            t0 = time.perf_counter()
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length <= 0 or length > 64 * 1024 * 1024:
                    raise ValueError(f"bad Content-Length {length}")
                data = self.rfile.read(length)
                frame = cv2.imdecode(np.frombuffer(data, np.uint8),
                                     cv2.IMREAD_COLOR)
                if frame is None:
                    raise ValueError("could not decode image")
                decode_s = time.perf_counter() - t0
            except Exception as e:  # noqa: BLE001 - request validation
                stats.record_error()
                self._json(400, {"error": str(e)})
                return
            try:
                # detect_mixed letterboxes on the host: one device batch
                # shape serves any client resolution
                if batcher is not None:
                    det = batcher.detect(frame)
                    stats.record_stages({"decode_s": decode_s})
                else:
                    stats.record_batch(1)
                    (det,) = detector.detect_mixed([frame])
                    # single-threaded mode: this thread ran the detect, so
                    # last_stage_s is this request's split
                    stats.record_stages({"decode_s": decode_s,
                                         **(detector.last_stage_s or {})})
                out = [{
                    "bbox_tlbr": [round(float(v), 2) for v in box],
                    "score": round(float(s), 4),
                    "class_id": int(c),
                    "class_name": (class_names[int(c)] if class_names
                                   and 0 <= int(c) < len(class_names)
                                   else str(int(c))),
                } for box, s, c in zip(det.bbox_tlbr, det.class_prob,
                                       det.class_idx)]
                dt = time.perf_counter() - t0
                stats.record(dt)
                self._json(200, {"detections": out,
                                 "latency_ms": round(dt * 1e3, 2),
                                 "image_hw": list(frame.shape[:2])})
            except MicroBatcher.Overloaded as e:
                stats.record_error()
                self._json(503, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 - serving boundary
                stats.record_error()
                # inference failures are server faults, not client errors
                self._json(500, {"error": str(e)})

    return Handler


def serve(detector, class_names=None, host: str = "127.0.0.1",
          port: int = 8500, warmup_hw: Optional[tuple] = (720, 1280),
          server_cls=None, batch_window_s: float = 0.0, max_batch: int = 16):
    """Build the HTTP server (call ``.serve_forever()`` to run).

    ``batch_window_s > 0`` enables the threaded server + micro-batcher:
    concurrent requests coalesce into one device batch per window.
    ``warmup_hw`` warms up for one source resolution ``(H, W)`` or a list
    of them (multi-tenant serving with several known camera shapes)."""
    from . import native

    stats = _Stats()
    batcher = None
    # normalize warmup to a list of (H, W)
    warmups = []
    if warmup_hw:
        warmups = ([tuple(warmup_hw)] if isinstance(warmup_hw[0], int)
                   else [tuple(hw) for hw in warmup_hw])
    if batch_window_s > 0:
        batcher = MicroBatcher(detector, window_s=batch_window_s,
                               max_batch=max_batch, stats=stats)
        if server_cls is None:
            server_cls = GracefulThreadingHTTPServer
        # the batcher pads every batch to max_batch: one warm-up per
        # source shape
        for hw in warmups:
            detector.warmup(max_batch, hw,
                            host_preprocessed=native.available())
    else:
        if server_cls is None:
            server_cls = HTTPServer
        for hw in warmups:
            # warm the host-letterboxed pipeline (what /detect uses when the
            # C++ loader is available)
            detector.warmup(1, hw, host_preprocessed=native.available())
    server = server_cls((host, port), make_handler(detector, class_names,
                                                   stats, batcher))
    server.batcher = batcher  # for shutdown in tests/embedding
    return server


def shutdown_gracefully(server):
    """Drain the server: stop accepting, answer every accepted request,
    flush the micro-batcher, release the socket.

    Safe from any thread except the one running ``serve_forever``. Order
    matters: ``shutdown()`` stops the accept loop; ``server_close()`` joins
    in-flight handler threads (GracefulThreadingHTTPServer) — they finish
    because the batcher worker is still alive; only then is the batcher
    stopped (its queue is empty once all handlers returned)."""
    server.shutdown()
    server.server_close()
    if getattr(server, "batcher", None) is not None:
        server.batcher.drain()


def install_graceful_shutdown(server, signals=(signal.SIGTERM, signal.SIGINT)):
    """SIGTERM/SIGINT → graceful drain in a background thread (the handler
    itself must not block, and ``shutdown()`` deadlocks if called from the
    ``serve_forever`` thread). Returns an Event set when the drain is done."""
    drained = threading.Event()

    def _drain():
        shutdown_gracefully(server)
        drained.set()

    def _handler(signum, frame):
        threading.Thread(target=_drain, daemon=True,
                         name="yolov3-serve-drain").start()

    for s in signals:
        signal.signal(s, _handler)
    return drained


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(prog="yolov3_tpu_torch.serve")
    ap.add_argument("--config", "-C", default="models/yolov3.cfg")
    ap.add_argument("--weights", "-W", required=True)
    ap.add_argument("--class-names", "-N", default="models/coco.names")
    ap.add_argument("--device", default=None,
                    help="torch device: cuda, cuda:N or cpu; default = the "
                         "card (exits when there is none)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8500)
    ap.add_argument("--prob-thresh", type=float, default=0.05)
    ap.add_argument("--iou-thresh", type=float, default=0.3)
    ap.add_argument("--precision", choices=("default", "highest", "bf16"),
                    default="bf16")
    ap.add_argument("--net-size", type=int, default=None)
    ap.add_argument("--warmup-hw", default="720x1280",
                    help="source resolution(s) to warm up for: HxW or a "
                         "comma-separated list (e.g. 720x1280,1080x1920), or "
                         "'none'")
    ap.add_argument("--batch-window", type=float, default=0.0, metavar="MS",
                    help="micro-batching window in ms (0 = single-threaded); "
                         "concurrent requests coalesce into device batches")
    ap.add_argument("--max-batch", type=int, default=16,
                    help="micro-batch size cap (with --batch-window)")
    ap.add_argument("--quantize-int8", metavar="CALIB_DIR", default=None,
                    help="serve the int8 PTQ tier, calibrated on the images "
                         "in CALIB_DIR (same scheme as the main CLI)")
    ap.add_argument("--calib-method", choices=("absmax", "percentile"),
                    default="absmax",
                    help="activation-scale statistic for --quantize-int8 "
                         "(see the main CLI)")
    ap.add_argument("--calib-percentile", type=float, default=99.9,
                    help="percentile q for --calib-method percentile")
    ap.add_argument("--no-bias-correct", action="store_true",
                    help="skip the default DFQ-style bias correction after "
                         "--quantize-int8 (see the main CLI)")
    ap.add_argument("--act-scheme", choices=("symmetric", "asymmetric"),
                    default="symmetric",
                    help="activation quantization scheme for "
                         "--quantize-int8 (see the main CLI)")
    ap.add_argument("--quant-state", metavar="PATH", default=None,
                    help="int8 quantization-state cache (npz): load if PATH "
                         "exists — a serving restart then skips calibration "
                         "— else calibrate via --quantize-int8 and save")
    ap.add_argument("--block-impl", choices=("xla", "pallas"),
                    default="xla",
                    help="residual-block backend on the int8 path (pallas = "
                         "the fused kernel, ops/cuda_block.py)")
    ap.add_argument("--decode-impl",
                    choices=("xla", "pallas", "pallas-fused"),
                    default="pallas",
                    help="head decode backend (see yolov3_tpu_torch --help)")
    ap.add_argument("--select-group", type=int, default=2,
                    help="group-max selection width G (see yolov3_tpu_torch "
                         "--help)")
    ap.add_argument("--top-k", type=int, default=None,
                    help="NMS working set per image (default: the "
                         "Detector's auto preset — 256 for small graphs, "
                         "512 otherwise; results change only on images "
                         "where more than K candidates pass --prob-thresh)")
    ap.add_argument("--max-results", type=int, default=128,
                    help="max returned detections per image (0 = all "
                         "top-k survivors); also sizes the per-image "
                         "device->host result payload (24 bytes each)")
    ap.add_argument("--devices", type=int, default=1, metavar="N",
                    help="shard each request batch over N cards; N > 1 is "
                         "not ported yet (ROADMAP.md): exits")
    ap.add_argument("--no-compile-cache", action="store_true",
                    help="accepted for compatibility with the JAX "
                         "package's server and does nothing: this package "
                         "compiles no programs per shape")
    args = ap.parse_args(argv)

    if args.devices > 1:
        raise SystemExit(f"--devices {args.devices}: the multi-device routes "
                         "(parallel/) are not ported yet, see ROADMAP.md")

    from pathlib import Path

    from .__main__ import _resolve_device

    from .inference import Detector
    from .model import Darknet
    from .utils.drawing import load_class_names

    precision = None if args.precision == "default" else args.precision
    net = Darknet(args.config, precision=precision,
                  device=_resolve_device(args.device))
    net.load_weights(args.weights)
    net_hw = (args.net_size, args.net_size) if args.net_size else None
    if args.quant_state and Path(args.quant_state).exists():
        try:
            net.load_quantized(args.quant_state)
        except ValueError as e:
            raise SystemExit(str(e))
    elif args.quantize_int8:
        from .quant import load_calibration_dir

        net.quantize_int8(load_calibration_dir(args.quantize_int8),
                          net_hw=net_hw,
                          calib_method=args.calib_method,
                          calib_percentile=args.calib_percentile,
                          bias_correct=not args.no_bias_correct,
                          act_scheme=args.act_scheme)
        if args.quant_state:
            net.save_quantized(args.quant_state)
    elif args.quant_state:
        raise SystemExit(f"--quant-state {args.quant_state}: file not found "
                         "(pass --quantize-int8 CALIB_DIR to create it)")
    try:
        detector = Detector(net, prob_thresh=args.prob_thresh,
                            iou_thresh=args.iou_thresh, net_hw=net_hw,
                            decode_impl=args.decode_impl,
                            select_group=args.select_group,
                            block_impl=args.block_impl,
                            top_k=args.top_k,
                            max_results=args.max_results)
    except ValueError as e:
        raise SystemExit(f"error: {e}")  # user error: one line, no traceback
    names = (load_class_names(args.class_names)
             if Path(args.class_names).exists() else None)
    warmup = (None if args.warmup_hw == "none"
              else [tuple(int(v) for v in hw.split("x"))
                    for hw in args.warmup_hw.split(",")])

    server = serve(detector, names, args.host, args.port, warmup,
                   batch_window_s=args.batch_window / 1e3,
                   max_batch=args.max_batch)
    drained = install_graceful_shutdown(server)
    mode = (f"micro-batched ({args.batch_window}ms/{args.max_batch})"
            if args.batch_window > 0 else "single-threaded")
    print(f"serving on http://{args.host}:{args.port} [{mode}] "
          f"(POST /detect, GET /healthz, GET /stats)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        # ^C in a terminal raises here as well; drain the same way
        shutdown_gracefully(server)
        drained.set()
    if drained.wait(timeout=120):
        print("drained: all accepted requests answered")
    else:
        # do NOT claim a clean drain that didn't happen; stuck non-daemon
        # handler threads would also block normal interpreter exit
        print("drain TIMED OUT after 120s: exiting with in-flight requests "
              "unanswered", flush=True)
        os._exit(1)


if __name__ == "__main__":
    main()
