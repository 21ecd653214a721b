"""The port's HTTP server (``yolov3_tpu_torch/serve.py``) on the CPU: the
counterparts of the JAX package's serving tests (round trip, health, stats,
stage timings, Prometheus text, error codes, micro-batching, overload,
graceful drain, warm-up, CLI errors) and the same PNG posted to both
packages' servers. Every server runs on an ephemeral port in a daemon
thread; every wait has a timeout."""
import json
import signal
import socket
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from yolov3_tpu_torch import Darknet, Detector
from yolov3_tpu_torch import native as tnative
from yolov3_tpu_torch import serve as tserve
from yolov3_tpu_torch.weights import fold_raw, random_raw, write_weights

torch.set_num_threads(1)

MODELS = Path(__file__).parent.parent / "models"
TINY = str(MODELS / "yolov3-tiny.cfg")
NAMES = ["c%d" % i for i in range(80)]
STAGES = ("decode_s", "h2d_s", "dispatch_s", "device_fetch_s")


def _detector(seed, **kw):
    net = Darknet(TINY, precision="highest", device="cpu")
    net.set_params(fold_raw(random_raw(net.graph, seed=seed)))
    return Detector(net, prob_thresh=0.3, net_hw=(160, 160), **kw)


def _png(seed, hw=(240, 320)):
    import cv2

    img = np.random.default_rng(seed).integers(0, 256, (*hw, 3), dtype=np.uint8)
    ok, buf = cv2.imencode(".png", img)
    assert ok
    return buf.tobytes()


def _post(url, data):
    req = urllib.request.Request(url, data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url, raw=False):
    with urllib.request.urlopen(url, timeout=10) as r:
        body = r.read()
        return (r.headers, body.decode()) if raw else json.loads(body)


def _metric_lines(text):
    return dict(ln.rsplit(" ", 1) for ln in text.splitlines()
                if ln and not ln.startswith("#"))


def _start(srv):
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return f"http://127.0.0.1:{srv.server_address[1]}", thread


@pytest.fixture(scope="module")
def server():
    srv = tserve.serve(_detector(30), class_names=NAMES, host="127.0.0.1",
                       port=0, warmup_hw=(240, 320))
    url, thread = _start(srv)
    yield url
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)


@pytest.fixture(scope="module")
def batched_server():
    srv = tserve.serve(_detector(31), host="127.0.0.1", port=0,
                       warmup_hw=(240, 320), batch_window_s=0.02, max_batch=4)
    url, thread = _start(srv)
    yield url
    tserve.shutdown_gracefully(srv)
    thread.join(timeout=10)


def test_detect_roundtrip(server):
    status, body = _post(server + "/detect", _png(0))
    assert status == 200
    assert body["image_hw"] == [240, 320]
    assert body["latency_ms"] > 0
    assert body["detections"]
    for d in body["detections"]:
        assert len(d["bbox_tlbr"]) == 4
        assert 0.0 <= d["score"] <= 1.0
        assert d["class_name"] == "c%d" % d["class_id"]


def test_healthz_and_stats(server):
    _post(server + "/detect", _png(1))
    assert _get(server + "/healthz")["status"] == "ok"
    stats = _get(server + "/stats")
    assert stats["requests"] >= 1 and stats["errors"] >= 0
    assert stats["mean_latency_ms"] > 0 and stats["uptime_s"] >= 0


def test_metrics_prometheus_text():
    """_Stats.prometheus on recorded values: cumulative le-buckets, +Inf,
    counters, the stage summary; line for line what the JAX package's
    _Stats prints for the same records."""
    from yolov3_tpu.serve import _Stats as JStats

    texts = []
    for cls in (tserve._Stats, JStats):
        st = cls()
        st.record(0.03)
        st.record(0.04)
        st.record(6.0)  # beyond the last finite bucket -> +Inf only
        st.record_error()
        st.record_batch(4)
        st.record_batch(4)
        st.record_stages({"decode_s": 0.002, "device_fetch_s": 0.05})
        st.record_stages({"decode_s": 0.004})
        texts.append(st.prometheus(queue_depth=3))
        assert st.stage_summary()["decode_s"] == {"mean_ms": 3.0, "count": 2}
    lines = _metric_lines(texts[0])
    assert lines["yolov3_requests_total"] == "3"
    assert lines["yolov3_errors_total"] == "1"
    assert lines['yolov3_request_latency_seconds_bucket{le="0.025"}'] == "0"
    assert lines['yolov3_request_latency_seconds_bucket{le="0.05"}'] == "2"
    assert lines['yolov3_request_latency_seconds_bucket{le="5.0"}'] == "2"
    assert lines['yolov3_request_latency_seconds_bucket{le="+Inf"}'] == "3"
    assert float(lines["yolov3_request_latency_seconds_sum"]) == pytest.approx(6.07)
    assert lines['yolov3_device_batches_total{size="4"}'] == "2"
    assert lines["yolov3_queue_depth"] == "3"
    assert float(lines['yolov3_stage_seconds_sum{stage="decode_s"}']) == \
        pytest.approx(0.006)
    assert lines['yolov3_stage_seconds_count{stage="device_fetch_s"}'] == "1"
    other = _metric_lines(texts[1])
    assert lines.keys() == other.keys()
    for key in lines:
        if key != "yolov3_uptime_seconds":
            assert lines[key] == other[key], key


def test_metrics_endpoint(server):
    _post(server + "/detect", _png(2))
    headers, text = _get(server + "/metrics", raw=True)
    assert headers["Content-Type"].startswith("text/plain")
    lines = _metric_lines(text)
    assert int(lines["yolov3_requests_total"]) >= 1
    # single-threaded mode: every device batch is one request, no queue
    assert int(lines['yolov3_device_batches_total{size="1"}']) >= 1
    assert "yolov3_queue_depth" not in lines
    assert lines['yolov3_request_latency_seconds_bucket{le="+Inf"}'] \
        == lines["yolov3_request_latency_seconds_count"]


def test_stats_stage_timings(server):
    """/stats and /metrics publish the reference's stage keys: decode on the
    handler, preprocess / h2d / dispatch / device_fetch from the Detector."""
    assert tnative.available()
    status, _ = _post(server + "/detect", _png(3))
    assert status == 200
    stages = _get(server + "/stats")["stages"]
    for key in STAGES + ("preprocess_s",):
        assert stages[key]["count"] >= 1
        assert stages[key]["mean_ms"] >= 0.0
    assert "enqueue_s" not in stages
    assert stages["decode_s"]["count"] == stages["device_fetch_s"]["count"]
    _, text = _get(server + "/metrics", raw=True)
    assert 'yolov3_stage_seconds_sum{stage="dispatch_s"}' in text
    assert 'yolov3_stage_seconds_count{stage="device_fetch_s"}' in text


def test_bad_payload_is_400(server):
    before = _get(server + "/stats")["errors"]
    status, body = _post(server + "/detect", b"this is not an image")
    assert status == 400 and "decode" in body["error"]
    status, body = _post(server + "/detect", b"")
    assert status == 400 and "Content-Length" in body["error"]
    assert _get(server + "/stats")["errors"] == before + 2


def test_unknown_path_404(server):
    assert _post(server + "/nope", b"x")[0] == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(server + "/nope")
    assert e.value.code == 404


def test_microbatched_concurrent_requests(batched_server):
    """8 concurrent clients through the micro-batcher: all answered, and
    each answer is its own image's (checked against the Detector)."""
    import cv2

    pngs = [_png(10 + i, hw=(240 - 16 * (i % 3), 320)) for i in range(8)]
    with ThreadPoolExecutor(max_workers=8) as pool:
        results = list(pool.map(lambda b: _post(batched_server + "/detect", b),
                                pngs))
    assert all(status == 200 for status, _ in results)
    det = _detector(31)
    for png, (_, body) in zip(pngs, results):
        frame = cv2.imdecode(np.frombuffer(png, np.uint8), cv2.IMREAD_COLOR)
        assert body["image_hw"] == list(frame.shape[:2])
        (want,) = det.detect_mixed([frame])
        assert [d["class_id"] for d in body["detections"]] == list(want.class_idx)
        np.testing.assert_allclose([d["score"] for d in body["detections"]],
                                   want.class_prob, atol=1e-4)


def test_microbatched_bad_payload(batched_server):
    assert _post(batched_server + "/detect", b"garbage")[0] == 400


def test_microbatched_metrics_and_stages(batched_server):
    _post(batched_server + "/detect", _png(40))
    _, text = _get(batched_server + "/metrics", raw=True)
    lines = _metric_lines(text)
    assert "yolov3_queue_depth" in lines
    coalesced = {int(k.split('"')[1]): int(v) for k, v in lines.items()
                 if k.startswith("yolov3_device_batches_total")}
    assert coalesced and all(1 <= s <= 4 for s in coalesced)
    assert sum(s * n for s, n in coalesced.items()) \
        == int(lines["yolov3_requests_total"])
    stages = _get(batched_server + "/stats")["stages"]
    assert stages["queue_wait_s"]["count"] >= 1
    assert stages["decode_s"]["count"] >= 1
    assert 1 <= stages["device_fetch_s"]["count"] <= stages["queue_wait_s"]["count"]


def test_batcher_pads_to_max_batch_and_rejects_when_full():
    """The reference's policy: every batch padded to max_batch; a full
    queue answers Overloaded (503) at once; stop() fails what is queued."""
    release = threading.Event()
    shapes = []

    class Slow:
        last_stage_s = None

        def detect_mixed(self, frames):
            shapes.append(len(frames))
            release.wait(10)
            return [f.shape for f in frames]

    batcher = tserve.MicroBatcher(Slow(), window_s=0.01, max_batch=2)
    try:
        frame = np.zeros((4, 4, 3), np.uint8)
        with ThreadPoolExecutor(max_workers=12) as pool:
            futs = [pool.submit(batcher.detect, frame, 10.0) for _ in range(12)]
            time.sleep(0.3)   # 1-2 in the worker, 8 queued, the rest refused
            refused = [f for f in futs if f.done()]
            assert refused and all(
                isinstance(f.exception(), tserve.MicroBatcher.Overloaded)
                for f in refused)
            release.set()
            ok = [f.result(timeout=20) for f in futs if f not in refused]
        assert ok and all(r == (4, 4, 3) for r in ok)
        assert set(shapes) == {2}
    finally:
        release.set()
        batcher.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        batcher.detect(np.zeros((4, 4, 3), np.uint8))
    assert not batcher._thread.is_alive()


def test_overload_is_503():
    class Full:
        _q = type("Q", (), {"qsize": staticmethod(lambda: 0)})()

        def detect(self, frame):
            raise tserve.MicroBatcher.Overloaded("serving queue full")

    stats = tserve._Stats()
    handler = tserve.make_handler(None, None, stats, Full())
    srv = tserve.GracefulThreadingHTTPServer(("127.0.0.1", 0), handler)
    url, thread = _start(srv)
    try:
        status, body = _post(url + "/detect", _png(5, hw=(32, 32)))
        assert status == 503 and "full" in body["error"]
        assert stats.errors == 1
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)


def test_graceful_drain_mid_batch():
    """SIGTERM lands while requests sit in the micro-batcher's open window:
    every accepted request is answered 200, then the socket closes."""
    srv = tserve.serve(_detector(33), host="127.0.0.1", port=0,
                       warmup_hw=(240, 320), batch_window_s=0.3, max_batch=8)
    url, thread = _start(srv)
    old_term = signal.getsignal(signal.SIGTERM)
    old_int = signal.getsignal(signal.SIGINT)
    try:
        drained = tserve.install_graceful_shutdown(srv)
        png = _png(2)
        with ThreadPoolExecutor(max_workers=4) as pool:
            futs = [pool.submit(_post, url + "/detect", png) for _ in range(4)]
            time.sleep(0.1)  # requests accepted, batch window still open
            signal.raise_signal(signal.SIGTERM)
            results = [f.result(timeout=60) for f in futs]
        assert all(status == 200 for status, _ in results)
        assert all("detections" in body for _, body in results)
        assert drained.wait(timeout=30)
        thread.join(timeout=10)
        assert not thread.is_alive()
        assert not srv.batcher._thread.is_alive()
        with pytest.raises(OSError):
            socket.create_connection(("127.0.0.1", srv.server_address[1]),
                                     timeout=2)
    finally:
        signal.signal(signal.SIGTERM, old_term)
        signal.signal(signal.SIGINT, old_int)
        srv.batcher.stop()


def test_multi_shape_warmup(monkeypatch):
    det = _detector(34)
    calls = []
    real = det.warmup
    monkeypatch.setattr(det, "warmup", lambda *a, **k: calls.append((a, k))
                        or real(*a, **k))
    srv = tserve.serve(det, host="127.0.0.1", port=0,
                       warmup_hw=[(240, 320), (120, 160)])
    srv.server_close()
    assert calls == [((1, (240, 320)), {"host_preprocessed": True}),
                     ((1, (120, 160)), {"host_preprocessed": True})]
    calls.clear()
    srv = tserve.serve(det, host="127.0.0.1", port=0, warmup_hw=None,
                       batch_window_s=0.01, max_batch=4)
    srv.server_close()
    srv.batcher.stop()
    assert calls == []


@pytest.mark.parametrize("extra,match", [
    (["--net-size", "100"], "max stride"),
    (["--top-k", "0"], "top_k"),
    (["--devices", "2"], "ROADMAP.md"),
    (["--device", "cuda"], "--device cuda"),
    (["--quant-state", "/nonexistent/q.npz"], "file not found"),
])
def test_serve_cli_errors(tmp_path, extra, match):
    net = Darknet(TINY, device="cpu")
    wpath = tmp_path / "t.weights"
    write_weights(wpath, net.graph, random_raw(net.graph, seed=32))
    argv = ["--weights", str(wpath), "--config", TINY]
    if "--device" not in extra:
        argv += ["--device", "cpu"]
    with pytest.raises(SystemExit, match=match):
        tserve.main(argv + extra)


def test_same_png_to_both_servers():
    """One PNG, both packages' servers, same weights: the same JSON within
    the golden bars (``latency_ms`` aside)."""
    from yolov3_tpu.inference import Detector as JDetector
    from yolov3_tpu.model import Darknet as JDarknet
    from yolov3_tpu.serve import serve as jserve

    params = fold_raw(random_raw(Darknet(TINY, device="cpu").graph, seed=30))
    jdet = JDetector(JDarknet(TINY, precision="highest").set_params(params),
                     prob_thresh=0.3, net_hw=(160, 160))
    servers = [tserve.serve(_detector(30), class_names=NAMES, host="127.0.0.1",
                            port=0, warmup_hw=(240, 320)),
               jserve(jdet, class_names=NAMES, host="127.0.0.1", port=0,
                      warmup_hw=(240, 320))]
    started = [_start(s) for s in servers]
    try:
        png = _png(0)
        (s1, got), (s2, want) = (_post(url + "/detect", png)
                                 for url, _ in started)
        assert s1 == s2 == 200
        assert got.keys() == want.keys() == {"detections", "latency_ms",
                                             "image_hw"}
        assert got["image_hw"] == want["image_hw"]
        assert len(got["detections"]) == len(want["detections"]) > 0
        for g, w in zip(got["detections"], want["detections"]):
            assert g.keys() == w.keys()
            assert (g["class_id"], g["class_name"]) == (w["class_id"],
                                                        w["class_name"])
            assert abs(g["score"] - w["score"]) <= 5e-5 + 1e-4  # 4-digit JSON
            np.testing.assert_allclose(g["bbox_tlbr"], w["bbox_tlbr"],
                                       atol=0.1 + 0.01)
        assert _get(started[0][0] + "/stats")["stages"].keys() == \
            _get(started[1][0] + "/stats")["stages"].keys()
    finally:
        for srv, (_, thread) in zip(servers, started):
            srv.shutdown()
            srv.server_close()
            thread.join(timeout=10)
