"""The port's benchmark (``yolov3_tpu_torch/bench.py``) on the CPU.

Its probe, watchdog, crash guards, failure line, probe retry and latency
row, case by case as ``tests/test_bench_probe.py`` holds the JAX package's
``bench.py``; then what only the port has to show:

* the bench's step against the same composition of the JAX package's
  functions, as ``bench.py``'s ``run`` builds it (the Pallas decode in
  interpret mode), on the same seeded frames and the same
  ``fold_raw(random_raw(·, 0))`` weights with the heads' objectness biases
  at -6, at precision "highest": survivor counts equal, score sums within
  ``tests/test_torch_pipeline.py``'s 5e-5 a score (summed over the
  survivors); the int8 step on one quantization state (made by the JAX
  package, carried across as numpy arrays) within
  ``tests/test_torch_int8_pipeline.py``'s bar, 0.01 a score; the port's
  calibration of that state within two bf16 ulps of the JAX package's
  (``tests/test_torch_calibrate.py``'s bar at bf16), its int8 weights equal;
* the scanned step's sums equal the sum over its unscanned sub-batches, bit
  for bit;
* the headline, its rows and their keys, the measuring calls and
  ``_fail_row`` equal the JAX package's for the same arguments (both mains
  driven with fake measurements);
* the port's copy of the host NMS oracle equals ``tests/test_nms.py``'s;
* the CPU denominator is written only to the port's own cache, never to
  ``BENCH_TORCH_BASELINE.json``.
"""
import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from tests.test_nms import numpy_reference_nms as jnms_oracle
from tests.test_nms import random_detections
from yolov3_tpu import quant as jq
from yolov3_tpu.graph import load_graph as jload_graph
from yolov3_tpu.model import (forward_packed as jforward_packed,
                              forward_packed_fused as jforward_packed_fused,
                              fused_heads_eligible as jfused_eligible)
from yolov3_tpu.ops.nms import batched_nms_packed as jnms_packed
from yolov3_tpu.ops.preprocess import preprocess as jpreprocess
from yolov3_tpu_torch import bench
from yolov3_tpu_torch.graph import load_graph
from yolov3_tpu_torch.weights import quant_state_from_jax

torch.set_num_threads(1)

REPO = Path(__file__).parent.parent
DATA = Path(__file__).parent / "data"
WIDE = DATA / "port_wide.cfg"     # 32x32, 128-wide, head-fused eligible
BLOCK = DATA / "port_block.cfg"   # 48x48, two K6-eligible residual blocks
SCORE_ATOL = 5e-5                 # tests/test_torch_pipeline.py, a score
INT8_SCORE_ATOL = 0.01            # tests/test_torch_int8_pipeline.py


# --- the cases of tests/test_bench_probe.py ----------------------------

def test_probe_times_out_bounded():
    # 0.3 s is below any torch import, so the probe returns (False, ...)
    # on every machine: it cannot itself hang its caller
    ok, detail = bench.device_reachable(timeout_s=0.3)
    assert not ok
    assert detail


def test_probe_without_cuda_is_a_failure(monkeypatch):
    """A child that finds no CUDA fails the probe; it never measures
    whatever it finds instead."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    ok, detail = bench.device_reachable(timeout_s=120.0)
    assert not ok and "is_available() is False" in detail


def test_deadline_watchdog_aborts_with_json_error():
    # 2 s is below any quick run's completion (tiny@416, 64 frames a step,
    # on the CPU), so the watchdog fires
    r = subprocess.run([sys.executable, "-m", "yolov3_tpu_torch.bench",
                        "--quick", "--device", "cpu", "--probe-timeout", "0",
                        "--deadline", "2"],
                       capture_output=True, text=True, timeout=120,
                       cwd=REPO)
    assert r.returncode == 3, r.stderr[-2000:]
    row = json.loads(r.stdout.strip().splitlines()[-1])
    assert "deadline" in row["error"]
    assert row["metric"] == ("images/sec/chip yolov3-tiny@416 batch8 bf16 "
                             "e2e inference")


def _fakes(calls, fail_fused=True):
    """Fake measurements for both packages' mains, recording each call's
    knobs (the port's ``device`` aside) in ``calls``; with ``fail_fused``
    the float step at 608 with K4 raises."""
    def fake_float(graph, prms, frames, iters, **kw):
        kw.pop("device", None)
        calls.append(("float", graph.name, frames.shape, iters,
                      sorted(kw.items())))
        if fail_fused and kw.get("fused_heads") and frames.shape[1] == 608:
            raise RuntimeError("kernel build failed")
        return 100.0 + frames.shape[1], [100.0 + frames.shape[1], 99.0]

    def fake_int8(graph, prms, frames, iters, **kw):
        kw.pop("device", None)
        calls.append(("int8", graph.name, frames.shape, iters,
                      sorted(kw.items())))
        return 200.0 + frames.shape[1], [200.0 + frames.shape[1], 199.0]

    def fake_latency(graph, params, size, **kw):
        kw.pop("device", None)
        calls.append(("latency", graph.name, size, sorted(kw.items())))
        return 0.5, {f"b{b}": bench.latency_row([2.0 * b, 2.1 * b], 0.5, b)
                     for b in kw.get("batches", (1, 8, 32))}

    def fake_baseline(graph, raw, size, batch, iters, remeasure=False):
        return {"img_s": 1.0 + size / 1000, "std": 0.01}

    return fake_float, fake_int8, fake_latency, fake_baseline


def _patch_port(monkeypatch, calls, fail_fused=True):
    fake_float, fake_int8, fake_latency, fake_baseline = _fakes(calls,
                                                                fail_fused)
    monkeypatch.setattr(bench, "measure_gpu", fake_float)
    monkeypatch.setattr(bench, "measure_gpu_int8", fake_int8)
    monkeypatch.setattr(bench, "measure_latency", fake_latency)
    monkeypatch.setattr(bench, "torch_baseline",
                        lambda *a, **k: fake_baseline(*a, **k))


def test_fused_extra_rows_and_crash_guard(monkeypatch, capsys):
    # a default run appends the head-fused rows at 608; a failure there
    # lands in that row's "error" field and never costs the headline
    calls = []
    _patch_port(monkeypatch, calls)
    bench.main(["--cfg", "yolov3-tiny.cfg", "--batch", "2", "--deadline", "0",
                "--probe-timeout", "0", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip())
    rows = out["rows"]
    assert out["value"] == 708.0  # the headline, untouched by the failure
    fb = rows["yolov3-tiny@608 batch2 bf16 fused-heads"]
    assert "kernel build failed" in fb["error"] and fb["fused_heads"]
    fq = rows["yolov3-tiny@608 batch2 int8 fused-heads"]
    assert fq["img_s"] == 808.0 and fq["fused_heads"] is True
    # the standard rows ran unfused; only the extra rows asked for K4
    fused = [(c[0], c[2][1], dict(c[4])["fused_heads"]) for c in calls
             if c[0] in ("float", "int8")]
    assert ("float", 608, True) in fused and ("float", 608, False) in fused
    assert out["card"] == "cpu"


def test_fail_row_preserves_partial_rows():
    ns = argparse.Namespace(cfg="yolov3.cfg", size=None, batch=128,
                            precision="bf16")
    rows = {"yolov3@608 batch128 bf16": {"img_s": 907.0,
                                         "vs_baseline": 1400.0}}
    row = json.loads(bench._fail_row(ns, "wedged", rows=rows))
    # a stall after the headline completed still reports it
    assert row["value"] == 907.0 and row["vs_baseline"] == 1400.0
    assert row["rows"] == rows and row["error"] == "wedged"


def _retry_args(**kw):
    ns = argparse.Namespace(probe_timeout=180.0, probe_retry_budget=1800.0,
                            deadline=3600.0, device=None)
    vars(ns).update(kw)
    return ns


def test_probe_retry_recovers(monkeypatch):
    # two failures then a recovery: ok, with the attempt count in the detail
    results = iter([(False, "down"), (False, "down"), (True, "H100 1024.0")])
    sleeps = []
    monkeypatch.setattr(bench, "device_reachable",
                        lambda t, d: next(results))
    monkeypatch.setattr(time, "sleep", sleeps.append)
    monkeypatch.setattr(bench, "_T0", time.perf_counter())
    ok, detail = bench._probe_with_retry(_retry_args())
    assert ok and "recovered on probe attempt 3" in detail
    assert sleeps == [30.0, 60.0]  # the backoff doubles


def test_probe_retry_gives_up_within_budget(monkeypatch):
    # a card that never answers still gives the error line, and no attempt
    # starts whose worst case (sleep + a hung probe) would pass the budget
    calls = []
    monkeypatch.setattr(bench, "device_reachable",
                        lambda t, d: (calls.append(t) or (False, "down")))
    slept = []
    monkeypatch.setattr(time, "sleep", slept.append)
    monkeypatch.setattr(bench, "_T0", time.perf_counter())
    # the budget admits the first attempt and exactly one retry
    # (30 + 180 = 210 <= 230; the next worst case 60 + 180 = 240 > 230)
    ok, detail = bench._probe_with_retry(
        _retry_args(probe_timeout=180.0, probe_retry_budget=230.0,
                    deadline=0.0))
    assert not ok and "gave up after" in detail
    assert len(calls) == 2 and slept == [30.0]


def test_probe_retry_budget_zero_is_single_attempt(monkeypatch):
    calls = []
    monkeypatch.setattr(bench, "device_reachable",
                        lambda t, d: (calls.append(t) or (False, "down")))
    ok, _ = bench._probe_with_retry(_retry_args(probe_retry_budget=0.0))
    assert not ok and len(calls) == 1


def test_main_fails_fast_with_json_error(monkeypatch, capsys):
    monkeypatch.setattr(bench, "device_reachable",
                        lambda t, d: (False, "no card answered"))
    with pytest.raises(SystemExit) as e:
        bench.main(["--quick", "--probe-retry-budget", "0"])
    assert e.value.code == 2
    row = json.loads(capsys.readouterr().out.strip())
    assert row["error"].startswith("device unreachable")
    assert row["value"] == 0.0 and row["unit"] == "img/s"
    # keyed exactly as the success headline (model@size batch precision)
    assert "yolov3-tiny@416" in row["metric"]
    assert "batch8" in row["metric"] and "bf16" in row["metric"]


def test_main_without_cuda_is_a_json_error(monkeypatch, capsys):
    """With the probe off, a run that asks for the card where there is
    none still ends in one JSON error line and exit code 2."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        bench.main(["--quick", "--probe-timeout", "0"])
    assert e.value.code == 2
    row = json.loads(capsys.readouterr().out.strip())
    assert "is_available() is False" in row["error"]
    assert row["metric"].startswith("images/sec/chip yolov3-tiny@416 batch8")


def test_latency_row_congestion_semantics():
    """chip_ms_est is the p50 less the null program's round trip where that
    is below the p50, and null with rtt_congested where it exceeds it."""
    lat = [46.0, 46.1, 46.2, 45.9, 46.0]
    row = bench.latency_row(lat, rtt_p50=37.3, batch=1)
    assert row["rtt_congested"] is False
    assert abs(row["chip_ms_est"] - (row["p50_ms"] - 37.3)) < 0.02
    assert row["img_s_sync"] == pytest.approx(1000.0 / row["p50_ms"], rel=0.01)

    row = bench.latency_row(lat, rtt_p50=72.4, batch=1)
    assert row["rtt_congested"] is True
    assert row["chip_ms_est"] is None
    assert row == jbench.latency_row(lat, 72.4, 1)


# --- (a) the step against the JAX composition of bench.py's run ---------

def _nets(cfg):
    g, jg = load_graph(cfg), jload_graph(cfg)
    raw, params = bench._bench_raw(g)
    hw = (g.in_height, g.in_width)
    return g, jg, params, hw


def _frames(hw, b=4, seed=5):
    return np.random.default_rng(seed).integers(0, 256, (b, *hw, 3),
                                                dtype=np.uint8)


def _jax_run(jg, net_hw, prob_thresh, precision, fused, top_k):
    """bench.py:150-165, the reference's float step."""
    fwd = (jforward_packed_fused if fused and jfused_eligible(jg)
           else jforward_packed)

    @jax.jit
    def run(params, frames_u8):
        x = jpreprocess(frames_u8[..., ::-1], net_hw)
        payload, scores = fwd(jg, params, x, prob_thresh=prob_thresh,
                              precision=precision)
        res = jnms_packed(payload, scores, select_group=2, top_k=top_k)
        return jnp.sum(res.scores), jnp.sum(res.valid)

    return run


def _jax_run_int8(jg, net_hw, scales, prob_thresh, precision, fused,
                  block_impl, top_k):
    """bench.py:222-249, the reference's int8 step (its precision a
    parameter here)."""
    fwd_q = (jq.forward_packed_fused_int8 if fused and jfused_eligible(jg)
             else jq.forward_packed_int8)

    @jax.jit
    def run(qparams, frames_u8):
        x = jpreprocess(frames_u8[..., ::-1], net_hw)
        payload, scores = fwd_q(jg, qparams, scales, x,
                                prob_thresh=prob_thresh, precision=precision,
                                carrier="int8", block_impl=block_impl,
                                zeros=None)
        res = jnms_packed(payload, scores, select_group=2, top_k=top_k)
        return jnp.sum(res.scores), jnp.sum(res.valid)

    return run


@pytest.mark.parametrize("fused", [False, True], ids=["K1", "K4"])
def test_step_matches_jax_composition(fused):
    g, jg, params, hw = _nets(WIDE)
    frames = _frames(hw)
    top_k = bench.auto_top_k(g, hw)
    step = bench.make_step(g, bench.device_params(params, torch.device("cpu")),
                           hw, precision="highest", fused_heads=fused)
    s, n = step(torch.from_numpy(frames))
    js, jn = _jax_run(jg, hw, 0.05, "highest", fused, top_k)(
        jax.device_put(params), jnp.asarray(frames))
    assert int(n) == int(jn) > 0
    assert abs(float(s) - float(js)) <= SCORE_ATOL * int(jn)


def test_int8_state_matches_jax_calibration():
    """bench.py:225-238 on the port: scales at bf16 within two bf16 ulps of
    the JAX package's on the same default_rng(3) frames; the int8 weights
    equal."""
    g, jg, params, hw = _nets(BLOCK)
    qparams, scales, zeros = bench.int8_state(
        g, bench.device_params(params, torch.device("cpu")), hw)
    dev_params = jax.tree.map(jnp.asarray, params)
    rng = np.random.default_rng(3)
    calib = [jpreprocess(jnp.asarray(
        rng.integers(0, 256, (8, *hw, 3), dtype=np.uint8)), hw)]
    jscales = jq.calibrate_tensors(jg, dev_params, calib, precision="bf16")
    jqparams = jq.quantize_weights(jg, dev_params)
    assert zeros is None and set(scales) == set(jscales)
    for i in jscales:
        assert scales[i] == pytest.approx(jscales[i], rel=2 ** -6), i
    assert set(qparams) == set(jqparams)
    for i, jqp in jqparams.items():
        assert set(qparams[i]) == set(jqp)
        for k, v in jqp.items():
            np.testing.assert_allclose(qparams[i][k].float().numpy(),
                                       np.asarray(v, np.float32), rtol=1e-6)


@pytest.mark.parametrize("cfg,block_impl,fused,prob", [
    (BLOCK, "xla", False, 0.003), (BLOCK, "pallas", False, 0.003),
    (WIDE, "xla", True, 0.05)], ids=["blocks-xla", "blocks-K6", "K4"])
def test_int8_step_matches_jax_composition(cfg, block_impl, fused, prob):
    """One quantization state, made by the JAX package as bench.py makes
    it, through both steps at "highest" (port_block's survivors score
    about 0.004, so its threshold sits below them)."""
    g, jg, params, hw = _nets(cfg)
    frames = _frames(hw)
    dev_params = jax.tree.map(jnp.asarray, params)
    rng = np.random.default_rng(3)
    calib = [jpreprocess(jnp.asarray(
        rng.integers(0, 256, (8, *hw, 3), dtype=np.uint8)), hw)]
    scales = jq.calibrate_tensors(jg, dev_params, calib, precision="bf16")
    jqparams = jq.quantize_weights(jg, dev_params)
    top_k = bench.auto_top_k(g, hw)
    run = _jax_run_int8(jg, hw, scales, prob, "highest", fused, block_impl,
                        top_k)
    js, jn = run(jax.device_put(jqparams), jnp.asarray(frames))
    qparams = quant_state_from_jax(
        {i: {k: np.asarray(v) for k, v in qp.items()}
         for i, qp in jqparams.items()}, "cpu")
    step = bench.make_step(g, qparams, hw, prob_thresh=prob,
                           precision="highest", fused_heads=fused,
                           act_scales={int(i): float(v)
                                       for i, v in scales.items()},
                           block_impl=block_impl,
                           operands=bench.Operands(qparams))
    s, n = step(torch.from_numpy(frames))
    assert int(n) == int(jn) > 0
    assert abs(float(s) - float(js)) <= INT8_SCORE_ATOL * int(jn)


# --- (b) the scan -------------------------------------------------------

@pytest.mark.parametrize("precision", ["highest", "bf16", "int8"])
def test_scanned_step_sums_its_sub_batches(precision):
    g, _, params, hw = _nets(WIDE)
    cpu = torch.device("cpu")
    kw = {}
    if precision == "int8":
        tp = bench.device_params(params, cpu)
        qparams, scales, _ = bench.int8_state(g, tp, hw)
        prms = qparams
        kw = dict(act_scales=scales, operands=bench.Operands(qparams))
        prec = "bf16"
    else:
        dtype = torch.bfloat16 if precision == "bf16" else torch.float32
        prms = bench.device_params(params, cpu, dtype)
        prec = precision
    frames = torch.from_numpy(_frames(hw, b=6))
    scanned = bench.make_step(g, prms, hw, precision=prec, scan=3, **kw)
    one = bench.make_step(g, prms, hw, precision=prec, **kw)
    s, n = scanned(frames)
    parts = [one(f) for f in frames.chunk(3)]
    assert torch.equal(s, torch.stack([p[0] for p in parts]).sum())
    assert torch.equal(n, torch.stack([p[1] for p in parts]).sum())
    assert int(n) > 0 and s.dtype == torch.float32
    # the captured form is the eager step on the CPU
    prog = bench.capture_step(scanned, frames.shape, frames.device)
    got = bench.call_step(prog, frames)
    assert not isinstance(prog, bench._CapturedProgram)
    assert torch.equal(got[0], s) and torch.equal(got[1], n)


def test_measure_and_latency_run_on_cpu():
    """The timed estimator and the latency rows end to end on the CPU (the
    numbers are the CPU's, only their shape is checked)."""
    g, _, params, hw = _nets(WIDE)
    frames = _frames(hw, b=2)
    best, blocks = bench.measure_gpu(g, params, frames, 2, precision="bf16",
                                     scan=2, device="cpu")
    assert best == max(blocks) > 0 and len(blocks) == 2
    best, blocks = bench.measure_gpu_int8(g, params, frames, 2, scan=2,
                                          fused_heads=True, device="cpu")
    assert best == max(blocks) > 0
    rtt, rows = bench.measure_latency(g, params, hw[0], batches=(1, 2), n=3,
                                      device="cpu")
    assert set(rows) == {"b1", "b2"} and rtt > 0
    assert all(r["p50_ms"] > 0 for r in rows.values())


def test_main_on_cpu_end_to_end(monkeypatch, capsys, tmp_path):
    """``main`` on the CPU at port_wide@160 (7 calls a block: the count
    scales with (608 / size)²): the one JSON line, keyed as the
    headline, its row measured and traced (``--profile``); the CPU
    denominator measured into the port's cache (here tmp_path)."""
    cache = tmp_path / "baseline.json"
    monkeypatch.setattr(bench, "PORT_BASELINE_CACHE", cache)
    bench.main(["--cfg", str(WIDE), "--size", "160", "--batch", "2",
                "--iters", "1", "--scan", "2", "--device", "cpu",
                "--probe-timeout", "0", "--deadline", "600",
                "--profile", str(tmp_path / "trace")])
    assert json.loads((tmp_path / "trace" / "trace.json").read_text())
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"] == ("images/sec/chip port_wide@160 batch2 bf16 e2e "
                             "inference")
    row = out["rows"]["port_wide@160 batch2 bf16"]
    assert out["value"] == row["img_s"] > 0 and row["scan"] == 2
    assert json.loads(cache.read_text())["port_wide@160"]["batch"] == 2


# --- (c) the keys against the JAX package's bench -----------------------

def _run_both(monkeypatch, capsys, argv, fail_fused):
    """Both mains on ``argv`` with fake measurements: (port's line, JAX
    package's line, port's calls, JAX package's calls)."""
    import tools.bench_clock

    pcalls, jcalls = [], []
    _patch_port(monkeypatch, pcalls, fail_fused)
    fake_float, fake_int8, fake_latency, fake_baseline = _fakes(jcalls,
                                                                fail_fused)
    monkeypatch.setattr(jbench, "measure_tpu", fake_float)
    monkeypatch.setattr(jbench, "measure_tpu_int8", fake_int8)
    monkeypatch.setattr(jbench, "measure_latency", fake_latency)
    monkeypatch.setattr(jbench, "torch_baseline", fake_baseline)
    monkeypatch.setattr(tools.bench_clock, "enable_compile_cache",
                        lambda: None)
    flags = ["--probe-timeout", "0", "--deadline", "0"]
    bench.main(argv + flags + ["--device", "cpu"])
    port = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    monkeypatch.setattr(sys, "argv", ["bench.py"] + argv + flags)
    jbench.main()
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return port, ref, pcalls, jcalls


@pytest.mark.parametrize("argv", [
    ["--cfg", "yolov3-tiny.cfg", "--batch", "2"],
    ["--batch", "2"],
    ["--quick"],
    ["--cfg", "yolov3-tiny.cfg", "--size", "320", "--precision", "int8",
     "--fuse-blocks", "--act-scheme", "asymmetric", "--select-group", "4",
     "--batch", "4", "--int8-heads"],
    ["--cfg", "yolov3-tiny.cfg", "--batch", "2", "--fused-heads",
     "--no-variants", "--scan", "2"],
    ["--cfg", "yolov3-tiny.cfg", "--latency", "--size", "416",
     "--fused-heads"],
], ids=["tiny-matrix", "yolov3-matrix", "quick", "int8-knobs", "fused",
        "latency"])
def test_rows_and_keys_equal_the_reference(monkeypatch, capsys, argv):
    # a K4 row that fails keeps its error in its row; with --fused-heads
    # every row runs K4, so there nothing fails
    port, ref, pcalls, jcalls = _run_both(monkeypatch, capsys, argv,
                                          "--fused-heads" not in argv)
    assert port.pop("card") == "cpu"
    assert port == ref
    assert pcalls == jcalls


@pytest.mark.parametrize("cfg", ["yolov3.cfg", "yolov3-tiny.cfg",
                                 "yolov3-spp.cfg"])
@pytest.mark.parametrize("size,batch,precision", [
    (None, 128, "bf16"), (416, 8, "int8"), (320, 1, "highest"),
    (608, 32, "default")])
def test_fail_row_equals_the_reference(cfg, size, batch, precision):
    ns = argparse.Namespace(cfg=cfg, size=size, batch=batch,
                            precision=precision)
    rows = {"a": {"error": "x"}, "b": {"img_s": 3.5, "vs_baseline": 2.0}}
    for r in (None, rows):
        assert bench._fail_row(ns, "stalled", rows=r) == \
            jbench._fail_row(ns, "stalled", rows=r)


# --- (d) the host NMS oracle ---------------------------------------------

@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("prob,iou", [(0.05, 0.3), (0.2, 0.45), (0.0, 0.6)])
def test_numpy_reference_nms_copy(seed, prob, iou):
    det = random_detections(np.random.default_rng(seed), n=150)
    got = bench.numpy_reference_nms(det, prob, iou)
    assert got == jnms_oracle(det, prob, iou) and got


# --- (e) the CPU denominator --------------------------------------------

def test_torch_baseline_writes_only_its_own_cache(monkeypatch, tmp_path):
    frozen = jbench.BASELINE_CACHE
    assert frozen.resolve() == bench.BASELINE_CACHE.resolve()
    digest = hashlib.sha256(frozen.read_bytes()).hexdigest()
    g = load_graph(REPO / "models" / "yolov3-tiny.cfg")
    raw, _ = bench._bench_raw(g)
    cache = tmp_path / "sub" / "baseline.json"
    monkeypatch.setattr(bench, "PORT_BASELINE_CACHE", cache)
    entry = bench.torch_baseline(g, raw, 64, batch=1, iters=1)
    assert entry["img_s"] > 0 and entry["batch"] == 1
    assert json.loads(cache.read_text()) == {"yolov3-tiny@64": entry}

    def never(*a, **k):
        raise AssertionError("measured again")

    monkeypatch.setattr(bench, "measure_torch_cpu", never)
    # the port's cache and the repository's file are read, not measured
    assert bench.torch_baseline(g, raw, 64, 1, 1) == entry
    want = json.loads(frozen.read_text())["yolov3-tiny@416"]
    assert bench.torch_baseline(g, raw, 416, 4, 1) == want
    with pytest.raises(AssertionError, match="measured again"):
        bench.torch_baseline(g, raw, 416, 4, 1, remeasure=True)
    assert hashlib.sha256(frozen.read_bytes()).hexdigest() == digest
