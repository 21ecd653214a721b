"""Throughput and latency benchmark of the port; the last line of stdout is
ONE JSON object.

Port of the JAX package's ``bench.py``. Tracked metric (``BASELINE.json``):
images/sec/chip at 608 (and 416), batch 128, end-to-end inference: uint8
frames → BGR→RGB flip and ``ops.preprocess.preprocess`` on the card → the
forward pass (``model.forward_packed``, K1; ``forward_packed_fused``, K4;
the int8 walks of ``quant.py``, K6 with ``--fuse-blocks``) →
``ops.nms.batched_nms_packed`` (K2) → two scalars on the card, the sum of
the survivors' scores and their count. ``vs_baseline`` is the ratio against
the reference-equivalent PyTorch-CPU pipeline (``tools.torch_ref``'s
module-list forward + host numpy NMS), read from the repository's
``BENCH_TORCH_BASELINE.json`` (never written here); a key it lacks, or
``--remeasure-baseline``, is measured on the CPU and kept in
``build/bench_torch_baseline.json``.

How a row is measured (:func:`measure_gpu`, :func:`measure_gpu_int8`):
``iters`` distinct inputs of ``scan`` sub-batches each are staged on the
card before the clock starts (``default_rng(7)``); the step over ``scan``
sub-batches back to back (``inference.scanned``) is ONE CUDA graph,
warmed up and captured before the clock starts (:func:`capture_step`);
a timed block enqueues, for each input, a device-to-device copy into the
graph's static input, a replay, and the copy of the step's two scalars
into the input's own slot on the card, then fetches the slots (the only
bytes that leave the card) once; ``img_s`` is the better of two blocks and
``blocks`` both. The copy into the static input is part of the step, as a
``Detector`` call's copy is: at 608, B=128, ``scan=4`` it moves 568 MB, a
fraction of a millisecond of a step of hundreds. On the CPU the same code
runs the step eagerly on each staged input.

Weights are ``random_raw(graph, seed=0)`` with the heads' objectness biases
at -6 (trained-weights candidate counts), folded; throughput does not
depend on the weights' values.

    python -m yolov3_tpu_torch.bench [--quick] [--batch 128] [--size 608]
        [--precision bf16|int8|highest|default] [--scan K] [--latency]
        [--fused-heads] [--fuse-blocks] [--device cuda|cuda:N|cpu] ...

Without ``--device cpu`` it runs on the card and never falls back: a card
that a bounded probe in a child process cannot reach, or no CUDA at all,
gives one JSON error line and exit code 2; a run that passes
``--deadline`` gives one with exit code 3, keeping the rows measured.
Progress and each row's peak device memory go to stderr.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .graph import Graph, load_graph
from .inference import (_CapturedProgram, _InterpCache, _Program,
                        detect_step, scanned)
from .model import fused_heads_eligible
from .ops.nms import NMSResult, auto_top_k
from .ops.preprocess import preprocess
from .quant import (Operands, calibrate_tensors, calibrate_tensors_affine,
                    quantize_weights)
from .utils.boxes import cxywh_to_tlbr
from .weights import (TorchParams, fold_raw, params_from_jax, random_raw,
                      resolve_device)

REPO = Path(__file__).resolve().parent.parent
BASELINE_CACHE = REPO / "BENCH_TORCH_BASELINE.json"   # read only
PORT_BASELINE_CACHE = REPO / "build" / "bench_torch_baseline.json"

# rows measured so far this run: the deadline watchdog prints them in its
# error line, so a run that stalls keeps the rows that completed
_PARTIAL = {}
_T0 = time.perf_counter()


def _log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def device_reachable(timeout_s: float = 180.0, device: str = "cuda"):
    """Bounded reachability probe of the card, run in a CHILD process.

    The child imports torch, requires CUDA, sums a (8, 128) tensor on
    ``device`` and prints the card's name; it is killed at ``timeout_s``.
    A child without CUDA is a failure. Returns (ok, detail)."""
    src = ("import sys, torch\n"
           "if not torch.cuda.is_available():\n"
           "    sys.exit('torch.cuda.is_available() is False')\n"
           f"d = torch.device({device!r})\n"
           "x = torch.ones((8, 128), device=d)\n"
           "print(torch.cuda.get_device_name(d), float(x.sum()))\n")
    try:
        r = subprocess.run([sys.executable, "-c", src], timeout=timeout_s,
                           capture_output=True, text=True)
    except subprocess.TimeoutExpired:
        return False, f"device probe hung >{timeout_s:.0f}s"
    if r.returncode != 0:
        return False, (r.stderr or "device probe failed").strip()[-400:]
    return True, r.stdout.strip()


def _probe_with_retry(args):
    """Startup probe with bounded retry and backoff (sleeps of 30, 60, 120,
    then 180 s) while ``--probe-retry-budget`` allows, leaving at least 25 min
    of ``--deadline`` for the run itself; an attempt starts only if its
    worst case (sleep + a hung probe) fits in the budget. Returns (ok,
    detail)."""
    device = args.device or "cuda"
    ok, detail = device_reachable(args.probe_timeout, device)
    if ok or args.probe_retry_budget <= 0:
        return ok, detail
    budget = args.probe_retry_budget
    if args.deadline > 0:
        budget = min(budget, max(0.0, args.deadline - 1500.0))
    attempts, sleep_s = 1, 30.0
    while True:
        elapsed = time.perf_counter() - _T0
        if elapsed + sleep_s + args.probe_timeout > budget:
            return False, (f"{detail} (gave up after {attempts} probe "
                           f"attempts over {elapsed:.0f}s)")
        # stdout carries only the JSON line
        print(f"probe attempt {attempts} failed ({detail}); retrying in "
              f"{sleep_s:.0f}s", file=sys.stderr, flush=True)
        time.sleep(sleep_s)
        sleep_s = min(sleep_s * 2, 180.0)
        attempts += 1
        ok, detail = device_reachable(args.probe_timeout, device)
        if ok:
            return ok, f"{detail} (recovered on probe attempt {attempts})"


def device_params(params, device: torch.device,
                  dtype: torch.dtype = torch.float32) -> TorchParams:
    """Folded HWIO numpy params → the port's OIHW tensors on ``device`` in
    ``dtype`` (channels_last weights, as ``Darknet.set_params`` keeps
    them). The cast happens here, never inside a capture."""
    return {i: {"w": p["w"].to(dtype), "b": p["b"].to(dtype)}
            for i, p in params_from_jax(params, device).items()}


def step_sums(res: NMSResult) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the survivors' scores, count of survivors), two 0-d tensors
    on the device of ``res`` (scores are 0 where no survivor)."""
    return res.scores.sum(), res.valid.sum()


def make_step(graph: Graph, params: TorchParams, net_hw: Tuple[int, int],
              prob_thresh: float = 0.05, precision: Optional[str] = None,
              scan: int = 1, fused_heads: bool = False,
              select_group: int = 2, top_k: Optional[int] = None,
              act_scales=None, act_zeros=None, block_impl: str = "xla",
              operands=None) -> Callable:
    """The bench's step, the body of the reference's ``run``: (scan·B, H,
    W, 3) uint8 BGR frames at net size on ``params``' device → (sum of
    scores, count of survivors), summed over the ``scan`` sub-batches, which
    run back to back (``inference.scanned``). Flip → ``preprocess`` →
    ``forward_packed`` (K1), or ``forward_packed_fused`` (K4) when
    ``fused_heads`` and the graph is eligible → ``batched_nms_packed`` (K2)
    with ``top_k`` (None: ``auto_top_k``). With ``act_scales`` the params
    are int8 ``qparams`` and the int8-carrier walk runs at ``precision``
    (None: "bf16"), K6 for its blocks with ``block_impl="pallas"``.

    Each sub-batch's sums are reduced as the unscanned step reduces them,
    then added in order, so the scanned sums equal the sum of the unscanned
    ones bit for bit. Nothing in the step copies from the host or waits for
    the card once its lazy caches are filled (one eager call)."""
    w0 = next(iter(next(iter(params.values())).values()))
    route = ("pallas-fused" if fused_heads and fused_heads_eligible(graph)
             else "pallas")
    top_k = auto_top_k(graph, net_hw) if top_k is None else top_k
    nms = dict(top_k=top_k, select_group=select_group)
    run = scanned(detect_step(
        graph, params, net_hw, "letterbox", True, route,
        _InterpCache(net_hw, "letterbox", w0.device), prob_thresh, nms,
        precision=precision, act_scales=act_scales, act_zeros=act_zeros,
        carrier="int8", block_impl=block_impl, operands=operands), scan)

    def step(frames_u8: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        res = run(frames_u8)
        if scan == 1:
            return step_sums(res)
        parts = [step_sums(NMSResult(*fields))
                 for fields in zip(*(f.chunk(scan) for f in res))]
        return tuple(torch.stack(p).sum() for p in zip(*parts))

    return step


def capture_step(step: Callable, shape, device: torch.device) -> _Program:
    """``step`` on a static uint8 input of ``shape``, as a ``Detector``
    program is: on the card ONE CUDA graph (``inference._CapturedProgram``:
    one eager call on its stream builds the kernels and fills every lazy
    cache, then the capture); on the CPU the eager step."""
    key = (shape[0], tuple(shape[1:3]))
    if device.type != "cuda":
        return _Program(key, "bench", step, ())
    prog = _CapturedProgram(key, "bench", step, (), device)
    prog.capture()
    return prog


def call_step(prog: _Program, frames: torch.Tensor):
    """One call of ``prog`` on ``frames`` on its device: on the card a
    device-to-device copy into the static input, then one replay, whose
    outputs the next call overwrites."""
    if isinstance(prog, _CapturedProgram):
        prog.input.copy_(frames)
        frames = prog.input
    return prog(frames)


def _stage(rng, shape, count: int, device: torch.device):
    return [torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)
                             ).to(device) for _ in range(count)]


def _release(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _timed_blocks(step: Callable, frames_shape, iters: int, scan: int,
                  device: torch.device, what: str):
    """The reference's estimator on ``step``: ``iters`` distinct inputs
    staged, the step captured, two warm-up calls, then the best of two
    timed blocks (all calls enqueued, then one fetch of every call's
    scalars; both blocks must fetch the same scalars). Returns (best img/s,
    [img/s of each block]). Drops the graph, its pool and the inputs before
    it returns. On the card it logs the row's capture time and peak memory,
    and the device time of ``iters`` back-to-back replays against the
    better block (the replays' share of it: the card is idle at most the
    rest)."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    shape = (scan * frames_shape[0], *frames_shape[1:])
    batches = _stage(np.random.default_rng(7), shape, iters, device)
    prog = capture_step(step, shape, device)
    try:
        float(call_step(prog, batches[0])[0])
        float(call_step(prog, batches[-1])[0])
        sums = torch.zeros(iters, dtype=torch.float32, device=device)
        counts = torch.zeros(iters, dtype=torch.int64, device=device)
        blocks, fetched = [], []
        for _ in range(2):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            with torch.inference_mode():
                for i, b in enumerate(batches):  # enqueue all
                    s, v = call_step(prog, b)
                    sums[i].copy_(s)
                    counts[i].copy_(v)
                # only the scalars leave the card
                fetched.append((sums.cpu(), counts.cpu()))
            blocks.append(shape[0] * iters / (time.perf_counter() - t0))
        if not all(torch.equal(a, b) for a, b in zip(*fetched)):
            raise RuntimeError(f"{what}: the two timed blocks' steps gave "
                               f"different results on the same inputs")
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                prog.graph.replay()
            end.record()
            end.synchronize()
            replay_ms = start.elapsed_time(end) / iters
            share = replay_ms * iters / (1e3 * shape[0] * iters / max(blocks))
            gib = 2 ** 30
            _log(f"{what} B={frames_shape[0]} scan={scan} iters={iters}: "
                 f"warm-up + capture {prog.capture_s:.2f} s; replay "
                 f"{replay_ms:.3f} ms a call, {share:.4f} of the better "
                 f"block; peak "
                 f"{torch.cuda.max_memory_allocated(device) / gib:.2f} GiB "
                 f"allocated, "
                 f"{torch.cuda.max_memory_reserved(device) / gib:.2f} GiB "
                 f"reserved")
        return max(blocks), blocks
    finally:
        prog.close()
        del batches, prog
        _release(device)


def measure_gpu(graph, params, frames, iters, prob_thresh=0.05,
                precision=None, scan=1, fused_heads=False, select_group=2,
                top_k=None, device=None):
    """img/s of the float step (``precision`` None, "highest" or "bf16")
    over ``frames``' shape (only its shape is used; the inputs are staged
    from ``default_rng(7)``), ``params`` the folded numpy tree, cast on
    ``device`` (default the card). Returns (best, [block 1, block 2])."""
    device = torch.device(device or "cuda")
    net_hw = (frames.shape[1], frames.shape[2])
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    step = make_step(graph, device_params(params, device, dtype), net_hw,
                     prob_thresh=prob_thresh, precision=precision, scan=scan,
                     fused_heads=fused_heads, select_group=select_group,
                     top_k=top_k)
    return _timed_blocks(step, frames.shape, iters, scan, device,
                         f"{graph.name}@{net_hw[0]} {precision}")


def int8_state(graph, params: TorchParams, net_hw, quantize_heads=False,
               quantize_stem=False, act_scheme="symmetric"):
    """The reference bench's quantization state: per-tensor scales
    calibrated at bf16 on ONE batch of 8 frames from ``default_rng(3)``
    (``calibrate_tensors``, or ``calibrate_tensors_affine`` for the
    asymmetric scheme), then ``quantize_weights``; ``params`` float32 on
    the device. Returns (qparams, scales, zeros or None)."""
    device = next(iter(params.values()))["w"].device
    rng = np.random.default_rng(3)
    with torch.inference_mode():
        calib = [preprocess(torch.from_numpy(rng.integers(
            0, 256, (8, *net_hw, 3), dtype=np.uint8)).to(device), net_hw)]
        zeros = None
        if act_scheme == "asymmetric":
            scales, zeros = calibrate_tensors_affine(graph, params, calib,
                                                     precision="bf16")
        else:
            scales = calibrate_tensors(graph, params, calib, precision="bf16")
        qparams = quantize_weights(graph, params, include_heads=quantize_heads,
                                   include_stem=quantize_stem)
    return qparams, scales, zeros


def measure_gpu_int8(graph, params, frames, iters, prob_thresh=0.05,
                     quantize_heads=False, quantize_stem=False, scan=1,
                     fused_heads=False, select_group=2, block_impl="xla",
                     top_k=None, act_scheme="symmetric", device=None):
    """img/s of the int8 step: :func:`int8_state` (throughput only: the
    calibration frames are random), then the int8-carrier walk at bf16
    (``carrier="int8"``), its residual blocks through K6 with
    ``block_impl="pallas"``, the heads quantized with ``quantize_heads``,
    the stem with ``quantize_stem``, zero-points with
    ``act_scheme="asymmetric"``. As :func:`measure_gpu` otherwise."""
    device = torch.device(device or "cuda")
    net_hw = (frames.shape[1], frames.shape[2])
    qparams, scales, zeros = int8_state(
        graph, device_params(params, device), net_hw,
        quantize_heads=quantize_heads, quantize_stem=quantize_stem,
        act_scheme=act_scheme)
    step = make_step(graph, qparams, net_hw, prob_thresh=prob_thresh,
                     precision="bf16", scan=scan, fused_heads=fused_heads,
                     select_group=select_group, top_k=top_k,
                     act_scales=scales, act_zeros=zeros,
                     block_impl=block_impl, operands=Operands(qparams))
    return _timed_blocks(step, frames.shape, iters, scan, device,
                         f"{graph.name}@{net_hw[0]} int8 {block_impl}")


def latency_row(lat_ms, rtt_p50, batch):
    """One latency row from per-sample step times (ms): ``p50_ms`` /
    ``p90_ms`` of the samples; ``chip_ms_est`` the p50 less the null
    program's round trip ``rtt_p50`` (the card's share of a step), or None
    with ``rtt_congested`` when the round trip exceeds the p50, where the
    difference means nothing; ``img_s_sync`` the images a second of one
    synchronous step after another."""
    p50 = float(np.percentile(lat_ms, 50))
    congested = rtt_p50 > p50
    return {
        "p50_ms": round(p50, 2),
        "p90_ms": round(float(np.percentile(lat_ms, 90)), 2),
        "chip_ms_est": None if congested else round(p50 - rtt_p50, 2),
        "rtt_congested": congested,
        "img_s_sync": round(batch / p50 * 1e3, 1),
    }


def measure_latency(graph, params, size, batches=(1, 8, 32), n=20,
                    precision="bf16", prob_thresh=0.05, fused_heads=False,
                    select_group=2, device=None):
    """Synchronous latency: each of ``n`` samples is one step (copy into
    the static input, one replay of the captured step, the fetch of its
    score sum) on its own staged input, at each batch size. The null
    program, a captured one-op graph (the sum of a 3 KB input) called the
    same way (copy, replay, fetch), is the round trip a step pays whatever
    its work; its p50 is returned beside the rows
    (:func:`latency_row`), and the output keeps it under the reference's
    key ``relay_rtt_p50_ms``. NMS keeps the default ``top_k`` of 512."""
    device = torch.device(device or "cuda")
    net_hw = (size, size)
    tiny = torch.zeros((8, 8, 16, 3), dtype=torch.uint8, device=device)
    null = capture_step(lambda x: x.sum(), tiny.shape, device)
    float(call_step(null, tiny))
    rtt = []
    for _ in range(n):
        t0 = time.perf_counter()
        float(call_step(null, tiny))
        rtt.append((time.perf_counter() - t0) * 1e3)
    rtt_p50 = float(np.percentile(rtt, 50))
    null.close()

    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    dev_params = device_params(params, device, dtype)
    rows = {}
    for b in batches:
        step = make_step(graph, dev_params, net_hw, prob_thresh=prob_thresh,
                         precision=precision, fused_heads=fused_heads,
                         select_group=select_group, top_k=512)
        shape = (b, size, size, 3)
        frames = _stage(np.random.default_rng(7), shape, n, device)
        prog = capture_step(step, shape, device)
        try:
            float(call_step(prog, frames[0])[0])
            float(call_step(prog, frames[-1])[0])
            lat = []
            for f in frames:
                t0 = time.perf_counter()
                float(call_step(prog, f)[0])
                lat.append((time.perf_counter() - t0) * 1e3)
        finally:
            prog.close()
            del frames, prog
            _release(device)
        rows[f"b{b}"] = latency_row(lat, rtt_p50, b)
    return rtt_p50, rows


def numpy_reference_nms(det, prob_thresh, iou_thresh):
    """Reference-style host NMS: per-class greedy loops (SURVEY.md §2.7).
    The port's copy of the JAX package tests' oracle."""
    obj = det[:, 4]
    cls_prob = det[:, 5:].max(axis=1)
    cls_idx = det[:, 5:].argmax(axis=1)
    score = obj * cls_prob
    keep_rows = score >= prob_thresh
    boxes = cxywh_to_tlbr(det[:, :4])

    def iou(a, b):
        tl = np.maximum(a[:2], b[:2])
        br = np.minimum(a[2:], b[2:])
        wh = np.maximum(br - tl, 0)
        inter = wh[0] * wh[1]
        ua = max(a[2] - a[0], 0) * max(a[3] - a[1], 0)
        ub = max(b[2] - b[0], 0) * max(b[3] - b[1], 0)
        return inter / max(ua + ub - inter, 1e-9)

    survivors = []
    for c in np.unique(cls_idx[keep_rows]):
        idxs = np.where(keep_rows & (cls_idx == c))[0]
        idxs = idxs[np.argsort(-score[idxs], kind="stable")]
        kept = []
        for i in idxs:
            if all(iou(boxes[i], boxes[j]) <= iou_thresh for j in kept):
                kept.append(i)
        survivors.extend(kept)
    return {(tuple(np.round(boxes[i], 4)), int(cls_idx[i])) for i in survivors}


def measure_torch_cpu(graph, raw, size, batch, iters):
    """Reference-equivalent pipeline on the CPU: ``tools.torch_ref``'s
    module-list forward + :func:`numpy_reference_nms` per image. Returns
    the mean img/s, its run-to-run std, the config and each iteration's
    rate."""
    from .tools.torch_ref import TorchDarknet

    model = TorchDarknet(graph).load_raw(raw)
    x = torch.from_numpy(
        np.random.default_rng(0).uniform(0, 1, (batch, 3, size, size))
        .astype(np.float32))
    per_iter = []
    with torch.no_grad():
        model(x)  # warm-up
        for _ in range(iters):
            t0 = time.perf_counter()
            det = model(x).numpy()
            for i in range(batch):
                numpy_reference_nms(det[i], 0.05, 0.3)
            per_iter.append(batch / (time.perf_counter() - t0))
    return {
        "img_s": float(np.mean(per_iter)),
        "std": float(np.std(per_iter)),
        "batch": batch,
        "iters": iters,
        "per_iter": [round(v, 4) for v in per_iter],
    }


def torch_baseline(graph, raw, size, batch, iters, remeasure=False):
    """The CPU denominator for ``graph@size``: the repository's
    ``BENCH_TORCH_BASELINE.json`` entry, else the port's own cache
    ``PORT_BASELINE_CACHE``; measured and written to that cache when
    neither has it, or with ``remeasure``. The repository's file is never
    written."""
    key = f"{graph.name}@{size}"
    cache = Path(PORT_BASELINE_CACHE)
    own = json.loads(cache.read_text()) if cache.exists() else {}
    if not remeasure:
        for table in (json.loads(BASELINE_CACHE.read_text())
                      if BASELINE_CACHE.exists() else {}, own):
            entry = table.get(key)
            if isinstance(entry, dict):  # a bare number is an older schema
                return entry
    entry = measure_torch_cpu(graph, raw, size, batch, iters)
    own[key] = entry
    cache.parent.mkdir(parents=True, exist_ok=True)
    cache.write_text(json.dumps(own, indent=1))
    return entry


def smi_id(device: torch.device) -> str:
    """``nvidia-smi``'s name for the card ``device`` is: ``GPU-<uuid>``,
    with the UUID CUDA reports for it. nvidia-smi numbers every card of the
    machine whatever ``CUDA_VISIBLE_DEVICES`` hides, so a device's index
    may name another card; its UUID does not."""
    uuid = str(torch.cuda.get_device_properties(device).uuid)
    return uuid if uuid.startswith("GPU-") else f"GPU-{uuid}"


def card_line(device: torch.device) -> str:
    """The name and power limit of the card ``device`` is, found by its
    UUID (:func:`smi_id`), as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them; "cpu" for the CPU."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={smi_id(device)}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(device)}, power limit not read"


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=None,
                    help="single resolution (default: the 608 and 416 rows)")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--cfg", default="yolov3.cfg")
    ap.add_argument("--quick", action="store_true",
                    help="tiny model at 416, batch 8 (smoke check)")
    ap.add_argument("--remeasure-baseline", action="store_true",
                    help="measure the CPU denominator again (written under "
                         "build/, never to BENCH_TORCH_BASELINE.json)")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="trace the headline row with torch.profiler into DIR")
    ap.add_argument("--scan", type=int, default=None,
                    help="pipeline steps per captured graph (the "
                         "Detector(scan=) serving configuration). Default: "
                         "4 at >=608, 8 below; 1 = one step per replay")
    ap.add_argument("--latency", action="store_true",
                    help="measure synchronous per-step latency at b1/b8/b32 "
                         "instead of throughput")
    ap.add_argument("--int8-heads", action="store_true",
                    help="quantize the no-BN head projections too on the "
                         "int8 rows (quant.eligible include_heads)")
    ap.add_argument("--int8-stem", action="store_true",
                    help="quantize the Cin=3 stem conv too on the int8 rows "
                         "(exact-u8 input scheme, include_stem)")
    ap.add_argument("--act-scheme", choices=("symmetric", "asymmetric"),
                    default="symmetric",
                    help="activation quantization scheme of the int8 rows")
    ap.add_argument("--fuse-blocks", action="store_true",
                    help="int8 rows: residual blocks through the fused int8 "
                         "block kernel K6 (block_impl='pallas')")
    ap.add_argument("--no-variants", action="store_true",
                    help="skip the tiny@416 / 320 / spp variant rows")
    ap.add_argument("--fused-heads", action="store_true",
                    help="run the 1x1 head convs inside the decode kernel K4 "
                         "(decode_impl='pallas-fused')")
    ap.add_argument("--select-group", type=int, default=2,
                    help="group-max selection width G of the NMS selection")
    ap.add_argument("--precision", choices=("default", "highest", "bf16",
                                            "int8"),
                    default="bf16",
                    help="serving precision (default = TF32 allowed)")
    ap.add_argument("--probe-timeout", type=float, default=180.0,
                    help="per-attempt timeout of the card's reachability "
                         "probe (a child process); 0 disables")
    ap.add_argument("--probe-retry-budget", type=float, default=1800.0,
                    help="keep re-probing an unreachable card for up to this "
                         "many seconds (bounded by --deadline minus 25 min) "
                         "before the error line; 0 = one attempt")
    ap.add_argument("--deadline", type=float, default=5400.0,
                    help="whole-run wall-clock limit in seconds: a watchdog "
                         "then prints an error line keeping the rows "
                         "measured and exits 3; 0 disables")
    ap.add_argument("--device", default=None,
                    help="cuda (default), cuda:N or cpu")
    return ap


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)

    if args.select_group < 2:
        ap.error(f"--select-group must be >= 2 (got {args.select_group})")

    global _T0
    _T0 = time.perf_counter()

    if args.quick:
        args.cfg, args.size, args.batch, args.iters = ("yolov3-tiny.cfg", 416,
                                                       8, 5)

    on_cpu = (args.device is not None
              and torch.device(args.device).type == "cpu")
    if args.probe_timeout > 0 and not on_cpu:
        ok, detail = _probe_with_retry(args)
        if not ok:
            print(_fail_row(args, f"device unreachable: {detail}"))
            raise SystemExit(2)
    if not on_cpu:
        try:
            args.device = str(resolve_device(args.device))
        except RuntimeError as e:
            print(_fail_row(args, f"device unreachable: {e}"))
            raise SystemExit(2)

    timer = None
    if args.deadline > 0:
        import os
        import threading

        def _expire():
            # stdout may hold a partial line; the last line is the result
            print("\n" + _fail_row(args,
                                   f"bench exceeded {args.deadline:.0f}s "
                                   f"deadline", rows=dict(_PARTIAL)),
                  flush=True)
            os._exit(3)

        timer = threading.Timer(args.deadline, _expire)
        timer.daemon = True
        timer.start()
    # cancelled on every exit: an armed timer would end any process that
    # called main() in process (the tests) later
    try:
        _run(args)
    finally:
        if timer is not None:
            timer.cancel()


def _fail_row(args, error, rows=None):
    """The failure line, keyed as the success headline is (``cfg@size batch
    precision``). ``rows`` (the ``_PARTIAL`` dict) keeps what was measured
    before the failure; if the headline row completed, its rate is the
    value."""
    size = args.size or 608
    out = {
        "metric": f"images/sec/chip {Path(args.cfg).stem}@{size} "
                  f"batch{args.batch} {args.precision} e2e inference",
        "value": 0.0,
        "unit": "img/s",
        "vs_baseline": 0.0,
        "error": error,
    }
    if rows:
        out["rows"] = rows
        first = next((r for r in rows.values() if "img_s" in r), None)
        if first:  # insertion order: the headline row is measured first
            out["value"] = first["img_s"]
            out["vs_baseline"] = first.get("vs_baseline", 0.0)
    return json.dumps(out)


def _bench_raw(graph: Graph):
    """``random_raw(graph, 0)`` with every head's objectness biases at -6,
    so the candidates over the threshold are as few as trained weights give
    (else about half of all anchors pass 0.05), and its folded form."""
    raw = random_raw(graph, seed=0)
    per_anchor = 5 + graph.yolo_nodes[0].classes
    for node in graph.conv_nodes:
        if not node.batch_normalize:
            raw[node.index]["bias"][4::per_anchor] = -6.0
    return raw, fold_raw(raw)


def _run(args):
    device = torch.device(args.device or "cuda")
    graph = load_graph(REPO / "models" / args.cfg)
    raw, params = _bench_raw(graph)
    card = card_line(device)
    _log(f"{card}; torch {torch.__version__}")

    precision = None if args.precision == "default" else args.precision

    if args.latency:
        lat_size = args.size or 608
        lat_prec = args.precision if args.precision in ("bf16",
                                                        "highest") else "bf16"
        # a latency row records the knobs it was asked for
        if args.scan is not None and args.scan > 1:
            print("warning: --scan ignored in --latency mode (each sample "
                  "is ONE synchronous step by definition)", file=sys.stderr)
        lat_fused = False
        if args.fused_heads:
            lat_fused = fused_heads_eligible(graph)
            if not lat_fused:
                print(f"warning: --fused-heads requested but {graph.name} "
                      f"is not eligible; latency rows measure the UNFUSED "
                      f"path", file=sys.stderr)
        rtt_p50, lrows = measure_latency(graph, params, lat_size,
                                         precision=lat_prec,
                                         fused_heads=lat_fused,
                                         select_group=args.select_group,
                                         device=device)
        out = {
            "metric": f"latency p50 {graph.name}@{lat_size} batch1 "
                      f"{lat_prec} e2e inference",
            "value": lrows["b1"]["p50_ms"],
            "unit": "ms",
            # None when the round trip exceeded the p50 (rtt_congested)
            "vs_baseline": lrows["b1"]["chip_ms_est"],
            "relay_rtt_p50_ms": round(rtt_p50, 2),
            "rows": lrows,
        }
        if args.fused_heads:
            out["fused_heads"] = lat_fused
        if args.select_group != 2:
            out["select_group"] = args.select_group
        out["card"] = card
        print(json.dumps(out))
        return

    def scan_for(size):
        # steps per graph: enough to amortize the launch without
        # ballooning the staged inputs
        if args.scan is not None:
            return max(1, args.scan)
        return 4 if size >= 608 else 8

    def measure_at(size, prec, fused=None):
        fused = args.fused_heads if fused is None else fused
        scan = scan_for(size)
        frames = np.random.default_rng(1).integers(
            0, 256, (args.batch, size, size, 3), dtype=np.uint8)
        # iterations scale with the expected step speed, so fast rows
        # amortize the fixed cost of a call as much as the 608 rows do
        iters = args.iters * max(1, round((608 / size) ** 2))
        if scan > 1:
            # each call carries scan batches: fewer calls keep the staged
            # inputs' footprint constant
            iters = max(2, round(iters / scan))
        if prec == "int8":
            blocks_impl = "pallas" if args.fuse_blocks else "xla"
            return measure_gpu_int8(graph, params, frames, iters,
                                    quantize_heads=args.int8_heads,
                                    quantize_stem=args.int8_stem,
                                    scan=scan, fused_heads=fused,
                                    select_group=args.select_group,
                                    block_impl=blocks_impl,
                                    act_scheme=args.act_scheme, device=device)
        return measure_gpu(graph, params, frames, iters, precision=prec,
                           scan=scan, fused_heads=fused,
                           select_group=args.select_group, device=device)

    # BASELINE.json's metric names both 608 and 416: the default run
    # measures both; --size pins one. The headline row is the first size.
    sizes = [args.size] if args.size else [608, 416]
    torch_iters = 1 if args.quick else max(5, args.iters // 2)

    # rows record the knobs that shaped them; --fused-heads runs unfused
    # where the cfg is not eligible, and says so
    fused_active = False
    if args.fused_heads:
        fused_active = fused_heads_eligible(graph)
        if not fused_active:
            print(f"warning: --fused-heads requested but {graph.name} is "
                  f"not eligible (see model.fused_heads_eligible); rows "
                  f"measure the UNFUSED path", file=sys.stderr)

    def knob_fields(row, prec):
        if args.fused_heads:
            row["fused_heads"] = fused_active
        if args.fuse_blocks and prec == "int8":
            # block_impl exists on the int8 walk only
            row["fuse_blocks"] = True
        if args.act_scheme != "symmetric" and prec == "int8":
            row["act_scheme"] = args.act_scheme
        if args.select_group != 2:
            row["select_group"] = args.select_group
        return row

    # rows accumulate in _PARTIAL, which the deadline watchdog prints
    _PARTIAL.clear()
    rows = _PARTIAL
    headline = None
    for size in sizes:
        if args.profile and size == sizes[0]:
            from .__main__ import _profiler

            with _profiler(args.profile):
                ips, blocks = measure_at(size, precision)
        else:
            ips, blocks = measure_at(size, precision)
        base = torch_baseline(graph, raw, size, batch=min(args.batch, 4),
                              iters=torch_iters,
                              remeasure=args.remeasure_baseline)
        row = knob_fields({
            "img_s": round(ips, 2),
            "blocks": [round(b, 2) for b in blocks],
            "scan": scan_for(size),
            "vs_baseline": round(ips / base["img_s"], 2),
            "baseline_img_s": round(base["img_s"], 4),
            "baseline_std": round(base["std"], 4),
        }, args.precision)
        rows[f"{graph.name}@{size} batch{args.batch} {args.precision}"] = row
        if headline is None:
            headline = (size, ips, base["img_s"])

    # the int8 rows (the opt-in fast path)
    if precision == "bf16" and args.size is None and not args.quick:
        for size in sizes:
            ips, blocks = measure_at(size, "int8")
            base = torch_baseline(graph, raw, size, batch=min(args.batch, 4),
                                  iters=torch_iters)
            rows[f"{graph.name}@{size} batch{args.batch} int8"] = knob_fields({
                "img_s": round(ips, 2),
                "blocks": [round(b, 2) for b in blocks],
                "scan": scan_for(size),
                "vs_baseline": round(ips / base["img_s"], 2),
            }, "int8")

    # the fused int8 block row (K6); a failure lands in its own row
    if (precision == "bf16" and args.size is None and not args.quick
            and not args.fuse_blocks):
        # only a graph with residual blocks: elsewhere block_impl="pallas"
        # runs the same walk and the row would claim a fusion that ran
        # nothing
        has_blocks = any(n.kind == "shortcut" for n in graph.nodes)
        elapsed = time.perf_counter() - _T0
        if (has_blocks
                and (args.deadline <= 0 or elapsed < args.deadline * 0.6)):
            key = f"{graph.name}@608 batch{args.batch} int8 fuse-blocks"
            try:  # the whole row, its baseline too: never cost the headline
                base = torch_baseline(graph, raw, 608,
                                      batch=min(args.batch, 4),
                                      iters=torch_iters)
                frames = np.random.default_rng(1).integers(
                    0, 256, (args.batch, 608, 608, 3), dtype=np.uint8)
                iters = max(2, round(args.iters / scan_for(608)))
                ips, blocks = measure_gpu_int8(
                    graph, params, frames, iters,
                    quantize_heads=args.int8_heads,
                    quantize_stem=args.int8_stem, scan=scan_for(608),
                    select_group=args.select_group, block_impl="pallas",
                    device=device)
                rows[key] = {
                    "img_s": round(ips, 2),
                    "blocks": [round(b, 2) for b in blocks],
                    "scan": scan_for(608),
                    "vs_baseline": round(ips / base["img_s"], 2),
                    "fuse_blocks": True,
                }
            except Exception as e:  # never cost the headline
                rows[key] = {"error": f"{type(e).__name__}: {e}"[:300],
                             "fuse_blocks": True}

    # the variant rows: tiny@416, yolov3@320 and spp@608, within the budget
    if (precision == "bf16" and args.size is None and not args.quick
            and args.cfg == "yolov3.cfg" and not args.no_variants):
        variants = [("yolov3-tiny.cfg", 416, ("bf16", "int8")),
                    ("yolov3.cfg", 320, ("bf16",)),
                    ("yolov3-spp.cfg", 608, ("bf16", "int8"))]
        for vcfg, vsize, vprecs in variants:
            elapsed = time.perf_counter() - _T0
            if args.deadline > 0 and elapsed > args.deadline * 0.75:
                rows[f"variants-skipped {vcfg}@{vsize}"] = {
                    "error": "deadline budget exhausted"}
                continue
            try:  # set-up, the CPU baseline too: never cost the headline
                vgraph = load_graph(REPO / "models" / vcfg)
                vraw, vparams = _bench_raw(vgraph)
                vbase = torch_baseline(vgraph, vraw, vsize,
                                       batch=min(args.batch, 4),
                                       iters=torch_iters)
                frames = np.random.default_rng(1).integers(
                    0, 256, (args.batch, vsize, vsize, 3), dtype=np.uint8)
            except Exception as e:
                rows[f"variants-failed {vcfg}@{vsize}"] = {
                    "error": f"{type(e).__name__}: {e}"[:300]}
                continue
            vscan = scan_for(vsize)
            viters = max(2, round(args.iters * max(1, round(
                (608 / vsize) ** 2)) / vscan))
            for vprec in vprecs:
                key = f"{vgraph.name}@{vsize} batch{args.batch} {vprec}"
                try:
                    if vprec == "int8":
                        ips, blocks = measure_gpu_int8(
                            vgraph, vparams, frames, viters, scan=vscan,
                            select_group=args.select_group, device=device)
                    else:
                        ips, blocks = measure_gpu(
                            vgraph, vparams, frames, viters, precision="bf16",
                            scan=vscan, select_group=args.select_group,
                            device=device)
                    rows[key] = {
                        "img_s": round(ips, 2),
                        "blocks": [round(b, 2) for b in blocks],
                        "scan": vscan,
                        "vs_baseline": round(ips / vbase["img_s"], 2),
                    }
                    vk = auto_top_k(vgraph, (vsize, vsize))
                    if vk != 512:  # the serving preset, when not 512
                        rows[key]["top_k"] = vk
                except Exception as e:  # never cost the headline
                    rows[key] = {"error": f"{type(e).__name__}: {e}"[:300]}

    # the head-fused rows (K4), bf16 and int8; a failure lands in its row
    if (precision == "bf16" and args.size is None and not args.quick
            and not args.fused_heads):
        # the budget gates rise block by block (fuse-blocks 0.6, variants
        # 0.75, here 0.8, latency 0.85), and a skip leaves a row saying so
        elapsed = time.perf_counter() - _T0
        in_budget = args.deadline <= 0 or elapsed < args.deadline * 0.8
        if fused_heads_eligible(graph) and not in_budget:
            rows[f"{graph.name}@608 fused-heads skipped"] = {
                "error": "deadline budget exhausted"}
        elif fused_heads_eligible(graph):
            for prec in ("bf16", "int8"):
                key = f"{graph.name}@608 batch{args.batch} {prec} fused-heads"
                try:  # the baseline too: never cost the headline
                    base = torch_baseline(graph, raw, 608,
                                          batch=min(args.batch, 4),
                                          iters=torch_iters)
                    ips, blocks = measure_at(608, prec, fused=True)
                    rows[key] = {
                        "img_s": round(ips, 2),
                        "blocks": [round(b, 2) for b in blocks],
                        "scan": scan_for(608),
                        "vs_baseline": round(ips / base["img_s"], 2),
                        "fused_heads": True,
                    }
                except Exception as e:  # never cost the headline
                    rows[key] = {"error": f"{type(e).__name__}: {e}"[:300],
                                 "fused_heads": True}

    # the latency row: synchronous steps at B=1 and 8, within the budget
    if precision == "bf16" and args.size is None and not args.quick:
        elapsed = time.perf_counter() - _T0
        if args.deadline <= 0 or elapsed < args.deadline * 0.85:
            try:
                rtt_p50, lrows = measure_latency(
                    graph, params, 608, batches=(1, 8), n=12,
                    select_group=args.select_group, device=device)
                rows["latency yolov3@608 bf16"] = {
                    "relay_rtt_p50_ms": round(rtt_p50, 2), **lrows}
            except Exception as e:  # never cost the headline
                rows["latency yolov3@608 bf16"] = {
                    "error": f"{type(e).__name__}: {e}"[:300]}
        else:
            rows["latency yolov3@608 bf16"] = {
                "error": "deadline budget exhausted"}

    size, ips, torch_ips = headline
    print(json.dumps({
        "metric": f"images/sec/chip {graph.name}@{size} batch{args.batch} "
                  f"{args.precision} e2e inference",
        "value": round(ips, 2),
        "unit": "img/s",
        "vs_baseline": round(ips / torch_ips, 2),
        "rows": rows,
        "card": card,
    }))


if __name__ == "__main__":
    main()
