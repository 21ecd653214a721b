#!/usr/bin/env python3
"""On-card check of the PyTorch port's serving path (one CUDA device).

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card and
the CUDA toolkit. Phases, each of which raises on failure:

1. device and build: require CUDA, print the card's name and power limit,
   build the kernels from ``yolov3_tpu_torch/csrc`` with nvcc;
2. K1 (packed decode) against its plain PyTorch version on the card, at the
   yolov3@416 head shapes, batch 8: tie-heavy logits, exp-clamped boxes,
   scores exactly on the threshold;
3. K2 (suppression) against its plain version, K = 512 and 256, batch 8;
4. the golden fixtures (``tests/data/golden_{tiny,yolov3}.json``) replayed
   through the port's Detector at precision="highest";
5. the full-width main path: a 248,007,048-byte yolov3 ``.weights`` file
   through ``Darknet.load_weights``, then ``Detector.detect_batch`` at 416
   on 8 frames of 480x640 for yolov3 and yolov3-tiny, with the kernels'
   launch counts read around it.

The last two lines of standard output are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Exits non-zero, and prints neither, when
CUDA is unavailable or the port is not beside this script.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
DEVICE = "cuda"
BATCH = 8
SRC_HW = (480, 640)
# float lanes of K1 against its plain version: both run the same float
# operations in the same order (no FMA contraction, full-precision expf),
# so they should agree to the bit; the bar allows 4 ulp relative, and an
# absolute 1e-4 px for corners that cancel to near zero
K1_RTOL, K1_ATOL = 4 * 2.0 ** -23, 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` back-to-back calls,
    timed with CUDA events on the current stream."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_build():
    import torch
    from yolov3_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.build_kernels()
    _build.load_kernels()
    log(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s "
        f"(torch {torch.__version__}, CUDA {torch.version.cuda})")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build]   {line.strip()}")


def k1_inputs(graph, seed: int):
    """Head maps at the graph's 416 shapes: class and objectness logits on
    a 1/8 grid (exact ties), some tw/th past the clamp at 60."""
    rng = np.random.default_rng(seed)
    heads = []
    for node, stride in zip(graph.yolo_nodes, graph.head_strides()):
        g = 416 // stride
        a, per = len(node.anchors), 5 + node.classes
        f = rng.normal(0, 2, (BATCH, g, g, a, per)).astype(np.float32)
        f[..., 4:] = np.round(f[..., 4:] * 8) / 8
        big = rng.uniform(0, 1, f[..., 2:4].shape) < 0.01
        f[..., 2:4] = np.where(big, rng.uniform(60, 100, big.shape), f[..., 2:4])
        heads.append(f.reshape(BATCH, g, g, a * per))
    return heads


def decode_plain(feats, anchors, strides, num_classes, prob_thresh):
    import torch
    from yolov3_tpu_torch.ops.cuda_decode import decode_packed_head_reference

    parts, off = [], 0
    for f, a, s in zip(feats, anchors, strides):
        parts.append(decode_packed_head_reference(f, a, s, num_classes,
                                                  prob_thresh, off))
        off += parts[-1].shape[1]
    payload = torch.cat(parts, dim=1)
    return payload, payload[..., 4]


def phase_k1(graph, name: str):
    import torch
    from yolov3_tpu_torch.ops.cuda_decode import decode_packed

    anchors = [n.anchors for n in graph.yolo_nodes]
    strides = list(graph.head_strides())
    ncls = graph.yolo_nodes[0].classes
    feats = [torch.from_numpy(h).to(DEVICE) for h in k1_inputs(graph, seed=1)]
    # a threshold that many scores land on exactly: the most common nonzero
    # score of the plain version (ties come from the 1/8 logit grid)
    _, s0 = decode_plain(feats, anchors, strides, ncls, 0.0)
    vals, counts = torch.unique(s0[s0 > 0.3], return_counts=True)
    thresh = float(vals[counts.argmax()])
    n_on = int((s0 == vals[counts.argmax()]).sum())
    max_err = 0.0
    for prob in (0.0, thresh):
        want, ws = decode_plain(feats, anchors, strides, ncls, prob)
        got, gs = decode_packed(feats, anchors, strides, ncls, prob)
        torch.cuda.synchronize()
        if not torch.equal(got[..., 5:], want[..., 5:]):
            raise AssertionError(f"K1 class/cand lanes differ at prob={prob}")
        if not torch.equal(gs == 0, ws == 0):
            n = int(((gs == 0) != (ws == 0)).sum())
            raise AssertionError(f"K1 threshold zero pattern differs in {n} "
                                 f"records at prob={prob}")
        err = (got[..., :5] - want[..., :5]).abs()
        bound = K1_ATOL + K1_RTOL * want[..., :5].abs()
        if not bool((err <= bound).all()) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"K1 float lanes off: max |err| "
                                 f"{float(err.max())} at prob={prob}")
        max_err = max(max_err, float(err.max()))
    log(f"[K1] {name}@416 B={BATCH}: {tuple(got.shape)} records, class/cand "
        f"exact, {n_on} scores exactly on prob_thresh={thresh!r} kept "
        f"identically, max |err| {max_err!r} (bar {K1_RTOL:.3g} rel + "
        f"{K1_ATOL} px)")
    ms = cuda_ms(lambda: decode_packed(feats, anchors, strides, ncls, 0.3))
    plain_ms = cuda_ms(lambda: decode_plain(feats, anchors, strides, ncls, 0.3))
    log(f"[K1] {name}@416 B={BATCH} all heads: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms")
    return max_err, ms, plain_ms


def k2_inputs(k: int, seed: int):
    """Clustered, heavily overlapping boxes with tied scores, sorted by
    score; few classes so conflicts abound; some invalid slots."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 416, (BATCH, 24, 2))
    pick = rng.integers(0, 24, (BATCH, k))
    c = np.take_along_axis(centers, pick[..., None], axis=1)
    c = c + rng.normal(0, 6, c.shape)
    wh = rng.uniform(20, 90, (BATCH, k, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    boxes = np.round(boxes * 2) / 2  # exact duplicates and shared edges
    scores = np.round(rng.uniform(0, 1, (BATCH, k)) * 16) / 16
    order = np.argsort(-scores, axis=1, kind="stable")
    boxes = np.take_along_axis(boxes, order[..., None], axis=1)
    classes = rng.integers(0, 3, (BATCH, k)).astype(np.int32)
    valid = rng.uniform(0, 1, (BATCH, k)) > 0.1
    return boxes.astype(np.float32), classes, valid


def phase_k2():
    import torch
    from yolov3_tpu_torch.ops.cuda_nms import suppress, suppress_reference

    times, max_err = {}, 0.0
    for k in (512, 256):
        b, c, v = (torch.from_numpy(a).to(DEVICE) for a in k2_inputs(k, seed=k))
        for iou in (0.3, 0.45, 0.7):
            got = suppress(b, c, v, iou)
            want = suppress_reference(b, c, v, iou)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                n = int((got != want).sum())
                raise AssertionError(f"K2 keep mask differs in {n} slots "
                                     f"at K={k} iou={iou}")
            max_err = max(max_err, float((got.int() - want.int()).abs().max()))
        kept = int(got.sum())
        ms = cuda_ms(lambda: suppress(b, c, v, 0.45))
        plain_ms = cuda_ms(lambda: suppress_reference(b, c, v, 0.45), iters=3,
                           warmup=1)
        times[k] = (ms, plain_ms)
        log(f"[K2] K={k} B={BATCH}: keep masks exact at iou 0.3/0.45/0.7 "
            f"({kept} kept at 0.7); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return max_err, times


def phase_golden():
    import torch
    from yolov3_tpu_torch import Darknet, Detector
    from yolov3_tpu_torch.weights import fold_raw, random_raw

    for fixture in ("golden_tiny.json", "golden_yolov3.json"):
        golden = json.loads((REPO / "tests" / "data" / fixture).read_text())
        net = Darknet(REPO / "models" / golden["cfg"], precision="highest",
                      device=DEVICE)
        net.set_params(fold_raw(random_raw(net.graph, seed=golden["seed"],
                                           scale=golden.get("scale", 1.0))))
        size = golden["net_size"]
        det = Detector(net, prob_thresh=golden["prob_thresh"],
                       iou_thresh=golden["iou_thresh"], top_k=golden["top_k"],
                       net_hw=(size, size))
        frames = np.random.default_rng(golden["seed"]).integers(
            0, 256, (1, *SRC_HW, 3), dtype=np.uint8)
        (got,) = det._unpack(det._run(det._stage(frames)), None)  # net px
        if len(got.class_prob) != len(golden["scores"]):
            raise AssertionError(f"{fixture}: {len(got.class_prob)} survivors "
                                 f"vs golden {len(golden['scores'])}")
        np.testing.assert_array_equal(got.class_idx, golden["classes"])
        np.testing.assert_allclose(got.class_prob, golden["scores"], atol=5e-5)
        np.testing.assert_allclose(got.bbox_tlbr, golden["boxes"], atol=0.1)
        err = float(np.abs(got.bbox_tlbr - np.asarray(golden["boxes"])).max())
        log(f"[golden] {fixture}: {len(got.class_prob)} survivors match "
            f"(max box err {err:.2e} px) on {torch.cuda.get_device_name(0)}")


def run_main_path(net, name: str, frames: np.ndarray, card: str,
                  calls: int = 10):
    import torch
    from yolov3_tpu_torch import Detector

    det = Detector(net).warmup(BATCH, SRC_HW)
    host, dev = [], []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = det.detect_batch(frames)
        end.record()
        end.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        dev.append(start.elapsed_time(end))
    for d in out:
        n = len(d.class_prob)
        if not (0 < n <= det.max_results and np.isfinite(d.bbox_tlbr).all()
                and (d.class_prob >= det.prob_thresh).all()
                and (d.class_prob <= 1).all()
                and (d.bbox_tlbr[:, [0, 2]] <= SRC_HW[1]).all()
                and (d.bbox_tlbr[:, [1, 3]] <= SRC_HW[0]).all()
                and (d.bbox_tlbr >= 0).all()):
            raise AssertionError(f"{name}: implausible detections {d}")
    log(f"[main] {name}@416 detect_batch B={BATCH} {SRC_HW[0]}x{SRC_HW[1]} "
        f"uint8, precision={net.precision}: per call median "
        f"{np.median(dev):.3f} ms (CUDA events), {np.median(host):.3f} ms "
        f"(host clock), {calls} calls, on {card}; survivors/image "
        f"{[len(d.class_prob) for d in out]}")


def phase_main(card: str):
    import torch
    from yolov3_tpu_torch import Darknet
    from yolov3_tpu_torch.ops import cuda_decode, cuda_nms
    from yolov3_tpu_torch.weights import fold_raw, random_raw, write_weights

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "yolov3.weights"
        yolo = Darknet(REPO / "models" / "yolov3.cfg", device=DEVICE)
        write_weights(path, yolo.graph, random_raw(yolo.graph, seed=0))
        size = path.stat().st_size
        if size != 248_007_048:
            raise AssertionError(f"yolov3.weights is {size} bytes, "
                                 f"published file is 248007048")
        yolo.load_weights(path)
    tiny = Darknet(REPO / "models" / "yolov3-tiny.cfg", device=DEVICE)
    tiny.set_params(fold_raw(random_raw(tiny.graph, seed=0)))
    frames = np.random.default_rng(0).integers(0, 256, (BATCH, *SRC_HW, 3),
                                               dtype=np.uint8)
    cuda_decode.decode_packed_head.launches = 0
    cuda_nms.suppress.launches = 0
    run_main_path(yolo, "yolov3", frames, card)
    run_main_path(tiny, "yolov3-tiny", frames, card)
    launches = {"decode_packed_head": cuda_decode.decode_packed_head.launches,
                "nms_suppress": cuda_nms.suppress.launches}
    log(f"[main] kernel launches in the main-path run: {launches}")
    for kernel, n in launches.items():
        if n == 0:
            raise AssertionError(f"the main path never launched {kernel}")
    return launches


def main() -> int:
    if not (REPO / "yolov3_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py: yolov3_tpu_torch/ is not beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this check "
              "needs a CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    log(card)
    phase_build()
    from yolov3_tpu_torch.graph import load_graph

    k1_err, k1_ms, k1_plain = phase_k1(
        load_graph(REPO / "models" / "yolov3.cfg"), "yolov3")
    phase_k1(load_graph(REPO / "models" / "yolov3-tiny.cfg"), "yolov3-tiny")
    k2_err, k2 = phase_k2()
    phase_golden()
    launches = phase_main(card)
    kernels = {"kernels": [
        {"name": "decode_packed_head", "route": "cuda",
         "source": "yolov3_tpu_torch/csrc/decode_packed.cu",
         "replaces": "yolov3_tpu/ops/pallas_decode.py:626",
         "launches": launches["decode_packed_head"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "nms_suppress", "route": "cuda",
         "source": "yolov3_tpu_torch/csrc/nms_suppress.cu",
         "replaces": "yolov3_tpu/ops/pallas_nms.py:65",
         "launches": launches["nms_suppress"], "max_abs_err": k2_err,
         "ms": k2[512][0], "plain_ms": k2[512][1]},
    ]}
    log(card)
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
