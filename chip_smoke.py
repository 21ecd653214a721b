#!/usr/bin/env python3
"""On-card check of the PyTorch port's serving routes (one CUDA device).

    python3 chip_smoke.py [--phases k1,k1c,k2,k3,k4,k5,int8conv,k6,golden,main,int8,
                                    probes,dots,native,entry,serve]

Run from the root of a checkout on a machine with an NVIDIA Hopper card and
the CUDA toolkit. With no arguments every phase runs, in this order, and
each raises on failure (the build always runs):

1. build: require CUDA, print the card's name and power limit, build the
   kernels from ``yolov3_tpu_torch/csrc`` with nvcc (one process per
   source, in parallel);
2. K1 (packed decode, one launch for all the heads) against its plain
   version at the yolov3@416 and tiny@416 head shapes, batch 8, on float32
   and on bf16 maps: tie-heavy logits, exp-clamped boxes, scores exactly on
   the threshold; the one launch against one launch per head (equal to the
   bit), dense maps against channel-padded and sliced ones (the strided
   path, equal to the bit), B=1, yolov3@608, 20 and 251 classes, tiny; by
   graph replay and as eager event means, per head, with 2 and 4 lanes a
   record, and its staging and its decode alone (``tools/ablate_phases.py``);
3. K1c (compact decode, the same kernel) against its plain version,
   yolov3@416 B=8, timed as K1;
4. K2 (suppression) against its plain version, keep masks and phase 1's
   scratch (``conflict_bits_reference``) exact, at K = 1, 33, 256, 300, 512
   and 1024 on clustered boxes, with 10% valid, with no conflicts, with
   nothing valid and with NaN and overflowing boxes, batch 8; timed at K =
   256, 512 and 1024 by graph replay and as eager event means, each phase
   alone from ablated builds, with the longest chain of kept candidates and
   the time a kept step;
5. K3 (full decode, one launch for the heads into the concatenated
   output) against the plain decode, exact, on float32 and bf16 maps: the
   three yolov3@416 B=8 heads, channel-padded maps, channel-slice and
   spatial-slice views, each head alone, yolov3@608, B=1; one launch a call;
   by graph replay at both map types, with its math and its stores each
   taken out (``tools/ablate_phases.py``) and the share of the bound;
6. K4 (head-fused decode: the tensor-core kernel at bf16, the CUDA-core
   kernel at float32) at the three yolov3@416 B=8 pre-head shapes, float32
   and bf16 operands (bf16 over four seeds), then off the main path at
   B=1, at 608, on tiny, with 20, 150 and 251 classes, on a channel slice,
   and the inputs it must refuse; per head and over the three, the
   kernel's, its plain version's and cuDNN 1x1 + K1's device time from
   replayed CUDA graphs, and the bf16 kernel's time at each tile choice;
7. K5 (fused 3x3 conv: the tensor-core kernel at bf16, the CUDA-core kernel
   at float32) at every distinct eligible yolov3@416 B=8 layer shape, at
   three ragged shapes, one yolov3@608 layer and an odd Cout, and on
   strided views, float32 and bf16, leaky and linear, a bias in either
   type; per shape the kernel's and cuDNN's device time from replayed CUDA
   graphs;
8. int8conv: the card's im2col + ``torch._int_mm`` int8 conv against the
   CPU's int32 ``F.conv2d``: 1x1, 3x3 at stride 1 and 2, asymmetric
   zero-points, a padded N and a short M, the exact-u8 stem;
9. K6 (fused int8 residual block on ``wgmma`` s8) against its plain
   version, exact, at both yolov3@416 B=8 block shapes, yolov3@608's two,
   both 416 shapes at B=1 and five odd geometries (an H and W no tile
   divides, cmid = C, cmid below 64), int8, bf16 and float32 outputs, at
   both tile heights; K6, its plain version and the block's two bare
   products on ``torch._int_mm`` (a yardstick, not the same function) as
   device time by CUDA graph replay, with TOP/s and the share of the bound;
10. the golden fixtures (``tests/data/golden_{tiny,yolov3}.json``) replayed
    at precision "highest" through the Detector's routes: K1, the plain
    compact decode, K4, and K5 convs;
11. main, the full-width float path: a 248,007,048-byte yolov3 ``.weights``
    file through ``Darknet.load_weights``, then ``Detector.detect_batch``
    at 416 on 8 frames of 480x640: yolov3 precision None (K1), bf16 (K1 on
    bf16 maps), bf16 with the fused head (K4), bf16 with the fused head and
    fused convs (K4, K5), None on the compact route, and yolov3-tiny; the
    three bf16 routes by stage, their walks' and decodes' device time from
    replayed CUDA graphs, K5's launches per call, which of K1's paths the
    heads took and K2 on the selection's real candidates (exact, each phase
    timed); ``forward_compact`` through K1c
    against the plain compact decode; ``Darknet(x)`` through ONE K3 launch;
    and the bf16 parity bar against "highest";
12. int8, the full-width int8 tier: ``quantize_int8`` of yolov3 on 8 seeded
    frames on the card, then ``detect_batch`` through the int8 carrier with
    K6 blocks (K1 and K4 decode), with unfused blocks, the asymmetric
    scheme and the bf16 carrier, each with its stage split; K6's launches
    per forward against ``fused_block_plan``; identical detections for
    fused and unfused blocks; the state file's round trip; the DESIGN int8
    bar against float32 on tiny@416;
13. probes: the ingredient kernels T3a-e (int8 dot on ``wgmma``, on
    ``mma.sync`` and on ``__dp4a``, round / clip, the row shifts, the edge
    mask, the float epilogue) against their plain versions and the tool's
    exact host values, then ``tools.probe_block``'s full blocks and chain
    prefixes: 0 differences everywhere; T3a-e by graph replay beside their
    wrapper times;
14. dots: T1 (int8 ``wgmma``, int8 ``mma.sync``, int8 ``__dp4a``, bf16
    ``wgmma``) and T2 over the tools' shape lists, checked against their
    plain versions, then timed by the tools' own clocks: time per step,
    useful rate, share of the card's peak (above 100% fails), the library's
    product at the same shape; T1's step, its store mode (the bare product,
    exact at int8) and the library products also as device time alone
    (replayed CUDA graphs), shape by shape; T2 (all three products on
    ``wgmma``) by graph replay whole and as its bare products (the
    ``-DT2_SKIP_PROJECT`` build), the library's product by graph replay, the
    tile plan and the useful share of the issued products;
15. native: the C++ host loader built with g++ (required here), its
    letterbox and stretch held to the device preprocess on seeded frames;
16. entry, the entry-point path at full width (yolov3@416, bf16, batch 8,
    frames of four sizes): ``detect_mixed`` against ``detect_preletterboxed``
    (exact) and against per-frame ``detect_batch`` (gated on tiny@416),
    ``scan=4`` against the same sub-batches at ``scan=1`` (exact) and the
    convs whose result depends on the batch size, ``PipelinedDetector(depth=2)``
    against the synchronous calls;
17. serve: ``serve()`` on 127.0.0.1 with the micro-batcher over the same
    model: requests one at a time and 16 from 8 threads (PNG bytes to
    ``/detect`` where cv2 is installed), ``/healthz``, ``/stats``,
    ``/metrics``, then a graceful shutdown that releases the port.

Every kernel's launch count is zeroed just before phases 11, 12 and 17 (in
17 after the server's own warm-up), in 16 just before one ``detect_mixed``
call and before the pipelined batches, in 13 and 14 before the tools' runs,
and read just after. A Detector call launches K2 once and, on the K1 route,
K1 once for all its heads: checked call by call in 11 and 12, and in 16 and
17 against the calls and device batches made. The last two
lines of standard output are the kernels' JSON
record and ``{"ok": true, "device": {...}}`` (printed only when every phase
ran). Exits non-zero, and prints neither, when CUDA is unavailable or the
port is not beside this script.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
DEVICE = "cuda"
BATCH = 8
SRC_HW = (480, 640)
PHASES = ("build", "k1", "k1c", "k2", "k3", "k4", "k5", "int8conv", "k6",
          "golden", "main", "int8", "probes", "dots", "native", "entry",
          "serve")
YOLOV3_WEIGHTS_BYTES = 248_007_048  # the published yolov3.weights file
# float lanes of K1 / K1c against their plain versions: both run the same
# float operations in the same order (no FMA contraction, full-precision
# expf), so they should agree to the bit; the bar allows 4 ulp relative,
# and an absolute 1e-4 px for corners that cancel to near zero
K1_RTOL, K1_ATOL = 4 * 2.0 ** -23, 1e-4
# K4: the head projection sums Cin products in another order than the
# plain matmul (the JAX package's fused-vs-unfused bars); the class lane is
# exact wherever the top two class logits are further apart than K4_MARGIN
K4_SCORE_ATOL, K4_SCORE_RTOL, K4_BOX_ATOL, K4_MARGIN = 1e-5, 1e-4, 5e-3, 1e-4
# K5, float32: the JAX package's conv-kernel tolerance (float32 sums of
# 9·Cin products in different orders). bf16: one bf16 ulp of the plain
# version (rtol 2^-7), plus the float32 bar's atol for values near zero,
# where a float32 summation-order difference moves the one rounding
K5_ATOL, K5_RTOL, K5_BF16_RTOL = 5e-5, 1e-4, 2.0 ** -7
# the DESIGN bf16 parity bar: IoU > 0.99 on >= 90% of the float32
# detections scoring >= 0.45
PARITY_IOU, PARITY_SHARE, PARITY_SCORE = 0.99, 0.9, 0.45
# the card's published peaks (NVIDIA H100 SXM data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12
FP32_FLOPS_PER_S = 67e12
# the DESIGN int8 bar (tests/test_quant.py): pre-NMS, the float32 forward's
# top-200 candidates per image
INT8_BAR_TOP, INT8_BAR_SCORE, INT8_BAR_BOX = 200, 0.01, 0.5
K6_BLOCKS_YOLOV3 = 10  # fused_block_plan on models/yolov3.cfg (the JAX plan's count)


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
    from yolov3_tpu_torch.tools.clock import event_ms

    return event_ms(fn, iters, warmup)


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


def head_spec(graph):
    return ([n.anchors for n in graph.yolo_nodes], list(graph.head_strides()),
            graph.yolo_nodes[0].classes)


def k1_inputs(graph, seed: int, size: int = 416, bsz: int = BATCH,
              ncls=None):
    """Head maps at the graph's shapes for a ``size`` input (with ``ncls``
    classes in place of the graph's when given): class and objectness
    logits on a 1/8 grid (exact ties, exact in bf16 too), some tw/th past
    the clamp at 60."""
    rng = np.random.default_rng(seed)
    heads = []
    for node, stride in zip(graph.yolo_nodes, graph.head_strides()):
        g = size // stride
        a, per = len(node.anchors), 5 + (ncls or node.classes)
        f = rng.normal(0, 2, (bsz, g, g, a, per)).astype(np.float32)
        f[..., 4:] = np.round(f[..., 4:] * 8) / 8
        big = rng.uniform(0, 1, f[..., 2:4].shape) < 0.01
        f[..., 2:4] = np.where(big, rng.uniform(60, 100, big.shape), f[..., 2:4])
        heads.append(f.reshape(bsz, g, g, a * per))
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


def check_records(got, want, what: str) -> float:
    """K1's bars on K1-style records: class / candidate / spare lanes exact,
    the threshold's zero pattern exact, float lanes within 4 ulp + 1e-4 px."""
    import torch

    torch.cuda.synchronize()
    if not torch.equal(got[..., 5:], want[..., 5:]):
        raise AssertionError(f"{what}: class/cand lanes differ")
    if not torch.equal(got[..., 4] == 0, want[..., 4] == 0):
        n = int(((got[..., 4] == 0) != (want[..., 4] == 0)).sum())
        raise AssertionError(f"{what}: threshold zero pattern differs in {n} records")
    err = (got[..., :5] - want[..., :5]).abs()
    bound = K1_ATOL + K1_RTOL * want[..., :5].abs()
    if not bool((err <= bound).all()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: float lanes off, max |err| {float(err.max())}")
    return float(err.max())


def k1_times(feats, anchors, strides, ncls, compact: bool = False):
    """K1 (K1c with ``compact``) over the heads at prob_thresh 0.3: the
    all-heads wrapper by graph replay and as the event mean of eager calls
    (taken first: eager timings after a capture read slower), each head's
    wrapper by graph replay, the plain version both ways, and the bound
    (map bytes read once, records written once, at 3.35 TB/s)."""
    import torch
    from yolov3_tpu_torch.ops import cuda_decode as cd

    if compact:
        def every():
            return cd.decode_compact(feats, anchors, strides, ncls, 0.3)

        def plain():
            return [cd.decode_compact_head_reference(f, a, s, ncls, 0.3)
                    for f, a, s in zip(feats, anchors, strides)]
        out = every()
        one = lambda f, a, s, off: cd.decode_compact_head(  # noqa: E731
            f, a, s, ncls, 0.3, off, out=out)
        rec_bytes = 24
    else:
        def every():
            return cd.decode_packed(feats, anchors, strides, ncls, 0.3)

        def plain():
            return decode_plain(feats, anchors, strides, ncls, 0.3)
        out = every()[0]
        one = lambda f, a, s, off: cd.decode_packed_head(  # noqa: E731
            f, a, s, ncls, 0.3, off, out=out)
        rec_bytes = 32
    t = {"ms_eager": cuda_ms(every), "plain_ms_eager": cuda_ms(plain)}
    t["ms"] = graph_ms(every)
    t["plain_ms"] = graph_ms(plain, iters=5)
    heads, off = [], 0
    for f, a, s in zip(feats, anchors, strides):
        heads.append(graph_ms(lambda f=f, a=a, s=s, off=off: one(f, a, s, off)))
        off += len(a) * f.shape[1] * f.shape[2]
    t["heads_ms"] = heads
    # the one launch with each number of lanes a record (K1_GROUP is the
    # default the wrappers use)
    outs = list(out) if compact else [out]
    offsets = cd.candidate_offsets(feats, anchors)
    t["group_ms"] = {g: graph_ms(lambda g=g: cd.launch_decode(
        feats, anchors, strides, ncls, 0.3, offsets, outs,
        "K1c" if compact else "K1", group=g)) for g in cd.K1_GROUPS}
    t["group"] = cd.K1_GROUP[feats[0].dtype]
    if not compact:  # the staging alone and the decode alone
        from yolov3_tpu_torch.tools.ablate_phases import decode_phase_times

        ph = decode_phase_times(feats, anchors, strides, ncls, 0.3)
        t["copy_ms"], t["decode_ms"] = ph["copy"], ph["decode"]
    nbytes = (sum(f.numel() * f.element_size() for f in feats)
              + rec_bytes * feats[0].shape[0] * off)
    t["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    t["bytes"] = nbytes
    torch.cuda.synchronize()
    return t


def k1_line(t) -> str:
    return (f"one call {t['ms']:.4f} ms by graph replay ({t['ms_eager']:.4f} "
            f"eager), per head " + " / ".join(f"{h:.4f}" for h in t["heads_ms"])
            + " ms, one call with G lanes a record " + ", ".join(
                f"G={g} {v:.4f}" for g, v in t["group_ms"].items())
            + f" ms (G={t['group']} by default)"
            + (f"; ablated builds: staging alone {t['copy_ms']:.4f}, decode "
               f"alone {t['decode_ms']:.4f} ms" if "copy_ms" in t else "")
            + f"; plain {t['plain_ms']:.4f} ms ({t['plain_ms_eager']:.4f} "
            f"eager); bound {t['bound_ms']:.4f} ms ({t['bytes'] / 1e6:.2f} MB "
            f"at 3.35 TB/s), {t['bound_ms'] / t['ms']:.1%} of it reached")


def phase_k1(graph, name: str, dtype_name: str = "float32"):
    import torch
    from yolov3_tpu_torch.ops.cuda_decode import decode_packed

    anchors, strides, ncls = head_spec(graph)
    dtype = getattr(torch, dtype_name)
    feats = [torch.from_numpy(h).to(DEVICE, dtype) for h in k1_inputs(graph, seed=1)]
    # a threshold that many scores land on exactly: the most common nonzero
    # score of the plain version (ties come from the 1/8 logit grid)
    _, s0 = decode_plain(feats, anchors, strides, ncls, 0.0)
    vals, counts = torch.unique(s0[s0 > 0.3], return_counts=True)
    thresh = float(vals[counts.argmax()])
    n_on = int((s0 == vals[counts.argmax()]).sum())
    max_err = 0.0
    for prob in (0.0, thresh):
        want, _ = decode_plain(feats, anchors, strides, ncls, prob)
        got, _ = decode_packed(feats, anchors, strides, ncls, prob)
        max_err = max(max_err, check_records(got, want, f"K1 {dtype_name} prob={prob}"))
    log(f"[K1] {name}@416 B={BATCH} {dtype_name} maps: {tuple(got.shape)} "
        f"records, class/cand exact, {n_on} scores exactly on "
        f"prob_thresh={thresh!r} kept identically, max |err| {max_err!r} "
        f"(bar {K1_RTOL:.3g} rel + {K1_ATOL} px)")
    t = k1_times(feats, anchors, strides, ncls)
    log(f"[K1] {name}@416 B={BATCH} {dtype_name}: " + k1_line(t))
    return max_err, t


def compact_plain(feats, anchors, strides, ncls, prob_thresh):
    """K1c's plain version over the heads, concatenated."""
    import torch
    from yolov3_tpu_torch.ops.cuda_decode import decode_compact_head_reference

    parts = [decode_compact_head_reference(f, a, s, ncls, prob_thresh)
             for f, a, s in zip(feats, anchors, strides)]
    return tuple(torch.cat([p[i] for p in parts], dim=1) for i in range(3))


def compact_record(out):
    """K1c's three outputs as K1-style records (no candidate lane), so that
    ``check_records`` holds them to K1's bars."""
    import torch

    if out[2].dtype != torch.int32:
        raise AssertionError(f"K1c classes are {out[2].dtype}, not int32")
    return torch.cat([out[0], out[1][..., None], out[2].float()[..., None]],
                     dim=-1)


def phase_k1c(graph):
    import torch
    from yolov3_tpu_torch.ops.cuda_decode import decode_compact

    anchors, strides, ncls = head_spec(graph)
    feats = [torch.from_numpy(h).to(DEVICE) for h in k1_inputs(graph, seed=2)]
    max_err = 0.0
    for prob in (0.0, 0.3):
        got = decode_compact(feats, anchors, strides, ncls, prob)
        want = compact_plain(feats, anchors, strides, ncls, prob)
        max_err = max(max_err, check_records(
            compact_record(got), compact_record(want), f"K1c prob={prob}"))
    t = k1_times(feats, anchors, strides, ncls, compact=True)
    log(f"[K1c] yolov3@416 B={BATCH}: boxes {tuple(got[0].shape)}, scores, "
        f"int32 classes exact, max |err| {max_err!r}; " + k1_line(t))
    return max_err, t


def k1_strided(f):
    """Two strided views holding the values of ``f``: channel-padded (the
    pixel stride 8 channels wider than the channels decoded) and a spatial
    slice of a wider map."""
    import torch

    b, gy, gx, c = f.shape
    padded = torch.zeros((b, gy, gx, c + 8), dtype=f.dtype, device=f.device)
    padded[..., :c] = f
    wide = torch.zeros((b, gy, gx + 3, c), dtype=f.dtype, device=f.device)
    wide[:, :, 1:gx + 1] = f
    return {"channel-padded": padded[..., :c], "sliced": wide[:, :, 1:gx + 1]}


def phase_k1_cases(graph, tiny):
    """K1 and K1c off the timed shapes: the one launch against a launch per
    head (equal to the bit), dense against strided maps (channel-padded and
    sliced views decode to the same bits by the strided path), at float32
    and bf16; then B=1, yolov3@608 (a 76x76 head), 20 and 251 classes and
    tiny, against the plain versions within K1's bars."""
    import torch
    from yolov3_tpu_torch.ops import cuda_decode as cd

    anchors, strides, ncls = head_spec(graph)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        feats = [torch.from_numpy(h).to(DEVICE, dtype)
                 for h in k1_inputs(graph, seed=4)]
        offsets = cd.candidate_offsets(feats, anchors)
        one, _ = cd.decode_packed(feats, anchors, strides, ncls, 0.3)
        per = torch.empty_like(one)
        c_one = cd.decode_compact(feats, anchors, strides, ncls, 0.3)
        c_per = tuple(torch.empty_like(t) for t in c_one)
        for f, a, st, off in zip(feats, anchors, strides, offsets):
            cd.decode_packed_head(f, a, st, ncls, 0.3, off, out=per)
            cd.decode_compact_head(f, a, st, ncls, 0.3, off, out=c_per)
        torch.cuda.synchronize()
        if not (torch.equal(one, per)
                and all(torch.equal(x, y) for x, y in zip(c_one, c_per))):
            raise AssertionError(f"K1 / K1c {name}: the one launch differs "
                                 f"from the launches per head")
        plans = cd.plan_decode(feats, anchors, ncls, offsets)
        if len(plans) != 1 or not all(r.dense for r in plans[0].rows):
            raise AssertionError(f"K1 {name}: contiguous yolov3 heads are not "
                                 f"one launch on the dense path: {plans}")
        for kind in ("channel-padded", "sliced"):
            views = [k1_strided(f)[kind] for f in feats]
            if any(r.dense for p in cd.plan_decode(views, anchors, ncls, offsets)
                   for r in p.rows):
                raise AssertionError(f"K1: a {kind} map took the dense path")
            got, _ = cd.decode_packed(views, anchors, strides, ncls, 0.3)
            gotc = cd.decode_compact(views, anchors, strides, ncls, 0.3)
            torch.cuda.synchronize()
            if not (torch.equal(got, one)
                    and all(torch.equal(x, y) for x, y in zip(gotc, c_one))):
                raise AssertionError(f"K1 / K1c {name}: the {kind} map "
                                     f"(strided path) differs from the dense")
        want, _ = decode_plain(feats, anchors, strides, ncls, 0.3)
        worst = max(worst, check_records(one, want, f"K1 {name}"))
    log(f"[K1] yolov3@416 B={BATCH}, float32 and bf16: one launch == three "
        "launches of one head each, bit for bit (K1 and K1c); contiguous "
        "heads dense, channel-padded and sliced views strided, equal to the "
        "dense path bit for bit")
    cases = (("yolov3@416 B=1", graph, 416, 1, None),
             ("yolov3@608 B=8 (76x76 head)", graph, 608, BATCH, None),
             ("yolov3@416 B=8 20 classes", graph, 416, BATCH, 20),
             ("yolov3@416 B=2 251 classes", graph, 416, 2, 251),
             ("yolov3-tiny@416 B=1", tiny, 416, 1, None))
    for what, g, size, bsz, nc in cases:
        a_, s_, c_ = head_spec(g)
        nc = nc or c_
        for dtype in (torch.float32, torch.bfloat16):
            feats = [torch.from_numpy(h).to(DEVICE, dtype)
                     for h in k1_inputs(g, seed=5, size=size, bsz=bsz, ncls=nc)]
            got, _ = cd.decode_packed(feats, a_, s_, nc, 0.3)
            want, _ = decode_plain(feats, a_, s_, nc, 0.3)
            worst = max(worst, check_records(got, want, f"K1 {what} {dtype}"))
            got = cd.decode_compact(feats, a_, s_, nc, 0.3)
            want = compact_plain(feats, a_, s_, nc, 0.3)
            worst = max(worst, check_records(
                compact_record(got), compact_record(want), f"K1c {what} {dtype}"))
        plans = cd.plan_decode(feats, a_, nc, cd.candidate_offsets(feats, a_))
        log(f"[K1] {what}, float32 and bf16: K1 and K1c within the bars, "
            f"{len(plans)} launch(es)")
    return worst


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


def k2_check(b, c, v, iou: float, what: str):
    """K2's keep mask against its plain version, exactly, and phase 1's
    scratch against ``conflict_bits_reference`` bit for bit on every word
    the kernel writes; returns the keep mask."""
    import torch
    from yolov3_tpu_torch.ops.cuda_nms import (conflict_bits_reference,
                                               suppress_bits,
                                               suppress_reference,
                                               written_words)

    got, bits = suppress_bits(b, c, v, iou)
    want = suppress_reference(b, c, v, iou)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        n = int((got != want).sum())
        raise AssertionError(f"K2 keep mask differs in {n} slots: {what} "
                             f"iou={iou}")
    mask = written_words(b.shape[1], b.device)
    want_bits = conflict_bits_reference(b, c, iou)
    if not torch.equal(bits[:, mask], want_bits[:, mask]):
        n = int((bits[:, mask] != want_bits[:, mask]).sum())
        raise AssertionError(f"K2 phase 1: {n} words of the scratch differ "
                             f"from conflict_bits_reference: {what} iou={iou}")
    return got


def k2_special(k: int, kind: str, seed: int):
    """Other K2 inputs, numpy (boxes, classes, valid): "sparse" (clustered,
    10% valid), "disjoint" (a grid of boxes that never overlap, all valid:
    every candidate is kept, the longest chain), "empty" (nothing valid),
    "nonfinite" (clustered, with NaN corners and exp-clamped boxes whose
    areas overflow to inf)."""
    boxes, classes, valid = k2_inputs(k, seed)
    rng = np.random.default_rng(seed)
    if kind == "sparse":
        valid = rng.uniform(0, 1, valid.shape) < 0.1
    elif kind == "disjoint":
        i = np.arange(k)
        x, y = (i % 32) * 13.0, (i // 32) * 13.0
        boxes[:] = np.stack([x, y, x + 10, y + 10], -1)[None]
        classes[:] = 0
        valid[:] = True
    elif kind == "empty":
        valid[:] = False
    elif kind == "nonfinite":
        pick = rng.uniform(0, 1, valid.shape)
        boxes[pick < 0.05, rng.integers(0, 4)] = np.nan
        big = (pick > 0.9)[..., None]
        # exp(60) * anchor-sized half extents around the centres
        c = (boxes[..., :2] + boxes[..., 2:]) / 2
        huge = np.concatenate([c - 3e28, c + 3e28], -1).astype(np.float32)
        boxes = np.where(big, huge, boxes).astype(np.float32)
    return boxes, classes, valid


def phase_k2():
    """K2 exact against its plain version (and phase 1's scratch against
    ``conflict_bits_reference``) at K = 1 to 1024 on clustered boxes, a
    sparse-valid, a no-conflict, an all-invalid and a non-finite case;
    timed at K = 256, 512 and 1024, B=8, by graph replay and as eager event
    means, with each phase alone from the ablated builds
    (``tools/ablate_phases.py``) and the longest chain of kept candidates (the
    walk's sequential steps). The no-conflict case at K = 1024 (every
    candidate kept) against the all-invalid one (none) gives the time a
    kept step."""
    import torch
    from yolov3_tpu_torch.ops.cuda_nms import (bits_blocks, suppress,
                                               suppress_reference)
    from yolov3_tpu_torch.tools.ablate_phases import nms_phase_times

    def to_dev(arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)
                     for a in arrays)

    for k in (1, 33, 300):
        b, c, v = to_dev(k2_inputs(k, seed=k))
        for iou in (0.3, 0.45, 0.7):
            k2_check(b, c, v, iou, f"K={k}")
    for k, kind in ((512, "sparse"), (1024, "disjoint"), (1024, "empty"),
                    (300, "nonfinite"), (512, "nonfinite")):
        b, c, v = to_dev(k2_special(k, kind, seed=k))
        for iou in (0.3, 0.45):
            got = k2_check(b, c, v, iou, f"K={k} {kind}")
        if kind == "disjoint" and not bool(got.all()):
            raise AssertionError("K2: disjoint boxes were suppressed")
    log(f"[K2] keep masks exact and phase 1's scratch bit for bit at K = 1, "
        f"33, 300 (clustered), K=512 10% valid, K=1024 no conflicts (all "
        f"kept) and nothing valid, K = 300 and 512 with NaN and overflowing "
        f"boxes; phase 1 on {bits_blocks(BATCH, 512)} blocks at B={BATCH} "
        f"K=512, {bits_blocks(BATCH, 1024)} at K=1024")

    times = {}
    for k, kind in ((256, None), (512, None), (1024, None), (1024, "disjoint"),
                    (1024, "empty")):
        arrays = k2_inputs(k, seed=k) if kind is None else k2_special(k, kind, k)
        b, c, v = to_dev(arrays)
        if kind is None:
            for iou in (0.3, 0.7):
                got = k2_check(b, c, v, iou, f"K={k}")
            kept_07 = int(got.sum())
        got = k2_check(b, c, v, 0.45, f"K={k} {kind or ''}")
        t = {"ms_eager": cuda_ms(lambda: suppress(b, c, v, 0.45)),
             "plain_ms_eager": cuda_ms(lambda: suppress_reference(b, c, v, 0.45),
                                       iters=3, warmup=1)}
        t["ms"] = graph_ms(lambda: suppress(b, c, v, 0.45))
        t["plain_ms"] = graph_ms(lambda: suppress_reference(b, c, v, 0.45),
                                 iters=1, warmup=1)
        ph = nms_phase_times(b, c, v, 0.45)
        t.update(phase1_ms=ph["phase1"], phase2_ms=ph["phase2"],
                 whole_ms=ph["whole"],
                 chain_max=int(got.sum(1).max()),
                 phase1_blocks=bits_blocks(BATCH, k))
        # every pair's IoU once (about 20 float32 operations)
        t["bound_ms"] = max(BATCH * k * 22 / HBM_BYTES_PER_S,
                            BATCH * k * (k - 1) / 2 * 20 / FP32_FLOPS_PER_S) * 1e3
        times[k if kind is None else f"{k} {kind}"] = t
        log(f"[K2] K={k} B={BATCH} {kind or 'clustered'}: keep masks exact"
            + (f" at iou 0.3/0.45/0.7 ({kept_07} kept at 0.7)" if kind is None
               else " at iou 0.45")
            + f"; at 0.45 the longest chain of kept candidates "
            f"{t['chain_max']}; {t['ms']:.4f} ms by graph replay "
            f"({t['ms_eager']:.4f} eager); phase 1 alone {t['phase1_ms']:.4f} "
            f"({t['phase1_blocks']} blocks), phase 2 alone "
            f"{t['phase2_ms']:.4f} ms (ablated builds, graph replay; whole "
            f"{t['whole_ms']:.4f}); plain {t['plain_ms']:.4f} ms "
            f"({t['plain_ms_eager']:.4f} eager); bound {t['bound_ms']:.4f} ms")
    step = (times["1024 disjoint"]["phase2_ms"]
            - times["1024 empty"]["phase2_ms"]) / 1024
    log(f"[K2] the walk's time a kept step: {step * 1e6:.1f} ns (phase 2 "
        f"alone at K=1024: 1,024 kept a image against none)")
    for t in times.values():
        t["step_ns"] = step * 1e6
    return 0.0, times


def k4_heads(graph, size: int, bsz: int, rng, ncls=None, dtype=None):
    """Seeded K4 operands at ``graph``'s pre-head shapes for a ``size``
    input: per head (x (B, g, g, Cin), w (Cout, Cin), bias float32), with
    ``ncls`` classes in place of the graph's when given."""
    import torch

    heads = []
    for yn, s in zip(graph.yolo_nodes, graph.head_strides()):
        hc = graph.nodes[yn.inputs[0]]
        cin = graph.nodes[hc.inputs[0]].out_channels
        cout = hc.filters if ncls is None else len(yn.anchors) * (5 + ncls)
        g = size // s
        x = rng.normal(0, 1, (bsz, g, g, cin)).astype(np.float32)
        w = rng.normal(0, 1 / np.sqrt(cin), (cout, cin)).astype(np.float32)
        b = rng.normal(0, 0.5, cout).astype(np.float32)
        heads.append(tuple(torch.from_numpy(v).to(DEVICE) for v in (x, w, b)))
    if dtype is not None:
        heads = [(x.to(dtype), w.to(dtype), b) for x, w, b in heads]
    return heads


def k4_check(heads, anchors, strides, ncls, what: str):
    """K4 on ``heads`` [(x, w, bias)] against its plain version, within
    K4's bars: scores, boxes where both keep the candidate, the candidate
    lane exactly, the class lane exactly outside the K4_MARGIN logit margin.
    Returns (max |err|, cell-anchors inside the margin)."""
    import torch
    from yolov3_tpu_torch.ops.cuda_decode import (
        decode_packed_fused, decode_packed_fused_head_reference)
    from yolov3_tpu_torch.precision import tf32

    xs, ws, bs = zip(*heads)
    got, _ = decode_packed_fused(xs, ws, bs, anchors, strides, ncls, 0.2)
    off, wants, nears = 0, [], []
    for (x, w, b), a, s in zip(heads, anchors, strides):
        wants.append(decode_packed_fused_head_reference(x, w, b, a, s, ncls,
                                                        0.2, off))
        off += wants[-1].shape[1]
        with tf32(False):  # the plain head map, for the class margins
            h = x.reshape(-1, x.shape[3]).float() @ w.float().T + b
        cls = h.reshape(-1, len(a), 5 + ncls)[..., 5:]
        top2 = cls.topk(2, dim=-1).values
        near = (top2[..., 0] - top2[..., 1]) <= K4_MARGIN   # (cells, a)
        nears.append(near.reshape(x.shape[0], -1, len(a)).permute(0, 2, 1)
                     .reshape(x.shape[0], -1))
    want, near = torch.cat(wants, dim=1), torch.cat(nears, dim=1)
    torch.cuda.synchronize()
    se, sw = got[..., 4], want[..., 4]
    if got.shape != want.shape or not bool(torch.isfinite(got).all()) or not bool(
            ((se - sw).abs() <= K4_SCORE_ATOL + K4_SCORE_RTOL * sw.abs()).all()):
        raise AssertionError(f"{what}: scores off, max |err| "
                             f"{float((se - sw).abs().max())}")
    both = (se > 0) & (sw > 0)
    box_err = (got[..., :4] - want[..., :4]).abs()[both]
    if not bool((box_err <= K4_BOX_ATOL + K4_SCORE_RTOL
                 * want[..., :4].abs()[both]).all()):
        raise AssertionError(f"{what}: boxes off, max |err| {float(box_err.max())}")
    if not torch.equal(got[..., 6], want[..., 6]):
        raise AssertionError(f"{what}: candidate lane differs")
    bad_cls = (got[..., 5] != want[..., 5]) & ~near
    if bool(bad_cls.any()):
        raise AssertionError(f"{what}: class lane differs in "
                             f"{int(bad_cls.sum())} records outside the margin")
    err = max(float((se - sw).abs().max()),
              float(box_err.max()) if box_err.numel() else 0.0)
    return err, int(near.sum())


def k4_bound(x, cout: int, n_anchors: int):
    """(operations, bytes, bound ms, bound by) of K4 on one head: x and w
    read once, the records written once; operations at the peak of x's
    type."""
    import torch

    bsz, g, _, cin = x.shape
    es = x.element_size()
    flop = 2 * bsz * g * g * cin * cout
    nbytes = es * (bsz * g * g * cin + cin * cout) + 32 * bsz * n_anchors * g * g
    peak = BF16_FLOPS_PER_S if x.dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, flop / peak * 1e3
    return flop, nbytes, max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def phase_k4(graph):
    """K4 at yolov3@416 B=8's three pre-head shapes, float32 and bf16
    operands, bf16 over four seeds; off the main path yolov3@416 B=1,
    yolov3@608, yolov3-tiny, 20-, 150- and 251-class heads, a strided view
    and the refusals; both tile heights. Times (graph replay): K4, its plain
    version, cuDNN 1x1 head conv + K1, per head and over the three."""
    import torch
    import torch.nn.functional as F
    from yolov3_tpu_torch.graph import load_graph
    from yolov3_tpu_torch.ops import cuda_decode
    from yolov3_tpu_torch.ops._build import sm_count
    from yolov3_tpu_torch.ops.cuda_decode import (
        decode_packed_fused, decode_packed_fused_head,
        decode_packed_fused_head_reference, decode_packed_head)
    from yolov3_tpu_torch.precision import tf32

    anchors, strides, ncls = head_spec(graph)
    times, max_err = {}, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        for seed in ((4, 5, 6, 7) if dtype == torch.bfloat16 else (4,)):
            heads = k4_heads(graph, 416, BATCH, np.random.default_rng(seed),
                             dtype=dtype)
            err, margins_in = k4_check(heads, anchors, strides, ncls,
                                       f"K4 {name} seed {seed}")
            max_err = max(max_err, err)
            log(f"[K4] yolov3@416 B={BATCH} {name} operands, seed {seed}, "
                f"pre-head (g, Cin) {[(x.shape[1], x.shape[3]) for x, _, _ in heads]}: "
                f"scores/boxes within bars, cand exact, class exact outside "
                f"the {K4_MARGIN} logit margin ({margins_in} cell-anchors "
                f"inside it), max |err| {err!r}")
        xs, ws, bs = zip(*heads)
        eager_ms = cuda_ms(lambda: decode_packed_fused(xs, ws, bs, anchors,
                                                       strides, ncls, 0.2))
        tot = [0.0, 0.0, 0.0]
        n_total = sum(len(a) * x.shape[1] * x.shape[2] for x, a in zip(xs, anchors))
        out = torch.empty((BATCH, n_total, 8), device=DEVICE)
        off = 0
        for (x, w, b), a, s in zip(heads, anchors, strides):
            cw = w.reshape(*w.shape, 1, 1).contiguous(
                memory_format=torch.channels_last)
            bb = b.to(dtype)

            def unfused(x=x, cw=cw, bb=bb, a=a, s=s, off=off):
                # cuDNN 1x1 head conv in the working type (TF32 allowed),
                # then K1: what the "pallas" route runs
                head = F.conv2d(x.permute(0, 3, 1, 2), cw, bb).permute(0, 2, 3, 1)
                decode_packed_head(head, a, s, ncls, 0.2, off, out=out)

            ms = graph_ms(lambda: decode_packed_fused_head(
                x, w, b, a, s, ncls, 0.2, off, out=out))
            plain_ms = graph_ms(lambda: decode_packed_fused_head_reference(
                x, w, b, a, s, ncls, 0.2, off), iters=5, warmup=1)
            with tf32(True):
                lib_ms = graph_ms(unfused)
            for i, t in enumerate((ms, plain_ms, lib_ms)):
                tot[i] += t
            flop, nbytes, bound_ms, by = k4_bound(x, w.shape[0], len(a))
            log(f"[K4] {name} head {x.shape[1]}x{x.shape[2]} Cin {x.shape[3]} "
                f"B={BATCH}: kernel {ms * 1e3:.2f} us ({flop / ms / 1e9:.1f} "
                f"TFLOP/s, bound {bound_ms * 1e3:.2f} us by {by} = "
                f"{bound_ms / ms:.1%} of it), plain {plain_ms * 1e3:.1f} us, "
                f"cuDNN 1x1 + K1 {lib_ms * 1e3:.2f} us (graph replays, L2-hot)")
            off += len(a) * x.shape[1] * x.shape[2]
        flop = sum(k4_bound(x, w.shape[0], len(a))[0]
                   for (x, w, _), a in zip(heads, anchors))
        times[dtype] = (*tot, eager_ms)
        log(f"[K4] yolov3@416 B={BATCH} {name} all three heads: kernel "
            f"{tot[0]:.4f} ms ({flop / tot[0] / 1e9:.1f} TFLOP/s), plain "
            f"{tot[1]:.4f} ms, cuDNN 1x1 + K1 {tot[2]:.4f} ms (graph "
            f"replays); eager wrapper calls (CUDA events) {eager_ms:.4f} ms")
    # off the main path, bf16 (float32 where the float32 kernel runs a new
    # shape): other batches, sizes, graphs and class counts
    rng = np.random.default_rng(8)
    tiny = load_graph(REPO / "models" / "yolov3-tiny.cfg")
    cases = [("yolov3@416 B=1", graph, 416, 1, None, (torch.bfloat16,)),
             ("yolov3@608 B=8", graph, 608, BATCH, None,
              (torch.bfloat16, torch.float32)),
             ("yolov3-tiny@416 B=8", tiny, 416, BATCH, None, (torch.bfloat16,)),
             ("yolov3@416 B=2, 20 classes", graph, 416, 2, 20, (torch.bfloat16,)),
             ("yolov3@128 B=2, 150 classes", graph, 128, 2, 150, (torch.bfloat16,)),
             ("yolov3@128 B=1, 251 classes", graph, 128, 1, 251, (torch.bfloat16,))]
    for what, gr, size, bsz, nc, dtypes in cases:
        a_, s_, c_ = head_spec(gr)
        for dtype in dtypes:
            heads = k4_heads(gr, size, bsz, rng, nc, dtype)
            err, _ = k4_check(heads, a_, s_, nc or c_, f"K4 {what}")
            max_err = max(max_err, err)
            log(f"[K4] {what} {str(dtype)[6:]}, (g, Cin, Cout) "
                f"{[(x.shape[1], x.shape[3], w.shape[0]) for x, w, _ in heads]}"
                f": within bars, max |err| {err!r}")
    # a channel slice of a wider map (strides of 512, base 256 bytes in):
    # read in place; a base 8 bytes in, or a pixel stride of 260, refused
    x, w, b = k4_heads(graph, 416, 2, rng, dtype=torch.bfloat16)[1]
    wide = torch.cat([x, x], dim=3)
    view = wide[..., 128:640]
    err, _ = k4_check([(view, w, b)], anchors[1:2], strides[1:2], ncls,
                      "K4 channel slice")
    max_err = max(max_err, err)
    refused = 0
    for bad in (wide[..., 4:516], torch.cat([x, x[..., :4]], dim=3)[..., :512]):
        try:
            decode_packed_fused_head(bad, w, b, anchors[1], strides[1], ncls)
        except ValueError:
            refused += 1
    try:
        decode_packed_fused_head(x, torch.zeros(3 * 257, 512, device=DEVICE,
                                                dtype=torch.bfloat16),
                                 torch.zeros(3 * 257, device=DEVICE),
                                 anchors[1], strides[1], 252)
    except ValueError:
        refused += 1
    torch.cuda.synchronize()
    if refused != 3:
        raise AssertionError(f"K4 took {3 - refused} of three inputs it must "
                             f"refuse")
    log(f"[K4] a channel slice (pixel stride 512, base 256 bytes in) within "
        f"bars, max |err| {err!r}; refused a base 8 bytes in, a pixel stride "
        f"of 260 and 5 + C = 257, with no launch")
    # the tile plan on the card: both heights, and one or two resident
    # blocks where a head's K allows two, at each main-path head and at the
    # 13x13 head at one image, held to the bars and timed
    plan = cuda_decode.plan_fused_tiles
    for bsz, gi in ((BATCH, 0), (BATCH, 1), (BATCH, 2), (1, 0)):
        x, w, b = k4_heads(graph, 416, bsz, rng, dtype=torch.bfloat16)[gi]
        per, a, s, cin = 5 + ncls, anchors[gi], strides[gi], x.shape[3]
        m = bsz * x.shape[1] * x.shape[2]
        chosen = plan(m, per, len(a), cin, sm_count(x.get_device()))
        tile_us = {}
        for block_m in (64, 128):
            for resident in (1, 2):
                if resident == 2 and (cin > 256 or block_m + chosen.n_tile > 224):
                    continue
                cuda_decode.plan_fused_tiles = (
                    lambda *args, t=chosen._replace(block_m=block_m,
                                                    resident=resident): t)
                try:
                    k4_check([(x, w, b)], [a], [s], ncls,
                             f"K4 B={bsz} {x.shape[1]}x{x.shape[2]} "
                             f"{block_m}-row tiles, {resident} resident")
                    tile_us[block_m, resident] = 1e3 * graph_ms(
                        lambda: decode_packed_fused_head(x, w, b, a, s, ncls, 0.2))
                finally:
                    cuda_decode.plan_fused_tiles = plan
        log(f"[K4] B={bsz} {x.shape[1]}x{x.shape[2]} Cin {cin} bfloat16 by "
            f"(tile rows, resident blocks): " + ", ".join(
                f"{k} {v:.2f} us" for k, v in tile_us.items())
            + f"; plan_fused_tiles takes {tuple(chosen)}")
    return max_err, times


def k5_shapes(graph):
    """Distinct (H, W, Cin, Cout) of the eligible 3x3/s1 convs at 416, with
    their layer counts."""
    from yolov3_tpu_torch.ops.cuda_conv import supported

    shapes = Counter()
    for n in graph.conv_nodes:
        cin = (graph.nodes[n.inputs[0]].out_channels if n.inputs[0] >= 0
               else graph.in_channels)
        if n.pad and supported(n.size, n.stride, cin, n.activation):
            hw = 416 // n.downsample
            shapes[(hw, hw, cin, n.filters)] += 1
    return shapes


# K5 off the main path (B, H, W, Cin, Cout): the JAX package's conv test
# shapes (a W that is not a multiple of 8, an odd grid, Cout below a tile's
# 128 channels), one yolov3@608 layer, and a Cout that is no multiple of 8
# (output rows off the 16-byte grid: the kernel's element-wise stores)
K5_EXTRA_SHAPES = ((2, 8, 10, 128, 256), (1, 19, 19, 256, 128),
                   (1, 38, 38, 128, 64), (8, 76, 76, 128, 256),
                   (1, 13, 13, 128, 255))


def graph_ms(fn, iters: int = 20, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn``: ``iters`` calls captured into one
    CUDA graph and replayed, so the host's time per call (about 25 us for a
    ctypes wrapper) does not count."""
    from yolov3_tpu_torch.tools.clock import graph_ms as replay_ms

    return replay_ms(fn, iters, warmup)


def k5_check(x, wt, b, what: str) -> float:
    """K5 against its plain version on one input, both activations, within
    the bars of x's type; returns max |err|."""
    import torch
    from yolov3_tpu_torch.ops.cuda_conv import (conv3x3_fused,
                                                conv3x3_fused_reference)

    rtol = K5_RTOL if x.dtype == torch.float32 else K5_BF16_RTOL
    worst = 0.0
    for act in ("leaky", "linear"):
        got = conv3x3_fused(x, wt, b, act)
        want = conv3x3_fused_reference(x, wt, b, act)
        torch.cuda.synchronize()
        g, wv = got.float(), want.float()
        err = (g - wv).abs()
        if not (got.shape == want.shape and got.dtype == x.dtype
                and got.is_contiguous() and bool(torch.isfinite(g).all())
                and bool((err <= K5_ATOL + rtol * wv.abs()).all())):
            raise AssertionError(f"K5 {what} {act}: max |err| "
                                 f"{float(err.max())}")
        worst = max(worst, float(err.max()))
    return worst


def phase_k5(graph):
    import torch
    import torch.nn.functional as F
    from yolov3_tpu_torch.ops import cuda_conv
    from yolov3_tpu_torch.ops._build import sm_count
    from yolov3_tpu_torch.ops.cuda_conv import (conv3x3_fused,
                                                conv3x3_fused_reference,
                                                plan_tiles)

    shapes = k5_shapes(graph)
    rng = np.random.default_rng(5)

    def operands(bsz, h, w, cin, cout):
        x32 = torch.from_numpy(rng.normal(0, 1, (bsz, h, w, cin))
                               .astype(np.float32)).to(DEVICE)
        w32 = torch.from_numpy(rng.normal(0, 0.1, (cout, cin, 3, 3)).astype(
            np.float32)).to(DEVICE).contiguous(memory_format=torch.channels_last)
        b32 = torch.from_numpy(rng.normal(0, 0.1, cout).astype(np.float32)
                               ).to(DEVICE)
        return x32, w32, b32

    max_err, totals = 0.0, {}
    cases = [((BATCH, *shape), count) for shape, count in sorted(shapes.items())]
    cases += [(shape, 0) for shape in K5_EXTRA_SHAPES]
    for (bsz, h, w, cin, cout), count in cases:
        x32, w32, b32 = operands(bsz, h, w, cin, cout)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            # the bias in the working type, as the walk's buffers hold it
            x, wt, b = x32.to(dtype), w32.to(dtype), b32.to(dtype)
            what = f"B={bsz} {h}x{w} {cin}->{cout} {name}"
            max_err = max(max_err, k5_check(x, wt, b, what))
            if dtype == torch.bfloat16:
                max_err = max(max_err, k5_check(x, wt, b32,
                                                what + ", float32 bias"))
            ms = graph_ms(lambda: conv3x3_fused(x, wt, b))
            plain_ms = graph_ms(lambda: conv3x3_fused_reference(x, wt, b),
                                iters=5, warmup=1)
            xc = x.permute(0, 3, 1, 2)
            # what the main path runs without K5: cuDNN in the working type
            # (TF32 allowed for float32, as at precision None), then leaky
            cudnn_ms = graph_ms(lambda: F.leaky_relu(
                F.conv2d(xc, wt, b, padding=1), 0.1))
            if count:
                tot = totals.setdefault(dtype, [0.0, 0.0, 0.0])
                for i, t in enumerate((ms, plain_ms, cudnn_ms)):
                    tot[i] += count * t
            size = x.element_size()
            flop = 2 * bsz * h * w * cin * cout * 9
            nbytes = size * (bsz * h * w * (cin + cout) + 9 * cin * cout)
            peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else FP32_FLOPS_PER_S
            bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, flop / peak)
            log(f"[K5] {what} x{count} layers: leaky/linear within bars; "
                f"kernel {ms:.4f} ms ({flop / ms / 1e9:.1f} TFLOP/s, bound "
                f"{bound_ms:.4f} ms = {bound_ms / ms:.1%} of it), plain "
                f"{plain_ms:.4f} ms, cuDNN {cudnn_ms:.4f} ms (all three: one "
                f"call repeated in a CUDA graph, operands hot in L2)")
    # the tile rule (plan_tiles) on the card: each main-path shape at one
    # image, where 64-row tiles each get a multiprocessor, and the 13 x 13
    # shape at the batch, where they do not; both heights held to the bars
    for bsz, (h, w, cin, cout) in [(1, shape) for shape in sorted(shapes)] + [
            (BATCH, min(shapes))]:
        x, wt, b = (t.to(torch.bfloat16) for t in operands(bsz, h, w, cin, cout))
        chosen = cuda_conv.plan_tiles(bsz * h * w, cout,
                                      sm_count(x.get_device()))
        tile_ms = {}
        for block_m in (64, 128):
            cuda_conv.plan_tiles = lambda m, n, sms, block_m=block_m: block_m
            try:
                k5_check(x, wt, b, f"B={bsz} {h}x{w} {cin}->{cout} bfloat16, "
                                   f"{block_m}-row tiles")
                tile_ms[block_m] = graph_ms(lambda: conv3x3_fused(x, wt, b))
            finally:
                cuda_conv.plan_tiles = plan_tiles
        log(f"[K5] B={bsz} {h}x{w} {cin}->{cout} bfloat16 by tile height: "
            f"64 rows {tile_ms[64] * 1e3:.1f} us, 128 rows "
            f"{tile_ms[128] * 1e3:.1f} us; plan_tiles takes {chosen}")
    # strided views, as the walk produces them: the NHWC view of a
    # channels_last torch.cat (a route layer's output), and a channel slice
    # of a wider map (pixel stride above Cin, base off the allocation's start)
    for dtype in (torch.float32, torch.bfloat16):
        x32, w32, b32 = operands(2, 19, 19, 256, 128)
        halves = [x32[..., :128].permute(0, 3, 1, 2).to(dtype).contiguous(
            memory_format=torch.channels_last), x32[..., 128:].permute(
            0, 3, 1, 2).to(dtype).contiguous(memory_format=torch.channels_last)]
        cat = torch.cat(halves, dim=1).permute(0, 2, 3, 1)
        wide = torch.cat([x32, x32], dim=3).to(dtype)[..., 64:320]
        if wide.is_contiguous() or wide.stride(2) != 512:
            raise AssertionError("the channel slice is not a strided view")
        for view, what in ((cat, "torch.cat view"), (wide, "channel slice")):
            max_err = max(max_err, k5_check(
                view, w32.to(dtype), b32.to(dtype),
                f"B=2 19x19 256->128 {str(dtype)[6:]} {what}"))
    log("[K5] strided inputs (channels_last torch.cat view, channel slice "
        "with pixel stride 512), float32 and bfloat16: within bars")
    for dtype, (ms, plain_ms, cudnn_ms) in totals.items():
        log(f"[K5] yolov3@416 B={BATCH} all {sum(shapes.values())} eligible "
            f"layers, {str(dtype)[6:]}: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, cuDNN {cudnn_ms:.3f} ms (L2-hot graph "
            f"replays per shape; the main phase's walk is the cold figure)")
    return max_err, totals


def k3_views(f):
    """Maps that are not dense, holding the values of ``f``: the
    channel-padded map itself (8 channels past the A·(5+C) decoded), a
    channel-slice view 3 channels into a wider map (pixel stride above
    A·(5+C), a base off the 16-byte grid) and a spatial slice."""
    import torch

    b, gy, gx, c = f.shape
    padded = torch.full((b, gy, gx, c + 8), 9.0, dtype=f.dtype, device=f.device)
    padded[..., :c] = f
    wide = torch.full((b, gy, gx, c + 11), -9.0, dtype=f.dtype,
                      device=f.device)
    wide[..., 3:3 + c] = f
    return {"channel-padded": padded, "channel slice": wide[..., 3:3 + c],
            "spatial slice": k1_strided(f)["sliced"]}


def phase_k3(graph):
    """K3 (full decode, one launch for the heads into the concatenated
    output) against its plain version: exact on float32 and bf16 maps at
    the three yolov3@416 B=8 heads, on channel-padded maps, channel-slice
    and spatial-slice views, at yolov3@608 and at B=1; one launch a call;
    each head's one-row table equal to its rows of the call; by graph
    replay at both map types, with the ablated builds (no math, no stores:
    ``tools/ablate_phases.py``) and the share of the bound."""
    import torch
    from yolov3_tpu_torch.ops import cuda_decode as cd
    from yolov3_tpu_torch.ops import decode as plain_decode
    from yolov3_tpu_torch.tools.ablate_phases import full_decode_phase_times

    anchors, strides, ncls = head_spec(graph)

    def exact(feats, what: str) -> None:
        before = cd.decode_all.launches
        got = cd.decode_all(feats, anchors, strides, ncls)
        want = plain_decode.decode_all([f.float() for f in feats], anchors,
                                       strides, ncls)
        torch.cuda.synchronize()
        if cd.decode_all.launches - before != 1:
            raise AssertionError(f"K3 {what}: "
                                 f"{cd.decode_all.launches - before} launches")
        if got.shape != want.shape or not torch.equal(got, want):
            bad = int((got != want).sum()) if got.shape == want.shape else -1
            raise AssertionError(f"K3 {what}: {bad} elements differ from the "
                                 f"plain decode")

    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        feats = [torch.from_numpy(h).to(DEVICE, dtype)
                 for h in k1_inputs(graph, seed=3)]
        exact(feats, f"yolov3@416 B={BATCH} {dtype}")
        for name in ("channel-padded", "channel slice", "spatial slice"):
            views = [k3_views(f)[name] for f in feats]
            if any(r.dense for p in cd.plan_full_decode(
                    views, anchors, ncls, [0] * len(views)) for r in p.rows):
                raise AssertionError(f"K3 {name}: planned as a dense map")
            exact(views, f"{name} {dtype}")
        # one head alone (a one-row table) is its rows of the call
        got = cd.decode_all(feats, anchors, strides, ncls)
        offs = cd.candidate_offsets(feats, anchors)
        for h, (f, a, st) in enumerate(zip(feats, anchors, strides)):
            if not torch.equal(cd.decode_head(f, a, st, ncls),
                               got[:, offs[h]:offs[h + 1]]):
                raise AssertionError(f"K3 head {h} alone differs from the call")
        for size, bsz in ((608, BATCH), (416, 1), (608, 1)):
            exact([torch.from_numpy(h).to(DEVICE, dtype) for h in k1_inputs(
                graph, seed=size + bsz, size=size, bsz=bsz)],
                f"yolov3@{size} B={bsz} {dtype}")
        cases += 8
    log(f"[K3] exact against the plain decode in {cases} cases (float32 and "
        f"bf16 maps: dense, channel-padded, channel slice, spatial slice, "
        f"each head alone, yolov3@608 B={BATCH}, B=1 at 416 and 608), one "
        f"launch a call")
    res = {"max_abs_err": 0.0}
    feats32 = [torch.from_numpy(h).to(DEVICE) for h in k1_inputs(graph, seed=3)]
    for dtype in (torch.float32, torch.bfloat16):
        feats = [f.to(dtype) for f in feats32]
        key = "" if dtype == torch.float32 else "_bf16"
        # eager first: eager timings taken after a capture read slower
        ms_eager = cuda_ms(lambda: cd.decode_all(feats, anchors, strides, ncls))
        plain = cuda_ms(lambda: plain_decode.decode_all(
            [f.float() for f in feats], anchors, strides, ncls))
        ms = graph_ms(lambda: cd.decode_all(feats, anchors, strides, ncls))
        ablated = full_decode_phase_times(feats, anchors, strides, ncls)
        n = sum(f.numel() for f in feats)
        nbytes = n * (feats[0].element_size() + 4)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        res.update({f"ms{key}": ms, f"ms_eager{key}": ms_eager,
                    f"plain_ms{key}": plain, f"bound_ms{key}": bound_ms,
                    f"ablated{key}": ablated})
        # the plain decode copies its anchors from the host, which a CUDA
        # graph capture refuses: its time is the eager event mean
        log(f"[K3] yolov3@416 B={BATCH} {dtype} maps: {ms:.4f} ms by graph "
            f"replay ({ms_eager:.4f} eager), plain {plain:.4f} ms (eager), "
            f"bound {bound_ms:.4f} ms ({nbytes / 1e6:.2f} MB at 3.35 TB/s, "
            f"{bound_ms / ms:.1%} of the bound reached); ablated builds by "
            f"graph replay: " + ", ".join(f"{k} {v:.4f} ms"
                                          for k, v in ablated.items()))
    return res


def _int8_qp(rng, k: int, cin: int, cout: int, device):
    import torch

    return {"wq": torch.from_numpy(rng.integers(-127, 128, (k, k, cin, cout),
                                                dtype=np.int8)).to(device),
            "sw": torch.from_numpy(rng.uniform(1e-4, 2e-4, cout)
                                   .astype(np.float32)).to(device),
            "b": torch.from_numpy(rng.normal(0, 0.1, cout)
                                  .astype(np.float32)).to(device)}


def phase_int8conv():
    """The card's im2col + ``torch._int_mm`` route against the CPU's int32
    ``F.conv2d``: the integer sums exactly, the float32 epilogue (symmetric,
    asymmetric with its border-deficit map, stem) within 1 ulp."""
    import torch
    from yolov3_tpu_torch import quant
    from yolov3_tpu_torch.graph import Node
    from yolov3_tpu_torch.ops import int8_conv

    rng = np.random.default_rng(7)
    cases = [("1x1", 1, 1, 256, 128, 52, 0), ("3x3 s1", 3, 1, 128, 256, 52, 0),
             ("3x3 s2", 3, 2, 64, 128, 104, 0), ("3x3 s1 zx=-37", 3, 1, 64, 128, 37, -37),
             ("3x3 s2 zx=21", 3, 2, 32, 64, 52, 21), ("1x1 head N=255", 1, 1, 256, 255, 13, 0),
             ("1x1 M=8", 1, 1, 64, 32, 2, 0)]
    for name, k, stride, cin, cout, hw, zx in cases:
        xq = torch.from_numpy(rng.integers(-127, 128, (2, hw, hw, cin), dtype=np.int8))
        qp = _int8_qp(rng, k, cin, cout, "cpu")
        qp_d = {key: v.to(DEVICE) for key, v in qp.items()}
        want = int8_conv.conv_int8(xq, int8_conv.weight_operand(qp["wq"]),
                                   stride, k // 2)
        got = int8_conv.conv_int8(xq.to(DEVICE), int8_conv.weight_operand(qp_d["wq"]),
                                  stride, k // 2)
        if got.dtype != torch.int32 or not torch.equal(got.cpu(), want):
            raise AssertionError(f"int8 conv {name}: integer sums differ")
        node = Node(index=1, kind="convolutional", inputs=(0,), out_channels=cout,
                    downsample=1, filters=cout,
                    size=k, stride=stride, pad=1, activation="leaky",
                    batch_normalize=True)
        y_c = quant._conv_int8_core(xq, node, qp, 0.031, True, zx)
        y_d = quant._conv_int8_core(xq.to(DEVICE), node, qp_d, 0.031, True, zx).cpu()
        ulp = float(((y_d - y_c).abs() / (y_c.abs() * 2.0 ** -23 + 1e-30)).max())
        if not ulp <= 1.0:
            raise AssertionError(f"int8 conv {name}: epilogue off by {ulp} ulp")
        log(f"[int8conv] {name} {cin}->{cout} at {hw}x{hw}: int32 sums exact "
            f"against the CPU int32 conv, epilogue max {ulp:.2f} ulp"
            f"{' (bit-equal)' if torch.equal(y_d, y_c) else ''}")
    # the stem: exact-u8 input, q = -128 padding, K = 27 padded to 32
    x = torch.from_numpy(rng.integers(0, 256, (2, 64, 64, 3)).astype(np.float32) / 255.0)
    qp = _int8_qp(rng, 3, 3, 32, "cpu")
    qp_d = {key: v.to(DEVICE) for key, v in qp.items()}
    node = Node(index=0, kind="convolutional", inputs=(-1,), out_channels=32,
                downsample=1, filters=32, size=3,
                stride=1, pad=1, activation="leaky", batch_normalize=True)
    y_c = quant._conv_stem_int8(x, node, qp)
    y_d = quant._conv_stem_int8(x.to(DEVICE), node, qp_d).cpu()
    ulp = float(((y_d - y_c).abs() / (y_c.abs() * 2.0 ** -23 + 1e-30)).max())
    if not ulp <= 1.0:
        raise AssertionError(f"int8 stem conv: off by {ulp} ulp")
    log(f"[int8conv] stem 3->32 at 64x64 (K=27 padded, q=-128 border): max "
        f"{ulp:.2f} ulp against the CPU")
    # cost of one quantized conv at a yolov3 shape, for orientation
    xq = torch.from_numpy(rng.integers(-127, 128, (BATCH, 52, 52, 128),
                                       dtype=np.int8)).to(DEVICE)
    op = int8_conv.weight_operand(_int8_qp(rng, 3, 128, 256, DEVICE)["wq"])
    ms = cuda_ms(lambda: int8_conv.conv_int8(xq, op, 1, 1))
    cols = int8_conv.im2col(torch.nn.functional.pad(xq, (0, 0, 1, 1, 1, 1)), 3, 1)
    mm_ms = cuda_ms(lambda: torch._int_mm(cols, op["mm"]))
    log(f"[int8conv] B={BATCH} 52x52 128->256 3x3: pad + im2col + _int_mm "
        f"{ms:.4f} ms, of which _int_mm {mm_ms:.4f} ms")


K6_SHAPES = ((BATCH, 104, 104, 128, 64), (BATCH, 52, 52, 256, 128))
# K6 off yolov3@416's main path, all timed too: yolov3@608's two block
# shapes, both 416 shapes at one image (where the tile plan takes 8-row
# tiles)
K6_TIMED_SHAPES = ((BATCH, 152, 152, 128, 64), (BATCH, 76, 76, 256, 128),
                   (1, 104, 104, 128, 64), (1, 52, 52, 256, 128))
# exact only: an H and W that no tile divides (37 x 53), a 5 x 3 image with
# cmid = C, and mid widths below a 64-channel product (zero-filled N and K)
K6_ODD_SHAPES = ((2, 37, 53, 128, 64), (1, 5, 3, 128, 128),
                 (3, 21, 19, 256, 128), (2, 13, 11, 128, 32),
                 (1, 12, 20, 256, 48))


def k6_case(rng, b: int, h: int, w: int, c: int, cmid: int):
    """A residual block with int8 inputs over the full range and scales
    that spread the quantized intermediates over theirs (with clipping)."""
    import torch
    from yolov3_tpu_torch.ops.cuda_block import prepare_block_params

    x = torch.from_numpy(rng.integers(-127, 128, (b, h, w, c), dtype=np.int8)).to(DEVICE)
    s_in, s_mid, s_mid2, s_out = 0.05, 3.0 / 127, 2.5 / 127, 8.0 / 127
    qp1, qp2 = _int8_qp(rng, 1, c, cmid, DEVICE), _int8_qp(rng, 3, cmid, c, DEVICE)
    # |m1| ~ 73 * 73 * sqrt(c); |mid| ~ 40; |m2| ~ 73 * 40 * sqrt(9 * cmid)
    qp1["sw"] = qp1["sw"] / 1.5e-4 / (73 * 73 * np.sqrt(c) * s_in)
    qp2["sw"] = qp2["sw"] / 1.5e-4 / (73 * 40 * np.sqrt(9 * cmid) * s_mid)
    bp = prepare_block_params(qp1, qp2, s_in, s_mid)
    kw = dict(s_in=s_in, s_mid=s_mid, s_mid2=s_mid2, s_out=s_out)
    return x, bp, kw


def k6_exact(x, bp, kw, what: str) -> float:
    """K6 against its plain version on one block: int8, bf16 and float32
    outputs equal, 0 differing elements; returns max |err| (0.0)."""
    import torch
    from yolov3_tpu_torch.ops.cuda_block import (residual_block_int8,
                                                 residual_block_int8_reference)

    worst = 0.0
    for emit_q, carrier in ((True, torch.bfloat16), (False, torch.bfloat16),
                            (False, torch.float32)):
        got = residual_block_int8(x, bp, emit_q=emit_q, carrier_dtype=carrier, **kw)
        want = residual_block_int8_reference(x, bp, emit_q=emit_q,
                                             carrier_dtype=carrier, **kw)
        torch.cuda.synchronize()
        d = (got.float() - want.float()).abs()
        worst = max(worst, float(d.max()))
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(
                f"K6 {what} emit_q={emit_q} {carrier}: {int((d > 0).sum())} "
                f"of {d.numel()} elements differ, max {float(d.max())}")
    return worst


def phase_k6():
    """K6 (fused int8 residual block) against its plain version: exact at
    yolov3@416's and @608's B=8 block shapes, at B=1 and at odd
    geometries, int8, bf16 and float32 outputs, at the plan's tile and at
    the other one; then device time by CUDA graph replay of the kernel, its
    plain version and the library yardstick (the block's two bare int8
    products as ``torch._int_mm``)."""
    import torch
    from yolov3_tpu_torch.ops import cuda_block
    from yolov3_tpu_torch.ops._build import sm_count
    from yolov3_tpu_torch.ops.cuda_block import (residual_block_int8,
                                                 residual_block_int8_reference)

    rng = np.random.default_rng(6)
    plan = cuda_block.plan_block_tiles
    times, max_err = {}, 0.0
    for shape in K6_SHAPES + K6_TIMED_SHAPES + K6_ODD_SHAPES:
        b, h, w, c, cmid = shape
        x, bp, kw = k6_case(rng, *shape)
        chosen = plan(b, h, w, c, cmid, sm_count(x.get_device()))
        tile_ms = {}
        heights = [th for th in cuda_block.TILE_HEIGHTS if cuda_block.
                   block_smem_bytes(th, c, cmid) <= cuda_block.SMEM_LIMIT]
        for th in heights:
            cuda_block.plan_block_tiles = lambda *a, th=th: th
            try:
                max_err = max(max_err, k6_exact(x, bp, kw, f"{shape} {th}-row tiles"))
                if shape not in K6_ODD_SHAPES:
                    tile_ms[th] = graph_ms(lambda: residual_block_int8(
                        x, bp, emit_q=True, **kw))
            finally:
                cuda_block.plan_block_tiles = plan
        q = residual_block_int8(x, bp, emit_q=True, **kw)
        spread = [float((q == v).float().mean()) for v in (-127, 0, 127)]
        log(f"[K6] B={b} {h}x{w} C={c} cmid={cmid}: int8, bf16 and float32 "
            f"outputs exact against the plain version at tile heights "
            f"{heights} (share of outputs at -127/0/127: {spread[0]:.3f}/"
            f"{spread[1]:.3f}/{spread[2]:.3f})")
        if shape in K6_ODD_SHAPES:
            continue
        ms = graph_ms(lambda: residual_block_int8(x, bp, emit_q=True, **kw))
        plain_ms = graph_ms(lambda: residual_block_int8_reference(
            x, bp, emit_q=True, **kw), iters=5, warmup=1)
        # the yardstick: the block's two products alone, (M, C) . (C, cmid)
        # and the 3x3's im2col (M, 9 cmid) . (9 cmid, C), on torch._int_mm;
        # NOT the same function (no epilogues, no mid tile, no shortcut)
        m = b * h * w
        a1 = torch.randint(-127, 128, (m, c), dtype=torch.int8, device=DEVICE)
        b1 = torch.randint(-127, 128, (c, cmid), dtype=torch.int8, device=DEVICE)
        a2 = torch.randint(-127, 128, (m, 9 * cmid), dtype=torch.int8, device=DEVICE)
        b2 = torch.randint(-127, 128, (9 * cmid, c), dtype=torch.int8, device=DEVICE)
        lib_ms = graph_ms(lambda: (torch._int_mm(a1, b1), torch._int_mm(a2, b2)))
        del a1, a2
        ops = 2 * m * (c * cmid + 9 * cmid * c)
        nbytes = 2 * x.numel() + c * cmid + 9 * cmid * c + 8 * (c + cmid)
        t_ops, t_bytes = ops / INT8_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(t_ops, t_bytes)
        times[shape] = (ms, plain_ms, bound_ms,
                        "operations" if t_ops >= t_bytes else "bytes", lib_ms)
        log(f"[K6] B={b} {h}x{w} C={c} cmid={cmid}: kernel {ms:.4f} ms "
            f"({ops / ms / 1e9:.1f} TOP/s int8, {bound_ms / ms:.1%} of the "
            f"bound {bound_ms:.4f} ms: {ops / 1e9:.1f} G operations at 1,979 "
            f"TOP/s against {nbytes / 1e6:.1f} MB at 3.35 TB/s); plain "
            f"(unfused ops) {plain_ms:.4f} ms; yardstick, the two bare products "
            f"on torch._int_mm (not the same function) {lib_ms:.4f} ms; by tile "
            f"height " + ", ".join(f"{k} rows {v * 1e3:.1f} us"
                                   for k, v in sorted(tile_ms.items()))
            + f", plan_block_tiles takes {chosen} (one call repeated in a CUDA "
            f"graph, operands hot in L2)")
    forward = [sum(n * times[shape][i] for n, shape in zip((2, 8), K6_SHAPES))
               for i in (0, 1, 2, 4)]
    log(f"[K6] yolov3@416 B={BATCH}, the 10 blocks of a forward (2 at 104x104 "
        f"C=128, 8 at 52x52 C=256): kernel {forward[0]:.4f} ms, plain "
        f"{forward[1]:.4f} ms, bound {forward[2]:.4f} ms ({forward[2] / forward[0]:.1%} "
        f"of it reached), torch._int_mm yardstick {forward[3]:.4f} ms")
    return max_err, times


GOLDEN_ROUTES = (("pallas", "xla"), ("xla", "xla"), ("pallas-fused", "xla"),
                 ("pallas", "pallas"))


def phase_golden():
    import torch
    from yolov3_tpu_torch import Darknet, Detector
    from yolov3_tpu_torch.weights import fold_raw, random_raw

    for fixture in ("golden_tiny.json", "golden_yolov3.json"):
        golden = json.loads((REPO / "tests" / "data" / fixture).read_text())
        params = fold_raw(random_raw(
            Darknet(REPO / "models" / golden["cfg"]).graph,
            seed=golden["seed"], scale=golden.get("scale", 1.0)))
        frames = np.random.default_rng(golden["seed"]).integers(
            0, 256, (1, *SRC_HW, 3), dtype=np.uint8)
        size = golden["net_size"]
        for decode_impl, conv_impl in GOLDEN_ROUTES:
            net = Darknet(REPO / "models" / golden["cfg"], precision="highest",
                          device=DEVICE, conv_impl=conv_impl).set_params(params)
            det = Detector(net, prob_thresh=golden["prob_thresh"],
                           iou_thresh=golden["iou_thresh"],
                           top_k=golden["top_k"], net_hw=(size, size),
                           decode_impl=decode_impl)
            if det.route != decode_impl:
                raise AssertionError(f"{fixture}: route {det.route} run for "
                                     f"decode_impl={decode_impl}")
            (got,) = det._unpack(det._run(det._stage(frames)), None)  # net px
            what = f"{fixture} decode_impl={decode_impl} conv_impl={conv_impl}"
            if len(got.class_prob) != len(golden["scores"]):
                raise AssertionError(f"{what}: {len(got.class_prob)} survivors "
                                     f"vs golden {len(golden['scores'])}")
            np.testing.assert_array_equal(got.class_idx, golden["classes"])
            np.testing.assert_allclose(got.class_prob, golden["scores"], atol=5e-5)
            np.testing.assert_allclose(got.bbox_tlbr, golden["boxes"], atol=0.1)
            err = float(np.abs(got.bbox_tlbr - np.asarray(golden["boxes"])).max())
            log(f"[golden] {what}: {len(got.class_prob)} survivors match "
                f"(max box err {err:.2e} px) on {torch.cuda.get_device_name(0)}")


def run_main_path(det, name: str, frames: np.ndarray, card: str,
                  calls: int = 10):
    """``det.detect_batch`` timed over ``calls`` calls after a warmup, its
    detections checked for plausibility, and its launches a call: K2 once,
    and K1 once (all the heads in one launch) on the K1 route."""
    import torch
    from yolov3_tpu_torch.ops import cuda_decode, cuda_nms

    det.warmup(BATCH, SRC_HW)
    wrappers = {"decode_packed": cuda_decode.decode_packed,
                "nms_suppress": cuda_nms.suppress}
    before = {n: w.launches for n, w in wrappers.items()}
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
    per_call = {n: (w.launches - before[n]) / calls for n, w in wrappers.items()}
    want = {"decode_packed": int(det.route == "pallas"), "nms_suppress": 1}
    if per_call != want:
        raise AssertionError(f"{name} ({det.route}): launches a call "
                             f"{per_call}, expected {want}")
    for d in out:
        n = len(d.class_prob)
        if not (0 < n <= det.max_results and np.isfinite(d.bbox_tlbr).all()
                and (d.class_prob >= det.prob_thresh).all()
                and (d.class_prob <= 1).all()
                and (d.bbox_tlbr[:, [0, 2]] <= SRC_HW[1]).all()
                and (d.bbox_tlbr[:, [1, 3]] <= SRC_HW[0]).all()
                and (d.bbox_tlbr >= 0).all()):
            raise AssertionError(f"{name}: implausible detections {d}")
    net = det.net
    log(f"[main] {name}@416 detect_batch B={BATCH} {SRC_HW[0]}x{SRC_HW[1]} "
        f"uint8, precision={net.precision}, decode_impl={det.route}, "
        f"conv_impl={net.conv_impl}: per call median {np.median(dev):.3f} ms "
        f"(CUDA events), {np.median(host):.3f} ms (host clock), {calls} "
        f"calls, on {card}; survivors/image {[len(d.class_prob) for d in out]}; "
        f"launches a call {want}")
    return out


def _iou(a, b):
    tl = np.maximum(a[:2], b[:2])
    br = np.minimum(a[2:], b[2:])
    wh = np.maximum(br - tl, 0)
    inter = wh[0] * wh[1]
    ua = (a[2] - a[0]) * (a[3] - a[1])
    ub = (b[2] - b[0]) * (b[3] - b[1])
    return inter / max(ua + ub - inter, 1e-9)


def check_parity(ref, test, what: str, strict: bool = True) -> None:
    """The DESIGN bf16 bar: same-class boxes at IoU > 0.99 for >= 90% of
    the reference detections scoring >= 0.45. ``ref`` / ``test``: per image
    (boxes, scores, classes) of the survivors. ``strict=False`` only
    reports the share."""
    matched = total = 0
    for (rb, rs, rc), (tb, _, tc) in zip(ref, test):
        for box, score, cls in zip(rb, rs, rc):
            if score < PARITY_SCORE:
                continue
            total += 1
            best = max((_iou(box, b) for b, c in zip(tb, tc) if c == cls),
                       default=0.0)
            matched += best > PARITY_IOU
    if strict and (total == 0 or matched / total < PARITY_SHARE):
        raise AssertionError(f"{what}: parity {matched}/{total}")
    log(f"[main] {what}: {matched}/{total} reference detections scoring >= "
        f"{PARITY_SCORE} matched at IoU > {PARITY_IOU} (bar {PARITY_SHARE:.0%})")


def parity_survivors(net, x):
    """tests/test_compact_path.py's parity pipeline on the card:
    forward_compact, then batched_nms_compact at prob 0.35, top_k 64 →
    per image (boxes, scores, classes) of the survivors."""
    import torch
    from yolov3_tpu_torch import forward_compact
    from yolov3_tpu_torch.ops.nms import (batched_nms_compact, pack_results,
                                          unpack_results)

    with torch.inference_mode():
        out = forward_compact(net.graph, net.params, x, precision=net.precision)
        res = unpack_results(pack_results(batched_nms_compact(
            *out, prob_thresh=0.35, top_k=64)).cpu().numpy())
    return [(res.boxes[i][res.valid[i]], res.scores[i][res.valid[i]],
             res.classes[i][res.valid[i]]) for i in range(x.shape[0])]


def compact_sets(res):
    from yolov3_tpu_torch.ops.nms import pack_results, unpack_results

    arr = unpack_results(pack_results(res).cpu().numpy())
    return [{(tuple(np.round(b, 3)), int(c), round(float(s), 5))
             for b, s, c, v in zip(arr.boxes[i], arr.scores[i], arr.classes[i],
                                   arr.valid[i]) if v}
            for i in range(arr.scores.shape[0])]


def phase_main(card: str):
    import torch
    from yolov3_tpu_torch import (Darknet, Detector, forward_compact,
                                  forward_features)
    from yolov3_tpu_torch.ops import cuda_conv, cuda_decode, cuda_nms
    from yolov3_tpu_torch.ops.nms import batched_nms_compact
    from yolov3_tpu_torch.ops.preprocess import preprocess
    from yolov3_tpu_torch.weights import fold_raw, random_raw, write_weights

    cfg = REPO / "models" / "yolov3.cfg"
    nets = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "yolov3.weights"
        graph = Darknet(cfg).graph
        write_weights(path, graph, random_raw(graph, seed=0))
        size = path.stat().st_size
        if size != YOLOV3_WEIGHTS_BYTES:
            raise AssertionError(f"yolov3.weights is {size} bytes, "
                                 f"published file is {YOLOV3_WEIGHTS_BYTES}")
        for key, prec, conv in (("none", None, "xla"), ("highest", "highest", "xla"),
                                ("bf16", "bf16", "xla"), ("bf16-k5", "bf16", "pallas")):
            nets[key] = Darknet(cfg, precision=prec, device=DEVICE,
                                conv_impl=conv).load_weights(path)
    tiny = Darknet(REPO / "models" / "yolov3-tiny.cfg", device=DEVICE)
    tiny.set_params(fold_raw(random_raw(tiny.graph, seed=0)))
    frames = np.random.default_rng(0).integers(0, 256, (BATCH, *SRC_HW, 3),
                                               dtype=np.uint8)
    kernels = {"decode_packed": cuda_decode.decode_packed,
               "decode_compact": cuda_decode.decode_compact,
               "decode_packed_fused_head": cuda_decode.decode_packed_fused_head,
               "conv3x3_fused": cuda_conv.conv3x3_fused,
               "decode_all": cuda_decode.decode_all,
               "nms_suppress": cuda_nms.suppress}
    for k in kernels.values():
        k.launches = 0
    run_main_path(Detector(nets["none"]), "yolov3", frames, card)
    run_main_path(Detector(nets["bf16"]), "yolov3", frames, card)
    run_main_path(Detector(nets["bf16"], decode_impl="pallas-fused"),
                  "yolov3", frames, card)
    k5_det = Detector(nets["bf16-k5"], decode_impl="pallas-fused")
    run_main_path(k5_det, "yolov3", frames, card)
    run_main_path(Detector(nets["none"], decode_impl="xla"), "yolov3", frames, card)
    run_main_path(Detector(tiny), "yolov3-tiny", frames, card)
    # forward_compact through K1c against the plain compact decode, on the
    # same preprocessed frames
    det = Detector(nets["none"])
    x = preprocess(torch.from_numpy(frames).to(DEVICE).flip(-1), det.net_hw,
                   interp=det._interp_for(SRC_HW))
    net = nets["none"]
    sets = {}
    with torch.inference_mode():
        for impl in ("xla", "pallas"):
            out = forward_compact(net.graph, net.params, x, decode_impl=impl)
            sets[impl] = compact_sets(batched_nms_compact(
                *out, prob_thresh=det.prob_thresh, iou_thresh=det.iou_thresh,
                top_k=det.top_k, max_results=det.max_results))
    if sets["xla"] != sets["pallas"] or not all(sets["xla"]):
        raise AssertionError("forward_compact: K1c and the plain compact "
                             "decode give different detection sets")
    log(f"[main] yolov3@416 forward_compact B={BATCH}: K1c and the plain "
        f"compact decode give the same detection sets "
        f"({[len(s) for s in sets['xla']]} per image)")

    # Darknet(x): the decoded (B, N, 5+C) tensor through K3, against the
    # plain decode of the same head maps
    from yolov3_tpu_torch.ops import decode as plain_decode

    with torch.inference_mode():
        before = cuda_decode.decode_all.launches, cuda_decode.decode_head.launches
        full = net(x)
        k3_calls = (cuda_decode.decode_all.launches - before[0],
                    cuda_decode.decode_head.launches - before[1])
        want = plain_decode.decode_all(
            [h.float() for h in forward_features(net.graph, net.params, x)],
            *head_spec(net.graph))
    if full.shape != (BATCH, 10647, 85) or not torch.equal(full, want):
        raise AssertionError(f"Darknet(x): {tuple(full.shape)} differs from the "
                             f"plain decode of its head maps")
    if k3_calls != (1, 0):
        raise AssertionError(f"Darknet(x): {k3_calls[0]} launches of K3 for "
                             f"the heads and {k3_calls[1]} one-head launches; "
                             f"one launch for the three heads expected")
    log(f"[main] yolov3@416 Darknet(x) B={BATCH}: {tuple(full.shape)} through "
        f"ONE K3 launch for the three heads, equal to the plain decode of the "
        f"same head maps")

    launches = {name: k.launches for name, k in kernels.items()}
    log(f"[main] kernel launches in the main-path run: {launches}")
    for kernel, n in launches.items():
        if n == 0:
            raise AssertionError(f"the main path never launched {kernel}")
    # after the read of the counts, which are the main path's own: the
    # fused-conv route by stage, beside the routes that leave the convs to
    # cuDNN; the walk also as device time alone (replayed from a CUDA
    # graph: every layer's weights come from device memory, not from L2 as
    # in the k5 phase), and K5's launches in one call: every eligible layer
    x = preprocess(torch.from_numpy(frames).to(DEVICE).flip(-1), k5_det.net_hw,
                   interp=k5_det._interp_for(SRC_HW))
    routes = (("bf16 + K1", Detector(nets["bf16"])),
              ("bf16 + K4", Detector(nets["bf16"], decode_impl="pallas-fused")),
              ("bf16 + K4 + K5", k5_det))
    # all eager splits before any graph capture: taken after one in the same
    # process they read up to 1.5x slower (seen on the card, cause not
    # isolated)
    splits = [stage_split(det, frames, calls=10) for _, det in routes]
    for (name, det), split in zip(routes, splits):
        walk, decode = route_stages(det)
        with torch.inference_mode():
            walk_ms = graph_ms(lambda: walk(x), iters=5)
            heads = walk(x)
            decode_ms = graph_ms(lambda: decode(heads))
            if det.route == "pallas":
                k1_main_path(det, heads, name)
        log(f"[main] yolov3@416 B={BATCH} {name}: stage split ms (CUDA "
            f"events, median of 10) " + ", ".join(
                f"{k} {v:.3f}" for k, v in split.items())
            + f"; device time (CUDA graph replay): the walk {walk_ms:.3f} ms, "
            f"the decode {decode_ms:.4f} ms")
    before = cuda_conv.conv3x3_fused.launches
    k5_det.detect_batch(frames)
    per_call = cuda_conv.conv3x3_fused.launches - before
    eligible = sum(k5_shapes(nets["bf16-k5"].graph).values())
    if per_call != eligible:
        raise AssertionError(f"K5 launched {per_call} times in one call, the "
                             f"graph has {eligible} eligible convs")
    log(f"[main] yolov3@416 bf16 + K4 + K5: {per_call} K5 launches per call "
        f"(every eligible 3x3 conv)")
    # the bf16 bar where the reference holds it (tests/test_compact_path.py:
    # tiny@416, random weights of seed 3, uniform inputs); at yolov3's depth
    # random weights amplify rounding, so its shares are reported, not gated
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (BATCH, 416, 416, 3)).astype(np.float32)).to(DEVICE)
    tiny_params = fold_raw(random_raw(tiny.graph, seed=3))
    tiny_runs = {prec: parity_survivors(
        Darknet(REPO / "models" / "yolov3-tiny.cfg", precision=prec,
                device=DEVICE).set_params(tiny_params), x)
        for prec in ("highest", "bf16")}
    check_parity(tiny_runs["highest"], tiny_runs["bf16"],
                 "yolov3-tiny@416 bf16 against \"highest\"")
    runs = {key: parity_survivors(nets[key], x)
            for key in ("highest", "bf16", "none")}
    check_parity(runs["highest"], runs["bf16"],
                 "yolov3@416 bf16 against \"highest\"", strict=False)
    check_parity(runs["highest"], runs["none"], "yolov3@416 None (TF32) "
                 "against \"highest\"", strict=False)
    return launches


def k1_main_path(det, heads, name: str) -> None:
    """On the main path's own head maps: which of K1's paths each head took
    (the planner's choice), and K2 on the real candidates that the
    selection hands it, exact against its plain version (keep mask and
    phase 1's scratch), with each phase's time alone."""
    from yolov3_tpu_torch.ops import cuda_decode
    from yolov3_tpu_torch.ops.nms import _select_pairmax_payload
    from yolov3_tpu_torch.tools.ablate_phases import nms_phase_times

    anchors, strides, ncls = head_spec(det.net.graph)
    plans = cuda_decode.plan_decode(
        heads, anchors, ncls, cuda_decode.candidate_offsets(heads, anchors))
    paths = [("dense" if r.dense else "strided") for p in plans for r in p.rows]
    payload, scores = cuda_decode.decode_packed(heads, anchors, strides, ncls,
                                                det.prob_thresh)
    k = min(det.top_k, scores.shape[1])
    boxes, _, classes, valid = _select_pairmax_payload(
        payload, scores, k, group=det.select_group)
    keep = k2_check(boxes, classes, valid, det.iou_thresh,
                    f"yolov3@416 {name} real candidates")
    t = nms_phase_times(boxes, classes, valid, det.iou_thresh)
    log(f"[main] yolov3@416 B={BATCH} {name}: K1's heads "
        f"{[tuple(h.shape) for h in heads]} {heads[0].dtype}: {paths} path, "
        f"{len(plans)} launch; K2 on the "
        f"selection's K={k} real candidates ({int(valid.sum())} valid in "
        f"{BATCH} images): keep "
        f"masks and scratch exact, longest chain {int(keep.sum(1).max())}, "
        f"{t['whole'] * 1e3:.2f} us by graph replay (phase 1 alone "
        f"{t['phase1'] * 1e3:.2f}, phase 2 alone {t['phase2'] * 1e3:.2f})")


def prenms_bar(ref, test, what: str, strict: bool = True) -> None:
    """The DESIGN int8 bar, pre-NMS: on the reference's top-200 candidates
    per image, the same class, |Δscore| <= 0.01 and |Δbox| <= 0.5 px.
    ``ref`` / ``test``: (boxes, scores, classes) of ``forward_compact``."""
    (rb, rs, rc), (tb, ts, tc) = ([t.float().cpu().numpy() for t in out]
                                  for out in (ref, test))
    ds = db = flips = 0.0
    for i in range(rs.shape[0]):
        top = np.argsort(rs[i])[::-1][:INT8_BAR_TOP]
        ds = max(ds, float(np.abs(rs[i][top] - ts[i][top]).max()))
        db = max(db, float(np.abs(rb[i][top] - tb[i][top]).max()))
        flips += int((rc[i][top] != tc[i][top]).sum())
    ok = ds <= INT8_BAR_SCORE and db <= INT8_BAR_BOX and flips == 0
    log(f"[int8] {what}: top-{INT8_BAR_TOP} pre-NMS max |dscore| {ds:.5f} (bar "
        f"{INT8_BAR_SCORE}), max |dbox| {db:.4f} px (bar {INT8_BAR_BOX}), "
        f"{int(flips)} class flips: {'holds' if ok else 'MISSED'}")
    if strict and not ok:
        raise AssertionError(f"{what}: the int8 parity bar is missed")


def device_busy_ms(fn):
    """Sum of the kernels' device time in one call of ``fn``
    (torch.profiler), or None when the profiler reports no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        # device-side events only: an operator's row repeats its kernels' time
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            total += getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0.0))
    return total / 1e3 if total > 0 else None


def route_stages(det):
    """(walk, decode) of a packed route, float or quantized: ``walk(x)`` →
    the head maps (pre-head maps on the fused route), ``decode(heads)`` →
    (payload, scores) through K1, or K4 with the head convs."""
    from yolov3_tpu_torch import forward_features, quant
    from yolov3_tpu_torch.ops.cuda_decode import decode_packed, decode_packed_fused

    net = det.net
    anchors, strides, ncls = head_spec(net.graph)
    fused = det.route == "pallas-fused"
    head_convs = [yn.inputs[0] for yn in net.graph.yolo_nodes]
    if net.quantized:
        # HWIO int8-tier weights: (1, 1, Cin, Cout) -> (Cout, Cin)
        ws = [net.qparams[i]["w"] for i in head_convs]
        ws = [w.reshape(w.shape[2], w.shape[3]).t() for w in ws]
        bs = [net.qparams[i]["b"] for i in head_convs]
    else:
        params = net.params
        ws = [params[i]["w"] for i in head_convs]  # OIHW, 1x1
        ws = [w.reshape(w.shape[0], w.shape[1]) for w in ws]
        bs = [params[i]["b"] for i in head_convs]

    def walk(x):
        if not net.quantized:
            return forward_features(net.graph, params, x, net.precision,
                                    net.conv_impl, stop_before_heads=fused)
        if net.qcarrier == "int8":
            return quant.forward_features_int8_carrier(
                net.graph, net.qparams, net.act_scales, x,
                net.precision or "bf16", stop_before_heads=fused,
                block_impl=det.block_impl, tensor_zeros=net.act_zeros,
                operands=net.qoperands)
        return quant.forward_features_int8(
            net.graph, net.qparams, net.act_scales, x,
            net.precision or "bf16", operands=net.qoperands)

    def decode(heads):
        if fused:
            return decode_packed_fused(heads, ws, bs, anchors, strides, ncls,
                                       det.prob_thresh)
        return decode_packed(heads, anchors, strides, ncls, det.prob_thresh)

    return walk, decode


def stage_split(det, frames: np.ndarray, calls: int):
    """Median device ms (CUDA events) of the stages of one ``detect_batch``
    on the packed routes, float or quantized: H2D, flip + preprocess, the
    walk, the decode (K1, or K4 with the head convs), selection + K2 +
    compaction + pack."""
    import torch
    from yolov3_tpu_torch.ops.nms import batched_nms_packed, pack_results
    from yolov3_tpu_torch.ops.preprocess import preprocess

    names = ("h2d", "preprocess", "walk", "decode", "nms+pack")
    rows = []
    walk, decode = route_stages(det)
    with torch.inference_mode():
        for _ in range(calls + 1):
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            marks[0].record()
            dev = det._stage(frames)
            marks[1].record()
            x = preprocess(dev.flip(-1), det.net_hw, mode=det.resize_mode,
                           interp=det._interp_for(SRC_HW))
            marks[2].record()
            heads = walk(x)
            marks[3].record()
            payload, scores = decode(heads)
            marks[4].record()
            pack_results(batched_nms_packed(
                payload, scores, iou_thresh=det.iou_thresh, top_k=det.top_k,
                max_results=det.max_results, select_group=det.select_group))
            marks[5].record()
            marks[5].synchronize()
            rows.append([a.elapsed_time(b) for a, b in zip(marks, marks[1:])])
    med = np.median(np.asarray(rows[1:]), axis=0)
    return dict(zip(names, (float(v) for v in med)))


def same_detections(a, b) -> bool:
    return len(a) == len(b) and all(
        np.array_equal(x.bbox_tlbr, y.bbox_tlbr)
        and np.array_equal(x.class_prob, y.class_prob)
        and np.array_equal(x.class_idx, y.class_idx) for x, y in zip(a, b))


def phase_int8(card: str):
    """The int8 tier at full width: quantize yolov3 on the card, then
    ``detect_batch`` through the quantized routes; K6's launch count per
    forward, "pallas" against "xla" blocks, the parity bar, the state file."""
    import torch
    from yolov3_tpu_torch import Darknet, Detector, forward_compact, quant
    from yolov3_tpu_torch.ops import cuda_block, cuda_decode, cuda_nms
    from yolov3_tpu_torch.weights import fold_raw, random_raw

    cfg = REPO / "models" / "yolov3.cfg"
    graph = Darknet(cfg).graph
    params = fold_raw(random_raw(graph, seed=0))
    frames = np.random.default_rng(0).integers(0, 256, (BATCH, *SRC_HW, 3),
                                               dtype=np.uint8)
    calib = np.random.default_rng(1).integers(0, 256, (BATCH, *SRC_HW, 3),
                                              dtype=np.uint8)

    def quantized(**kw):
        net = Darknet(cfg, precision="bf16", device=DEVICE).set_params(params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.quantize_int8(calib, **kw)
        torch.cuda.synchronize()
        n_q = sum("wq" in qp for qp in net.qparams.values())
        log(f"[int8] yolov3@416 quantize_int8({kw or ''}) on {BATCH} seeded "
            f"frames: {time.perf_counter() - t0:.2f} s, {n_q} of "
            f"{len(net.qparams)} convs int8, {len(net.act_scales)} scales")
        return net

    nets = {"sym": quantized(), "asym": quantized(act_scheme="asymmetric"),
            "bf16c": quantized(carrier="bf16")}
    plan = cuda_block.fused_block_plan(graph, nets["sym"].qparams,
                                       nets["sym"].act_scales)
    shapes = Counter((416 // graph.nodes[a].downsample, v["cin"])
                     for a, v in plan.items())
    log(f"[int8] fused_block_plan: {len(plan)} blocks {dict(shapes)} "
        f"((grid, C): count)")
    if len(plan) != K6_BLOCKS_YOLOV3:
        raise AssertionError(f"fused_block_plan found {len(plan)} blocks on "
                             f"yolov3.cfg, expected {K6_BLOCKS_YOLOV3}")
    kernels = {"decode_packed": cuda_decode.decode_packed,
               "decode_packed_fused_head": cuda_decode.decode_packed_fused_head,
               "residual_block_int8": cuda_block.residual_block_int8,
               "nms_suppress": cuda_nms.suppress}
    for k in kernels.values():
        k.launches = 0
    routes = (("int8 carrier, K6 blocks, K1", "sym", dict(block_impl="pallas")),
              ("int8 carrier, K6 blocks, K4", "sym",
               dict(block_impl="pallas", decode_impl="pallas-fused")),
              ("int8 carrier, unfused blocks, K1", "sym", {}),
              ("asymmetric int8 carrier, K1", "asym", {}),
              ("bf16 carrier, K1", "bf16c", {}))
    calls, outs, dets, per_forwards = 5, {}, {}, {}
    k6 = cuda_block.residual_block_int8
    for name, key, kw in routes:
        det = dets[name] = Detector(nets[key], **kw)
        before = k6.launches
        outs[name] = run_main_path(det, f"yolov3 [{name}]", frames, card,
                                   calls=calls)
        per_forward = (k6.launches - before) / (calls + 1)  # + the warmup
        want = len(plan) if kw.get("block_impl") == "pallas" else 0
        if per_forward != want:
            raise AssertionError(f"{name}: K6 launched {per_forward} times per "
                                 f"forward, expected {want}")
        per_forwards[name] = per_forward
    # the counts of the detect_batch calls alone: the stage split below
    # rebuilds a call out of its stages and would add its own launches
    launches = {name: k.launches for name, k in kernels.items()}
    log(f"[int8] kernel launches in the int8 main-path runs ({calls} timed "
        f"calls + 1 warmup of detect_batch on each of {len(routes)} routes): "
        f"{launches}")
    for kernel, n in launches.items():
        if n == 0:
            raise AssertionError(f"the int8 main path never launched {kernel}")
    for name, det in dets.items():
        per_forward = per_forwards[name]
        split = stage_split(det, frames, calls=5)
        busy = device_busy_ms(lambda: det.detect_batch(frames))
        log(f"[int8] {name}: K6 launches per forward {per_forward:.0f}; stage "
            f"ms (CUDA events, median of 5) "
            + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
            + f", sum {sum(split.values()):.3f}; kernel time of one profiled "
            f"call " + (f"{busy:.3f} ms" if busy else "not measured"))
    if not same_detections(outs[routes[0][0]], outs[routes[2][0]]):
        raise AssertionError("block_impl='pallas' and 'xla' give different "
                             "detections (K6 is exact on the card)")
    log("[int8] block_impl='pallas' and 'xla': identical detections "
        f"({[len(d.class_prob) for d in outs[routes[0][0]]]} per image)")

    # the state file: save, load into a fresh net, identical detections
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "yolov3_int8.npz"
        nets["sym"].save_quantized(path)
        fresh = Darknet(cfg, precision="bf16", device=DEVICE).set_params(params)
        fresh.load_quantized(path)
        size = path.stat().st_size
    again = Detector(fresh, block_impl="pallas").detect_batch(frames)
    if not same_detections(again, outs[routes[0][0]]):
        raise AssertionError("a reloaded quantization state gives other detections")
    log(f"[int8] save_quantized -> load_quantized ({size / 1e6:.1f} MB npz): "
        f"identical detections")

    # the DESIGN int8 bar where the reference holds it (tests/test_quant.py:
    # tiny@416, random weights of seed 3, uniform inputs, scales calibrated
    # on them), against the float32 forward; reported for yolov3
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (2, 416, 416, 3)).astype(np.float32)).to(DEVICE)
    tiny_cfg = REPO / "models" / "yolov3-tiny.cfg"
    tiny = Darknet(tiny_cfg, precision="highest", device=DEVICE)
    tiny.set_params(fold_raw(random_raw(tiny.graph, seed=3)))
    with torch.inference_mode():
        ref = forward_compact(tiny.graph, tiny.params, x, precision="highest")
        scales = quant.calibrate_tensors(tiny.graph, tiny.params, [x], precision=None)
        qp = quant.quantize_weights(tiny.graph, tiny.params)
        test = quant.forward_compact_int8(tiny.graph, qp, scales, x, precision=None,
                                          carrier="int8")
        prenms_bar(ref, test, "yolov3-tiny@416 int8 carrier against float32")
        big = Darknet(cfg, precision="highest", device=DEVICE).set_params(params)
        ref = forward_compact(big.graph, big.params, x, precision="highest")
        scales = quant.calibrate_tensors(big.graph, big.params, [x], precision=None)
        qp = quant.quantize_weights(big.graph, big.params)
        for impl in ("xla", "pallas"):
            test = quant.forward_compact_int8(big.graph, qp, scales, x,
                                              precision=None, carrier="int8",
                                              block_impl=impl)
            prenms_bar(ref, test, f"yolov3@416 int8 carrier (block_impl={impl}) "
                       f"against float32, random weights", strict=False)
    return launches


def _sum_ms(fn_of_args, cases, iters: int = 5) -> float:
    """Sum over ``cases`` of the device ms of one ``fn_of_args(*case)``."""
    return sum(cuda_ms(lambda: fn_of_args(*case), iters=iters, warmup=1)
               for case in cases)


def phase_probes():
    """T3a-e against their plain versions and against the exact host values
    of the tool, then the tool's own path (``tools.probe_block``) with the
    launch counts zeroed before it: 0 differences everywhere."""
    import torch
    from yolov3_tpu_torch.ops import cuda_probe as cp
    from yolov3_tpu_torch.tools import probe_block as pb

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(8)
    rec = {}

    def same(got, want, what) -> float:
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
            n = int((got != want).sum()) if got.shape == want.shape else -1
            raise AssertionError(f"{what}: {n} elements differ from the plain version")
        return float((got.double() - want.double()).abs().max())

    # T3a: every shape of the tool, all three int8 cores, against the
    # float64 product
    dots, errs = [], []
    for m, k, n in pb.INT8_DOT_SHAPES:
        lhs = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8)).to(dev)
        rhs = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8)).to(dev)
        errs += [same(cp.probe_int8_dot(lhs, rhs, core), cp.dot_reference(lhs, rhs),
                      f"T3a {core} {(m, k, n)}")
                 for core in ("wgmma_s8", "mma_s8", "dp4a_s8")]
        dots.append((lhs, rhs))
    ops = sum(2 * a.shape[0] * a.shape[1] * b.shape[1] for a, b in dots)
    nbytes = sum(a.numel() + b.numel() + 4 * a.shape[0] * b.shape[1] for a, b in dots)
    rec["T3a"] = dict(
        max_abs_err=max(errs),
        ms=_sum_ms(lambda a, b: cp.probe_int8_dot(a, b, "wgmma_s8"), dots),
        ms_mma=_sum_ms(lambda a, b: cp.probe_int8_dot(a, b, "mma_s8"), dots),
        ms_dp4a=_sum_ms(lambda a, b: cp.probe_int8_dot(a, b, "dp4a_s8"), dots),
        plain_ms=_sum_ms(cp.dot_reference, dots),
        library_ms=_sum_ms(torch._int_mm, dots), ops=ops, nbytes=nbytes,
        peak=INT8_OPS_PER_S,
        # device time alone (CUDA graph replay), beside the eager sums
        graph_ms=sum(graph_ms(lambda: cp.probe_int8_dot(a, b, "wgmma_s8"))
                     for a, b in dots),
        graph_ms_mma=sum(graph_ms(lambda: cp.probe_int8_dot(a, b, "mma_s8"))
                         for a, b in dots),
        library_graph_ms=sum(graph_ms(lambda: torch._int_mm(a, b))
                             for a, b in dots))
    log(f"[probes] T3a over {len(dots)} shapes: wgmma "
        f"{rec['T3a']['ms']:.4f} ms eager, {rec['T3a']['graph_ms']:.4f} ms "
        f"graph replay; mma.sync {rec['T3a']['ms_mma']:.4f} / "
        f"{rec['T3a']['graph_ms_mma']:.4f} ms; torch._int_mm "
        f"{rec['T3a']['library_ms']:.4f} / {rec['T3a']['library_graph_ms']:.4f} ms")
    # T3b-e at the tool's inputs
    x = torch.from_numpy(pb.round_inputs()).to(dev)
    err = same(cp.probe_round(x), cp.probe_round_reference(x), "T3b")
    rec["T3b"] = dict(max_abs_err=err, ms=cuda_ms(lambda: cp.probe_round(x)),
                      plain_ms=cuda_ms(lambda: cp.probe_round_reference(x)),
                      nbytes=8 * x.numel(), ops=3 * x.numel())
    xr = torch.from_numpy(np.random.default_rng(1).integers(
        -127, 128, (10, 48, 128)).astype(np.int8)).to(dev)
    err = same(cp.probe_roll(xr), cp.probe_roll_reference(xr), "T3c")
    rec["T3c"] = dict(max_abs_err=err, ms=cuda_ms(lambda: cp.probe_roll(xr)),
                      plain_ms=cuda_ms(lambda: cp.probe_roll_reference(xr)),
                      nbytes=3 * xr.numel(), ops=0)
    mask_args = (6, 48, 128, 40, 40)
    err = max(same(cp.probe_mask(*mask_args, hi, device=dev),
                   cp.probe_mask_reference(*mask_args, hi, device=dev),
                   f"T3d hi={hi}") for hi in (0, 3, 6))
    n_mask = (6 + 2) * 48 * 128
    rec["T3d"] = dict(max_abs_err=err, ms=cuda_ms(lambda: cp.probe_mask(*mask_args, 3, device=dev)),
                      plain_ms=cuda_ms(lambda: cp.probe_mask_reference(
                          *mask_args, 3, device=dev)),
                      nbytes=4 * n_mask, ops=5 * n_mask)
    acc, deq, b, inv = pb.epilogue_inputs()
    acc, deq, b = (torch.from_numpy(a).to(dev) for a in (acc, deq, b))
    err = same(cp.probe_epilogue(acc, deq, b, inv),
               cp.probe_epilogue_reference(acc, deq, b, inv), "T3e")
    rec["T3e"] = dict(max_abs_err=err, ms=cuda_ms(lambda: cp.probe_epilogue(acc, deq, b, inv)),
                      plain_ms=cuda_ms(lambda: cp.probe_epilogue_reference(
                          acc, deq, b, inv)),
                      nbytes=8 * acc.numel() + 8 * deq.numel(), ops=6 * acc.numel())
    # T3b-e as device time alone (CUDA graph replay), beside the wrapper
    # times above (about 25 us of host work a call)
    rec["T3b"]["graph_ms"] = graph_ms(lambda: cp.probe_round(x))
    rec["T3c"]["graph_ms"] = graph_ms(lambda: cp.probe_roll(xr))
    rec["T3d"]["graph_ms"] = graph_ms(
        lambda: cp.probe_mask(*mask_args, 3, device=dev))
    rec["T3e"]["graph_ms"] = graph_ms(
        lambda: cp.probe_epilogue(acc, deq, b, inv))
    log("[probes] T3b-e, one launch each: " + ", ".join(
        f"{key} {rec[key]['graph_ms'] * 1e3:.2f} us by graph replay "
        f"({rec[key]['ms'] * 1e3:.2f} us a wrapper call)"
        for key in ("T3b", "T3c", "T3d", "T3e")))
    log("[probes] T3a-e equal their plain versions on the card (T3a at "
        f"{len(dots)} shapes, wgmma, mma.sync and __dp4a)")
    # the tool's path: exact host values, the reference's wording
    wrappers = {"T3a": cp.probe_int8_dot, "T3b": cp.probe_round,
                "T3c": cp.probe_roll, "T3d": cp.probe_mask,
                "T3e": cp.probe_epilogue}
    for w in wrappers.values():
        w.launches = 0
    bad = (pb.probe_int8_dot(dev) + pb.probe_round(dev) + pb.probe_roll(dev)
           + pb.probe_mask(dev) + pb.probe_epilogue(dev))
    for name, w in wrappers.items():
        rec[name]["launches"] = w.launches
        if w.launches == 0:
            raise AssertionError(f"tools.probe_block never launched {name}")
    for case in pb.FULL_BLOCK_CASES:
        bad += pb.probe_full_tiny(*case, device=dev)
    bad += pb.probe_chain(dev)
    if bad:
        raise AssertionError(f"tools.probe_block: {bad} elements differ from "
                             f"their exact values")
    log(f"[probes] tools.probe_block: 0 differences in every probe; launches "
        f"{ {k: v['launches'] for k, v in rec.items()} }")
    return rec


# T1's store mode at bf16 against the float32 matmul: the same products
# summed in another order (and truncated by the tensor cores' alignment),
# relative to the largest sum
DOT_STORE_BF16_RTOL = 2.0 ** -12


def phase_dots(card: str):
    """T1 (int8 wgmma, int8 mma.sync, int8 __dp4a, bf16 wgmma) and T2 over
    the tools' shape lists: checked against their plain versions, then
    timed by the tools' own clocks with the launch counts zeroed before;
    shares of the card's peaks; the library call at the same shape; T1's
    store mode (the bare product) by graph replay beside the step."""
    import torch
    from yolov3_tpu_torch.ops import cuda_probe as cp
    from yolov3_tpu_torch.tools import bench_dot, bench_int8_dot

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(9)
    rec = {}
    cases = {}
    for name, dtype, core, peak in bench_int8_dot.VARIANTS:
        err = 0.0
        for shape in bench_int8_dot.SHAPES:
            args = cases.setdefault((dtype, shape), cp.dot_operands(
                *shape, dtype, rng, dev))
            err = max(err, bench_int8_dot.check_shape(args, core))
        rec[core] = dict(max_abs_err=err, peak=peak, name=name, rows=[])
    t2_cases = [cp.dot_operands(*shape, torch.bfloat16, rng, dev)[1:]
                for shape in bench_dot.SHAPES]
    rec["grid"] = dict(max_abs_err=max(bench_dot.check_shape(a) for a in t2_cases),
                       peak=BF16_FLOPS_PER_S, name="bf16 grid", rows=[])
    log(f"[dots] T1 ({len(bench_int8_dot.VARIANTS)} cores x "
        f"{len(bench_int8_dot.SHAPES)} shapes) and T2 "
        f"({len(bench_dot.SHAPES)} shapes) within the bar of their plain "
        f"versions (rtol {bench_int8_dot.DOT_RTOL:.3g} of the largest output): "
        f"max |err| { {k: v['max_abs_err'] for k, v in rec.items()} }")
    lens, grids = (64, 512), (2048, 8192)
    floor = bench_int8_dot.step_floor_us(dev, lens=lens)
    log(f"[dots] T1's floor at M, K, N = {bench_int8_dot.FLOOR_SHAPE}: "
        f"{floor:.2f} us per dependent step (launch, projections, two-stage "
        f"finish) on {card}")
    cp.dot_step.launches = cp.dot_grid.launches = 0
    for name, dtype, core, peak in bench_int8_dot.VARIANTS:
        before = cp.dot_step.launches
        for shape in bench_int8_dot.SHAPES:
            args = cases[(dtype, shape)]
            r = bench_int8_dot.time_shape(args, core, peak, lens=lens)
            r["shape"] = shape
            rec[core]["rows"].append(r)
        rec[core]["launches"] = cp.dot_step.launches - before
    for shape, args in zip(bench_dot.SHAPES, t2_cases):
        r = bench_dot.time_shape(args, grids=grids)
        r["shape"] = shape
        rec["grid"]["rows"].append(r)
    rec["grid"]["launches"] = cp.dot_grid.launches
    # plain and library times at the same shapes, outside the counted run
    for name, dtype, core, peak in bench_int8_dot.VARIANTS:
        for r in rec[core]["rows"]:
            args = cases[(dtype, r["shape"])]
            r["plain_ms"] = cuda_ms(lambda: cp.dot_step_reference(*args),
                                    iters=3, warmup=1)
            r["library_ms"] = bench_int8_dot.library_ms(args[1], args[2])
    for r, args in zip(rec["grid"]["rows"], t2_cases):
        r["plain_ms"] = cuda_ms(lambda: cp.dot_grid_reference(*args, 1),
                                iters=3, warmup=1)
        r["library_ms"] = cuda_ms(lambda: torch.matmul(args[0], args[1]))
    # T1's step and the library's product again as device time alone (CUDA
    # graph replay): the eager times above carry ~25 us of host work a call
    for name, dtype, core, peak in bench_int8_dot.VARIANTS:
        lib = torch._int_mm if dtype == torch.int8 else torch.matmul
        for r in rec[core]["rows"]:
            args = cases[(dtype, r["shape"])]
            r["graph_ms"] = graph_ms(lambda: cp.dot_step(*args, core=core))
            r["library_graph_ms"] = graph_ms(lambda: lib(args[1], args[2]))
        # the timing split: T1's kernel in store mode is the bare product,
        # the function of the library call; the step minus it is the
        # projections and the two-stage finish
        for r in rec[core]["rows"]:
            lhs, rhs = cases[(dtype, r["shape"])][1:3]
            got = cp.dot_product(lhs, rhs, core)
            want = cp.dot_reference(lhs, rhs)
            torch.cuda.synchronize()
            if dtype == torch.int8:
                if not torch.equal(got, want):
                    raise AssertionError(f"T1 store mode {core} {r['shape']}: "
                                         f"int32 sums differ")
            else:
                err = float((got - want).abs().max())
                if not err <= DOT_STORE_BF16_RTOL * float(want.abs().max()):
                    raise AssertionError(f"T1 store mode {core} {r['shape']}: "
                                         f"max |err| {err}")
            r["store_graph_ms"] = graph_ms(lambda: cp.dot_product(lhs, rhs, core))
        rows = rec[core]["rows"]
        log(f"[dots] {name}, {len(rows)} shapes, one each, device time "
            f"(CUDA graph replay): step {sum(r['graph_ms'] for r in rows):.4f}"
            f" ms, store mode (the bare product) "
            f"{sum(r['store_graph_ms'] for r in rows):.4f} ms, library "
            f"{sum(r['library_graph_ms'] for r in rows):.4f} ms; eager (CUDA "
            f"events): library {sum(r['library_ms'] for r in rows):.4f} ms on "
            f"{card}")
        for r in rows:
            log(f"[dots]   {name} {r['shape']}: step {r['graph_ms'] * 1e3:.2f} "
                f"us, store {r['store_graph_ms'] * 1e3:.2f} us, library "
                f"{r['library_graph_ms'] * 1e3:.2f} us")
    # T2: the library's bare product also by graph replay, and T2's time a
    # product by graph replay of a 1,024-step launch, whole and as the bare
    # products (the -DT2_SKIP_PROJECT build of tools/ablate_phases.py)
    from yolov3_tpu_torch.tools.ablate_phases import grid_phase_times

    for r, args in zip(rec["grid"]["rows"], t2_cases):
        r["library_graph_ms"] = graph_ms(lambda: torch.matmul(args[0], args[1]))
        t = grid_phase_times(args)
        r["graph_us"], r["product_us"] = t["whole"] * 1e3, t["product"] * 1e3
    rows = rec["grid"]["rows"]
    log(f"[dots] T2, {len(rows)} shapes, one product each, by graph replay: "
        f"whole {sum(r['graph_us'] for r in rows):.3f} us, bare products "
        f"(no projection) {sum(r['product_us'] for r in rows):.3f} us; "
        f"library {sum(r['library_graph_ms'] for r in rows) * 1e3:.2f} us "
        f"(torch.matmul, one launch a product) on {card}")
    for r in rows:
        m, k, n = r["shape"]
        t = cp.plan_grid_tiles(m, n)
        log(f"[dots]   T2 {r['shape']}: tile {t.block_m}x{t.block_n}, "
            f"{t.stages} stages, {t.smem} B; whole {r['graph_us']:.3f} us, "
            f"bare products {r['product_us']:.3f} us, "
            f"{r['issued_share']:.1%} of the issued products useful")
    # bound of one step inside the timed call. The operands are the same on
    # every step and stay in L2, so device memory sees them once per call:
    # a step's bytes are its share of them (the larger timed size) plus its
    # own result, (8, 128) float32 for T1 and bf16 for T2. Operations: the
    # product and both projections at the tensor cores' peak for the type.
    for key, v in rec.items():
        unit = "TOP/s" if key.endswith("_s8") else "TFLOP/s"
        steps, out_bytes = (grids[1], 8 * 128 * 2) if key == "grid" else (
            lens[1], 8 * 128 * 4)
        for r in v["rows"]:
            m, k, n = r["shape"]
            es = 1 if key.endswith("_s8") else 2
            operands = es * (m * k + k * n) + 2 * (8 * m + n * 128)
            nbytes = operands / steps + out_bytes
            ops = 2 * m * k * n + 2 * 8 * m * n + 2 * 8 * n * 128
            t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / v["peak"] * 1e3
            r["bound_ms"], r["bound_by"] = max(t_b, t_o), (
                "bytes" if t_b >= t_o else "operations")
            log(f"[dots] {v['name']} M={m:4d} K={k:4d} N={n:4d}: {r['us']:8.2f} "
                f"us/step ({r['tops']:6.1f} {unit} useful, {r['share']:.2%} of "
                f"the {v['peak'] / 1e12:,.0f} peak; bound {r['bound_ms'] * 1e3:.4f} "
                f"us by {r['bound_by']}; plain {r['plain_ms'] * 1e3:.1f} us; "
                f"library {r['library_ms'] * 1e3:.2f} us) on {card}")
    return rec


ENTRY_SHAPES = ((480, 640), (720, 1280), (360, 480), (600, 800))


def entry_net(precision: str = "bf16", cfg: str = "yolov3.cfg", seed: int = 0):
    """A net at full width with random weights of ``seed``, on the card."""
    from yolov3_tpu_torch import Darknet
    from yolov3_tpu_torch.weights import fold_raw, random_raw

    net = Darknet(REPO / "models" / cfg, precision=precision, device=DEVICE)
    return net.set_params(fold_raw(random_raw(net.graph, seed=seed)))


def phase_native():
    """The C++ host loader, built here with g++: required, and held to the
    device preprocess on seeded frames (the 128 pad exactly; the interior
    within tests/test_native_preproc.py's bar of 0.02)."""
    import torch
    from yolov3_tpu_torch import native
    from yolov3_tpu_torch.ops.preprocess import preprocess
    from yolov3_tpu_torch.utils.boxes import letterbox_geometry

    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("the C++ host loader did not build or load (g++ "
                             "and native/preproc.cpp are required here)")
    log(f"[native] {native.library_path().name} ready in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(10)
    frames = [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for hw in ENTRY_SHAPES]
    net_hw = (416, 416)
    canvases = native.letterbox_mixed_native(frames, net_hw, swap_rb=True)
    worst = 0.0
    for frame, canvas in zip(frames, canvases):
        dev = preprocess(torch.from_numpy(frame[None]).to(DEVICE).flip(-1), net_hw)[0]
        host = torch.from_numpy(canvas).to(DEVICE).float() * (1.0 / 255.0)
        _, top, left, nh, nw = letterbox_geometry(frame.shape[:2], net_hw)
        inside = torch.zeros(net_hw, dtype=torch.bool, device=DEVICE)
        inside[top:top + nh, left:left + nw] = True
        if not bool((torch.from_numpy(canvas).to(DEVICE)[~inside] == native.PAD_VALUE).all()):
            raise AssertionError("letterbox_mixed_native: pad is not 128")
        if not torch.equal(host[~inside], dev[~inside]):
            raise AssertionError("host and device pads differ after normalization")
        worst = max(worst, float((host[inside] - dev[inside]).abs().max()))
    same = np.stack([frames[0]] * 2)
    stretched = native.stretch_batch_native(same, net_hw, swap_rb=True)
    dev = preprocess(torch.from_numpy(same).to(DEVICE).flip(-1), net_hw, mode="stretch")
    worst_s = float((torch.from_numpy(stretched).to(DEVICE).float() / 255.0 - dev).abs().max())
    if not (worst < 0.02 and worst_s < 0.02):
        raise AssertionError(f"host loader against the device preprocess: "
                             f"letterbox {worst}, stretch {worst_s} (bar 0.02)")
    ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        native.letterbox_mixed_native(frames * 2, net_hw, swap_rb=True)
        ms.append((time.perf_counter() - t0) * 1e3)
    log(f"[native] letterbox_mixed / stretch_batch against the device "
        f"preprocess on {len(frames)} seeded frames {ENTRY_SHAPES}: pad 128 "
        f"exact, interior max |diff| {worst:.4f} / {worst_s:.4f} (bar 0.02); "
        f"letterbox of 8 frames to 416x416: median {np.median(ms):.2f} ms "
        f"(host clock)")


def mixed_against_batch(det, frames, what: str) -> str:
    """``detect_mixed`` (host letterbox, uint8 canvases) against per-frame
    ``detect_batch`` (device letterbox, float resize) by the bars of the JAX
    package's tests/test_e2e.py::test_detect_mixed_matches_detect_batch:
    survivor counts within max(2, n // 5), and each frame's three
    highest-scoring device detections matched in the host path by class, at
    IoU > 0.9 and a score within 0.02."""
    mixed = det.detect_mixed(frames)
    worst_iou, worst_score, counts = 1.0, 0.0, []
    for i, (frame, m) in enumerate(zip(frames, mixed)):
        (s,) = det.detect_batch(frame)
        n = min(len(m.class_prob), len(s.class_prob))
        counts.append((len(m.class_prob), len(s.class_prob)))
        if n == 0 or abs(len(m.class_prob) - len(s.class_prob)) > max(2, n // 5):
            raise AssertionError(f"{what}, frame {i}: {counts[-1]} survivors "
                                 f"(host, device letterbox)")
        for j in np.argsort(s.class_prob)[::-1][:3]:
            same = m.class_idx == s.class_idx[j]
            ious = [_iou(s.bbox_tlbr[j], b) for b in m.bbox_tlbr[same]]
            if not ious:
                raise AssertionError(f"{what}, frame {i}: class "
                                     f"{s.class_idx[j]} lost in the host path")
            best = int(np.argmax(ious))
            gap = abs(float(m.class_prob[same][best] - s.class_prob[j]))
            worst_iou, worst_score = min(worst_iou, ious[best]), max(worst_score, gap)
            if ious[best] <= 0.9 or gap >= 0.02:
                raise AssertionError(f"{what}, frame {i}: best IoU "
                                     f"{ious[best]:.3f}, score gap {gap:.4f} "
                                     f"(bars 0.9, 0.02)")
    return (f"survivors (host, device) {counts}; top-3 per frame matched, "
            f"worst IoU {worst_iou:.4f}, worst score gap {worst_score:.5f}")


def convs_moved_by_batch_size(net, x, sub: int):
    """One forward of ``net`` on ``x`` (B images) in which every ``F.conv2d``
    is also run on its first ``sub`` images alone: (convs whose two results
    differ in any bit, convs run). Each conv sees the same input both times,
    so a difference is that conv's own (the library's algorithm for the
    batch size), not one carried from an earlier layer."""
    import torch
    import torch.nn.functional as F
    from unittest import mock
    from yolov3_tpu_torch.model import forward_features

    real, same = F.conv2d, []

    def both(inp, *args, **kw):
        y = real(inp, *args, **kw)
        same.append(torch.equal(real(inp[:sub], *args, **kw), y[:sub]))
        return y

    with mock.patch.object(F, "conv2d", both), torch.inference_mode():
        forward_features(net.graph, net.params, x, precision=net.precision)
    return same.count(False), len(same)


def phase_entry(card: str):
    """The entry-point path at full width (yolov3@416, bf16, B=8, frames of
    four sizes): detect_mixed against detect_preletterboxed and detect_batch,
    scan, PipelinedDetector, with K1's and K2's launch counts of one
    detect_mixed call and of the pipelined sequence."""
    import torch
    from yolov3_tpu_torch import Detector
    from yolov3_tpu_torch.inference import PipelinedDetector
    from yolov3_tpu_torch.ops import cuda_decode, cuda_nms

    net = entry_net()
    rng = np.random.default_rng(11)
    frames = [rng.integers(0, 256, (*ENTRY_SHAPES[i % 4], 3), dtype=np.uint8)
              for i in range(BATCH)]
    hws = [f.shape[:2] for f in frames]
    kernels = {"decode_packed": cuda_decode.decode_packed,
               "nms_suppress": cuda_nms.suppress}

    def counted(fn, want):
        """``fn()`` with the counts zeroed just before and read just after;
        the path must have launched each kernel exactly ``want`` times."""
        for k in kernels.values():
            k.launches = 0
        out = fn()
        got = {name: k.launches for name, k in kernels.items()}
        if got != want:
            raise AssertionError(f"kernel launches {got}, expected {want}")
        return out, got

    det = Detector(net)
    det.warmup(BATCH, (416, 416), host_preprocessed=True)
    # one device batch: K1 once for all the heads, K2 once
    mixed, launches = counted(lambda: det.detect_mixed(frames),
                              {"decode_packed": 1, "nms_suppress": 1})
    stages = dict(det.last_stage_s)
    canvases = det._build_canvases(frames)
    pre = det.detect_preletterboxed(canvases, hws)
    if not same_detections(mixed, pre) or not all(len(d.class_prob) for d in mixed):
        raise AssertionError("detect_mixed and detect_preletterboxed differ on "
                             "the same canvases")
    # like for like: the canvases as same-shape RGB frames through
    # detect_batch run the same device program (a 416x416 source is not
    # resized), so the results are the same in net pixels
    as_batch = Detector(net, bgr=False).detect_batch(canvases)
    in_net = det._unpack(det._run_staged(det._stage(canvases), bgr=False), None)
    for d in in_net:   # detect_batch clips to its source frame, the canvas
        np.clip(d.bbox_tlbr, 0, 416, out=d.bbox_tlbr)
    if not same_detections(as_batch, in_net):
        raise AssertionError("detect_batch on the canvases differs from "
                             "detect_preletterboxed in net pixels")
    # per frame through the device letterbox (other input rounding: the
    # loader's uint8 canvas against the float resize). Gated on tiny@416 by
    # the JAX package's bar; at yolov3's depth random weights amplify the
    # rounding past any bar, so there it is reported
    # (that test's own net: tiny, random weights of seed 42, threshold 0.35)
    tiny_bar = mixed_against_batch(
        Detector(entry_net(cfg="yolov3-tiny.cfg", seed=42), prob_thresh=0.35),
        frames,
        "yolov3-tiny@416 bf16 detect_mixed against detect_batch")
    matched = total = 0
    for frame, got in zip(frames, mixed):
        (ref,) = det.detect_batch(frame)
        for box, score, cls in zip(ref.bbox_tlbr, ref.class_prob, ref.class_idx):
            if score < PARITY_SCORE:
                continue
            total += 1
            matched += max((_iou(box, b) for b, c in zip(got.bbox_tlbr, got.class_idx)
                            if c == cls), default=0.0) > 0.9
    log(f"[entry] yolov3@416 bf16 B={BATCH}, frames {ENTRY_SHAPES} x2: "
        f"detect_mixed == detect_preletterboxed exactly "
        f"({[len(d.class_prob) for d in mixed]} per image), kernel launches "
        f"of the one call {launches}; detect_batch on the canvases == the "
        f"same in net pixels; stage split ms "
        + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in stages.items()))
    log(f"[entry] detect_mixed against per-frame detect_batch (device "
        f"letterbox): yolov3-tiny@416 bf16 within the bar: {tiny_bar}; "
        f"yolov3@416 bf16, random weights (reported): {matched}/{total} "
        f"detections scoring >= {PARITY_SCORE} matched at IoU > 0.9")
    # scan: 4 sub-batches of 8 in one call against four calls of 8
    many = np.concatenate([canvases] * 4)
    many[8:] = many[8:][:, ::-1]          # other content in the later batches
    many = np.ascontiguousarray(many)
    src = hws * 4
    want = [d for i in range(4)
            for d in det.detect_preletterboxed(many[8 * i:8 * i + 8], src[:8])]
    det4 = Detector(net, scan=4)
    got = det4.detect_preletterboxed(many, src)
    if not same_detections(got, want):
        raise AssertionError("scan=4 on 32 frames differs from four scan=1 "
                             "calls of 8")
    t0 = time.perf_counter()
    for _ in range(3):
        det4.detect_preletterboxed(many, src)
    t_scan = (time.perf_counter() - t0) / 3 * 1e3
    t0 = time.perf_counter()
    for _ in range(3):
        for i in range(4):
            det.detect_preletterboxed(many[8 * i:8 * i + 8], src[:8])
    t_plain = (time.perf_counter() - t0) / 3 * 1e3
    log(f"[entry] scan=4 on 32 canvases == four scan=1 calls of 8 exactly, in "
        f"order; {t_scan:.2f} ms against {t_plain:.2f} ms (host clock, mean of 3)")
    # scan=4 on 8 canvases runs sub-batches of 2, scan=1 one batch of 8: the
    # results are the same only where every conv's result for an image does
    # not depend on the batch it is in. Shown per conv, and end to end
    x = torch.from_numpy(canvases).to(DEVICE).float() * (1.0 / 255.0)
    split = same_detections(det4.detect_preletterboxed(canvases, hws), pre)
    moved = {"bf16": convs_moved_by_batch_size(net, x, 2)}
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        moved["bf16, cudnn.deterministic"] = convs_moved_by_batch_size(net, x, 2)
    finally:
        torch.backends.cudnn.deterministic = was
    net32 = entry_net("highest")
    moved["float32 (highest)"] = convs_moved_by_batch_size(net32, x, 2)
    split32 = same_detections(
        Detector(net32, scan=4).detect_preletterboxed(canvases, hws),
        Detector(net32).detect_preletterboxed(canvases, hws))
    del net32
    log(f"[entry] scan=4 on 8 canvases (sub-batches of 2) against scan=1 "
        f"(one batch of 8): bf16 {'==' if split else '!='}, float32 (highest) "
        f"{'==' if split32 else '!='}; convs of one forward whose result on "
        f"images 0-1 alone differs in some bit from rows 0-1 of the batch of "
        f"8 (same input both times): "
        + "; ".join(f"{k} {a} of {b}" for k, (a, b) in moved.items()))
    # PipelinedDetector(depth=2) over 8 batches
    batches = [rng.integers(0, 256, (BATCH, *SRC_HW, 3), dtype=np.uint8)
               for _ in range(8)]
    det.warmup(BATCH, SRC_HW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = [det.detect_batch(b) for b in batches]
    t_sync = (time.perf_counter() - t0) / len(batches) * 1e3
    pipe = PipelinedDetector(det, depth=2)
    # the first batch on the pipeline's own stream pays that stream's memory
    # pool and cuDNN handle: timed apart, as warmup() is for the other path
    t0 = time.perf_counter()
    pipe.submit(batches[0])
    pipe.flush()
    t_first = (time.perf_counter() - t0) * 1e3

    def pipelined():
        out = []
        for b in batches:
            out.extend(pipe.submit(b))
            if len(pipe._inflight) > 2:
                raise AssertionError("more than depth batches in flight")
        return out + pipe.flush()

    t0 = time.perf_counter()
    got, piped = counted(pipelined, {"decode_packed": len(batches),
                                     "nms_suppress": len(batches)})
    t_pipe = (time.perf_counter() - t0) / len(batches) * 1e3
    if len(got) != len(want) or not all(same_detections(g, w)
                                        for g, w in zip(got, want)):
        raise AssertionError("PipelinedDetector's results differ from the "
                             "synchronous calls or come out of order")
    log(f"[entry] PipelinedDetector(depth=2) over 8 batches of {BATCH} "
        f"{SRC_HW[0]}x{SRC_HW[1]} frames: the synchronous results, in order; "
        f"{t_pipe:.3f} ms per batch pipelined (its first batch, apart: "
        f"{t_first:.1f} ms), {t_sync:.3f} ms synchronous (host clock) on "
        f"{card}; kernel launches of the 8 pipelined batches {piped}")
    return dict(launches, pipelined_ms=t_pipe, sync_ms=t_sync)


def phase_serve(card: str):
    """serve() on 127.0.0.1 with the micro-batcher (5 ms window, max_batch 8)
    over yolov3@416 bf16: 8 requests one at a time, then 16 from 8 threads;
    answers checked against detect_mixed; /healthz, /stats, /metrics;
    graceful shutdown."""
    import socket
    import threading
    import urllib.error
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from yolov3_tpu_torch import Detector
    from yolov3_tpu_torch import serve as serve_mod
    from yolov3_tpu_torch.ops import cuda_decode, cuda_nms

    try:
        import cv2
    except ImportError:
        cv2 = None
    det = Detector(entry_net())
    rng = np.random.default_rng(12)
    frames = [rng.integers(0, 256, (*ENTRY_SHAPES[i % 4], 3), dtype=np.uint8)
              for i in range(16)]
    # every batch is padded to max_batch = 8, so a frame's answer is its
    # row of a batch of 8, wherever it sits
    want = [det.detect_mixed([f] * 8)[0] for f in frames]
    b1 = []
    det.detect_batch(frames[0])
    for _ in range(8):
        t0 = time.perf_counter()
        det.detect_batch(frames[0])
        b1.append((time.perf_counter() - t0) * 1e3)
    server = serve_mod.serve(det, class_names=None, host="127.0.0.1", port=0,
                             warmup_hw=ENTRY_SHAPES[0], batch_window_s=0.005,
                             max_batch=8)
    # zeroed after serve()'s own warm-up: the counts are the requests'
    kernels = {"decode_packed": cuda_decode.decode_packed,
               "nms_suppress": cuda_nms.suppress}
    for k in kernels.values():
        k.launches = 0
    port = server.server_address[1]
    url = f"http://127.0.0.1:{port}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    get_ms, retried = {}, []
    try:
        def get(path):
            """GET ``path`` within the /detect requests' 120 s. A connect
            that times out before the request is sent is tried once more on
            a new socket and logged; the answer is checked either way."""
            for attempt in (0, 1):
                t0 = time.perf_counter()
                try:
                    with urllib.request.urlopen(url + path, timeout=120) as r:
                        body = r.read().decode()
                except urllib.error.URLError as e:
                    if attempt or not isinstance(e.reason, TimeoutError):
                        raise
                    retried.append(f"{path} after {time.perf_counter() - t0:.1f} s")
                    continue
                get_ms[path] = round((time.perf_counter() - t0) * 1e3, 2)
                return body

        if cv2 is not None:
            bodies = []
            for f in frames:
                ok, buf = cv2.imencode(".png", f)
                if not ok:
                    raise AssertionError("cv2.imencode failed")
                bodies.append(buf.tobytes())

            def ask(i):
                t0 = time.perf_counter()
                req = urllib.request.Request(url + "/detect", data=bodies[i],
                                             method="POST")
                with urllib.request.urlopen(req, timeout=120) as r:
                    body = json.loads(r.read())
                ms = (time.perf_counter() - t0) * 1e3
                dets = body["detections"]
                return ms, ([d["class_id"] for d in dets],
                            [d["score"] for d in dets],
                            [d["bbox_tlbr"] for d in dets], body["image_hw"])
        else:
            def ask(i):
                t0 = time.perf_counter()
                d = server.batcher.detect(frames[i])
                server.batcher.stats.record(time.perf_counter() - t0)
                ms = (time.perf_counter() - t0) * 1e3
                return ms, (list(d.class_idx), list(d.class_prob),
                            d.bbox_tlbr.tolist(), list(frames[i].shape[:2]))

        single = [ask(0)[0] for _ in range(8)]
        with ThreadPoolExecutor(max_workers=8) as pool:
            answers = list(pool.map(ask, range(16)))
        for i, (_, (cls, score, box, hw)) in enumerate(answers):
            w = want[i]
            if hw != list(frames[i].shape[:2]) or cls != list(w.class_idx):
                raise AssertionError(f"request {i}: classes differ from detect_mixed")
            # the JSON rounds scores to 4 digits and boxes to 2
            if len(cls) and (np.abs(np.asarray(score) - w.class_prob).max() > 1e-4
                             or np.abs(np.asarray(box) - w.bbox_tlbr).max() > 0.011):
                raise AssertionError(f"request {i}: answer differs from detect_mixed")
        if json.loads(get("/healthz")) != {"status": "ok"}:
            raise AssertionError("/healthz")
        stats = json.loads(get("/stats"))
        keys = {"preprocess_s", "h2d_s", "dispatch_s", "device_fetch_s", "queue_wait_s"}
        if cv2 is not None:
            keys.add("decode_s")
        if stats["requests"] != 24 or stats["errors"] != 0 or not keys <= set(stats["stages"]):
            raise AssertionError(f"/stats: {stats}")
        lines = dict(ln.rsplit(" ", 1) for ln in get("/metrics").splitlines()
                     if ln and not ln.startswith("#"))
        sizes = {int(k.split('"')[1]): int(v) for k, v in lines.items()
                 if k.startswith("yolov3_device_batches_total")}
        if (int(lines["yolov3_requests_total"]) != 24
                or sum(s * n for s, n in sizes.items()) != 24
                or lines['yolov3_request_latency_seconds_bucket{le="+Inf"}'] != "24"):
            raise AssertionError(f"/metrics: {lines}")
    finally:
        serve_mod.shutdown_gracefully(server)
        thread.join(timeout=30)
    if thread.is_alive() or server.batcher._thread.is_alive():
        raise AssertionError("the server's threads did not stop")
    try:
        socket.create_connection(("127.0.0.1", port), timeout=2).close()
        raise AssertionError("the port is still open after shutdown_gracefully")
    except OSError:
        pass
    launches = {name: k.launches for name, k in kernels.items()}
    # one device batch, one detect call: K1 once for all heads, K2 once
    n_batches = sum(sizes.values())
    if launches != {"decode_packed": n_batches, "nms_suppress": n_batches}:
        raise AssertionError(f"the serving path's launches {launches}, "
                             f"expected one of each for each of its "
                             f"{n_batches} device batches")
    conc = np.asarray([ms for ms, _ in answers])
    fill = sum(s * n for s, n in sizes.items()) / sum(sizes.values())
    post = "run" if cv2 is not None else "not run: no cv2"
    log(f"[serve] yolov3@416 bf16, micro-batched (5 ms, max_batch 8), "
        f'"post_detect": "{post}": 8 requests one at a time p50 '
        f"{np.median(single):.2f} ms (detect_batch B=1 alone: p50 "
        f"{np.median(b1):.2f} ms); 16 requests from 8 threads p50 "
        f"{np.percentile(conc, 50):.2f} ms, p95 {np.percentile(conc, 95):.2f} ms; "
        f"all answers equal detect_mixed; device batches by size {sizes}, mean "
        f"fill {fill:.2f} of 8; /stats requests 24, stages "
        f"{ {k: v['mean_ms'] for k, v in stats['stages'].items()} } ms; GETs "
        f"{get_ms} ms, retried {retried or 'none'}; drained "
        f"and port released; kernel launches {launches} on {card}")
    return dict(launches, post_detect=post, p50_single=float(np.median(single)),
                p50=float(np.percentile(conc, 50)), p95=float(np.percentile(conc, 95)))


def probe_records(dots, probes, bound):
    """The kernels-line entries of T1 (one per core), T2 and T3a-e. A dot's
    times are sums over its tool's shape list (one step at each shape); its
    launches are those of the tool's timed run."""
    src = "yolov3_tpu_torch/csrc/probe.cu"
    out = []
    for core, name in (("wgmma_s8", "probe_dot_step[int8 wgmma]"),
                       ("mma_s8", "probe_dot_step[int8 mma.sync]"),
                       ("dp4a_s8", "probe_dot_step[int8 __dp4a]"),
                       ("wgmma_bf16", "probe_dot_step[bf16 wgmma]"),
                       ("grid", "probe_dot_grid")):
        v = dots[core]
        rows = v["rows"]
        worst = max(rows, key=lambda r: r["bound_ms"])
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": ("tools/bench_pallas_dot.py:47" if core == "grid"
                         else "tools/bench_int8_dot.py:56"),
            "launches": v["launches"], "max_abs_err": v["max_abs_err"],
            "ms": sum(r["us"] for r in rows) / 1e3,
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": worst["bound_by"],
            "library_ms": sum(r["library_ms"] for r in rows),
            "ms_of": f"one step at each of the tool's {len(rows)} shapes",
            **({"graph_ms": sum(r["graph_ms"] for r in rows),
                "store_graph_ms": sum(r["store_graph_ms"] for r in rows),
                "library_graph_ms": sum(r["library_graph_ms"] for r in rows)}
               if core != "grid" else
               {"graph_ms": sum(r["graph_us"] for r in rows) / 1e3,
                "product_graph_ms": sum(r["product_us"] for r in rows) / 1e3,
                "library_graph_ms": sum(r["library_graph_ms"] for r in rows),
                "best_tflops": max(r["tops"] for r in rows)}),
            "best_share_of_peak": max(r["share"] for r in rows)})
    lines = {"T3a": ("probe_int8_dot", "tools/probe_block.py:55"),
             "T3b": ("probe_round_clip", "tools/probe_block.py:78"),
             "T3c": ("probe_roll", "tools/probe_block.py:101"),
             "T3d": ("probe_mask", "tools/probe_block.py:125"),
             "T3e": ("probe_epilogue", "tools/probe_block.py:155")}
    for key, (name, replaces) in lines.items():
        v = probes[key]
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": v["launches"],
                 "max_abs_err": v["max_abs_err"], "ms": v["ms"],
                 "plain_ms": v["plain_ms"],
                 **bound(v["nbytes"], v["ops"], v.get("peak", FP32_FLOPS_PER_S)),
                 "library_ms": v.get("library_ms"),
                 "graph_ms": v["graph_ms"]}
        if "ms_dp4a" in v:
            for key in ("ms_mma", "ms_dp4a", "graph_ms", "graph_ms_mma",
                        "library_graph_ms"):
                entry[key] = v[key]
            entry["ms_of"] = ("one launch at each of the tool's 8 shapes, "
                              "wgmma core")
        out.append(entry)
    return out


def main() -> int:
    if not (REPO / "yolov3_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py: yolov3_tpu_torch/ is not beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of " + ",".join(PHASES))
    phases = parser.parse_args().phases.split(",")
    if set(phases) - set(PHASES):
        parser.error(f"unknown phases {sorted(set(phases) - set(PHASES))}")
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

    yolo = load_graph(REPO / "models" / "yolov3.cfg")
    res = {}
    if "k1" in phases:
        res["k1"] = phase_k1(yolo, "yolov3")
        phase_k1(load_graph(REPO / "models" / "yolov3-tiny.cfg"), "yolov3-tiny")
        res["k1_bf16"] = phase_k1(yolo, "yolov3", "bfloat16")
        res["k1_cases"] = phase_k1_cases(
            yolo, load_graph(REPO / "models" / "yolov3-tiny.cfg"))
    if "k1c" in phases:
        res["k1c"] = phase_k1c(yolo)
    if "k2" in phases:
        res["k2"] = phase_k2()
    if "k3" in phases:
        res["k3"] = phase_k3(yolo)
    if "k4" in phases:
        res["k4"] = phase_k4(yolo)
    if "k5" in phases:
        res["k5"] = phase_k5(yolo)
    if "int8conv" in phases:
        phase_int8conv()
    if "k6" in phases:
        res["k6"] = phase_k6()
    if "golden" in phases:
        phase_golden()
    if "main" in phases:
        res["main"] = phase_main(card)
    if "int8" in phases:
        res["int8"] = phase_int8(card)
    if "probes" in phases:
        res["probes"] = phase_probes()
    if "dots" in phases:
        res["dots"] = phase_dots(card)
    if "native" in phases:
        phase_native()
    if "entry" in phases:
        res["entry"] = phase_entry(card)
    if "serve" in phases:
        res["serve"] = phase_serve(card)
    if set(phases) != set(PHASES):
        log(f"phases run: {phases}; no result printed for a partial run")
        return 0
    launches = res["main"]
    k1_err = max(res["k1"][0], res["k1_bf16"][0], res["k1_cases"])
    k1, k1b, k1c = res["k1"][1], res["k1_bf16"][1], res["k1c"][1]
    k2_err, k2 = res["k2"]
    k4_err, k4 = res["k4"]
    k5_err, k5 = res["k5"]
    k6_err, k6 = res["k6"]
    k3 = res["k3"]
    bf16 = torch.bfloat16
    # bounds: the larger of bytes over the memory rate (each input read
    # once, each output written once) and operations over the unit's peak
    grids = [416 // s for s in yolo.head_strides()]
    n_cand = sum(len(n.anchors) * g * g for n, g in zip(yolo.yolo_nodes, grids))

    def bound(nbytes: float, ops: float = 0.0, peak: float = FP32_FLOPS_PER_S):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
        return {"bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}

    pre_elems = k4_flop = 0
    for yn, g in zip(yolo.yolo_nodes, grids):
        hc = yolo.nodes[yn.inputs[0]]
        cin = yolo.nodes[hc.inputs[0]].out_channels
        pre_elems += BATCH * g * g * cin + cin * hc.filters
        k4_flop += 2 * BATCH * g * g * cin * hc.filters
    k5_bytes = k5_flop = 0
    for (h, w, cin, cout), count in k5_shapes(yolo).items():
        k5_bytes += count * 2 * (BATCH * h * w * (cin + cout) + 9 * cin * cout)
        k5_flop += count * 2 * BATCH * h * w * 9 * cin * cout
    k6_forward = [sum(n * k6[shape][i] for n, shape in zip((2, 8), K6_SHAPES))
                  for i in (0, 1, 2, 4)]
    kernels = {"kernels": [
        {"name": "decode_packed", "route": "cuda",
         "source": "yolov3_tpu_torch/csrc/decode_packed.cu",
         "headers": ["yolov3_tpu_torch/csrc/decode_common.cuh",
                     "yolov3_tpu_torch/csrc/wgmma_common.cuh"],
         "replaces": "yolov3_tpu/ops/pallas_decode.py:626",
         "launches": launches["decode_packed"],
         "launches_int8_path": res["int8"]["decode_packed"],
         "max_abs_err": k1_err, "ms": k1["ms"], "ms_eager": k1["ms_eager"],
         "plain_ms": k1["plain_ms"], **bound(k1["bytes"]), "library_ms": None,
         "heads_ms": k1["heads_ms"], "ms_bf16": k1b["ms"],
         "ms_eager_bf16": k1b["ms_eager"], "plain_ms_bf16": k1b["plain_ms"],
         "bound_ms_bf16": bound(k1b["bytes"])["bound_ms"],
         "heads_ms_bf16": k1b["heads_ms"]},
        {"name": "nms_suppress", "route": "cuda",
         "source": "yolov3_tpu_torch/csrc/nms_suppress.cu",
         "replaces": "yolov3_tpu/ops/pallas_nms.py:65",
         "launches": launches["nms_suppress"],
         "launches_int8_path": res["int8"]["nms_suppress"],
         "max_abs_err": k2_err, "ms": k2[512]["ms"],
         "ms_eager": k2[512]["ms_eager"], "plain_ms": k2[512]["plain_ms"],
         # K = 512: every pair's IoU once (about 20 float32 operations)
         **bound(BATCH * 512 * 22, BATCH * 512 * 511 / 2 * 20),
         "library_ms": None, "phase1_ms": k2[512]["phase1_ms"],
         "phase2_ms": k2[512]["phase2_ms"], "chain_max": k2[512]["chain_max"],
         "by_k": {str(k): v for k, v in k2.items()}},
        {"name": "decode_compact", "route": "cuda",
         "source": "yolov3_tpu_torch/csrc/decode_packed.cu",
         "replaces": "yolov3_tpu/ops/pallas_decode.py:731",
         "launches": launches["decode_compact"],
         "max_abs_err": res["k1c"][0], "ms": k1c["ms"],
         "ms_eager": k1c["ms_eager"], "plain_ms": k1c["plain_ms"],
         **bound(k1c["bytes"]), "library_ms": None},
        {"name": "decode_all", "route": "cuda",
         "source": "yolov3_tpu_torch/csrc/decode_full.cu",
         "headers": ["yolov3_tpu_torch/csrc/decode_common.cuh",
                     "yolov3_tpu_torch/csrc/wgmma_common.cuh"],
         "replaces": "yolov3_tpu/ops/pallas_decode.py:121",
         "launches": launches["decode_all"], "max_abs_err": k3["max_abs_err"],
         "ms": k3["ms"], "ms_eager": k3["ms_eager"],
         "plain_ms": k3["plain_ms"], "plain_ms_of": "eager event mean",
         "bound_ms": k3["bound_ms"], "bound_by": "bytes", "library_ms": None,
         "ms_bf16": k3["ms_bf16"], "plain_ms_bf16": k3["plain_ms_bf16"],
         "bound_ms_bf16": k3["bound_ms_bf16"], "ablated": k3["ablated"],
         "ablated_bf16": k3["ablated_bf16"]},
        {"name": "decode_packed_fused_head", "route": "cuda",
         "source": "yolov3_tpu_torch/csrc/decode_fused.cu",
         "headers": ["yolov3_tpu_torch/csrc/wgmma_common.cuh",
                     "yolov3_tpu_torch/csrc/decode_common.cuh"],
         "replaces": "yolov3_tpu/ops/pallas_decode.py:511",
         "launches": launches["decode_packed_fused_head"],
         "launches_int8_path": res["int8"]["decode_packed_fused_head"],
         # the three heads at bf16, each one call replayed from a CUDA graph
         "max_abs_err": k4_err, "ms": k4[bf16][0], "plain_ms": k4[bf16][1],
         **bound(2 * pre_elems + 32 * BATCH * n_cand, k4_flop, BF16_FLOPS_PER_S),
         # no single call: the cuDNN 1x1 head conv followed by K1
         "library_ms": k4[bf16][2], "ms_float32": k4[torch.float32][0],
         "ms_eager": k4[bf16][3]},
        {"name": "conv3x3_fused", "route": "cuda",
         "source": "yolov3_tpu_torch/csrc/conv3x3.cu",
         "headers": ["yolov3_tpu_torch/csrc/conv3x3_mma.cuh",
                     "yolov3_tpu_torch/csrc/wgmma_common.cuh"],
         "replaces": "yolov3_tpu/ops/pallas_conv.py:289",
         "launches": launches["conv3x3_fused"], "max_abs_err": k5_err,
         "ms": k5[bf16][0], "plain_ms": k5[bf16][1],
         **bound(k5_bytes, k5_flop, BF16_FLOPS_PER_S),
         "library_ms": k5[bf16][2]},
        {"name": "residual_block_int8", "route": "cuda",
         "source": "yolov3_tpu_torch/csrc/block_int8.cu",
         "headers": ["yolov3_tpu_torch/csrc/wgmma_common.cuh",
                     "yolov3_tpu_torch/csrc/block_int8_common.cuh"],
         "replaces": "yolov3_tpu/ops/pallas_block.py:222",
         "launches": res["int8"]["residual_block_int8"], "max_abs_err": k6_err,
         # one forward's ten launches (2 at 104x104 C=128, 8 at 52x52 C=256):
         # each time is 2 x the first shape's + 8 x the second's, one call
         # of each replayed from a CUDA graph
         "ms": k6_forward[0], "plain_ms": k6_forward[1],
         "bound_ms": k6_forward[2],
         "ms_of": "one forward: 2 launches at 104x104 C=128 + 8 at 52x52 C=256",
         "bound_by": ("operations" if all(k6[shape][3] == "operations"
                                          for shape in K6_SHAPES) else "bytes"),
         # the block's two bare int8 products on torch._int_mm: a yardstick,
         # not the same function (no epilogues, mid tile or shortcut)
         "library_ms": k6_forward[3]},
        *probe_records(res["dots"], res["probes"], bound),
    ]}
    for entry in kernels["kernels"]:
        if entry["name"] in res["entry"]:
            entry["launches_entry_path"] = res["entry"][entry["name"]]
            entry["launches_serve_path"] = res["serve"][entry["name"]]
    log(card)
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
