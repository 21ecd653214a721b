#!/usr/bin/env python3
"""On-card check of the PyTorch port's serving routes (one CUDA device).

    python3 chip_smoke.py [--phases k1,k1c,k2,k3,k4,k5,int8conv,k6,golden,main,int8,
                                    eval,cache,profile,probes,dots,native,entry,
                                    serve,mesh,tools,bench,epilogue,requant]

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
6. K4 (head-fused decode: a tensor-core kernel at bf16, split TF32 at
   float32) at the three yolov3@416 B=8 pre-head shapes, float32 and bf16
   operands (bf16 over four seeds), then off the main path at B=1, at 608,
   on tiny, with 20, 150 and 251 classes, on a channel slice, and the
   inputs it must refuse; 601 classes (darknet's Open Images head: three
   256-column pieces an anchor, ties across pieces keeping the first
   class) at bf16 and float32, timed, and one captured 601-class
   ``Detector`` call equal to its eager run; per head and over the three,
   the kernel's, its plain version's and cuDNN 1x1 + K1's device time from
   replayed CUDA graphs (at float32 with TF32 allowed and off), each
   kernel's share of its bound (at float32 the split-TF32 floor), and the
   time at each tile choice at both types;
7. K5 (fused 3x3 conv: a tensor-core kernel at bf16, split TF32 at
   float32) at every distinct eligible yolov3@416 B=8 layer shape, at
   three ragged shapes, one yolov3@608 layer and an odd Cout, and on
   strided views, float32 and bf16, leaky and linear, a bias in either
   type; per shape the kernel's and cuDNN's device time from replayed CUDA
   graphs (at float32 with TF32 allowed and off) and the share of the
   bound; both tile heights at both types;
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
10. the golden fixtures (``tests/data/golden_{tiny,yolov3,spp}.json``)
    replayed at precision "highest" through the Detector's captured
    programs (``detect_batch``) on its routes: K1, the plain compact
    decode, K4, and K5 convs; each program's results equal the eager
    ``_run``'s bit for bit;
11. main, the full-width float path: a 248,007,048-byte yolov3 ``.weights``
    file through ``Darknet.load_weights``, then ``Detector.detect_batch``
    at 416 on 8 frames of 480x640: yolov3 precision None (K1), bf16 (K1 on
    bf16 maps), bf16 with the fused head (K4), bf16 with the fused head and
    fused convs (K4, K5), None on the compact route, yolov3-tiny, "highest"
    (K1), and "highest" and None with the fused head and fused convs (the
    float32 forms of K4 and K5, split TF32); each
    route eager (``_run``) and through its captured program: the warm-up
    and capture launch each wrapper twice a forward's count (K1 1, K2 1,
    K4 3, K5 29), a steady call is one replay and no eager launch, the
    results equal the eager ones bit for bit; both per-call times, the
    program's device time by replay, its share of the call and its memory;
    the three bf16 routes by stage (eager), their walks' and decodes'
    device time from replayed CUDA graphs, which of K1's paths the heads
    took and K2 on the selection's real candidates (exact, each phase
    timed); the frames' staging pageable against pinned; ``set_params``
    after a capture against a fresh Detector; ``forward_compact`` through
    K1c against the plain compact decode; ``Darknet(x)`` through ONE K3
    launch; and the bf16 parity bar against "highest";
12. int8, the full-width int8 tier: ``quantize_int8`` of yolov3 on 8 seeded
    frames on the card, then ``detect_batch`` through the int8 carrier with
    K6 blocks (K1 and K4 decode), with unfused blocks, the asymmetric
    scheme and the bf16 carrier, each eager and captured as in 11 (K6 10
    launches a forward on the K6 routes), with its stage split; identical
    detections for fused and unfused blocks; the state file's round trip,
    and ``load_quantized`` after a capture giving each state's own
    detections; bf16 against int8, captured, at B=8 and 128; the DESIGN
    int8 bar against float32 on tiny@416;
13. eval: ``tests/data/eval_golden.json`` on the card through captured
    programs, with the port's copies of the fixture's generator
    (``tools/gen_eval_golden.py``) and scorer (``tools/eval_coco.py``):
    float32 "highest" at mAP50 = mAP50_95 = 1.0 exactly, int8 symmetric and
    asymmetric (calibrated on the card) over the fixture's floors, each call
    one replay and no eager launch, captured == eager bit for bit; then
    ``run_model_on_coco`` on a synthetic COCO directory of the same frames
    and the offline mode (``--detections``) on what the CLI's ``--save-json``
    wrote for the same directory;
14. cache: the program cache bounded by bytes, yolov3@608 bf16 + K1 at
    B=128 over eight source shapes (360x640 to 1080x1920, about 88 GB of
    programs by area) and the first again: no out-of-memory error, the
    programs' bytes under the Detector's budget after every call, each
    program's MiB, warm-up + capture time and evictions logged; captured ==
    eager bit for bit on the last shape and on the first, evicted and
    captured again;
15. profile: ``tools/profile_layers.py`` on yolov3@416 B=8 bf16 with a
    mark at every layer, with cuDNN convs and with K5, by graph replay (the
    full-depth prefix's head maps equal ``forward_features``' bit for bit,
    K5 29 launches a full walk), beside the whole walk's replay; then
    ``tools/profile_int8.py``'s stages on yolov3@416 B=8 symmetric, blocks
    unfused and through K6 (10 launches a walk);
16. probes: the ingredient kernels T3a-e (int8 dot on ``wgmma``, on
    ``mma.sync`` and on ``__dp4a``, round / clip, the row shifts, the edge
    mask, the float epilogue) against their plain versions and the tool's
    exact host values, then ``tools.probe_block``'s full blocks and chain
    prefixes: 0 differences everywhere; T3b and T3e also at ragged sizes,
    off the 16-byte grid and at K6's epilogue size (11,075,584 elements);
    T3a-e by graph replay beside their wrapper times, and T3c's two outputs
    as two ``torch.roll`` calls (its library call; T3b, T3d and T3e have
    none); T3b and T3e at K6's size beside ``copy_`` of the same bytes
    (``tools.bench_requant``), T3b-e beside the launch floor (one float's
    ``zero_()``);
17. dots: T1 (int8 ``wgmma``, int8 ``mma.sync``, int8 ``__dp4a``, bf16
    ``wgmma``) and T2 over the tools' shape lists, checked against their
    plain versions, then timed by the tools' own clocks: time per step,
    useful rate, share of the card's peak (above 100% fails), the library's
    product at the same shape; T1's step, its store mode (the bare product,
    exact at int8) and the library products also as device time alone
    (replayed CUDA graphs), shape by shape; T2 (all three products on
    ``wgmma``) by graph replay whole and as its bare products (the
    ``-DT2_SKIP_PROJECT`` build), the library's product by graph replay, the
    tile plan and the useful share of the issued products;
18. native: the C++ host loader built with g++ (required here), its
    letterbox and stretch held to the device preprocess on seeded frames;
19. entry, the entry-point path at full width (yolov3@416, bf16, batch 8,
    frames of four sizes): ``detect_mixed`` against ``detect_preletterboxed``
    (exact) and against per-frame ``detect_batch`` (gated on tiny@416),
    ``scan=4`` (ONE captured graph of the four sub-batches) against the
    same sub-batches at ``scan=1`` (exact) and the convs whose result
    depends on the batch size, ``PipelinedDetector(depth=2)`` (replays on
    its own stream) against the synchronous calls;
20. serve: ``serve()`` on 127.0.0.1 with the micro-batcher over the same
    model: requests one at a time and 16 from 8 threads (PNG bytes to
    ``/detect`` where cv2 is installed), ``/healthz``, ``/stats``,
    ``/metrics``, then a graceful shutdown that releases the port; each
    device batch one replay of the program the server's warm-up captured;
    a lone canvas captured at B=1 against padded to B=8;
21. mesh, ``parallel/`` at full width on every visible card, or on
    ``cuda:0`` twice where there is one card (a virtual mesh): batch-DP
    yolov3@416 B=8 on bf16 + K1, bf16 + K4 + K5, int8 K6 + K1 and bf16 +
    K1 with ``scan=2``, each replica's captured program equal bit for bit
    to one device's at the same B/n sub-batch over ten calls on distinct
    frames from one caller array overwritten after each call, and captured
    == eager; the call and its ``h2d_s`` / ``dispatch_s`` /
    ``device_fetch_s`` medians beside one device's at B=8;
    ``PipelinedDetector(depth=2)`` on the mesh equal to the synchronous
    calls, with the time a ``submit`` holds the host; no page-locked host
    allocation in steady calls; spatial yolov3@416 B=1
    "highest" and bf16 at n = 2 and 4 (head maps within the reference's
    bars at "highest", crossover and FLOP fractions, the collectives of a
    call and the bytes they move between shards and between cards, those
    copies alone by graph replay, the program ONE graph captured over the
    mesh's cards and equal to the eager ``_run`` bit for bit, no wrapper
    launch in its replays, its replay's device time and its call beside
    one device's at B=1; the peer access of each pair of cards); tiny@416
    spatial detection sets equal to one device's (K1c and K2 inside the
    program); ``parallel.dryrun.dryrun_multichip(2)``;
22. tools, the parameter checkpoint and the port's measuring tools at full
    width: ``save_params`` / ``load_params`` exact and a captured call on
    the reloaded tree equal to the original's; ``tools.gen_golden``'s three
    fixtures against the frozen ones; ``tools.bench_serve`` (yolov3@416
    bf16, one request at a time and 16 clients under a 5 ms window, 0
    errors); ``tools.bench_scan``
    (scanned == unscanned, bf16 + K1 and int8 K6 + K1); ``tools.bench_tiny_k``
    (the truncation audit, then each K's time); ``tools.bench_stem``;
    ``tools.traffic_model``'s floors beside the profilers' marks; the
    selection microbenches, each variant checked exactly before it is
    timed; ``tools.probe_quant_error`` (mode ``none`` at mAP 1.0 exactly);
23. bench, the port's benchmark (``yolov3_tpu_torch/bench.py``): its step
    (``make_step``, yolov3@416 bf16 B=8 ``scan=2``) captured as one CUDA
    graph equal, step by step, to the eager step bit for bit, K1 and K2
    launched once a forward by the warm-up and the capture and never by
    the replays; then ``python -m yolov3_tpu_torch.bench --quick`` and the
    default matrix (yolov3@608 and @416 B=128 bf16 and int8, K6, tiny@416,
    yolov3@320, spp@608, K4 at bf16 and int8, latency at B=1 and 8) with
    its own ``--deadline``, as subprocesses: every row measured, none with
    ``error``; both last lines are printed before the kernels' record;
24. epilogue, the float walk's conv epilogue (bias, activation and the
    shortcut's add in one pass over a cuDNN conv's output): bit for bit
    against the PyTorch chain it replaces and its plain version at every
    yolov3@608 conv output shape at B=32 and B=8 in bf16 (the 255-channel
    heads, -0, +-inf and a subnormal among the values) and at three shapes
    in float32, with and without a residual; one forward's 75 epilogues by
    graph replay beside their bound, the library chain and the plain
    version; ``forward_packed`` launching it 75 times a forward, 23 with a
    residual; the head maps equal bit for bit to the walk node by node
    with biased cuDNN convs;
25. requant, the int8 walk's requantize pass (an int8 conv's int32 sums
    to its next activation, with the shortcut after it, in one pass): a
    yolov3@608 int8 state calibrated on the card, one eager walk at B=32
    with K6 blocks recording each pass's operands (51 a forward, 13 with a
    shortcut), the kernel bit for bit against its plain version (the chain
    it replaces, on PyTorch's kernels) on every one of them, on edge sums
    at every activation and on a quantized head's 255 sums in rows 256
    apart, 0 elements differing; the head maps equal bit for bit to the
    walk that runs the plain version; the 51 passes by graph replay beside
    their bound (bytes at HBM's rate) and the plain version; K6's time in a
    captured forward beside the pass and beside the chain, with the SM
    clock and board power meanwhile; a captured K6 + K1 Detector launching
    the pass 51 times a forward, 13 with a shortcut, in its warm-up and its
    capture, and none in its replays. The int8 phase and every main-path
    capture hold the pass's launches to ``requant_launches``.

Every kernel's launch count is zeroed just before phases 11 to 15, 20, 22
and 23 (in 20 after the server's own warm-up), in 21 read before and after each
mesh Detector's calls (the single-device references are not counted and
each kernel of the path must have run), in 19 just before one
``detect_mixed`` call and before the pipelined batches, in 16 and 17 before
the tools' runs, and read just after (13 and 14 count only the programs'
warm-ups and captures: K1 and K2 once a forward in each). A wrapper counts
where it launches its kernel: in a Detector program's warm-up forward and
in its capture (on the K1 route K1 once for all its heads, K2 once); a
steady call replays the graph and counts one replay and no launch: checked
route by route in 11 to 14, and in 19 and 20 against the calls and device
batches made. The last two lines of standard output are the kernels' JSON
record and ``{"ok": true, "device": {...}}`` (printed only when every phase
ran). Exits non-zero, and prints neither, when CUDA is unavailable or the
port is not beside this script.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np

# the card's published peaks (NVIDIA H100 SXM data sheet), for the bounds:
# one definition, the port's traffic model's (outside a checkout this
# import fails, and the script with it)
from yolov3_tpu_torch.tools.traffic_model import (
    BF16_FLOPS_PER_S, FP32_FLOPS_PER_S, HBM_BYTES_PER_S, INT8_OPS_PER_S,
    TF32_FLOPS_PER_S)

REPO = Path(__file__).resolve().parent
DEVICE = "cuda"
BATCH = 8
SRC_HW = (480, 640)
PHASES = ("build", "k1", "k1c", "k2", "k3", "k4", "k5", "int8conv", "k6",
          "golden", "main", "int8", "eval", "cache", "profile", "probes",
          "dots", "native", "entry", "serve", "mesh", "tools", "bench",
          "epilogue", "requant")
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
# the DESIGN int8 bar (tests/test_quant.py): pre-NMS, the float32 forward's
# top-200 candidates per image
INT8_BAR_TOP, INT8_BAR_SCORE, INT8_BAR_BOX = 200, 0.01, 0.5
K6_BLOCKS_YOLOV3 = 10  # fused_block_plan on models/yolov3.cfg (the JAX plan's count)
# the float32 forms of K4 and K5 run split TF32: three TF32 products a
# product, so their floor is three times the work at the TF32 peak
TF32X3_FLOPS_PER_S = TF32_FLOPS_PER_S / 3


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line(device=None) -> str:
    """The name and power limit of the card ``device`` (``cuda:0`` by
    default) is, found by its UUID (``bench.smi_id``: nvidia-smi's own
    numbering ignores ``CUDA_VISIBLE_DEVICES``)."""
    import torch
    from yolov3_tpu_torch.bench import smi_id

    device = torch.device(DEVICE, 0) if device is None else device
    out = subprocess.run(["nvidia-smi", f"--id={smi_id(device)}",
                          "--query-gpu=name,power.limit",
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
    read once, the records written once; operations at the rate of x's
    type on the kernel's route (bf16 on the tensor cores; float32 as split
    TF32, a third of the TF32 peak)."""
    import torch

    bsz, g, _, cin = x.shape
    es = x.element_size()
    flop = 2 * bsz * g * g * cin * cout
    nbytes = es * (bsz * g * g * cin + cin * cout) + 32 * bsz * n_anchors * g * g
    peak = BF16_FLOPS_PER_S if x.dtype == torch.bfloat16 else TF32X3_FLOPS_PER_S
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, flop / peak * 1e3
    return flop, nbytes, max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def phase_k4(graph):
    """K4 at yolov3@416 B=8's three pre-head shapes, float32 and bf16
    operands, bf16 over four seeds; off the main path yolov3@416 B=1,
    yolov3@608, yolov3-tiny, 20-, 150- and 251-class heads, a strided view
    and the refusals; both tile heights at both types. Times (graph
    replay): K4, its plain version, cuDNN 1x1 head conv + K1 (at float32
    with TF32 allowed, and off as precision "highest" runs it), per head and
    over the three, with each kernel's share of its bound (at float32 the
    split-TF32 floor)."""
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
        tot = [0.0, 0.0, 0.0, 0.0, 0.0]
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
            lib_off_ms = lib_ms  # TF32 does not touch a bf16 conv
            if dtype == torch.float32:
                with tf32(False):  # as precision "highest" runs it
                    lib_off_ms = graph_ms(unfused)
            flop, nbytes, bound_ms, by = k4_bound(x, w.shape[0], len(a))
            for i, t in enumerate((ms, plain_ms, lib_ms, lib_off_ms,
                                   bound_ms)):
                tot[i] += t
            log(f"[K4] {name} head {x.shape[1]}x{x.shape[2]} Cin {x.shape[3]} "
                f"B={BATCH}: kernel {ms * 1e3:.2f} us ({flop / ms / 1e9:.1f} "
                f"TFLOP/s, bound {bound_ms * 1e3:.2f} us by {by} = "
                f"{bound_ms / ms:.1%} of it), plain {plain_ms * 1e3:.1f} us, "
                f"cuDNN 1x1 + K1 {lib_ms * 1e3:.2f} us"
                + (f" with TF32, {lib_off_ms * 1e3:.2f} us without"
                   if dtype == torch.float32 else "")
                + " (graph replays, L2-hot)")
            off += len(a) * x.shape[1] * x.shape[2]
        flop = sum(k4_bound(x, w.shape[0], len(a))[0]
                   for (x, w, _), a in zip(heads, anchors))
        times[dtype] = (*tot, eager_ms)
        log(f"[K4] yolov3@416 B={BATCH} {name} all three heads: kernel "
            f"{tot[0]:.4f} ms ({flop / tot[0] / 1e9:.1f} TFLOP/s, "
            f"{tot[4] / tot[0]:.1%} of its bound {tot[4]:.4f} ms"
            + (", the split-TF32 floor" if dtype == torch.float32 else "")
            + f"), plain {tot[1]:.4f} ms, cuDNN 1x1 + K1 {tot[2]:.4f} ms"
            + (f" with TF32, {tot[3]:.4f} ms without"
               if dtype == torch.float32 else "")
            + f" (graph replays); eager wrapper calls (CUDA events) "
            f"{eager_ms:.4f} ms")
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
    before = decode_packed_fused_head.launches
    for bad in (wide[..., 4:516], torch.cat([x, x[..., :4]], dim=3)[..., :512],
                torch.cat([x, x], dim=3)[..., ::2]):
        try:
            decode_packed_fused_head(bad, w, b, anchors[1], strides[1], ncls)
        except ValueError:
            refused += 1
    torch.cuda.synchronize()
    if refused != 3 or decode_packed_fused_head.launches != before:
        raise AssertionError(f"K4 took {3 - refused} of three inputs it must "
                             f"refuse")
    log(f"[K4] a channel slice (pixel stride 512, base 256 bytes in) within "
        f"bars, max |err| {err!r}; refused a base 8 bytes in, a pixel stride "
        f"of 260 and a channel stride of 2, with no launch")
    # the tile plan on the card: both heights, and one or two resident
    # blocks where a head's K allows two (bf16 only), at each main-path head
    # and at the 13x13 head at one image, at both types, held to the bars
    # and timed
    plan = cuda_decode.plan_fused_tiles
    for dtype, (bsz, gi) in [(dt, case) for dt in (torch.bfloat16, torch.float32)
                             for case in ((BATCH, 0), (BATCH, 1), (BATCH, 2),
                                          (1, 0))]:
        x, w, b = k4_heads(graph, 416, bsz, rng, dtype=dtype)[gi]
        per, a, s, cin = 5 + ncls, anchors[gi], strides[gi], x.shape[3]
        m = bsz * x.shape[1] * x.shape[2]
        chosen = plan(m, per, len(a), cin, sm_count(x.get_device()),
                      x.element_size())
        tile_us = {}
        for block_m in (64, 128):
            for resident in (1, 2):
                if resident == 2 and (dtype == torch.float32 or cin > 256
                                      or block_m + chosen.n_tile > 224):
                    continue
                cuda_decode.plan_fused_tiles = (
                    lambda *args, t=chosen._replace(block_m=block_m,
                                                    resident=resident): t)
                try:
                    k4_check([(x, w, b)], [a], [s], ncls,
                             f"K4 B={bsz} {x.shape[1]}x{x.shape[2]} "
                             f"{str(dtype)[6:]} {block_m}-row tiles, "
                             f"{resident} resident")
                    tile_us[block_m, resident] = 1e3 * graph_ms(
                        lambda: decode_packed_fused_head(x, w, b, a, s, ncls, 0.2))
                finally:
                    cuda_decode.plan_fused_tiles = plan
        log(f"[K4] B={bsz} {x.shape[1]}x{x.shape[2]} Cin {cin} {str(dtype)[6:]} "
            f"by (tile rows, resident blocks): " + ", ".join(
                f"{k} {v:.2f} us" for k, v in tile_us.items())
            + f"; plan_fused_tiles takes {tuple(chosen)}")
    # last, so that the cases above draw the same operands as before
    times["open_images"] = k4_open_images(graph, rng)
    max_err = max(max_err, times["open_images"].pop("max_abs_err"))
    return max_err, times


OPEN_IMAGES = 601  # classes of darknet's yolov3-openimages.cfg


def open_images_graph(graph):
    """``graph`` with 601 classes at every head (darknet's
    yolov3-openimages.cfg: head convs of 3 x 606 filters), made with
    ``dataclasses.replace``."""
    import dataclasses

    nodes = list(graph.nodes)
    for yn in graph.yolo_nodes:
        cout = len(yn.anchors) * (5 + OPEN_IMAGES)
        hc = nodes[yn.inputs[0]]
        nodes[hc.index] = dataclasses.replace(hc, filters=cout,
                                              out_channels=cout)
        nodes[yn.index] = dataclasses.replace(yn, classes=OPEN_IMAGES,
                                              out_channels=cout)
    return dataclasses.replace(graph, nodes=tuple(nodes))


def k4_open_images(graph, rng) -> dict:
    """K4 on a 601-class yolov3@416 B=8 (5 + C = 606 columns an anchor: the
    kernel's three pieces of 256) at bf16 and float32 against its plain
    version within K4's bars, with anchor 1 of every head given three equal
    top logits in three pieces (classes 100, 400 and 600: zero weights and
    the same bias, exact in any order): its class must be 100, the first.
    Timed by graph replay over the three heads beside the plain version and
    the bound; then one captured bf16 Detector call on the graph (route
    "pallas-fused": K4 in its program) equal to the eager ``_run``."""
    import torch
    from yolov3_tpu_torch import Darknet, Detector
    from yolov3_tpu_torch.ops.cuda_decode import (
        decode_packed_fused, decode_packed_fused_head,
        decode_packed_fused_head_reference)
    from yolov3_tpu_torch.weights import fold_raw, random_raw

    oi = open_images_graph(graph)
    anchors, strides, ncls = head_spec(oi)
    per = 5 + ncls
    out = {"max_abs_err": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        heads = k4_heads(oi, 416, BATCH, rng, dtype=dtype)
        for _, w, b in heads:
            for k in (100, 400, 600):
                w[per + 5 + k] = 0
                b[per + 5 + k] = 8.0
        err, near = k4_check(heads, anchors, strides, ncls,
                             f"K4 {OPEN_IMAGES} classes {name}")
        xs, ws, bs = zip(*heads)
        got, _ = decode_packed_fused(xs, ws, bs, anchors, strides, ncls, 0.2)
        off = 0
        for x, a in zip(xs, anchors):
            cells = x.shape[1] * x.shape[2]
            tied = got[:, off + cells:off + 2 * cells, 5]
            if not bool((tied == 100).all()):
                raise AssertionError(f"K4 {OPEN_IMAGES} classes {name}: a tie "
                                     f"across pieces did not keep the first "
                                     f"class")
            off += len(a) * cells
        ms = graph_ms(lambda: decode_packed_fused(xs, ws, bs, anchors,
                                                  strides, ncls, 0.2))
        offs = np.cumsum([0] + [len(a) * x.shape[1] * x.shape[2]
                                for x, a in zip(xs, anchors)])
        plain_ms = graph_ms(lambda: [decode_packed_fused_head_reference(
            x, w, b, a, s, ncls, 0.2, int(o)) for (x, w, b), a, s, o in zip(
                heads, anchors, strides, offs)], iters=5, warmup=1)
        bounds = [k4_bound(x, w.shape[0], len(a))
                  for (x, w, _), a in zip(heads, anchors)]
        bound_ms = sum(bd[2] for bd in bounds)
        flop = sum(bd[0] for bd in bounds)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "max_abs_err": err}
        out["max_abs_err"] = max(out["max_abs_err"], err)
        log(f"[K4] yolov3@416 B={BATCH} with {OPEN_IMAGES} classes ({per} "
            f"columns an anchor, pieces of 256) {name}: within bars, max "
            f"|err| {err!r} ({near} cell-anchors inside the class margin), "
            f"the ties across pieces keep class 100; all three heads kernel "
            f"{ms:.4f} ms ({flop / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.1%} "
            f"of its bound {bound_ms:.4f} ms), plain {plain_ms:.4f} ms "
            f"(graph replays)")
    net = Darknet(REPO / "models" / "yolov3.cfg", precision="bf16",
                  device=DEVICE)
    net.graph = oi
    net.set_params(fold_raw(random_raw(oi, seed=0)))
    det = Detector(net, decode_impl="pallas-fused")
    if det.route != "pallas-fused":
        raise AssertionError(f"the {OPEN_IMAGES}-class graph took route "
                             f"{det.route}")
    frames = np.random.default_rng(3).integers(0, 256, (BATCH, *SRC_HW, 3),
                                               dtype=np.uint8)
    k4 = decode_packed_fused_head.launches
    det.detect_batch(frames)
    if decode_packed_fused_head.launches - k4 != 2 * len(oi.yolo_nodes):
        raise AssertionError("the warm-up and capture did not launch K4 once "
                             "a head each")
    k4 = decode_packed_fused_head.launches
    res, host, dev = timed_calls(lambda: det.detect_batch(frames), 10)
    if decode_packed_fused_head.launches != k4:
        raise AssertionError("a steady call launched K4 outside its replay")
    eager = det._run(det._stage(frames)).cpu()
    if not torch.equal(eager, det._detect(frames, SRC_HW, None)[0]):
        raise AssertionError(f"{OPEN_IMAGES} classes: captured != eager")
    out["detector"] = {"host_ms": float(np.median(host)),
                       "event_ms": float(np.median(dev)),
                       "detections": [len(r.class_idx) for r in res]}
    log(f"[K4] a {OPEN_IMAGES}-class yolov3@416 bf16 Detector, route "
        f"pallas-fused, B={BATCH}: captured == eager bit for bit; per call "
        f"median over 10 {out['detector']['host_ms']:.3f} ms host clock / "
        f"{out['detector']['event_ms']:.3f} ms CUDA events; detections "
        f"{out['detector']['detections']}")
    del det, net
    torch.cuda.empty_cache()
    return out


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
    """K5 at every distinct eligible yolov3@416 B=8 layer shape and the
    extra shapes, float32 (split TF32) and bf16, within the bars; per shape
    the kernel, its plain version and cuDNN + leaky (at float32 with TF32
    allowed, and off as precision "highest" runs it) by graph replay, with
    the kernel's share of its bound (at float32 the split-TF32 floor); both
    tile heights at both types; strided views."""
    import torch
    import torch.nn.functional as F
    from yolov3_tpu_torch.ops import cuda_conv
    from yolov3_tpu_torch.ops._build import sm_count
    from yolov3_tpu_torch.ops.cuda_conv import (conv3x3_fused,
                                                conv3x3_fused_reference,
                                                plan_tiles)
    from yolov3_tpu_torch.precision import tf32

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

            def cudnn():
                return F.leaky_relu(F.conv2d(xc, wt, b, padding=1), 0.1)

            # what the main path runs without K5: cuDNN in the working type
            # (float32: TF32 allowed, as at precision None; and off, as at
            # "highest"), then leaky
            with tf32(True):
                cudnn_ms = graph_ms(cudnn)
            cudnn_off_ms = cudnn_ms  # TF32 does not touch a bf16 conv
            if dtype == torch.float32:
                with tf32(False):
                    cudnn_off_ms = graph_ms(cudnn)
            size = x.element_size()
            flop = 2 * bsz * h * w * cin * cout * 9
            nbytes = size * (bsz * h * w * (cin + cout) + 9 * cin * cout)
            peak = (BF16_FLOPS_PER_S if dtype == torch.bfloat16
                    else TF32X3_FLOPS_PER_S)
            bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, flop / peak)
            if count:
                tot = totals.setdefault(dtype, [0.0] * 5)
                for i, t in enumerate((ms, plain_ms, cudnn_ms, cudnn_off_ms,
                                       bound_ms)):
                    tot[i] += count * t
            log(f"[K5] {what} x{count} layers: leaky/linear within bars; "
                f"kernel {ms:.4f} ms ({flop / ms / 1e9:.1f} TFLOP/s, bound "
                f"{bound_ms:.4f} ms = {bound_ms / ms:.1%} of it), plain "
                f"{plain_ms:.4f} ms, cuDNN {cudnn_ms:.4f} ms"
                + (f" with TF32, {cudnn_off_ms:.4f} ms without"
                   if dtype == torch.float32 else "")
                + " (all: one call repeated in a CUDA graph, operands hot "
                "in L2)")
    # the tile rule (plan_tiles) on the card: each main-path shape at one
    # image, where 64-row tiles each get a multiprocessor, and at the
    # batch, where they do not; both heights at both types held to the
    # bars
    for dtype, bsz, (h, w, cin, cout) in [
            (dtype, bsz, shape) for dtype in (torch.bfloat16, torch.float32)
            for bsz in (1, BATCH) for shape in sorted(shapes)]:
        x, wt, b = (t.to(dtype) for t in operands(bsz, h, w, cin, cout))
        name = str(dtype)[6:]
        chosen = cuda_conv.plan_tiles(bsz * h * w, cout,
                                      sm_count(x.get_device()),
                                      x.element_size())
        tile_ms = {}
        for block_m in (64, 128):
            cuda_conv.plan_tiles = lambda *args, block_m=block_m: block_m
            try:
                k5_check(x, wt, b, f"B={bsz} {h}x{w} {cin}->{cout} {name}, "
                                   f"{block_m}-row tiles")
                tile_ms[block_m] = graph_ms(lambda: conv3x3_fused(x, wt, b))
            finally:
                cuda_conv.plan_tiles = plan_tiles
        log(f"[K5] B={bsz} {h}x{w} {cin}->{cout} {name} by tile height: "
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
    for dtype, (ms, plain_ms, cudnn_ms, cudnn_off_ms, bound_ms) in totals.items():
        log(f"[K5] yolov3@416 B={BATCH} all {sum(shapes.values())} eligible "
            f"layers, {str(dtype)[6:]}: kernel {ms:.3f} ms ({bound_ms / ms:.1%} "
            f"of its bound {bound_ms:.3f} ms"
            + (", the split-TF32 floor" if dtype == torch.float32 else "")
            + f"), plain {plain_ms:.3f} ms, cuDNN {cudnn_ms:.3f} ms"
            + (f" with TF32, {cudnn_off_ms:.3f} ms without"
               if dtype == torch.float32 else "")
            + " (L2-hot graph replays per shape; the main phase's walk is "
            "the cold figure)")
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
    """The three frozen fixtures through the captured programs: each route's
    ``detect_batch`` captures the program of (1, 480x640, BGR) and replays
    it; the fixture is held on that program's net-pixel output, which must
    also equal the eager ``_run`` bit for bit."""
    import torch
    from yolov3_tpu_torch import Darknet, Detector
    from yolov3_tpu_torch.weights import fold_raw, random_raw

    for fixture in ("golden_tiny.json", "golden_yolov3.json", "golden_spp.json"):
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
            in_src = det.detect_batch(frames)          # captures, replays
            prog = det._pipeline(1, SRC_HW)
            replays = prog.replays
            res, _, _ = det._detect(frames, SRC_HW, None)  # the same program
            if prog.replays != replays + 1:
                raise AssertionError(f"{fixture}: the call did not replay "
                                     f"the captured program")
            eager = det._run(det._stage(frames)).cpu()
            if not torch.equal(res, eager):
                raise AssertionError(f"{fixture} {decode_impl}/{conv_impl}: "
                                     f"captured and eager results differ")
            (got,) = det._unpack(res, None)             # net pixels
            what = f"{fixture} decode_impl={decode_impl} conv_impl={conv_impl}"
            if not same_detections(in_src, det._unpack(res, SRC_HW)):
                raise AssertionError(f"{what}: detect_batch differs from its "
                                     f"program's replay")
            if len(got.class_prob) != len(golden["scores"]):
                raise AssertionError(f"{what}: {len(got.class_prob)} survivors "
                                     f"vs golden {len(golden['scores'])}")
            np.testing.assert_array_equal(got.class_idx, golden["classes"])
            np.testing.assert_allclose(got.class_prob, golden["scores"], atol=5e-5)
            np.testing.assert_allclose(got.bbox_tlbr, golden["boxes"], atol=0.1)
            err = float(np.abs(got.bbox_tlbr - np.asarray(golden["boxes"])).max())
            log(f"[golden] {what}: {len(got.class_prob)} survivors match "
                f"(max box err {err:.2e} px) through the captured program "
                f"(= eager bit for bit) on {torch.cuda.get_device_name(0)}")


class ResidualLaunches:
    """A kernel wrapper's ``residual_launches`` (``conv_epilogue``'s,
    ``int8_requant``'s) read and zeroed as ``launches``, like the wrapper's
    own count."""

    def __init__(self, wrapper):
        self.wrapper = wrapper

    @property
    def launches(self) -> int:
        return self.wrapper.residual_launches

    @launches.setter
    def launches(self, n: int) -> None:
        self.wrapper.residual_launches = n


def path_wrappers():
    """The kernel wrappers a Detector program can run, by name."""
    from yolov3_tpu_torch.ops import (cuda_block, cuda_conv, cuda_decode,
                                      cuda_epilogue, cuda_nms, cuda_requant)

    return {"decode_packed": cuda_decode.decode_packed,
            "decode_packed_fused_head": cuda_decode.decode_packed_fused_head,
            "conv3x3_fused": cuda_conv.conv3x3_fused,
            "residual_block_int8": cuda_block.residual_block_int8,
            "nms_suppress": cuda_nms.suppress,
            "conv_epilogue": cuda_epilogue.conv_epilogue,
            "conv_epilogue_residual": ResidualLaunches(
                cuda_epilogue.conv_epilogue),
            "int8_requant": cuda_requant.int8_requant,
            "int8_requant_residual": ResidualLaunches(
                cuda_requant.int8_requant)}


def epilogue_launches(graph, route: str, conv_impl: str = "xla",
                      qparams=None):
    """The epilogue kernel's launches in ONE forward (all of them, those
    with a residual): once a conv the walk runs through ``model._conv`` —
    a float walk's every conv but K5's, an int8 walk's float convs (no
    "wq" in ``qparams``) — less the head convs K4 takes over; with a
    residual where ``model.residual_convs`` hands the conv its shortcut
    (float walks; an int8 walk adds its shortcuts itself)."""
    from yolov3_tpu_torch.model import residual_convs
    from yolov3_tpu_torch.ops import cuda_conv

    heads = ({yn.inputs[0] for yn in graph.yolo_nodes}
             if route == "pallas-fused" else set())
    convs = [n for n in graph.conv_nodes if n.index not in heads]
    if qparams is not None:
        return sum("wq" not in qparams[n.index] for n in convs), 0
    convs = [n for n in convs if not (
        conv_impl == "pallas" and n.pad and cuda_conv.supported(
            n.size, n.stride, graph.nodes[n.inputs[0]].out_channels
            if n.inputs[0] >= 0 else graph.in_channels, n.activation))]
    fused = residual_convs(graph)
    return len(convs), sum(n.index in fused for n in convs)


def requant_launches(det):
    """The requantize pass's launches in ONE forward of ``det``'s route (all
    of them, those with a shortcut): in the int8-carrier walk's symmetric
    scheme once a quantized conv but the stem and K6's, less the head convs
    K4 takes over; with a shortcut where ``model.residual_convs`` hands the
    conv its shortcut. yolov3: 51 and 13 with K6's 10 blocks."""
    from yolov3_tpu_torch.model import residual_convs
    from yolov3_tpu_torch.ops import cuda_block

    net = det.net
    if not (net.quantized and net.qcarrier == "int8") or (
            net.act_zeros and any(net.act_zeros.values())):
        return 0, 0
    k6 = set()
    if det.block_impl == "pallas":
        k6 = {i for a in cuda_block.fused_block_plan(
            net.graph, net.qparams, net.act_scales) for i in (a, a + 1)}
    heads = ({yn.inputs[0] for yn in net.graph.yolo_nodes}
             if det.route == "pallas-fused" else set())
    convs = [n.index for n in net.graph.conv_nodes
             if "wq" in net.qparams[n.index] and n.inputs[0] >= 0
             and n.index not in k6 | heads]
    fused = residual_convs(net.graph)
    return len(convs), sum(i in fused for i in convs)


def forward_launches(det):
    """Kernel-wrapper launches of ONE forward of ``det``'s route: K1 once
    for all the heads, K4 once a head, K5 once an eligible 3x3 conv, K6
    once a fused block, K2 once, the conv epilogue as
    :func:`epilogue_launches` counts, the requantize pass as
    :func:`requant_launches` does."""
    from yolov3_tpu_torch.ops import cuda_block

    net = det.net
    k6 = 0
    if (net.quantized and net.qcarrier == "int8" and det.block_impl == "pallas"
            and not (net.act_zeros and any(net.act_zeros.values()))):
        k6 = len(cuda_block.fused_block_plan(net.graph, net.qparams,
                                             net.act_scales))
    return {"decode_packed": int(det.route == "pallas"),
            "decode_packed_fused_head": (len(net.graph.yolo_nodes)
                                         if det.route == "pallas-fused" else 0),
            "conv3x3_fused": (sum(k5_shapes(net.graph).values())
                              if not net.quantized and net.conv_impl == "pallas"
                              else 0),
            "residual_block_int8": k6, "nms_suppress": 1,
            **dict(zip(("conv_epilogue", "conv_epilogue_residual"),
                       epilogue_launches(net.graph, det.route, net.conv_impl,
                                         net.qparams if net.quantized
                                         else None))),
            **dict(zip(("int8_requant", "int8_requant_residual"),
                       requant_launches(det)))}


def replay_ms(prog, iters: int = 10) -> float:
    """Device ms of one replay of a captured program (back-to-back replays
    on its static input, CUDA events; no host work between them)."""
    import torch

    prog.graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        prog.graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def timed_calls(fn, calls: int):
    """``fn()`` ``calls`` times: (host-clock ms, CUDA-event ms) per call."""
    import torch

    host, dev = [], []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        dev.append(start.elapsed_time(end))
    return out, host, dev


MAIN_ROWS = []   # one per run_main_path: the route's eager and captured calls


def run_main_path(det, name: str, frames: np.ndarray, card: str,
                  calls: int = 10):
    """``det.detect_batch`` on the main path. First the eager, uncached
    calls (``_run``), timed; then ``warmup`` (one eager forward and the
    capture), whose kernel-wrapper launches must be twice one forward's
    (:func:`forward_launches`); then ``calls`` steady calls, each ONE
    replay of the captured program and no eager wrapper launch, timed;
    their detections bit-equal to the eager ``_run``'s at the same batch,
    checked for plausibility. Logs both per-call times, the program's
    device time by replay and its share of the call, and its memory."""
    import torch

    wrappers = path_wrappers()

    def counts():
        return {n: w.launches for n, w in wrappers.items()}

    def eager():
        return det._unpack(det._run(det._stage(frames)), SRC_HW)

    eager()
    _, e_host, e_dev = timed_calls(eager, calls)
    before = counts()
    det.warmup(BATCH, SRC_HW)
    per_capture = {n: v - before[n] for n, v in counts().items()}
    want = forward_launches(det)
    if per_capture != {n: 2 * v for n, v in want.items()}:
        raise AssertionError(f"{name} ({det.route}): warm-up and capture "
                             f"launched {per_capture}, expected twice one "
                             f"forward's {want}")
    prog = det._pipeline(BATCH, SRC_HW)
    replays, before = prog.replays, counts()
    stages = []

    def captured():
        got = det.detect_batch(frames)
        stages.append(det.last_stage_s)
        return got

    out, host, dev = timed_calls(captured, calls)
    steady = {n: v - before[n] for n, v in counts().items()}
    if any(steady.values()) or prog.replays - replays != calls:
        raise AssertionError(f"{name}: {calls} steady calls made "
                             f"{prog.replays - replays} replays and eager "
                             f"launches {steady}; one replay and none "
                             f"expected a call")
    ref = det._run(det._stage(frames)).cpu()
    got, _, _ = det._detect(frames, SRC_HW, None)
    if not torch.equal(ref, got):
        raise AssertionError(f"{name} ({det.route}): the captured program's "
                             f"results differ from the eager _run's")
    for d in out:
        n = len(d.class_prob)
        if not (0 < n <= det.max_results and np.isfinite(d.bbox_tlbr).all()
                and (d.class_prob >= det.prob_thresh).all()
                and (d.class_prob <= 1).all()
                and (d.bbox_tlbr[:, [0, 2]] <= SRC_HW[1]).all()
                and (d.bbox_tlbr[:, [1, 3]] <= SRC_HW[0]).all()
                and (d.bbox_tlbr >= 0).all()):
            raise AssertionError(f"{name}: implausible detections {d}")
    device_ms = replay_ms(prog)
    net = det.net
    row = {"name": name, "route": det.route, "precision": net.precision,
           "conv_impl": net.conv_impl, "eager_host_ms": float(np.median(e_host)),
           "eager_event_ms": float(np.median(e_dev)),
           "graph_host_ms": float(np.median(host)),
           "graph_event_ms": float(np.median(dev)), "replay_ms": device_ms,
           "busy": device_ms / float(np.median(host)),
           "program_mb": prog.nbytes / 2 ** 20, "per_forward": want,
           "per_capture": per_capture,
           "stages_ms": {k: float(np.median([st[k] for st in stages])) * 1e3
                         for k in stages[0]}}
    MAIN_ROWS.append(row)
    log(f"[main] {name}@416 detect_batch B={BATCH} {SRC_HW[0]}x{SRC_HW[1]} "
        f"uint8, precision={net.precision}, decode_impl={det.route}, "
        f"conv_impl={net.conv_impl}: per call median, eager "
        f"{row['eager_host_ms']:.3f} ms host clock / {row['eager_event_ms']:.3f} "
        f"ms CUDA events; captured {row['graph_host_ms']:.3f} / "
        f"{row['graph_event_ms']:.3f} ms ({calls} calls each, on {card}); "
        f"one replay alone {device_ms:.3f} ms of device time, "
        f"{row['busy']:.1%} of the captured call (last_stage_s medians, ms: "
        + ", ".join(f"{k} {v:.3f}" for k, v in row["stages_ms"].items())
        + f"); program "
        f"{row['program_mb']:.1f} MiB; wrapper launches a forward {want} "
        f"(warm-up + capture made twice that), steady calls: one replay, 0 "
        f"eager launches; captured == eager bit for bit; survivors/image "
        f"{[len(d.class_prob) for d in out]}")
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


def staging_split(det, frames: np.ndarray, calls: int = 20) -> dict:
    """The frames' copy into a captured program's static input two ways,
    from the caller's pageable array and through a pinned host buffer (a
    host copy into it, then an asynchronous device copy): the copy alone
    (each ending in a synchronise) and a whole ``detect_batch``-like call
    around each (stage, replay, one device→host copy, unpack); in turns,
    host clock, medians of ``calls``."""
    import torch

    prog = det._pipeline(BATCH, SRC_HW)
    pinned = torch.empty(tuple(prog.input.shape), dtype=torch.uint8,
                         pin_memory=True)

    def stage(way):
        if way == "pageable":
            return prog.stage(frames, det.device)
        np.copyto(pinned.numpy(), frames)
        return prog.stage_pinned(pinned)

    def copy_only(way):
        stage(way)
        torch.cuda.synchronize()

    def whole(way):
        res = prog(stage(way)).cpu()
        prog.release()
        det._unpack(res, SRC_HW)

    out = {}
    for what, fn in (("copy", copy_only), ("call", whole)):
        times = {"pageable": [], "pinned": []}
        for i in range(calls + 1):
            for way in (("pageable", "pinned") if i % 2 else ("pinned", "pageable")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(way)
                if i:
                    times[way].append((time.perf_counter() - t0) * 1e3)
        out[what] = {k: float(np.median(v)) for k, v in times.items()}
    log(f"[main] staging B={BATCH} {SRC_HW[0]}x{SRC_HW[1]} uint8 "
        f"({frames.nbytes / 2 ** 20:.2f} MiB) into a program's static input, "
        f"medians of {calls} in turns (host clock), pageable / through a "
        f"pinned buffer: the copy {out['copy']['pageable']:.3f} / "
        f"{out['copy']['pinned']:.3f} ms, a whole call "
        f"{out['call']['pageable']:.3f} / {out['call']['pinned']:.3f} ms")
    return out


def weights_swap(frames: np.ndarray) -> None:
    """``set_params`` with new weights after a capture: the Detector's next
    call builds a new program (a new key) and gives a fresh Detector's
    detections on those weights, not the captured weights'."""
    from yolov3_tpu_torch import Darknet, Detector
    from yolov3_tpu_torch.weights import fold_raw, random_raw

    net = entry_net("bf16", seed=0)
    det = Detector(net)
    before = det.detect_batch(frames)
    params = fold_raw(random_raw(net.graph, seed=5))
    net.set_params(params)
    after = det.detect_batch(frames)
    fresh = Darknet(REPO / "models" / "yolov3.cfg", precision="bf16",
                    device=DEVICE).set_params(params)
    want = Detector(fresh).detect_batch(frames)
    if not same_detections(after, want) or same_detections(after, before):
        raise AssertionError("set_params after a capture: the Detector did "
                             "not give a fresh Detector's detections")
    log(f"[main] yolov3@416 bf16 set_params(new weights) after a capture: "
        f"{len(det._pipelines)} programs cached, the next call equals a fresh "
        f"Detector's on the new weights ({[len(d.class_prob) for d in after]} "
        f"per image; {[len(d.class_prob) for d in before]} before)")


def phase_main(card: str):
    import torch
    from yolov3_tpu_torch import (Darknet, Detector, forward_compact,
                                  forward_features)
    from yolov3_tpu_torch.ops import cuda_conv, cuda_decode, cuda_epilogue, cuda_nms
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
                                ("bf16", "bf16", "xla"), ("bf16-k5", "bf16", "pallas"),
                                ("highest-k5", "highest", "pallas"),
                                ("none-k5", None, "pallas")):
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
               "nms_suppress": cuda_nms.suppress,
               "conv_epilogue": cuda_epilogue.conv_epilogue,
               "conv_epilogue_residual": ResidualLaunches(
                   cuda_epilogue.conv_epilogue)}
    k5_det = Detector(nets["bf16-k5"], decode_impl="pallas-fused")
    routes = (("bf16 + K1", Detector(nets["bf16"])),
              ("bf16 + K4", Detector(nets["bf16"], decode_impl="pallas-fused")),
              ("bf16 + K4 + K5", k5_det))
    # the eager stage splits first, before any graph capture: taken after
    # one in the same process they read up to 1.5x slower (seen on the
    # card, cause not isolated); the counts are zeroed after them
    splits = [stage_split(det, frames, calls=10) for _, det in routes]
    for k in kernels.values():
        k.launches = 0
    run_main_path(Detector(nets["none"]), "yolov3", frames, card)
    for _, det in routes:
        run_main_path(det, "yolov3", frames, card)
    # the epilogue's count a forward on the captured path, held by
    # run_main_path to epilogue_launches; here to yolov3's own numbers
    epi = epilogue_row()["per_forward"]
    if (epi["conv_epilogue"], epi["conv_epilogue_residual"]) != (75, 23):
        raise AssertionError(f"yolov3 bf16 + K1: the conv epilogue launched "
                             f"{epi['conv_epilogue']} times a forward, "
                             f"{epi['conv_epilogue_residual']} with a "
                             f"residual; 75 / 23 expected")
    run_main_path(Detector(nets["none"], decode_impl="xla"), "yolov3", frames, card)
    run_main_path(Detector(tiny), "yolov3-tiny", frames, card)
    # the float32 forms of K5 and K4 (split TF32) on the captured path,
    # beside "highest" with cuDNN and K1 (None + K1 ran first)
    run_main_path(Detector(nets["highest"]), "yolov3", frames, card)
    for key in ("highest-k5", "none-k5"):
        run_main_path(Detector(nets[key], decode_impl="pallas-fused"),
                      "yolov3", frames, card)
    # forward_compact through K1c against the plain compact decode, on the
    # same preprocessed frames
    det = Detector(nets["none"])
    x = preprocess(torch.from_numpy(frames).to(DEVICE).flip(-1), det.net_hw,
                   interp=det._interp(SRC_HW))
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
    # three bf16 routes by stage (eager, measured above), the walk and the
    # decode also as device time alone (replayed from a CUDA graph: every
    # layer's weights come from device memory, not from L2 as in the k5
    # phase)
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
    staging_split(routes[0][1], frames)
    weights_swap(frames)
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


def epilogue_row() -> dict:
    """The main phase's yolov3 bf16 + K1 row (cuDNN convs, each with the
    epilogue kernel after it)."""
    return next(r for r in MAIN_ROWS
                if (r["name"], r["route"], r["precision"], r["conv_impl"])
                == ("yolov3", "pallas", "bf16", "xla"))


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
                           interp=det._interp(SRC_HW))
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
    """Two lists of detections equal bit for bit (the port's own check)."""
    from yolov3_tpu_torch.tools.bench_mesh import same_detections as same

    return same(a, b)


def int8_against_bf16(params, qnet, card: str, batches=(8, 128)) -> None:
    """bf16 + K1 against the int8 carrier with K6 blocks + K1 at batch 8
    and 128 of 480x640 frames, both captured: host-clock per-call medians of
    3 calls, device time of one replay, in turns in one process."""
    from yolov3_tpu_torch import Darknet, Detector

    fnet = Darknet(REPO / "models" / "yolov3.cfg", precision="bf16",
                   device=DEVICE).set_params(params)
    dets = {"bf16 + K1": Detector(fnet),
            "int8 carrier + K6 + K1": Detector(qnet, block_impl="pallas")}
    rng = np.random.default_rng(13)
    for b in batches:
        frames = rng.integers(0, 256, (b, *SRC_HW, 3), dtype=np.uint8)
        row = {}
        for name, det in dets.items():
            det.warmup(b, SRC_HW)
            _, host, _ = timed_calls(lambda: det.detect_batch(frames), 3)
            prog = det._pipeline(b, SRC_HW)
            row[name] = (float(np.median(host)), replay_ms(prog, iters=3),
                         prog.nbytes / 2 ** 20)
            del det._pipelines[prog.key]   # its pool back before the next
            prog.close()
        log(f"[int8] captured yolov3@416 B={b}: " + "; ".join(
            f"{n} {h:.3f} ms a call (host clock), replay {r:.3f} ms, "
            f"{b / h * 1e3:.1f} img/s, program {m:.0f} MiB"
            for n, (h, r, m) in row.items()) + f" on {card}")


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
               "nms_suppress": cuda_nms.suppress,
               "conv_epilogue": path_wrappers()["conv_epilogue"],
               "int8_requant": path_wrappers()["int8_requant"]}
    for k in kernels.values():
        k.launches = 0
    routes = (("int8 carrier, K6 blocks, K1", "sym", dict(block_impl="pallas")),
              ("int8 carrier, K6 blocks, K4", "sym",
               dict(block_impl="pallas", decode_impl="pallas-fused")),
              ("int8 carrier, unfused blocks, K1", "sym", {}),
              ("asymmetric int8 carrier, K1", "asym", {}),
              ("bf16 carrier, K1", "bf16c", {}))
    calls, outs, dets, per_forwards = 5, {}, {}, {}
    for name, key, kw in routes:
        det = dets[name] = Detector(nets[key], **kw)
        # run_main_path holds the warm-up and the capture to twice one
        # forward's launches: K6 once a fused block, len(plan) on the K6
        # routes
        outs[name] = run_main_path(det, f"yolov3 [{name}]", frames, card,
                                   calls=calls)
        fwd = forward_launches(det)
        per_forward = fwd["residual_block_int8"]
        want = len(plan) if kw.get("block_impl") == "pallas" else 0
        if per_forward != want:
            raise AssertionError(f"{name}: K6 launches {per_forward} times per "
                                 f"forward, expected {want}")
        per_forwards[name] = (per_forward, fwd["conv_epilogue"],
                              (fwd["int8_requant"],
                               fwd["int8_requant_residual"]))
    # the counts of the detect_batch calls alone: the stage split below
    # rebuilds a call out of its stages and would add its own launches
    launches = {name: k.launches for name, k in kernels.items()}
    log(f"[int8] kernel launches in the int8 main-path runs (on each of "
        f"{len(routes)} routes: {calls + 2} eager calls, one warm-up forward "
        f"and one capture, then {calls + 2} replays): {launches}")
    for kernel, n in launches.items():
        if n == 0:
            raise AssertionError(f"the int8 main path never launched {kernel}")
    for name, det in dets.items():
        per_forward, epilogues, requants = per_forwards[name]
        split = stage_split(det, frames, calls=5)
        busy = device_busy_ms(lambda: det.detect_batch(frames))
        log(f"[int8] {name}: K6 launches per forward {per_forward:.0f}, conv "
            f"epilogue launches (its float convs) {epilogues}, requantize "
            f"passes (with a shortcut) {requants}; stage "
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
        asym_path = Path(tmp) / "yolov3_int8_asym.npz"
        nets["asym"].save_quantized(asym_path)
        det = Detector(fresh, block_impl="pallas")
        again = det.detect_batch(frames)
        if not same_detections(again, outs[routes[0][0]]):
            raise AssertionError("a reloaded quantization state gives other "
                                 "detections")
        # re-quantizing after a capture: each state's own detections, never
        # the captured state's
        fresh.load_quantized(asym_path)
        swapped = det.detect_batch(frames)
        fresh.load_quantized(path)
        back = det.detect_batch(frames)
    if (not same_detections(swapped, outs[routes[3][0]])
            or not same_detections(back, outs[routes[0][0]])):
        raise AssertionError("load_quantized after a capture replayed a "
                             "stale quantization state")
    log(f"[int8] save_quantized -> load_quantized ({size / 1e6:.1f} MB npz): "
        f"identical detections; after the capture, load_quantized of the "
        f"asymmetric state gives its own detections and the symmetric one's "
        f"back again ({len(det._pipelines)} programs cached)")
    int8_against_bf16(params, nets["sym"], card)

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


def program_call(det, frames: np.ndarray, what: str, counts) -> dict:
    """``det.detect_batch(frames)`` twice: the first call builds the
    program (warm-up and capture: twice one forward's wrapper launches), the
    second is ONE replay and no eager launch; the replay's packed results
    equal the eager ``_run``'s bit for bit. Returns the build's launches."""
    import torch

    src_hw = tuple(frames.shape[1:3])
    before = counts()
    det.detect_batch(frames)
    built = {n: v - before[n] for n, v in counts().items()}
    want = forward_launches(det)
    if built != {n: 2 * v for n, v in want.items()}:
        raise AssertionError(f"{what}: warm-up and capture launched {built}, "
                             f"expected twice one forward's {want}")
    prog = det._pipeline(frames.shape[0], src_hw)
    replays, before = prog.replays, counts()
    res, _, _ = det._detect(frames, src_hw, None)
    steady = {n: v - before[n] for n, v in counts().items()}
    if prog.replays != replays + 1 or any(steady.values()):
        raise AssertionError(f"{what}: a steady call made "
                             f"{prog.replays - replays} replays and eager "
                             f"launches {steady}; one replay and none expected")
    eager = det._run(det._stage(frames)).cpu()
    if not torch.equal(res, eager):
        raise AssertionError(f"{what}: the captured program's results differ "
                             f"from the eager _run's")
    return {"built": built, "results": det._unpack(res, src_hw), "prog": prog}


def moved_detections(got, gt) -> str:
    """Where ``got`` ({img: {cls: (boxes, scores)}}) differs from the
    ground truth ({img: {cls: boxes}}): per image and class, the counts and,
    where they agree, the largest corner difference."""
    out = []
    for img in sorted(set(got) | set(gt)):
        g, w = got.get(img, {}), gt.get(img, {})
        for c in sorted(set(g) | set(w)):
            gb = np.asarray(g[c][0]) if c in g else np.zeros((0, 4))
            wb = np.asarray(w.get(c, np.zeros((0, 4))))
            if len(gb) != len(wb):
                out.append(f"image {img} class {c}: {len(gb)} boxes, golden "
                           f"{len(wb)}")
            elif len(gb):
                err = np.abs(gb[:, None] - wb[None]).max(-1).min(0).max()
                if err > 0.01:
                    out.append(f"image {img} class {c}: a box {err:.3f} px off")
    return "; ".join(out) or "none"


def synthetic_coco(root: Path, frames: np.ndarray, gt) -> Path:
    """A COCO directory under ``root``: the frames as PNG files and an
    annotation file of ``gt`` ({img: {contiguous class: tlbr boxes}}) with
    sparse category ids, as COCO's, and one crowd box (dropped by the
    scorer). Returns the annotation file's path."""
    import cv2

    cat_ids = [1 + c + c // 11 for c in range(80)]   # 1..87 with gaps
    images, anns = [], []
    for i, frame in enumerate(frames):
        name = f"{i:012d}.png"
        cv2.imwrite(str(root / name), frame)
        images.append({"id": 1000 + i, "file_name": name,
                       "height": frame.shape[0], "width": frame.shape[1]})
        for c, boxes in gt.get(i, {}).items():
            for x0, y0, x1, y1 in np.asarray(boxes, np.float64).tolist():
                anns.append({"id": len(anns) + 1, "image_id": 1000 + i,
                             "category_id": cat_ids[c], "iscrowd": 0,
                             "bbox": [x0, y0, x1 - x0, y1 - y0]})
    anns.append({"id": len(anns) + 1, "image_id": 1000, "iscrowd": 1,
                 "category_id": cat_ids[0], "bbox": [0.0, 0.0, 50.0, 50.0]})
    path = root / "annotations.json"
    path.write_text(json.dumps({"images": images, "annotations": anns,
                                "categories": [{"id": i, "name": str(i)}
                                               for i in cat_ids]}))
    return path


def phase_eval(card: str) -> dict:
    """``tests/data/eval_golden.json`` on the card, through captured
    programs (tiny@192, 8 structured frames, ground truth the JAX package's
    float32 "highest" Detector): float32 "highest" must give mAP50 =
    mAP50_95 = 1.0 exactly, int8 calibrated on the card (symmetric and
    asymmetric) must clear the fixture's floors; each call one replay.
    Then ``run_model_on_coco`` on a synthetic COCO directory of the same
    frames, and its offline mode on the detections the CLI saved
    (``--image-dir --save-json``) with the same settings. Returns the
    wrapper launches of the programs' warm-ups and captures."""
    import contextlib
    import io

    import torch
    from yolov3_tpu_torch import Darknet, Detector
    from yolov3_tpu_torch.__main__ import main as cli_main
    from yolov3_tpu_torch.graph import load_graph
    from yolov3_tpu_torch.tools import eval_coco
    from yolov3_tpu_torch.tools import gen_eval_golden as geg
    from yolov3_tpu_torch.weights import random_raw, write_weights

    wrappers = path_wrappers()

    def counts():
        return {n: w.launches for n, w in wrappers.items()}

    fx = json.loads((REPO / "tests" / "data" / "eval_golden.json").read_text())
    gt = {int(i): {int(c): np.asarray(b, np.float64) for c, b in per.items()}
          for i, per in fx["gt"].items()}
    frames = geg.make_frames(fx["seed"], n=fx["n_images"], hw=fx["img_hw"],
                             cell=fx["cell"])
    net_hw = tuple(fx["net_hw"])
    launches = Counter()
    for w in wrappers.values():
        w.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        wpath = tmp / "eval.weights"
        g = load_graph(geg.CFG)
        write_weights(wpath, g, random_raw(g, seed=geg.SEED))
        for name, precision, scheme in (("float32 \"highest\"", "highest", None),
                                        ("int8 symmetric", None, "symmetric"),
                                        ("int8 asymmetric", None, "asymmetric")):
            net = Darknet(geg.CFG, precision=precision,
                          device=DEVICE).load_weights(wpath)
            if scheme:
                net.quantize_int8(frames, net_hw=net_hw, act_scheme=scheme)
            det = Detector(net, prob_thresh=fx["prob_thresh"],
                           iou_thresh=fx["iou_thresh"], net_hw=net_hw)
            call = program_call(det, frames, f"[eval] {name}", counts)
            launches.update(call["built"])
            dets = geg.detections_to_dicts(call["results"])
            e = eval_coco.evaluate(dets, gt)
            if scheme is None and not (e["mAP50"] == 1.0
                                       and e["mAP50_95"] == 1.0):
                raise AssertionError(
                    f"[eval] {name}: mAP50 {e['mAP50']!r}, mAP50_95 "
                    f"{e['mAP50_95']!r} against the fixture's ground truth, "
                    f"1.0 expected; moved: {moved_detections(dets, gt)}")
            if scheme and not (e["mAP50"] >= fx["int8_mAP50_floor"] and
                               e["mAP50_95"] >= fx["int8_mAP50_95_floor"]):
                raise AssertionError(
                    f"[eval] {name}: mAP50 {e['mAP50']:.4f} / mAP50_95 "
                    f"{e['mAP50_95']:.4f} under the fixture's floors "
                    f"{fx['int8_mAP50_floor']} / {fx['int8_mAP50_95_floor']}")
            log(f"[eval] eval_golden.json {name} through its captured program "
                f"(one replay a call, 0 eager launches, = eager bit for bit): "
                f"mAP50 {e['mAP50']:.4f}, mAP50_95 {e['mAP50_95']:.4f} "
                + ("(1.0 required)" if scheme is None else
                   f"(floors {fx['int8_mAP50_floor']} / "
                   f"{fx['int8_mAP50_95_floor']})")
                + f", {sum(len(d.class_prob) for d in call['results'])} "
                f"detections, program {call['prog'].nbytes / 2 ** 20:.1f} MiB, "
                f"on {card}")
        # the tool over a synthetic COCO directory at the fixture's net size
        images = tmp / "images"
        images.mkdir()
        ann = synthetic_coco(images, frames, gt)
        cfg = tmp / "yolov3-tiny-192.cfg"
        cfg.write_text(geg.CFG.read_text().replace("width=416", "width=192")
                       .replace("height=416", "height=192"))
        settings = dict(prob_thresh=0.005, iou_thresh=fx["iou_thresh"],
                        batch_size=len(frames), precision="highest",
                        top_k=1024)
        before = counts()
        t0 = time.perf_counter()
        online = eval_coco.run_model_on_coco(images, ann, cfg, wpath,
                                             **settings, device=DEVICE)
        t_online = time.perf_counter() - t0
        launches.update({n: v - before[n] for n, v in counts().items()})
        saved = tmp / "dets.json"
        with contextlib.redirect_stdout(io.StringIO()):
            cli_main(["--image-dir", str(images), "--save-json", str(saved),
                      "--config", str(cfg), "--weights", str(wpath),
                      "--precision", "highest", "--prob-thresh", "0.005",
                      "--iou-thresh", str(fx["iou_thresh"]), "--top-k", "1024",
                      "--max-results", "0", "--batch-size", str(len(frames)),
                      "--device", DEVICE, "--no-show"])
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            eval_coco.main(["--detections", str(saved), "--annotations",
                            str(ann)])
        offline = json.loads(out.getvalue().strip().splitlines()[-1])
    for key in ("mAP50", "mAP50_95"):
        if not 0.0 <= online[key] <= 1.0:
            raise AssertionError(f"[eval] run_model_on_coco {key} "
                                 f"{online[key]!r}")
        # the saved file rounds boxes to 0.01 px and scores to 1e-5
        if abs(offline[key] - online[key]) > 0.01:
            raise AssertionError(f"[eval] offline {key} {offline[key]} against "
                                 f"run_model_on_coco's {online[key]:.4f}")
    if online["saturated_images"] or "skipped_entries" in offline:
        raise AssertionError(f"[eval] saturated or skipped: {online}, "
                             f"{offline}")
    log(f"[eval] run_model_on_coco (tiny@192 \"highest\", prob_thresh 0.005, "
        f"top_k 1024) on a synthetic COCO directory of the {len(frames)} "
        f"frames as PNG: mAP50 {online['mAP50']:.4f}, mAP50_95 "
        f"{online['mAP50_95']:.4f}, saturated {online['saturated_images']} / "
        f"near {online['near_saturated_images']}, {t_online:.2f} s; offline "
        f"mode on the CLI's --save-json of the same directory: {offline}")
    return dict(launches)


# source shapes of the cache phase, smallest first: by area their programs
# at yolov3@608 B=128 bf16 would need about 88 GB together
CACHE_SHAPES = ((360, 640), (480, 640), (540, 960), (600, 800), (720, 1280),
                (768, 1024), (900, 1600), (1080, 1920))
CACHE_BATCH = 128


def phase_cache(card: str) -> dict:
    """The program cache bounded by bytes: yolov3@608 bf16 + K1,
    ``detect_batch`` at B=128 for each of :data:`CACHE_SHAPES`; no
    out-of-memory error, the cached programs' bytes under the Detector's
    budget after every call; each program's MiB, its warm-up + capture
    time and the evictions logged; captured == eager bit for bit on the
    last shape and on the first, evicted and captured again. Returns the
    wrapper launches of the warm-ups and captures."""
    import torch
    from yolov3_tpu_torch import Darknet, Detector
    from yolov3_tpu_torch.weights import fold_raw, random_raw

    wrappers = path_wrappers()

    def counts():
        return {n: w.launches for n, w in wrappers.items()}

    net = Darknet(REPO / "models" / "yolov3.cfg", precision="bf16",
                  device=DEVICE)
    net.set_params(fold_raw(random_raw(net.graph, seed=0)))
    det = Detector(net, net_hw=(608, 608))
    budget = det._pipeline_budget
    total = torch.cuda.mem_get_info(DEVICE)[1]
    log(f"[cache] yolov3@608 bf16 + K1, B={CACHE_BATCH}: budget "
        f"{budget / 2 ** 20:.0f} MiB of the card's {total / 2 ** 20:.0f} MiB")

    def frames_of(hw):
        # 8 seeded frames, tiled: the batch costs one copy, not 128 draws
        base = np.random.default_rng(hw[0] * 7 + hw[1]).integers(
            0, 256, (8, *hw, 3), dtype=np.uint8)
        return np.tile(base, (CACHE_BATCH // 8, 1, 1, 1))

    def check(frames, what):
        ref = det._run(det._stage(frames)).cpu()
        got, _, _ = det._detect(frames, tuple(frames.shape[1:3]), None)
        if not torch.equal(ref, got):
            raise AssertionError(f"[cache] {what}: the captured program's "
                                 f"results differ from the eager _run's")

    for w in wrappers.values():
        w.launches = 0
    launches, evicted_first, rows = Counter(), False, []
    for hw in CACHE_SHAPES + CACHE_SHAPES[:1]:
        frames = frames_of(hw)
        keys = list(det._pipelines)
        before = counts()
        t0 = time.perf_counter()
        det.detect_batch(frames)
        call_s = time.perf_counter() - t0
        built = {n: v - before[n] for n, v in counts().items()}
        launches.update(built)
        gone = [k[1] for k in keys if k not in det._pipelines]
        evicted_first |= any(k == CACHE_SHAPES[0] for k in gone)
        prog = next(reversed(det._pipelines.values()))
        held = sum(p.nbytes for p in det._pipelines.values())
        if prog.key[1] != hw or held > budget:
            raise AssertionError(f"[cache] {hw}: newest program {prog.key}, "
                                 f"{held} bytes held against a budget of "
                                 f"{budget}")
        rows.append({"src_hw": list(hw), "mib": prog.nbytes / 2 ** 20,
                     "need_mib": prog.need / 2 ** 20,
                     "capture_s": prog.capture_s, "call_s": call_s,
                     "evicted": [list(k) for k in gone],
                     "held_mib": held / 2 ** 20,
                     "programs": len(det._pipelines)})
        log(f"[cache] {hw[0]}x{hw[1]}: program {rows[-1]['mib']:.0f} MiB "
            f"(warm-up peak {rows[-1]['need_mib']:.0f}), warm-up + capture "
            f"{prog.capture_s:.2f} s (call {call_s:.2f} s), evicted "
            f"{gone or 'none'}; {len(det._pipelines)} programs hold "
            f"{held / 2 ** 20:.0f} MiB, free "
            f"{torch.cuda.mem_get_info(DEVICE)[0] / 2 ** 20:.0f} MiB")
        if hw == CACHE_SHAPES[-1]:
            check(frames, f"last shape {hw}")
    if not evicted_first:
        raise AssertionError("[cache] the first shape's program was never "
                             "evicted: the phase did not test eviction")
    check(frames_of(CACHE_SHAPES[0]), f"first shape {CACHE_SHAPES[0]}, "
          f"evicted and captured again")
    log(f"[cache] {len(CACHE_SHAPES)} source shapes and the first again at "
        f"B={CACHE_BATCH}: no out-of-memory error, at most "
        f"{max(r['held_mib'] for r in rows):.0f} MiB held (budget "
        f"{budget / 2 ** 20:.0f}), {sum(len(r['evicted']) for r in rows)} "
        f"evictions; captured == eager bit for bit on the last shape and on "
        f"the re-captured first, on {card}")
    log("[cache] rows " + json.dumps(rows))
    del det
    torch.cuda.empty_cache()
    return dict(launches)


def phase_profile(card: str) -> dict:
    """``tools/profile_layers.py`` on yolov3@416 B=8 bf16 with a mark at
    every layer, with cuDNN convs and with K5 (``conv_impl="pallas"``); the
    full-depth prefix's head maps equal ``forward_features``' bit for bit;
    then ``tools/profile_int8.py`` on yolov3@416 B=8, symmetric, with
    ``block_impl`` "xla" and "pallas" (K6). Beside them, for the reader,
    the whole walk's replay (prefixes pay no consumption here, but each is
    its own graph). Returns the wrapper launches of the profiles' runs."""
    import torch
    from yolov3_tpu_torch.graph import load_graph
    from yolov3_tpu_torch.model import forward_features
    from yolov3_tpu_torch.tools import profile_int8, profile_layers as pl

    wrappers = path_wrappers()
    g = load_graph(REPO / "models" / "yolov3.cfg")
    params = pl.random_params(g, "bf16", DEVICE)
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (BATCH, 416, 416, 3)).astype(np.float32)).to(DEVICE)
    marks = list(range(1, len(g.nodes) + 1))
    for w in wrappers.values():
        w.launches = 0
    tables = {}
    with torch.inference_mode():
        for conv_impl in ("xla", "pallas"):
            k5 = wrappers["conv3x3_fused"].launches
            full = pl.partial_forward(g, params, x, len(g.nodes), "bf16",
                                      conv_impl)
            per_forward = wrappers["conv3x3_fused"].launches - k5
            heads = forward_features(g, params, x, "bf16", conv_impl)
            if not (len(full) == len(heads) + 1
                    and all(torch.equal(a, b) for a, b in zip(full, heads))):
                raise AssertionError(f"[profile] conv_impl={conv_impl}: the "
                                     f"full-depth prefix's head maps differ "
                                     f"from forward_features'")
            want = sum(k5_shapes(g).values()) if conv_impl == "pallas" else 0
            if per_forward != want:
                raise AssertionError(f"[profile] conv_impl={conv_impl}: a "
                                     f"full-depth prefix launched K5 "
                                     f"{per_forward} times, {want} expected")
            walk_ms = graph_ms(lambda: forward_features(
                g, params, x, "bf16", conv_impl), iters=5)
            rows = pl.profile_layers(g, params, x, marks, "bf16", conv_impl,
                                     log=lambda s: log(f"[profile] {s}"))
            tables[conv_impl] = rows
            top = sorted(rows, key=lambda r: -r["marginal_ms"])[:10]
            log(f"[profile] yolov3@416 B={BATCH} bf16 conv_impl={conv_impl}: "
                f"{len(marks)} prefixes by graph replay; full depth "
                f"{rows[-1]['ms']:.3f} ms, the same walk replayed whole "
                f"{walk_ms:.3f} ms (the main phase's walk, for the reader); "
                f"full-depth head maps == forward_features' bit for bit; "
                f"costliest marginals: " + ", ".join(
                    f"[{r['upto'] - 1}] {r['layer']} {r['marginal_ms']:.4f}"
                    for r in top) + f"; on {card}")
        st = profile_int8.State.calibrated(g, (416, 416), "symmetric",
                                           False, DEVICE)
        xq = st.frames(BATCH)
        for block_impl in ("xla", "pallas"):
            k6 = wrappers["residual_block_int8"].launches
            profile_int8.stages(st, [len(g.nodes)],
                                block_impl=block_impl)[0][1](xq)
            per_forward = wrappers["residual_block_int8"].launches - k6
            want = K6_BLOCKS_YOLOV3 if block_impl == "pallas" else 0
            if per_forward != want:
                raise AssertionError(f"[profile] int8 block_impl={block_impl}: "
                                     f"a full walk launched K6 {per_forward} "
                                     f"times, {want} expected")
            rows = profile_int8.profile_int8(
                st, xq, pl.default_marks(g), block_impl=block_impl,
                log=lambda s: log(f"[profile] {s}"))
            tables[f"int8 {block_impl}"] = rows
            log(f"[profile] yolov3@416 B={BATCH} int8 symmetric "
                f"block_impl={block_impl}: full step {rows[-1]['ms']:.3f} ms "
                f"by graph replay, {per_forward} K6 launches a walk; on {card}")
    log("[profile] rows " + json.dumps(tables))
    return {n: w.launches for n, w in wrappers.items()}


def _sum_ms(fn_of_args, cases, iters: int = 5) -> float:
    """Sum over ``cases`` of the device ms of one ``fn_of_args(*case)``."""
    return sum(cuda_ms(lambda: fn_of_args(*case), iters=iters, warmup=1)
               for case in cases)


def phase_probes(card: str):
    """T3a-e against their plain versions and against the exact host values
    of the tool, then the tool's own path (``tools.probe_block``) with the
    launch counts zeroed before it: 0 differences everywhere. T3b-e by graph
    replay beside the launch floor (one float's ``zero_()``); T3b and T3e
    also at K6's epilogue size beside ``copy_`` of the same bytes. Every T3
    time by graph replay is ``tools.bench_requant.replay_ms``: the least of
    five replays of 20 calls."""
    import torch
    from yolov3_tpu_torch.ops import cuda_probe as cp
    from yolov3_tpu_torch.tools import bench_requant as br
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
        graph_ms=sum(br.replay_ms(lambda: cp.probe_int8_dot(a, b, "wgmma_s8"))
                     for a, b in dots),
        graph_ms_mma=sum(br.replay_ms(lambda: cp.probe_int8_dot(a, b, "mma_s8"))
                         for a, b in dots),
        library_graph_ms=sum(br.replay_ms(lambda: torch._int_mm(a, b))
                             for a, b in dots))
    log(f"[probes] T3a over {len(dots)} shapes: wgmma "
        f"{rec['T3a']['ms']:.4f} ms eager, {rec['T3a']['graph_ms']:.4f} ms "
        f"graph replay; mma.sync {rec['T3a']['ms_mma']:.4f} / "
        f"{rec['T3a']['graph_ms_mma']:.4f} ms; torch._int_mm "
        f"{rec['T3a']['library_ms']:.4f} / {rec['T3a']['library_graph_ms']:.4f} ms")
    def on_card(a: np.ndarray, off_grid: bool = False):
        """``a`` on the card, its data 4 bytes past the 16-byte grid if
        ``off_grid`` (the kernels' one-at-a-time walk)."""
        t = torch.from_numpy(a).to(dev)
        if not off_grid:
            return t
        moved = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)[1:]
        return moved.copy_(t.reshape(-1)).view(t.shape)

    def round_case(a: np.ndarray, what: str, off_grid: bool = False):
        """T3b against its plain version and the tool's host values
        (numpy's half to even, clipped); returns (max |err|, plan, the input
        on the card, the plain version's output)."""
        t = on_card(a, off_grid)
        plan = cp.plan_elementwise(t.numel(), t.data_ptr() % 16 == 0)
        if plan.vec == off_grid:
            raise AssertionError(f"T3b {what}: {plan}")
        got, want = cp.probe_round(t), cp.probe_round_reference(t)
        e = same(got, want, f"T3b {what}")
        host = np.clip(np.round(a), -127, 127)
        if not np.array_equal(got.cpu().numpy(), host):
            raise AssertionError(f"T3b {what}: differs from the host values")
        return e, plan, t, want

    def epilogue_case(acc, deq, b, inv, what: str, off_grid: bool = False):
        """T3e against its plain version and the tool's numpy float32 chain;
        returns (max |err|, plan, a dict of the inputs on the card and the
        plain version's output, as ``tools.bench_requant.k6_cases``)."""
        ta = on_card(acc, off_grid)
        td, tb = on_card(deq), on_card(b)
        plan = cp.plan_epilogue(*ta.shape, ta.data_ptr() % 16 == 0)
        if plan.vec != (not off_grid and acc.shape[1] % 4 == 0):
            raise AssertionError(f"T3e {what}: {plan}")
        got = cp.probe_epilogue(ta, td, tb, inv)
        want = cp.probe_epilogue_reference(ta, td, tb, inv)
        e = same(got, want, f"T3e {what}")
        if not np.array_equal(got.cpu().numpy(),
                              pb.epilogue_reference(acc, deq, b, inv)):
            raise AssertionError(f"T3e {what}: differs from the host values")
        return e, plan, dict(acc=ta, deq=td, b=tb, inv=inv, want_epilogue=want)

    # T3b at the tool's inputs (one block), ragged counts (the tail alone,
    # pieces and a tail), off the 16-byte grid, and at K6's epilogue size
    xn = pb.round_inputs()
    x = torch.from_numpy(xn).to(dev)
    err, plan_b, _, _ = round_case(xn, "the tool's (8, 144)")
    if plan_b.blocks != 1:
        raise AssertionError(f"T3b at the tool's inputs: {plan_b}")
    flat = np.resize(xn.reshape(-1), 1153)
    for n in (1, 3, 1153):
        err = max(err, round_case(flat[:n].copy(), f"n={n}")[0])
    err = max(err, round_case(xn, "off the 16-byte grid", off_grid=True)[0])
    xk = br.k6_round_input()
    e, plan_bk, xk_card, want_bk = round_case(xk, f"K6's {xk.size:,} floats")
    err = max(err, e)
    log(f"[probes] T3b exact at the tool's (8, 144) ({plan_b.blocks} block), "
        f"n = 1, 3, 1,153, off the 16-byte grid and K6's {xk.size:,} floats "
        f"({plan_bk.blocks} blocks of {plan_bk.threads}, a piece a thread)")
    rec["T3b"] = dict(max_abs_err=err, ms=cuda_ms(lambda: cp.probe_round(x)),
                      plain_ms=cuda_ms(lambda: cp.probe_round_reference(x)),
                      nbytes=8 * x.numel(), ops=3 * x.numel(),
                      blocks=plan_b.blocks, blocks_k6=plan_bk.blocks)
    # T3c bit for bit at the tool's shape, a plane above 227 KB as float32 (a
    # block's most shared memory), lanes no multiple of 16 (the byte walk),
    # several 512-byte lane chunks, one row, and an input off the 16-byte grid
    xr = torch.from_numpy(np.random.default_rng(1).integers(
        -127, 128, (10, 48, 128)).astype(np.int8)).to(dev)
    roll_cases = [xr] + [
        torch.from_numpy(rng.integers(-128, 128, shape).astype(np.int8)).to(dev)
        for shape in ((2, 512, 128), (3, 37, 100), (2, 9, 1040), (3, 1, 64))]
    off_grid = torch.empty(4 * 6 * 32 + 1, dtype=torch.int8, device=dev)[1:]
    off_grid.copy_(torch.from_numpy(rng.integers(-128, 128, 4 * 6 * 32)
                                    .astype(np.int8)))
    roll_cases.append(off_grid.view(4, 6, 32))
    err = 0.0
    for xc in roll_cases:
        plan = cp.plan_roll(*xc.shape, vec=xc.data_ptr() % 16 == 0)
        err = max(err, same(cp.probe_roll(xc), cp.probe_roll_reference(xc),
                            f"T3c {tuple(xc.shape)} {plan}"))
    plan = cp.plan_roll(*xr.shape)
    if plan.grid[0] * plan.grid[1] <= 10 or not plan.vec:
        raise AssertionError(f"T3c at the tool's shape: {plan}")
    log(f"[probes] T3c exact at {[tuple(xc.shape) for xc in roll_cases]} "
        f"(the last off the 16-byte grid); the tool's shape on "
        f"{plan.grid[0] * plan.grid[1]} blocks of {plan.threads} threads, "
        f"{plan.smem} bytes of int8 staged a block")
    rec["T3c"] = dict(max_abs_err=err, ms=cuda_ms(lambda: cp.probe_roll(xr)),
                      plain_ms=cuda_ms(lambda: cp.probe_roll_reference(xr)),
                      nbytes=3 * xr.numel(), ops=0, blocks=plan.grid[0] * plan.grid[1])
    # T3d: the tool's three tiles in ONE launch, each tile alone, and a cp no
    # multiple of 4 (int stores) over tiles in another order
    mask_args, his = (6, 48, 128, 40, 40), (0, 3, 6)
    err = same(cp.probe_masks(*mask_args, his, device=dev),
               cp.probe_masks_reference(*mask_args, his, device=dev),
               "T3d, three tiles in one launch")
    err = max([err, same(cp.probe_masks(5, 12, 6, 11, 9, (2, 0, 1), device=dev),
                         cp.probe_masks_reference(5, 12, 6, 11, 9, (2, 0, 1),
                                                  device=dev), "T3d cp=6")]
              + [same(cp.probe_mask(*mask_args, hi, device=dev),
                      cp.probe_mask_reference(*mask_args, hi, device=dev),
                      f"T3d hi={hi}") for hi in his])
    rows1 = (6 + 2) * 48
    rec["T3d"] = dict(max_abs_err=err,
                      ms=cuda_ms(lambda: cp.probe_masks(*mask_args, his, device=dev)),
                      plain_ms=cuda_ms(lambda: cp.probe_masks_reference(
                          *mask_args, his, device=dev)),
                      nbytes=4 * len(his) * rows1 * 128, ops=5 * len(his) * rows1,
                      tiles=len(his))
    # T3e at the tool's inputs, cols 100 and 6 (6: the scalar walk), off the
    # 16-byte grid, and at K6's epilogue size
    acc_n, deq_n, b_n, inv = pb.epilogue_inputs()
    err, plan_e, _ = epilogue_case(acc_n, deq_n, b_n, inv,
                                   "the tool's (256, 128)")
    for rows, cols in ((1000, 100), (37, 6)):
        args = (rng.integers(-2_000_000, 2_000_000, (rows, cols)).astype(np.int32),
                rng.uniform(1e-6, 1e-4, cols).astype(np.float32),
                rng.normal(0, 0.05, cols).astype(np.float32))
        err = max(err, epilogue_case(*args, inv, f"({rows}, {cols})")[0])
    err = max(err, epilogue_case(acc_n, deq_n, b_n, inv,
                                 "off the 16-byte grid", off_grid=True)[0])
    k6_args = br.k6_epilogue_inputs()
    e, plan_ek, k6 = epilogue_case(*k6_args, f"K6's {k6_args[0].shape}")
    err = max(err, e)
    log(f"[probes] T3e exact at the tool's (256, 128) (grid {plan_e.grid}), "
        f"cols 100 and 6, off the 16-byte grid and K6's {k6_args[0].shape} "
        f"(grid {plan_ek.grid} of {plan_ek.threads}, a row a thread)")
    acc, deq, b = (torch.from_numpy(a).to(dev) for a in (acc_n, deq_n, b_n))
    rec["T3e"] = dict(max_abs_err=err, ms=cuda_ms(lambda: cp.probe_epilogue(acc, deq, b, inv)),
                      plain_ms=cuda_ms(lambda: cp.probe_epilogue_reference(
                          acc, deq, b, inv)),
                      nbytes=8 * acc.numel() + 8 * deq.numel(), ops=6 * acc.numel(),
                      blocks=plan_e.grid[0] * plan_e.grid[1],
                      blocks_k6=plan_ek.grid[0] * plan_ek.grid[1])
    del k6_args, xk
    # T3b and T3e by graph replay at the tool's inputs and at K6's size (the
    # inputs checked above), beside the launch floor (one float's zero_())
    # and copy_ of K6's bytes
    t = br.measure(dev, dict(k6, x=xk_card, want_round=want_bk))
    del k6, xk_card, want_bk
    for key, short in (("T3b", "t3b"), ("T3e", "t3e")):
        us, k6_us = t[f"{short}_tool_us"], t[f"{short}_k6_us"]
        rec[key].update(graph_ms=us / 1e3, graph_ms_k6=k6_us / 1e3,
                        copy_ms_k6=t["copy_k6_us"] / 1e3,
                        gbps_k6=t["k6_bytes"] / k6_us / 1e3,
                        bound_ms_k6=t["k6_bytes"] / HBM_BYTES_PER_S * 1e3,
                        share_of_copy_k6=t["copy_k6_us"] / k6_us)
    log(f"[probes] K6's size ({br.K6_ELEMENTS:,} elements, "
        f"{t['k6_bytes'] / 1e6:.1f} MB moved, bound "
        f"{rec['T3b']['bound_ms_k6'] * 1e3:.2f} us) by graph replay: " + ", ".join(
            f"{key} {rec[key]['graph_ms_k6'] * 1e3:.2f} us "
            f"({rec[key]['gbps_k6']:.0f} GB/s, "
            f"{rec[key]['bound_ms_k6'] / rec[key]['graph_ms_k6']:.1%} of the "
            f"bound, {rec[key]['share_of_copy_k6']:.1%} of copy_'s rate)"
            for key in ("T3b", "T3e"))
        + f"; copy_ of the same bytes {t['copy_k6_us']:.2f} us "
        f"({t['k6_bytes'] / t['copy_k6_us'] / 1e3:.0f} GB/s); on {card}")
    rec["T3c"]["graph_ms"] = br.replay_ms(lambda: cp.probe_roll(xr))
    # the library's counterpart of T3c: one torch.roll call per output
    rolls = (torch.roll(xr, 1, 1), torch.roll(xr, -1, 1))
    if not torch.equal(torch.stack(rolls), cp.probe_roll(xr)):
        raise AssertionError("T3c: torch.roll differs from the kernel")
    rec["T3c"]["library_ms"] = br.replay_ms(
        lambda: (torch.roll(xr, 1, 1), torch.roll(xr, -1, 1)))
    rec["T3d"]["graph_ms"] = br.replay_ms(
        lambda: cp.probe_masks(*mask_args, his, device=dev))
    rec["T3d"]["graph_ms_one_tile"] = br.replay_ms(
        lambda: cp.probe_mask(*mask_args, 3, device=dev))
    floor_ms = t["floor_us"] / 1e3
    for key in ("T3b", "T3c", "T3d", "T3e"):
        rec[key]["floor_ms"] = floor_ms
    log("[probes] T3b-e by graph replay: " + ", ".join(
        f"{key} {rec[key]['graph_ms'] * 1e3:.2f} us ({rec[key]['ms'] * 1e3:.2f} "
        f"us a wrapper call)" for key in ("T3b", "T3c", "T3d", "T3e"))
        + f"; T3d is the tool's three tiles in one launch (one tile "
        f"{rec['T3d']['graph_ms_one_tile'] * 1e3:.2f} us); T3c's two outputs as "
        f"two torch.roll calls {rec['T3c']['library_ms'] * 1e3:.2f} us (T3b, "
        f"T3d and T3e have no single library call); the launch floor (one "
        f"float's zero_()) {floor_ms * 1e3:.2f} us; on {card}")
    log("[probes] T3a-e equal their plain versions on the card (T3a at "
        f"{len(dots)} shapes, wgmma, mma.sync and __dp4a)")
    # the tool's path: exact host values, the reference's wording
    wrappers = {"T3a": cp.probe_int8_dot, "T3b": cp.probe_round,
                "T3c": cp.probe_roll, "T3d": cp.probe_masks,
                "T3e": cp.probe_epilogue}
    for w in (*wrappers.values(), cp.probe_mask):
        w.launches = 0
    bad = (pb.probe_int8_dot(dev) + pb.probe_round(dev) + pb.probe_roll(dev)
           + pb.probe_mask(dev) + pb.probe_epilogue(dev))
    for name, w in wrappers.items():
        rec[name]["launches"] = w.launches
        if w.launches == 0:
            raise AssertionError(f"tools.probe_block never launched {name}")
    if cp.probe_masks.launches != 1 or cp.probe_mask.launches != 0:
        raise AssertionError(f"tools.probe_block ran T3d in "
                             f"{cp.probe_masks.launches} + "
                             f"{cp.probe_mask.launches} launches, 1 expected")
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


def entry_net(precision: str = "bf16", cfg: str = "yolov3.cfg", seed: int = 0,
              **kw):
    """A net at full width with random weights of ``seed``, on the card."""
    from yolov3_tpu_torch import Darknet
    from yolov3_tpu_torch.weights import fold_raw, random_raw

    net = Darknet(REPO / "models" / cfg, precision=precision, device=DEVICE,
                  **kw)
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
    canvas_prog = det._pipeline(BATCH, (416, 416), bgr=False)
    replays = canvas_prog.replays
    # one device batch: the captured program's replay, no eager launch
    mixed, launches = counted(lambda: det.detect_mixed(frames),
                              {"decode_packed": 0, "nms_suppress": 0})
    if canvas_prog.replays != replays + 1:
        raise AssertionError("detect_mixed did not replay its program once")
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
    in_net = det._unpack(det._run(det._stage(canvases), bgr=False), None)
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
        f"({[len(d.class_prob) for d in mixed]} per image), eager kernel "
        f"launches of the one call {launches} (one replay of the captured "
        f"program); detect_batch on the canvases == the "
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
    (scan_prog,) = det4._pipelines.values()
    if scan_prog.key[0] != 32 or scan_prog.replays != 1:
        raise AssertionError(f"scan=4: programs {list(det4._pipelines)}, "
                             f"one graph of the 32 frames expected")
    t0 = time.perf_counter()
    for _ in range(3):
        det4.detect_preletterboxed(many, src)
    t_scan = (time.perf_counter() - t0) / 3 * 1e3
    t0 = time.perf_counter()
    for _ in range(3):
        for i in range(4):
            det.detect_preletterboxed(many[8 * i:8 * i + 8], src[:8])
    t_plain = (time.perf_counter() - t0) / 3 * 1e3
    log(f"[entry] scan=4 on 32 canvases, ONE captured graph of the four "
        f"sub-batches ({scan_prog.nbytes / 2 ** 20:.0f} MiB) == four scan=1 "
        f"calls of 8 exactly, in order; {t_scan:.2f} ms against "
        f"{t_plain:.2f} ms (host clock, mean of 3)")
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

    batch_prog = det._pipeline(BATCH, SRC_HW)
    replays = batch_prog.replays
    t0 = time.perf_counter()
    got, piped = counted(pipelined, {"decode_packed": 0, "nms_suppress": 0})
    t_pipe = (time.perf_counter() - t0) / len(batches) * 1e3
    if batch_prog.replays - replays != len(batches):
        raise AssertionError(f"{len(batches)} pipelined batches made "
                             f"{batch_prog.replays - replays} replays")
    if len(got) != len(want) or not all(same_detections(g, w)
                                        for g, w in zip(got, want)):
        raise AssertionError("PipelinedDetector's results differ from the "
                             "synchronous calls or come out of order")
    log(f"[entry] PipelinedDetector(depth=2) over 8 batches of {BATCH} "
        f"{SRC_HW[0]}x{SRC_HW[1]} frames: the synchronous results, in order; "
        f"{t_pipe:.3f} ms per batch pipelined (its first batch, apart: "
        f"{t_first:.1f} ms), {t_sync:.3f} ms synchronous (host clock) on "
        f"{card}; eager kernel launches of the 8 pipelined batches {piped}, "
        f"one replay each")
    return dict(launches, pipelined_ms=t_pipe, sync_ms=t_sync)


def padding_split(det, frame: np.ndarray, calls: int = 10) -> dict:
    """One host-letterboxed frame through ``detect_preletterboxed`` as a
    captured batch of 1 and padded to a batch of 8 (the micro-batcher's
    padding): host-clock median ms a call, by batch."""
    canvas = det._build_canvases([frame])
    out = {}
    for b in (1, 8):
        batch = np.concatenate([canvas] + [np.zeros_like(canvas)] * (b - 1))
        det.warmup(b, frame.shape[:2], host_preprocessed=True)
        _, host, _ = timed_calls(
            lambda: det.detect_preletterboxed(batch, [frame.shape[:2]] * b), calls)
        out[b] = float(np.median(host))
    return out


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
    replays = {k: p.replays for k, p in det._pipelines.items()}
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
    # one device batch, one detect call: one replay of the program the
    # server's warm-up captured, no eager launch
    n_batches = sum(sizes.values())
    made = sum(p.replays - replays.get(k, 0) for k, p in det._pipelines.items())
    if (launches != {"decode_packed": 0, "nms_suppress": 0}
            or made != n_batches or set(det._pipelines) != set(replays)):
        raise AssertionError(f"the serving path's eager launches {launches}, "
                             f"{made} replays; none and one for each of its "
                             f"{n_batches} device batches expected")
    padded = padding_split(det, frames[0])
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
        f"and port released; eager kernel launches {launches}, {made} "
        f"replays of the warm-up's program on {card}; a lone canvas "
        f"captured at B=1 {padded[1]:.3f} ms a call against {padded[8]:.3f} "
        f"ms padded to B=8 (host clock, median of 10)")
    return dict(launches, post_detect=post, p50_single=float(np.median(single)),
                p50=float(np.percentile(conc, 50)), p95=float(np.percentile(conc, 95)))


def card_mesh_devices():
    """The mesh of the ``mesh`` phase: every visible card when there are at
    least two, else ``cuda:0`` twice (a virtual mesh on the one card)."""
    import torch

    n = torch.cuda.device_count()
    if n >= 2:
        return ([torch.device("cuda", i) for i in range(n)],
                f"every visible card ({n})")
    return ([torch.device("cuda", 0)] * 2,
            "cuda:0 twice (a virtual mesh on the one card)")


def same_detections_exact(got, want, what: str) -> None:
    if not same_detections(got, want):
        raise AssertionError(f"{what}: detections differ")


def same_detection_sets(got, want, what: str) -> float:
    """Counts and classes exact, boxes within 1e-3 px; the largest box
    difference."""
    err = 0.0
    for g, w in zip(got, want):
        if (len(g.class_idx) != len(w.class_idx)
                or not np.array_equal(g.class_idx, w.class_idx)):
            raise AssertionError(f"{what}: detection sets differ")
        if len(g.class_idx):
            err = max(err, float(np.abs(g.bbox_tlbr - w.bbox_tlbr).max()))
    if len(got) != len(want) or err > 1e-3:
        raise AssertionError(f"{what}: boxes differ by {err} px")
    return err


def pinned_host_counts():
    """The page-locked host allocator's counts of blocks handed out and
    blocks created (``torch.cuda.host_memory_stats``), or None where this
    torch keeps neither."""
    import torch

    stats = getattr(torch.cuda, "host_memory_stats", None)
    if stats is None:
        return None
    s = stats()
    return {k: s[k] for k in ("active_requests.allocated", "num_host_alloc")
            if k in s} or None


def mesh_batch_dp(net, name: str, devices, frames, kw, counts, card: str,
                  calls: int = 10) -> dict:
    """One batch-DP route at B=8 on ``devices`` (``kw`` may hold ``scan``):
    each replica's results equal to the single-device Detector's on the
    same B/n sub-batch (B/(2n) sub-batches under ``scan=2``), bit for bit;
    the warm-up and capture launch each wrapper twice a forward's count per
    replica and sub-batch. Then ``calls`` distinct inputs, each through ONE
    caller array overwritten as soon as the call returns, in turns with
    one device at B=8 (same ``kw``): every call bit-equal to one device at
    the replicas' batches, the host-clock call and ``last_stage_s``'s
    ``h2d_s`` / ``dispatch_s`` / ``device_fetch_s`` medians beside one
    device's; then the same inputs through ``PipelinedDetector(depth=2)``
    on the mesh, equal to the synchronous calls in order, with the time a
    ``submit`` holds the host and the time it spends queueing
    (``Detector._enqueue``). Steady calls: one replay per replica each, no
    eager launch, no page-locked host allocation
    (``torch.cuda.host_memory_stats``); captured == eager. The mesh
    Detector's launches are added to ``counts``."""
    import torch
    from yolov3_tpu_torch import Detector
    from yolov3_tpu_torch.inference import PipelinedDetector
    from yolov3_tpu_torch.parallel import make_mesh
    from yolov3_tpu_torch.tools.bench_mesh import in_chunks, turns

    n = len(devices)
    scan = kw.get("scan", 1)
    b = BATCH // (n * scan)
    sub = Detector(net, **{k: v for k, v in kw.items() if k != "scan"})
    want = in_chunks(sub, frames, b)
    one = Detector(net, **kw)
    one.detect_batch(frames)
    wrappers = path_wrappers()
    before = {k: w.launches for k, w in wrappers.items()}
    det = Detector(net, mesh=make_mesh(n, devices=devices), **kw)
    got = det.detect_batch(frames)
    warm = {k: w.launches - before[k] for k, w in wrappers.items()}
    fwd = forward_launches(det)
    if warm != {k: 2 * n * scan * v for k, v in fwd.items()}:
        raise AssertionError(f"[mesh] {name}: warm-up and capture launched "
                             f"{warm}, expected 2 x {n} replicas x {scan} "
                             f"sub-batches x {fwd}")
    same_detections_exact(got, want, f"[mesh] {name} replicas against the "
                                     f"single device at B={b}")
    prog = det._pipeline(BATCH, SRC_HW)
    replays = [r.replays for r in prog.replicas]
    rng = np.random.default_rng(10)
    inputs = [rng.integers(0, 256, frames.shape, dtype=np.uint8)
              for _ in range(calls)]
    wants = [in_chunks(sub, x, b) for x in inputs]
    pinned = pinned_host_counts()
    mid = {k: w.launches for k, w in wrappers.items()}

    def check(i, out):
        same_detections_exact(out, wants[i], f"[mesh] {name} call {i} on "
                                             "distinct frames")

    row = {"route": det.route, "scan": scan,
           **turns(det, one, inputs, check)}
    buf = np.empty_like(frames)
    pipe = PipelinedDetector(det, depth=2)
    enqueue = det._enqueue
    enqueue_ms, submit_ms, done = [], [], []

    def timed_enqueue(*a, **k):
        t0 = time.perf_counter()
        try:
            return enqueue(*a, **k)
        finally:
            enqueue_ms.append((time.perf_counter() - t0) * 1e3)

    det._enqueue = timed_enqueue
    try:
        torch.cuda.synchronize()
        t_pipe = time.perf_counter()
        for x in inputs:
            buf[...] = x
            t0 = time.perf_counter()
            done += pipe.submit(buf)
            submit_ms.append((time.perf_counter() - t0) * 1e3)
            buf[...] = 0
            if len(pipe._inflight) > 2:
                raise AssertionError(f"[mesh] {name}: more than depth "
                                     "batches in flight")
        done += pipe.flush()
        t_pipe = (time.perf_counter() - t_pipe) * 1e3 / calls
    finally:
        del det._enqueue
    if len(done) != calls or not all(same_detections(g, w)
                                     for g, w in zip(done, wants)):
        raise AssertionError(f"[mesh] {name}: PipelinedDetector's results "
                             "differ from the synchronous calls or come out "
                             "of order")
    steady = {k: w.launches - mid[k] for k, w in wrappers.items()}
    if any(steady.values()) or any(
            r.replays - r0 != 2 * calls
            for r, r0 in zip(prog.replicas, replays)):
        raise AssertionError(f"[mesh] {name}: steady calls launched {steady}, "
                             "or a replica did not replay once a call")
    after = pinned_host_counts()
    if after != pinned:
        raise AssertionError(f"[mesh] {name}: steady calls allocated "
                             f"page-locked host memory: {pinned} -> {after}")
    for k, v in warm.items():
        counts[k] += v
    eager = det._run(det._stage(frames)).cpu()
    packed, _, _ = det._detect(frames, SRC_HW, None)
    if not torch.equal(eager, packed):
        raise AssertionError(f"[mesh] {name}: captured != eager")
    row.update(submit_ms=float(np.median(submit_ms)),
               enqueue_ms=float(np.median(enqueue_ms)), pipelined_ms=t_pipe,
               pinned_host_counts=pinned,
               replica_mib=[r.nbytes / 2 ** 20 for r in prog.replicas])
    pinned_how = ("torch.cuda.host_memory_stats " + str(pinned) if pinned
                  else "this torch's host_memory_stats keeps no counts: "
                       "not checked")
    log(f"[mesh] batch-DP {name}@416 B={BATCH} of {SRC_HW[0]}x{SRC_HW[1]} on "
        f"{n} shards (B={b} a replica{' a sub-batch' if scan > 1 else ''}): "
        f"replicas == single device at B={b} bit for bit over {calls} "
        f"distinct inputs from one reused caller array, captured == eager; "
        f"medians over {calls} in turns (host clock), mesh / one device at "
        f"B={BATCH}: call {row['call_ms_mesh']:.3f} / {row['call_ms_one']:.3f}"
        f" ms, h2d_s {row['h2d_ms_mesh']:.3f} / {row['h2d_ms_one']:.3f}, "
        f"dispatch_s {row['dispatch_ms_mesh']:.3f} / "
        f"{row['dispatch_ms_one']:.3f}, device_fetch_s "
        f"{row['device_fetch_ms_mesh']:.3f} / {row['device_fetch_ms_one']:.3f}"
        f" ms (on {card}); PipelinedDetector(depth=2) on the mesh == the "
        f"synchronous calls in order, {t_pipe:.3f} ms a batch, a submit holds "
        f"the host {row['submit_ms']:.3f} ms (median; queueing "
        f"{row['enqueue_ms']:.3f}); steady calls: one replay a replica each, "
        f"no eager launch, no page-locked allocation ({pinned_how}); "
        f"replica programs "
        f"{[round(m, 1) for m in row['replica_mib']]} MiB; wrapper launches "
        f"a forward {fwd} per replica")
    return row


def phase_mesh(card: str) -> dict:
    """``parallel/`` at full width on the card: batch-DP yolov3@416 B=8
    (bf16 + K1, bf16 + K4 + K5, int8 K6 + K1, and ``scan=2``; each
    :func:`mesh_batch_dp`), spatial
    yolov3@416 B=1 at "highest" and bf16 at n = 2 and 4
    (:func:`mesh_spatial`: one graph over the cards), tiny@416 spatial
    detection sets against one device, and the dry run. Returns the
    launches of K1, K1c, K2, K4, K5 and K6 in the phase's mesh Detectors'
    calls (counts read before and after each drive; the single-device
    references are not counted)."""
    import torch
    from yolov3_tpu_torch import Detector
    from yolov3_tpu_torch.ops import cuda_decode
    from yolov3_tpu_torch.parallel import make_mesh, make_spatial_mesh
    from yolov3_tpu_torch.parallel.dryrun import dryrun_multichip

    devices, which = card_mesh_devices()
    n = len(devices)
    log(f"[mesh] mesh devices: {which}: {[str(d) for d in devices]}")
    frames = np.random.default_rng(0).integers(0, 256, (BATCH, *SRC_HW, 3),
                                               dtype=np.uint8)
    counts = Counter()
    rows = {}
    # batch-DP, three routes at full width
    rows["bf16 + K1"] = mesh_batch_dp(entry_net(), "yolov3 bf16 + K1",
                                      devices, frames, {}, counts, card)
    rows["bf16 + K4 + K5"] = mesh_batch_dp(
        entry_net(conv_impl="pallas"), "yolov3 bf16 + K4 + K5", devices, frames,
        {"decode_impl": "pallas-fused"}, counts, card)
    q = entry_net()
    q.quantize_int8(np.random.default_rng(1).integers(
        0, 256, (BATCH, *SRC_HW, 3), dtype=np.uint8))
    rows["int8 K6 + K1"] = mesh_batch_dp(
        q, "yolov3 int8 K6 + K1", devices, frames, {"block_impl": "pallas"},
        counts, card)
    # scan=2: each replica's two sub-batches of B/(2n) in one program
    net = entry_net()
    rows["scan=2 bf16 + K1"] = mesh_batch_dp(
        net, "yolov3 scan=2 bf16 + K1", devices, frames, {"scan": 2}, counts,
        card)
    del net, q
    torch.cuda.empty_cache()

    # spatial, yolov3@416 B=1 at "highest" and bf16: head maps, then the
    # Detector's program over the mesh's cards
    cards = torch.cuda.device_count()
    for i, j in [(i, j) for i in range(cards) for j in range(cards) if i != j]:
        log(f"[mesh] peer access cuda:{i} -> cuda:{j}: "
            f"{torch.cuda.can_device_access_peer(i, j)}")
    spatial = {}
    for precision in ("highest", "bf16"):
        net = entry_net(precision)
        for ns in (2, 4):
            sdev = devices if n >= ns else [torch.device(DEVICE, 0)] * ns
            spatial[f"{precision} n={ns}"] = mesh_spatial(
                net, precision, make_spatial_mesh(ns, devices=sdev[:ns]),
                frames[:1], counts, card)
        del net
        torch.cuda.empty_cache()
    # tiny@416: spatial detection sets against one device
    tiny = entry_net("highest", "yolov3-tiny.cfg", seed=42)
    one = Detector(tiny, prob_thresh=0.3)
    for ns in (2, 4):
        sdev = devices if n >= ns else [torch.device(DEVICE, 0)] * ns
        det = Detector(tiny, prob_thresh=0.3, partition="spatial",
                       mesh=make_spatial_mesh(ns, devices=sdev[:ns]))
        before = {k: w.launches for k, w in path_wrappers().items()}
        k1c = cuda_decode.decode_compact.launches
        got = det.detect_batch(frames[:2])
        for k, w in path_wrappers().items():
            counts[k] += w.launches - before[k]
        counts["decode_compact"] += cuda_decode.decode_compact.launches - k1c
        box = same_detection_sets(got, one.detect_batch(frames[:2]),
                                  f"[mesh] spatial n={ns} tiny")
        log(f"[mesh] spatial tiny@416 B=2 n={ns}: detection sets == one "
            f"device ({[len(d.class_idx) for d in got]} detections, max box "
            f"diff {box:.2e} px)")
    # the dry run's counterpart, on the card
    dryrun_multichip(2)
    for k in ("decode_packed", "decode_compact", "nms_suppress",
              "decode_packed_fused_head", "conv3x3_fused",
              "residual_block_int8", "conv_epilogue",
              "conv_epilogue_residual", "int8_requant",
              "int8_requant_residual"):
        if not counts[k]:
            raise AssertionError(f"[mesh] the mesh path launched {k} no time")
    log(f"[mesh] kernel launches of the phase's mesh Detectors: {dict(counts)}")
    return {"launches": dict(counts), "batch_dp": rows, "spatial": spatial}


def copies_ms(copies, devices) -> float:
    """Device ms of one call's copies between devices alone
    (``collectives.copies`` of one call: the same shapes, sources and
    destinations, as many of each), captured as one graph over ``devices``
    as a spatial program is, by replay."""
    import torch
    from yolov3_tpu_torch.inference import _CapturedProgram

    srcs = {(src, shape, dtype): torch.ones(shape, device=src, dtype=dtype)
            for (_, src, _, shape, dtype) in copies}

    def run(frames):
        for (_, src, dst, shape, dtype), k in copies.items():
            for _ in range(k):
                srcs[src, shape, dtype].to(dst)
        return frames

    prog = _CapturedProgram((1, (1, 1)), "copies", run, (), *devices)
    prog.capture()
    try:
        return replay_ms(prog, iters=20)
    finally:
        prog.close()


def mesh_spatial(net, precision: str, mesh, frame: np.ndarray, counts,
                 card: str) -> dict:
    """Spatial yolov3@416 B=1 on ``mesh`` at ``precision``: the banded
    walk's head maps against the full walk's (within the reference's bars
    at "highest", logged at bf16); the collectives of one eager call (their
    count, the bytes they hand between shards and those that cross between
    cards, and those copies alone by graph replay); then the Detector: its
    program ONE captured graph over the mesh's distinct cards, equal to
    the eager ``_run`` bit for bit, K1c and K2 launched in its warm-up and
    capture (added to ``counts``) and never in a steady call, each steady
    call one replay; the replay's device time and both call times beside
    one device's at B=1."""
    import torch
    from yolov3_tpu_torch import Detector
    from yolov3_tpu_torch.inference import _CapturedProgram
    from yolov3_tpu_torch.model import forward_features
    from yolov3_tpu_torch.ops import cuda_decode
    from yolov3_tpu_torch.ops.preprocess import preprocess
    from yolov3_tpu_torch.parallel import collectives, plan_spatial
    from yolov3_tpu_torch.parallel.sharding import shard_params
    from yolov3_tpu_torch.parallel.spatial import forward_features_spatial

    ns = mesh.size
    cards = tuple(dict.fromkeys(mesh.devices))
    what = f"[mesh] spatial n={ns} {precision}"
    x = preprocess(torch.from_numpy(frame).to(DEVICE).flip(-1), (416, 416))
    plan = plan_spatial(net.graph, ns, (416, 416))
    h = 416 // ns
    with torch.inference_mode():
        full = forward_features(net.graph, net.params, x, precision=precision)
        heads = forward_features_spatial(
            net.graph, shard_params(net.params, mesh),
            [x[:, i * h:(i + 1) * h].to(d) for i, d in enumerate(mesh.devices)],
            n_shards=ns, crossover=plan.crossover, precision=precision,
            channel_roles=dict(plan.roles))
    err = 0.0
    for hd, f in zip(heads, full):
        d = (hd.float().to(f.device) - f.float()).abs()
        err = max(err, float(d.max()))
        if precision == "highest" and not bool(
                (d <= 2e-4 + 1e-4 * f.float().abs()).all()):
            raise AssertionError(f"{what}: head maps off the bar (max |diff| "
                                 f"{err})")
    n_rows = sum(1 for _, role in plan.roles if role == "row")
    det = Detector(net, mesh=mesh, partition="spatial")
    collectives.reset_counts()
    eager = det._run(det._stage(frame)).cpu()
    coll = dict(collectives.counts)
    moved = dict(collectives.shard_bytes)
    crossed = dict(collectives.device_bytes)
    copies = dict(collectives.copies)
    if (coll.get("psum", 0) != n_rows
            or not 1 <= coll.get("all_gather", 0) <= 6):
        raise AssertionError(f"{what}: collectives {coll}, {n_rows} row convs "
                             f"planned")
    if len(cards) == ns and crossed != moved:
        raise AssertionError(f"{what}: {crossed} bytes crossed between cards, "
                             f"{moved} handed between shards")
    cross_ms = copies_ms(copies, cards) if copies else 0.0
    one = Detector(net)
    want = one.detect_batch(frame)
    _, one_host, one_dev = timed_calls(lambda: one.detect_batch(frame), 10)
    wrappers = dict(path_wrappers(), decode_compact=cuda_decode.decode_compact)
    before = {k: w.launches for k, w in wrappers.items()}
    got = det.detect_batch(frame)
    warm = {k: w.launches - before[k] for k, w in wrappers.items()}
    prog = det._pipeline(1, SRC_HW)
    if not isinstance(prog, _CapturedProgram) or prog.devices != cards:
        raise AssertionError(f"{what}: the program is not one graph over "
                             f"{cards}")
    if warm["decode_compact"] != 2 or warm["nms_suppress"] != 2:
        raise AssertionError(f"{what}: the warm-up and capture launched "
                             f"{warm}: K1c and K2 twice expected")
    for k, v in warm.items():
        counts[k] += v
    replays = prog.replays
    before = {k: w.launches for k, w in wrappers.items()}
    _, host, dev = timed_calls(lambda: det.detect_batch(frame), 10)
    steady = {k: w.launches - before[k] for k, w in wrappers.items()}
    if any(steady.values()) or prog.replays - replays != 10:
        raise AssertionError(f"{what}: steady calls launched {steady} outside "
                             f"the replay, or a call did not replay once")
    packed = det._detect(frame, SRC_HW, None)[0]
    if not torch.equal(eager, packed):
        raise AssertionError(f"{what}: the captured program != eager _run")
    replay = replay_ms(prog)
    # random weights at yolov3's depth move borderline candidates (the bf16
    # bar is gated on tiny for the same reason): logged, not gated
    box = [len(got[0].class_idx), len(want[0].class_idx)]
    row = {"precision": precision, "devices": [str(d) for d in mesh.devices],
           "crossover": plan.crossover, "row_frac": plan.sharded_flop_frac,
           "total_frac": plan.total_sharded_flop_frac, "head_err": err,
           "collectives": coll, "shard_bytes": moved, "card_bytes": crossed,
           "cross_ms": cross_ms, "replay_ms": replay,
           "host_ms": float(np.median(host)),
           "event_ms": float(np.median(dev)),
           "one_host_ms": float(np.median(one_host)),
           "one_event_ms": float(np.median(one_dev)),
           "program_mib": {str(d): prog.bytes_on(d) / 2 ** 20 for d in cards},
           "capture_s": prog.capture_s, "detections": box,
           "design": (f"one multi-device capture over {len(cards)} cards"
                      if len(cards) > 1 else "one capture on one card")}
    log(f"{what} yolov3@416 B=1 on {row['devices']}: crossover node "
        f"{plan.crossover}, sharded FLOP fraction row-only "
        f"{plan.sharded_flop_frac:.3f}, with the channel tail "
        f"{plan.total_sharded_flop_frac:.3f}; head maps against the full "
        f"walk max |diff| {err:.3e}"
        + (" (bar atol 2e-4, rtol 1e-4)" if precision == "highest" else
           " (logged)")
        + f"; collectives a call {coll} ({n_rows} row convs), bytes handed "
        f"between shards {moved} ({sum(moved.values())}), across cards "
        f"{crossed} ({sum(crossed.values())}), those copies alone "
        f"{cross_ms:.4f} ms by graph replay; the program: {row['design']} "
        f"({row['program_mib']} MiB, warm-up + capture {prog.capture_s:.2f} "
        f"s), == eager _run bit for bit, K1c and K2 inside it (no launch in "
        f"10 steady calls), replay {replay:.3f} ms device time; per call "
        f"median over 10: spatial {row['host_ms']:.3f} ms host clock / "
        f"{row['event_ms']:.3f} ms CUDA events against one device at B=1 "
        f"{row['one_host_ms']:.3f} / {row['one_event_ms']:.3f} ms; "
        f"detections {box[0]} against one device's {box[1]} (on {card})")
    del det, one
    return row


def phase_tools(card: str) -> dict:
    """The port's measuring tools and its parameter checkpoint at full width
    on the card (yolov3@416 unless said): (a) ``save_params`` /
    ``load_params`` exact, and a captured bf16 + K1 call on the reloaded
    tree equal to the original's bit for bit; (b) ``tools.gen_golden``'s
    three fixtures against the frozen ones within ``test_golden``'s bars;
    (c) ``tools.bench_serve`` bf16, 20 requests one at a time, then 16
    clients x 8 requests at a 5 ms window and ``max_batch`` 8, 0 errors in
    both; (d) ``tools.bench_scan``
    B=8 ``scan=4`` at bf16 + K1 and int8 K6 + K1, scanned == unscanned bit
    for bit; (e) ``tools.bench_tiny_k`` on tiny@416 B=8 ``scan=8``: the
    truncation audit exact on the untruncated images, then each K's time;
    (f) ``tools.bench_stem`` at 416 and 608 B=8, bf16 and float32, parity
    before timing; (g) ``tools.traffic_model``'s floors for B=8, int8 and
    bf16, beside the profilers' measured marks; (h) the selection variants
    (``bench_topk``, ``bench_select_group``, ``bench_gather``) at N =
    10,647, B=8, K=512, each checked exactly first; (i)
    ``tools.probe_quant_error``'s four modes, ``none`` at mAP 1.0 exactly.
    Returns the kernel wrappers' launches of the phase (zeroed at its
    start): K1, K2 and K6 must have run."""
    import gc
    import json as _json
    import tempfile

    import torch
    from yolov3_tpu_torch import Darknet, Detector
    from yolov3_tpu_torch.graph import load_graph
    from yolov3_tpu_torch.tools import (bench_gather, bench_scan,
                                        bench_select_group, bench_serve,
                                        bench_stem, bench_tiny_k, bench_topk,
                                        gen_golden, probe_quant_error,
                                        traffic_model)
    from yolov3_tpu_torch.weights import (fold_raw, load_params, random_raw,
                                          save_params)

    def say(msg: str) -> None:
        log(f"[tools] {msg}")

    def released() -> None:
        gc.collect()
        torch.cuda.empty_cache()

    wrappers = path_wrappers()
    for w in wrappers.values():
        w.launches = 0
    cfg = REPO / "models" / "yolov3.cfg"
    yolo = load_graph(cfg)

    # (a) the checkpoint
    params = fold_raw(random_raw(yolo, seed=0))
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "yolov3.npz"
        t0 = time.perf_counter()
        save_params(path, params)
        t1 = time.perf_counter()
        loaded = load_params(path)
        t2 = time.perf_counter()
        nbytes = path.stat().st_size
    if set(loaded) != set(params) or not all(
            loaded[i][k].dtype == np.float32
            and np.array_equal(loaded[i][k], params[i][k])
            for i in params for k in ("w", "b")):
        raise AssertionError("[tools] the checkpoint's round trip is not exact")
    frames = np.random.default_rng(21).integers(0, 256, (BATCH, *SRC_HW, 3),
                                                dtype=np.uint8)
    results = []
    for tree in (params, loaded):
        det = Detector(Darknet(cfg, precision="bf16",
                               device=DEVICE).set_params(tree))
        det.detect_batch(frames)                      # warm-up and capture
        prog = det._pipeline(BATCH, SRC_HW)
        replays = prog.replays
        got, _, _ = det._detect(frames, SRC_HW, None)
        if prog.replays != replays + 1:
            raise AssertionError("[tools] the checkpoint call did not replay")
        results.append(got)
        del det, prog
        released()
    if not torch.equal(results[0], results[1]):
        raise AssertionError("[tools] a captured call on the reloaded "
                             "parameters differs from the original's")
    say(f"checkpoint: yolov3 folded tree, {len(params)} convs, {nbytes} bytes "
        f"npz, saved in {t1 - t0:.3f} s, loaded in {t2 - t1:.3f} s, every "
        f"array equal; a captured bf16 + K1 call at B={BATCH} on the reloaded "
        f"tree == the original's bit for bit ({int((results[0][..., 4] > 0).sum())}"
        f" survivors) on {card}")

    # (b) the golden fixtures
    for name in gen_golden.FIXTURES:
        made = gen_golden.make_fixture(name, DEVICE)
        frozen = _json.loads((REPO / "tests" / "data" /
                              f"golden_{name}.json").read_text())
        diffs = gen_golden.check_against(made, frozen)
        if not made["threshold_margin"] > 3 * gen_golden.SCORE_ATOL:
            raise AssertionError(f"[tools] golden {name}: margin "
                                 f"{made['threshold_margin']:.2e}")
        say(f"gen_golden {name}: meets the frozen fixture ({diffs})")
    released()

    # (c) serving under load
    rows = bench_serve.main([
        "--config", "models/yolov3.cfg", "--size", "416", "--precision",
        "bf16", "--seq-requests", "20", "--clients", "16", "--requests", "8",
        "--window-ms", "5", "--max-batch", "8"])
    for row in rows:
        if row["errors"] or row["requests"] != (20 if row["mode"] ==
                                               "sequential" else 128):
            raise AssertionError(f"[tools] bench_serve {row['mode']}: {row}")
    say("bench_serve: 0 errors in both modes (the two JSON lines above), "
        f"on {card}")
    released()

    # (d) scan
    for extra in (["--precision", "bf16"],
                  ["--precision", "int8", "--block-impl", "pallas"]):
        bench_scan.main(["--cfg", "yolov3.cfg", "--size", "416", "--batch",
                         str(BATCH), "--scan", "4", "--dispatches", "2",
                         *extra])
        released()
    say(f"bench_scan: scanned == unscanned bit for bit at bf16 + K1 and int8 "
        f"K6 + K1 (the JSON lines above), on {card}")

    # (e) the K-truncation audit and sweep
    rows = bench_tiny_k.main(["--batch", str(BATCH), "--scan", "8",
                              "--iters", "3"])
    bite = False
    for row in rows:
        for key, cell in row.items():
            if key.startswith("K="):
                if not cell["untruncated_equal"]:
                    raise AssertionError(f"[tools] bench_tiny_k: {row}")
                bite |= bool(cell["truncated_images"]
                             and cell["untruncated_images"])
    say(f"bench_tiny_k: the untruncated images' sets equal at every K "
        f"(a K splitting the images: {bite}), on {card}")
    released()

    # (f) the stem
    for size in (416, 608):
        for dtype in ("bf16", "f32"):
            r = bench_stem.run(size, BATCH, dtype, DEVICE)
            say(f"bench_stem {size} B={BATCH} {dtype}: parity "
                f"{r['parity_rel']:.2e}; device ms by graph replay " +
                ", ".join(f"{k} {v:.4f}" for k, v in r["ms"].items()) +
                f" on {card}")
    released()

    # (g) the traffic floors beside the measured marks
    for precision in ("int8", "bf16"):
        floors = traffic_model.stage_floors(yolo, 416, BATCH, precision)
        measured = traffic_model.measured_marks(yolo, 416, BATCH, precision,
                                                False, DEVICE)
        say(f"traffic_model yolov3@416 B={BATCH} {precision}: floors at the "
            f"card's peaks against the profiler's prefixes ({'profile_int8, blocks unfused' if precision == 'int8' else 'profile_layers, cuDNN'}) on {card}")
        traffic_model.table(floors, measured, log=say)
        released()

    # (h) the selection stage
    for tool, make in ((bench_topk, bench_topk.variants),
                       (bench_select_group, bench_select_group.variants()),
                       (bench_gather, bench_gather.variants)):
        bench_topk.run(BATCH, bench_topk.N_416, 512, 0.02, DEVICE, make,
                       log=lambda s, t=tool.__name__.rsplit(".", 1)[1]:
                       say(f"{t} N={bench_topk.N_416} B={BATCH} K=512 "
                           f"(checked exactly first): {s}"))
    released()

    # (i) the int8 error probe
    maps = probe_quant_error.score_modes(DEVICE)
    if maps["none"] != {"mAP50": 1.0, "mAP50_95": 1.0}:
        raise AssertionError(f"[tools] probe_quant_error none: {maps['none']}")
    say(f"probe_quant_error on eval_golden.json: {maps} on {card}")

    launches = {n: w.launches for n, w in wrappers.items()}
    for name in ("decode_packed", "nms_suppress", "residual_block_int8"):
        if not launches[name]:
            raise AssertionError(f"[tools] {name} never launched in the "
                                 f"phase: {launches}")
    say(f"kernel launches of the phase: {launches}")
    return launches


BENCH_DEADLINE = 600   # s, the default matrix's own --deadline
BENCH_SCAN = 2


def bench_rows_ok(line: dict, what: str) -> None:
    """The bench's last line: no error, every row measured (``img_s`` > 0;
    the latency row's batches ``img_s_sync`` > 0), none with ``error``."""
    if "error" in line or not line["value"] > 0:
        raise AssertionError(f"[bench] {what}: {line}")
    for key, row in line["rows"].items():
        rates = ([r["img_s_sync"] for k, r in row.items() if k.startswith("b")]
                 if key.startswith("latency") else [row.get("img_s", 0)])
        if "error" in row or not rates or not all(v > 0 for v in rates):
            raise AssertionError(f"[bench] {what}: row {key!r}: {row}")


def phase_bench(card: str) -> dict:
    """The port's benchmark (``yolov3_tpu_torch/bench.py``). (i) In
    process at yolov3@416 B=8 bf16 ``scan=2``: ``make_step``'s step eager
    on three staged inputs, then captured (``capture_step``: its warm-up
    and capture launch K1 and K2 once a forward, 2 x scan each) and
    replayed on the same inputs: each step's (sum of scores, survivors)
    equal to the eager one's bit for bit, and no wrapper launch in the
    replays. (ii) ``python -m yolov3_tpu_torch.bench --quick``, then the
    default matrix with ``--deadline`` BENCH_DEADLINE, as subprocesses the
    way a user runs them: each last line parses, every row measured and
    none with ``error``; their stderr (each row's peak memory) is echoed.
    Returns the in-process launches and both lines."""
    import gc

    import torch
    from yolov3_tpu_torch import bench
    from yolov3_tpu_torch.graph import load_graph
    from yolov3_tpu_torch.tools.clock import event_ms

    t_phase = time.perf_counter()
    device = torch.device(DEVICE, torch.cuda.current_device())
    yolo = load_graph(REPO / "models" / "yolov3.cfg")
    _, params = bench._bench_raw(yolo)
    step = bench.make_step(yolo, bench.device_params(params, device,
                                                     torch.bfloat16),
                           (416, 416), precision="bf16", scan=BENCH_SCAN)
    shape = (BENCH_SCAN * BATCH, 416, 416, 3)
    inputs = bench._stage(np.random.default_rng(7), shape, 3, device)
    with torch.inference_mode():
        eager = [tuple(t.clone() for t in step(x)) for x in inputs]
    wrappers = path_wrappers()
    for w in wrappers.values():
        w.launches = 0
    prog = bench.capture_step(step, shape, device)
    captured = {n: w.launches for n, w in wrappers.items()}
    want = {n: 0 for n in wrappers}
    want.update(decode_packed=2 * BENCH_SCAN, nms_suppress=2 * BENCH_SCAN,
                **{n: 2 * BENCH_SCAN * v for n, v in zip(
                    ("conv_epilogue", "conv_epilogue_residual"),
                    epilogue_launches(yolo, "pallas"))})
    if captured != want:
        raise AssertionError(f"[bench] warm-up + capture launched {captured}, "
                             f"expected {want}")
    for i, x in enumerate(inputs):
        got = bench.call_step(prog, x)
        if not all(torch.equal(g, e) for g, e in zip(got, eager[i])):
            raise AssertionError(f"[bench] captured step {i} {got} differs "
                                 f"from the eager step {eager[i]}")
    replay = event_ms(prog.graph.replay, iters=10, warmup=1)
    replays = {n: w.launches - captured[n] for n, w in wrappers.items()}
    if any(replays.values()):
        raise AssertionError(f"[bench] the replays launched {replays}")
    log(f"[bench] make_step yolov3@416 bf16 B={BATCH} scan={BENCH_SCAN}: "
        f"captured == eager bit for bit on 3 inputs "
        f"({[(float(s), int(n)) for s, n in eager]}); warm-up + capture "
        f"{prog.capture_s:.2f} s launching {captured}; replay "
        f"{replay:.3f} ms ({BENCH_SCAN * BATCH / replay * 1e3:.1f} img/s), "
        f"0 launches in the replays, on {card}")
    prog.close()
    del prog, step, inputs, eager
    gc.collect()
    torch.cuda.empty_cache()

    lines = {}
    for name, flags, limit in (
            ("quick", ["--quick"], 300),
            ("matrix", ["--deadline", str(BENCH_DEADLINE)],
             BENCH_DEADLINE + 60)):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "yolov3_tpu_torch.bench",
                            *flags], cwd=REPO, capture_output=True, text=True,
                           timeout=limit)
        for ln in r.stderr.strip().splitlines():
            log(f"[bench] {name} | {ln}")
        out = r.stdout.strip().splitlines()
        if r.returncode != 0 or not out:
            raise AssertionError(f"[bench] {name}: exit {r.returncode}, "
                                 f"stdout {r.stdout[-2000:]!r}")
        line = json.loads(out[-1])
        bench_rows_ok(line, name)
        lines[name] = line
        log(f"[bench] {name} in {time.perf_counter() - t0:.1f} s: "
            f"{line['metric']} = {line['value']} img/s "
            f"(vs_baseline {line['vs_baseline']}) on {line['card']}")
        for key, row in line["rows"].items():
            log(f"[bench] {name} | {key}: {json.dumps(row)}")
    log(f"[bench] phase in {time.perf_counter() - t_phase:.1f} s")
    return {"launches": captured, "lines": lines}


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
                 "graph_ms": v["graph_ms"],
                 **{k: v[k] for k in ("floor_ms", "graph_ms_one_tile", "blocks",
                                      "tiles", "blocks_k6", "graph_ms_k6",
                                      "bound_ms_k6", "gbps_k6", "copy_ms_k6",
                                      "share_of_copy_k6") if k in v}}
        if "ms_dp4a" in v:
            for key in ("ms_mma", "ms_dp4a", "graph_ms", "graph_ms_mma",
                        "library_graph_ms"):
                entry[key] = v[key]
            entry["ms_of"] = ("one launch at each of the tool's 8 shapes, "
                              "wgmma core")
        out.append(entry)
    return out


# the float walk's conv epilogue: yolov3@608's conv outputs at these
# batches in bf16 (the benchmark's stream and camera cells), and three
# shapes in float32 at B=8: the stem, a residual block's 3x3 at 76x76, a
# head (H, C, activation)
EPI_BATCHES = (32, 8)
EPI_F32_SHAPES = ((608, 32, "leaky"), (76, 256, "leaky"), (19, 255, "linear"))
EPI_SIZE = 608
# the Mish kernel against the library chain (the bias add, F.mish, the
# shortcut's add): the most bf16 / float32 ulps an element may differ by
MISH_ULPS = 0
# a yolov4 forward: 110 convs through the epilogue, 72 of them Mish, 23
# with a shortcut's residual, and 3 heads decoded with a scale_x_y
YOLOV4_EPILOGUES = (110, 72, 23)
YOLOV4_SCALED_HEADS = 3


def epilogue_convs(graph, size: int = EPI_SIZE):
    """yolov3's conv outputs in walk order: (H, C, activation, the
    activation of the shortcut the epilogue takes over, or None)."""
    from yolov3_tpu_torch.model import residual_convs

    plan = residual_convs(graph)
    return [(size // n.downsample, n.filters, n.activation,
             plan[n.index].activation if n.index in plan else None)
            for n in graph.conv_nodes]


def epilogue_operands(gen, bsz: int, h: int, c: int, residual: bool, dtype):
    """NHWC y (with -0, +-inf, a bf16 maximum, a subnormal in its first
    pixel), its bias, and a residual when asked, drawn on the card from
    the generator ``gen``."""
    import torch

    def t(shape, scale):
        return (torch.randn(shape, generator=gen, device=DEVICE) * scale
                ).to(dtype)

    y = t((bsz, h, h, c), 2.0)
    special = torch.tensor([-0.0, float("inf"), float("-inf"), 3.0e38,
                            -3.0e38, 1.0e-39, 1.0, -1.0])[:c]
    y[0, 0, 0, :len(special)] = special.to(DEVICE, dtype)
    return y, t((c,), 1.0), t((bsz, h, h, c), 2.0) if residual else None


def library_chain(y, b, activation, r, res_act):
    """What the walk ran on the card before the epilogue: cuDNN's route
    adds a biased conv's bias with ``add_`` of a (1, C, 1, 1) view of it
    over the NCHW output, then the activation, then (a node later) the
    shortcut's add and activation. In place on ``y``'s bias add."""
    from yolov3_tpu_torch.ops.cuda_epilogue import activate

    out = activate(y.permute(0, 3, 1, 2).add_(b.view(1, -1, 1, 1)), activation)
    if r is not None:
        out = activate(out + r.permute(0, 3, 1, 2), res_act)
    return out.permute(0, 2, 3, 1)


def epilogue_exact(y, b, activation, r, res_act, what: str) -> float:
    """The kernel against the library chain and the plain version, bit for
    bit (each on its own copy of ``y``); returns the largest difference
    measured (0.0 when every element's bits agree; an infinity where one
    side is infinite or NaN and the other not)."""
    import torch
    from yolov3_tpu_torch.ops.cuda_epilogue import (conv_epilogue,
                                                    conv_epilogue_reference)

    ints = torch.int16 if y.element_size() == 2 else torch.int32
    got = conv_epilogue(y.clone(), b, activation, r, res_act)
    want = library_chain(y.clone(), b, activation, r, res_act)
    plain = conv_epilogue_reference(y, b, activation, r, res_act)
    torch.cuda.synchronize()
    err, bad = 0.0, 0
    for name, ref in (("the library chain", want), ("the plain version", plain)):
        differ = got.contiguous().view(ints) != ref.contiguous().view(ints)
        diff = int(differ.sum())
        if diff:
            gap = (got.float() - ref.float()).abs()[differ]
            err = max(err, float(gap.nan_to_num(nan=float("inf")).max()))
            bad += diff
            log(f"[epilogue] {what}: {diff} elements differ from {name} in "
                f"their bits, the largest by {err}")
    if bad:
        raise AssertionError(f"epilogue {what}: the kernel's bits differ "
                             f"from the library chain's or the plain "
                             f"version's (largest difference {err})")
    return err


def ulps(a, b) -> tuple:
    """(elements whose bits differ, the most ulps of a's type between them)
    of two same-type float tensors: each read as its bits in sign-magnitude
    order; NaN against NaN agrees, NaN against a number is infinitely far."""
    import torch

    wide = torch.int32 if a.element_size() == 2 else torch.int64
    ints = torch.int16 if a.element_size() == 2 else torch.int32
    mask = (1 << (8 * a.element_size() - 1)) - 1

    def order(t):
        i = t.contiguous().view(ints).to(wide)
        return torch.where(i < 0, -(i & mask), i)

    both_nan = torch.isnan(a) & torch.isnan(b)
    one_nan = torch.isnan(a) ^ torch.isnan(b)
    differ = (a.contiguous().view(ints) != b.contiguous().view(ints)) & ~both_nan
    gap = (order(a) - order(b)).abs().float()
    gap = torch.where(one_nan, float("inf"), gap)[differ]
    return int(differ.sum()), float(gap.max()) if gap.numel() else 0.0


def mish_check(y, b, r, what: str) -> dict:
    """The Mish kernel (``act1`` mish, a linear shortcut where ``r``) on a
    copy of ``y`` against the library chain and the plain version: the
    elements whose bits differ and their most ulps; raises past
    :data:`MISH_ULPS` or where the kernel does not count a Mish launch."""
    import torch
    from yolov3_tpu_torch.ops.cuda_epilogue import (conv_epilogue,
                                                    conv_epilogue_reference)

    before = conv_epilogue.mish_launches
    got = conv_epilogue(y.clone(), b, "mish", r, "linear")
    want = library_chain(y.clone(), b, "mish", r, "linear")
    plain = conv_epilogue_reference(y, b, "mish", r, "linear")
    torch.cuda.synchronize()
    if conv_epilogue.mish_launches != before + 1:
        raise AssertionError(f"mish epilogue {what}: mish_launches moved by "
                             f"{conv_epilogue.mish_launches - before}")
    out = {}
    for name, ref in (("chain", want), ("plain", plain)):
        n, worst = ulps(got, ref)
        out[name] = (n, worst)
        if worst > MISH_ULPS:
            log(f"[epilogue] mish {what}: {n} of {got.numel()} elements "
                f"differ from the {name}, by up to {worst} ulp")
            raise AssertionError(f"mish epilogue {what}: {worst} ulp from "
                                 f"the {name}, past {MISH_ULPS}")
    return out


def phase_scaled_decode(v4) -> float:
    """K1, K1c and K3 with yolov4's heads (scale_x_y 1.2 / 1.1 / 1.05) at
    608, B=8, float32 and bf16 maps: K1 and K1c within K1's bars of their
    plain versions (``scale_x_y`` passed), K3 exact against the plain
    decode, each counted in ``scaled_heads`` (3 a call); scales of 1 equal
    to the bit to no scales. Returns the largest K1 / K1c difference."""
    import torch
    from yolov3_tpu_torch.ops import cuda_decode as cd
    from yolov3_tpu_torch.ops import decode as plain_decode

    anchors, strides, ncls = head_spec(v4)
    scales = list(v4.head_scales())
    ones = [1.0] * len(scales)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        feats = [torch.from_numpy(h).to(DEVICE, dtype)
                 for h in k1_inputs(v4, seed=6, size=608)]
        offs = cd.candidate_offsets(feats, anchors)
        for prob in (0.0, 0.3):
            before = cd.launch_decode.scaled_heads
            got, _ = cd.decode_packed(feats, anchors, strides, ncls, prob,
                                      scales=scales)
            want = torch.cat([cd.decode_packed_head_reference(
                f, a, st, ncls, prob, off, sxy) for f, a, st, off, sxy in zip(
                    feats, anchors, strides, offs, scales)], dim=1)
            worst = max(worst, check_records(got, want,
                                             f"K1 yolov4 {dtype} prob={prob}"))
            cgot = cd.decode_compact(feats, anchors, strides, ncls, prob,
                                     scales=scales)
            cwant = [cd.decode_compact_head_reference(f, a, st, ncls, prob, sxy)
                     for f, a, st, sxy in zip(feats, anchors, strides, scales)]
            cwant = tuple(torch.cat([p[i] for p in cwant], dim=1)
                          for i in range(3))
            worst = max(worst, check_records(
                compact_record(cgot), compact_record(cwant),
                f"K1c yolov4 {dtype} prob={prob}"))
            if cd.launch_decode.scaled_heads - before != 2 * YOLOV4_SCALED_HEADS:
                raise AssertionError(
                    f"K1 / K1c counted {cd.launch_decode.scaled_heads - before}"
                    f" scaled heads in two calls")
            for fn in (cd.decode_packed, cd.decode_compact):
                a1 = fn(feats, anchors, strides, ncls, prob)
                a2 = fn(feats, anchors, strides, ncls, prob, scales=ones)
                if not all(torch.equal(x, y) for x, y in zip(a1, a2)):
                    raise AssertionError(f"{fn.__name__}: scales of 1 differ "
                                         f"from none")
        before = cd.launch_full_decode.scaled_heads
        got = cd.decode_all(feats, anchors, strides, ncls, scales)
        want = plain_decode.decode_all([f.float() for f in feats], anchors,
                                       strides, ncls, scales)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K3 yolov4 {dtype}: "
                                 f"{int((got != want).sum())} elements differ "
                                 f"from the plain decode")
        if cd.launch_full_decode.scaled_heads - before != YOLOV4_SCALED_HEADS:
            raise AssertionError("K3 miscounted its scaled heads")
        if not torch.equal(cd.decode_all(feats, anchors, strides, ncls),
                           cd.decode_all(feats, anchors, strides, ncls, ones)):
            raise AssertionError("K3: scales of 1 differ from none")
    log(f"[epilogue] K1 / K1c / K3 with yolov4's scale_x_y {scales} at 608 "
        f"B={BATCH}, float32 and bf16 maps: K1 / K1c within K1's bars (max "
        f"|err| {worst!r}), K3 exact; scales of 1 bit for bit no scales; "
        f"{YOLOV4_SCALED_HEADS} scaled heads a call counted")
    return worst


def phase_epilogue_yolov4(card: str) -> dict:
    """yolov4@608 on the card: the Mish kernel against the library chain
    and the plain version at every Mish conv output shape at B=32 and 8
    (with the residual the walk gives it, and without), and in float32 at
    B=8; one forward's 110 epilogues (72 Mish) by graph replay beside the
    bound; a captured yolov4 bf16 + K1 Detector's launches a forward
    (``conv_epilogue.launches`` / ``.mish_launches`` /
    ``.residual_launches`` and ``launch_decode.scaled_heads``)."""
    import torch
    from yolov3_tpu_torch import Darknet, Detector
    from yolov3_tpu_torch.graph import load_graph
    from yolov3_tpu_torch.model import residual_convs
    from yolov3_tpu_torch.ops import cuda_decode as cd
    from yolov3_tpu_torch.ops.cuda_epilogue import (conv_epilogue,
                                                    conv_epilogue_reference)
    from yolov3_tpu_torch.weights import fold_raw, random_raw

    cfg = REPO / "models" / "yolov4.cfg"
    v4 = load_graph(cfg)
    decode_err = phase_scaled_decode(v4)
    convs = epilogue_convs(v4)
    rng = torch.Generator(device=DEVICE).manual_seed(25)
    mish = sorted({(h, c, r) for h, c, a, r in convs if a == "mish"}
                  | {(h, c, None) for h, c, a, _ in convs if a == "mish"},
                  key=str)
    diffs = {"chain": [0, 0.0], "plain": [0, 0.0]}

    def note(out):
        for k, (n, w) in out.items():
            diffs[k][0] += n
            diffs[k][1] = max(diffs[k][1], w)

    for bsz in EPI_BATCHES:
        for h, c, res_act in mish:
            y, b, r = epilogue_operands(rng, bsz, h, c, res_act is not None,
                                        torch.bfloat16)
            # Mish's turns in the last pixel: NaN, softplus's threshold,
            # exp's overflow
            y.view(-1, c)[-1, :4] = torch.tensor(
                [float("nan"), 20.5, -20.5, 89.0], device=DEVICE)[:c].to(y.dtype)
            note(mish_check(y, b, r, f"bf16 B={bsz} {h}x{h}x{c} shortcut "
                                     f"{res_act}"))
            del y, b, r
    for h, c, res_act in mish[:4]:
        y, b, r = epilogue_operands(rng, 8, h, c, res_act is not None,
                                    torch.float32)
        note(mish_check(y, b, r, f"float32 B=8 {h}x{h}x{c} shortcut {res_act}"))
    log(f"[epilogue] yolov4@608 Mish: {len(mish)} variants at B=32 and 8 "
        f"bf16 and 4 float32 against the library chain (bias add_, F.mish, "
        f"the shortcut's add) and the plain version: elements differing, "
        f"most ulps: chain {diffs['chain']}, plain {diffs['plain']} (bar "
        f"{MISH_ULPS} ulp)")

    times = {}
    for bsz in EPI_BATCHES[:1]:
        ops, nbytes, mish_ops, mish_bytes = [], 0, [], 0
        for h, c, act, res_act in convs:
            y, b, r = epilogue_operands(rng, bsz, h, c, res_act is not None,
                                        torch.bfloat16)
            op = (y, b, act, r, res_act or "linear")
            ops.append(op)
            n = (3 if r is not None else 2) * y.numel() * 2
            nbytes += n + c * 2
            if act == "mish":
                mish_ops.append(op)
                mish_bytes += n

        def run(fn, which):
            return lambda: [fn(*op) for op in which]

        times[bsz] = {
            "ms": graph_ms(run(conv_epilogue, ops), iters=3, warmup=1),
            "mish_ms": graph_ms(run(conv_epilogue, mish_ops), iters=3,
                                warmup=1),
            "library_mish_ms": graph_ms(run(library_chain, mish_ops), iters=3,
                                        warmup=1),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "mish_bound_ms": mish_bytes / HBM_BYTES_PER_S * 1e3}
        t = times[bsz]
        log(f"[epilogue] yolov4@608 B={bsz} bf16, one forward's {len(ops)} "
            f"epilogues by graph replay: {t['ms']:.3f} ms (bound "
            f"{t['bound_ms']:.3f}); its {len(mish_ops)} Mish ones "
            f"{t['mish_ms']:.3f} ms (bound {t['mish_bound_ms']:.3f} ms, "
            f"{mish_bytes / 1e9:.2f} GB: {t['mish_bound_ms'] / t['mish_ms']:.1%}"
            f" of it), the library chain {t['library_mish_ms']:.3f} ms; {card}")
        del ops, mish_ops
        torch.cuda.empty_cache()

    # a captured yolov4 Detector's launches a forward
    net = Darknet(cfg, precision="bf16", device=DEVICE).set_params(
        fold_raw(random_raw(v4, seed=25)))
    det = Detector(net, decode_impl="pallas", device=DEVICE)
    frames = np.random.default_rng(25).integers(
        0, 256, (BATCH, *SRC_HW, 3), dtype=np.uint8)
    counters = (lambda: (conv_epilogue.launches, conv_epilogue.mish_launches,
                         conv_epilogue.residual_launches,
                         cd.launch_decode.scaled_heads,
                         cd.decode_packed.launches))
    c0 = counters()
    det.detect_batch(frames)  # warm-up forward and capture: two forwards
    torch.cuda.synchronize()
    c1 = counters()
    det.detect_batch(frames)  # a replay: no launch
    torch.cuda.synchronize()
    c2 = counters()
    per_forward = tuple((b - a) // 2 for a, b in zip(c0, c1))
    want = (*YOLOV4_EPILOGUES, YOLOV4_SCALED_HEADS, 1)
    mish_convs = sum(n.activation == "mish" for n in v4.conv_nodes)
    if (det.route != "pallas" or per_forward != want or c2 != c1
            or (len(v4.conv_nodes), mish_convs, len(residual_convs(v4)))
            != YOLOV4_EPILOGUES
            or any((b - a) % 2 for a, b in zip(c0, c1))):
        raise AssertionError(f"yolov4 Detector ({det.route}): launches a "
                             f"forward (epilogues, Mish, residual, scaled "
                             f"heads, K1) {per_forward}, want {want}; a "
                             f"replay launched {tuple(b - a for a, b in zip(c1, c2))}")
    log(f"[epilogue] yolov4@608 bf16 + K1 Detector, captured: a forward "
        f"launches {per_forward[0]} epilogues, {per_forward[1]} Mish, "
        f"{per_forward[2]} with a residual, {per_forward[3]} scaled heads in "
        f"{per_forward[4]} K1 launch; a replay launches none")
    del det, net
    torch.cuda.empty_cache()
    return {"times": times, "mish_ulps": diffs, "decode_err": decode_err,
            "per_forward": per_forward}


def phase_epilogue(card: str) -> dict:
    """The float walk's conv epilogue (``ops/cuda_epilogue.py``) on the card.

    Bit for bit against the PyTorch chain it replaces and its plain version
    at every yolov3@608 conv output shape at B=32 and B=8 in bf16 (with the
    residual the walk gives it, and a residual conv's shape also without),
    and at three shapes in float32, with and without a residual; one
    forward's 75 epilogues timed by graph replay at each batch beside their
    bound (bytes at HBM's rate), the library chain and the plain version;
    and the walk's head maps at 608 equal bit for bit to the walk node by
    node with biased cuDNN convs (the code before the epilogue), in bf16 at
    B=8 and 32 and in float32 at B=8. Its launches a forward are counted on
    the Detector's captured path, in the main phase. Returns the times and
    the largest difference measured against the chain and the plain
    version."""
    import torch
    import torch.nn.functional as F
    from yolov3_tpu_torch import model as tmodel
    from yolov3_tpu_torch.graph import load_graph
    from yolov3_tpu_torch.model import Darknet, forward_features
    from yolov3_tpu_torch.ops.cuda_epilogue import (conv_epilogue,
                                                    conv_epilogue_reference)
    from yolov3_tpu_torch.weights import fold_raw, random_raw

    torch.backends.cudnn.benchmark = False
    cfg = REPO / "models" / "yolov3.cfg"
    graph = load_graph(cfg)
    convs = epilogue_convs(graph)
    rng = torch.Generator(device=DEVICE).manual_seed(23)
    bf16 = torch.bfloat16
    variants = sorted({v for v in convs} | {(h, c, a, None)
                                              for h, c, a, _ in convs},
                      key=str)
    err = 0.0
    for bsz in EPI_BATCHES:
        for h, c, act, res_act in variants:
            y, b, r = epilogue_operands(rng, bsz, h, c, res_act is not None, bf16)
            err = max(err, epilogue_exact(
                y, b, act, r, res_act or "linear",
                f"bf16 B={bsz} {h}x{h}x{c} {act} shortcut {res_act}"))
            del y, b, r
        log(f"[epilogue] bf16 B={bsz}: {len(variants)} variants of yolov3@608's "
            f"conv outputs ({len(set((h, c) for h, c, _, _ in convs))} shapes, "
            f"the 255-channel heads among them) bit for bit against the "
            f"library chain and the plain version")
    for h, c, act in EPI_F32_SHAPES:
        for res_act in (None, "linear", "leaky"):
            y, b, r = epilogue_operands(rng, 8, h, c, res_act is not None,
                                        torch.float32)
            err = max(err, epilogue_exact(
                y, b, act, r, res_act or "linear",
                f"float32 B=8 {h}x{h}x{c} {act} shortcut {res_act}"))
    log(f"[epilogue] float32 B=8 at {EPI_F32_SHAPES}, without a residual and "
        f"with a linear and a leaky shortcut: bit for bit")

    # one forward's epilogues, by graph replay
    times = {}
    for bsz in EPI_BATCHES:
        ops, nbytes = [], 0
        for h, c, act, res_act in convs:
            y, b, r = epilogue_operands(rng, bsz, h, c, res_act is not None, bf16)
            ops.append((y, b, act, r, res_act or "linear"))
            nbytes += (3 if r is not None else 2) * y.numel() * 2 + c * 2

        def run(fn):
            return lambda: [fn(*op) for op in ops]

        ms = graph_ms(run(conv_epilogue), iters=3, warmup=1)
        lib_ms = graph_ms(run(library_chain), iters=3, warmup=1)
        plain_ms = graph_ms(run(conv_epilogue_reference), iters=3, warmup=1)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        times[bsz] = {"ms": ms, "library_ms": lib_ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bytes": nbytes}
        log(f"[epilogue] yolov3@608 B={bsz} bf16, one forward's {len(ops)} "
            f"epilogues ({sum(op[3] is not None for op in ops)} with a "
            f"residual) by graph replay: kernel {ms:.3f} ms, bound "
            f"{bound_ms:.3f} ms ({nbytes / 1e9:.2f} GB at "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; {bound_ms / ms:.1%} of it), "
            f"the library chain it replaces {lib_ms:.3f} ms, the plain "
            f"version {plain_ms:.3f} ms; {card}")
        del ops
        torch.cuda.empty_cache()

    # the walk's head maps against the code before
    net = Darknet(cfg, precision="bf16", device=DEVICE).set_params(
        fold_raw(random_raw(graph, seed=23)))
    x8 = torch.rand(8, EPI_SIZE, EPI_SIZE, 3, generator=torch.Generator(
        ).manual_seed(23)).to(DEVICE)

    def before_conv(x, w, b, node, conv_impl="xla", residual=None,
                    residual_activation="linear"):
        assert residual is None
        return tmodel._activate(F.conv2d(
            x, w.to(x.dtype), b.to(x.dtype), stride=node.stride,
            padding=node.size // 2 if node.pad else 0), node.activation)

    def heads(params, x, precision, node_by_node: bool):
        saved = tmodel._conv, tmodel.residual_convs
        if node_by_node:
            tmodel._conv = before_conv
            tmodel.residual_convs = lambda graph, upto=None: {}
        try:
            with torch.inference_mode():
                return forward_features(graph, params, x, precision)
        finally:
            tmodel._conv, tmodel.residual_convs = saved

    net32 = Darknet(cfg, device=DEVICE).set_params(
        fold_raw(random_raw(graph, seed=23)))
    for params, bsz, precision in ((net.params, 8, "bf16"),
                                   (net.params, 32, "bf16"),
                                   (net32.params, 8, None),
                                   (net32.params, 8, "highest")):
        x = x8 if bsz == 8 else x8.repeat(4, 1, 1, 1)
        got = heads(params, x, precision, False)
        want = heads(params, x, precision, True)
        for g, w in zip(got, want):
            if not torch.equal(g, w) or g.dtype != w.dtype:
                raise AssertionError(f"yolov3@608 B={bsz} precision="
                                     f"{precision}: the fused walk's head "
                                     f"maps differ from the walk node by node")
    log(f"[epilogue] yolov3@608 head maps bit for bit equal to the walk "
        f"node by node with biased cuDNN convs (bf16 B=8 and 32, float32 None "
        f"and \"highest\" B=8); largest difference of the kernel from the "
        f"chain and the plain version over every case: {err}")
    del net, net32
    torch.cuda.empty_cache()
    return {"times": times, "max_abs_err": err,
            "yolov4": phase_epilogue_yolov4(card)}


# the int8 walk's requantize pass: yolov3@608 at the stream cell's batch; a
# forward's passes outside K6's 10 blocks, and those that take a shortcut
REQ_BATCH, REQ_SIZE = 32, 608
REQ_PER_FORWARD = (51, 13)
# the int8 phase's main-path route whose measured launches the kernel record
# gives: the stream cell's K6 + K1
REQ_ROUTE = "yolov3 [int8 carrier, K6 blocks, K1]"


def requant_differ(got, ref) -> tuple:
    """(elements whose bits differ, the largest absolute difference)."""
    import torch

    if got.dtype != ref.dtype or got.shape != ref.shape:
        return got.numel(), float("inf")
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32}[got.element_size()]
    n = int((got.view(ints) != ref.view(ints)).sum())
    return n, float((got.float() - ref.float()).abs().max())


def smi_samples(device):
    """Start sampling the card's SM clock (MHz) and board power (W) every
    100 ms; returns a function that stops and returns the (clock, power)
    medians, or None where nvidia-smi reads nothing."""
    from yolov3_tpu_torch.bench import smi_id

    try:
        proc = subprocess.Popen(
            ["nvidia-smi", f"--id={smi_id(device)}",
             "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,"
             "nounits", "-lms", "100"], stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True)
    except OSError:
        return lambda: None

    def stop():
        proc.terminate()
        rows = []
        for line in proc.communicate(timeout=30)[0].splitlines():
            try:
                rows.append([float(v) for v in line.split(",")])
            except ValueError:
                continue
        if not rows:
            return None
        return tuple(float(np.median([r[i] for r in rows])) for i in (0, 1))
    return stop


def k6_beside(walks: dict, device, rounds: int = 3, replays: int = 20):
    """K6 in a whole forward beside each producer of its input: each walk of
    ``walks`` ({name: fn}) captured into a CUDA graph, the graphs replayed
    in turn for ``rounds`` rounds, ``replays`` replays a round under the
    profiler. Per name the medians over the rounds of K6's device ms a
    forward (``block_int8_kernel``), the int8 products'
    (``cutlass_80_tensorop_i16832gemm_s8``), all kernels', each of the
    forward's K6 launches' ms in order, and the SM clock and board power
    while it replayed (nvidia-smi; None where it reads nothing)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    graphs = {}
    for name, fn in walks.items():
        fn()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
        graphs[name] = g
    seen = {name: [] for name in graphs}
    for _ in range(rounds):
        for name, g in graphs.items():
            g.replay()
            torch.cuda.synchronize()
            stop = smi_samples(device)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(replays):
                    g.replay()
                torch.cuda.synchronize()
            smi = stop()
            ms = Counter()
            for ev in prof.key_averages():
                if ev.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                t = getattr(ev, "self_device_time_total",
                            getattr(ev, "self_cuda_time_total", 0.0))
                ms["all"] += t
                for key, pat in (("k6", "block_int8_kernel"),
                                 ("int8_mm", "i16832gemm_s8")):
                    if pat in ev.key:
                        ms[key] += t
            k6 = sorted((e.time_range.start, e.time_range.elapsed_us())
                        for e in prof.events()
                        if "block_int8_kernel" in e.name
                        and e.device_type == torch.autograd.DeviceType.CUDA)
            per = len(k6) // replays
            blocks = ([float(np.median([d for _, d in k6[i::per]])) / 1e3
                       for i in range(per)] if per else [])
            seen[name].append({**{k: v / 1e3 / replays for k, v in ms.items()},
                               "blocks": blocks, "smi": smi})
    del graphs
    torch.cuda.empty_cache()
    out = {}
    for name, runs in seen.items():
        med = {k: float(np.median([r[k] for r in runs]))
               for k in ("k6", "int8_mm", "all")}
        per = min(len(r["blocks"]) for r in runs)
        med["blocks"] = [float(np.median([r["blocks"][i] for r in runs]))
                         for i in range(per)]
        smi = [r["smi"] for r in runs if r["smi"]]
        med["sm_mhz"], med["power_w"] = ((float(np.median([v[0] for v in smi])),
                                          float(np.median([v[1] for v in smi])))
                                         if smi else (None, None))
        out[name] = med
    return out


def phase_requant(card: str) -> dict:
    """The int8 walk's requantize pass (``ops/cuda_requant.py``) on the card.

    A yolov3@608 int8 state (random weights of seed 26, symmetric, K6
    blocks) calibrated on 8 seeded frames; one eager walk at B=32 records
    each pass's operands and output: 51 a forward, 13 with a shortcut. On
    every one the kernel's output against its plain version (the chain it
    replaces, on PyTorch's kernels), bit for bit, then the edge sums (0,
    ±(2^24 ± 1), ±(2^31 − 1), .5 ties, ±127.5 and beyond) at each output
    type and activation with and without a shortcut, and a quantized head's
    255 sums in rows 256 apart; the walk's head maps equal bit for bit to
    the walk that runs the plain version. The 51 passes timed by graph
    replay beside their bound (bytes at HBM's rate) and the plain version.
    K6 in a captured forward beside the pass and beside the chain
    (:func:`k6_beside`). A captured K6 + K1 Detector at B=32: the warm-up
    and the capture launch the pass twice a forward's count, steady calls
    none, captured == eager."""
    import torch
    from yolov3_tpu_torch import Darknet, Detector, quant
    from yolov3_tpu_torch.ops import cuda_requant as cr
    from yolov3_tpu_torch.weights import fold_raw, random_raw

    cfg = REPO / "models" / "yolov3.cfg"
    hw = (REQ_SIZE, REQ_SIZE)
    net = Darknet(cfg, precision="bf16", device=DEVICE)
    net.set_params(fold_raw(random_raw(net.graph, seed=26)))
    rng = np.random.default_rng(26)
    calib = rng.integers(0, 256, (BATCH, *SRC_HW, 3), dtype=np.uint8)
    net.quantize_int8(calib, net_hw=hw)
    x = torch.rand(REQ_BATCH, *hw, 3, generator=torch.Generator(
        ).manual_seed(26)).to(DEVICE)

    def walk():
        with torch.inference_mode():
            return quant.forward_features_int8_carrier(
                net.graph, net.qparams, net.act_scales, x, net.precision,
                block_impl="pallas", tensor_zeros=net.act_zeros)

    def plain_walk():
        """The walk with the plain version in the kernel's place: the
        chain the pass replaced, on PyTorch's kernels."""
        kernel, cr.int8_requant = cr.int8_requant, cr.int8_requant_reference
        try:
            return walk()
        finally:
            cr.int8_requant = kernel

    # one forward's passes, recorded with their operands
    calls, kernel = [], cr.int8_requant

    def record(*args):
        out = kernel(*args)
        calls.append((args, out))
        return out

    # the wrapper counts into whatever its module name holds
    record.launches = record.residual_launches = 0
    cr.int8_requant = record
    try:
        heads = walk()
    finally:
        cr.int8_requant = kernel
    torch.cuda.synchronize()
    got = (len(calls), sum(a[6] is not None for a, _ in calls))
    if got != REQ_PER_FORWARD:
        raise AssertionError(f"yolov3@608 int8 walk: {got} passes (with a "
                             f"shortcut), expected {REQ_PER_FORWARD}")
    kinds = Counter((str(a[4]).replace("torch.", ""), a[6] is not None)
                    for a, _ in calls)
    bad, err = 0, 0.0

    def check(out, args, what):
        nonlocal bad, err
        n, e = requant_differ(out, cr.int8_requant_reference(*args))
        if n:
            log(f"[requant] {what}: {n} elements differ from the plain "
                f"version, by up to {e}")
        bad, err = bad + n, max(err, e)

    for args, out in calls:
        check(out, args, f"{tuple(out.shape)} {out.dtype} shortcut "
              f"{args[6] is not None}")
    # edge sums, each output type and activation, with and without
    ties = list(range(1, 259, 2))
    edge_rows = [[0, 1, -1, 2 ** 24 - 1, 2 ** 24, 2 ** 24 + 1, -(2 ** 24 - 1),
                  -(2 ** 24), -(2 ** 24 + 1), 2 ** 31 - 1, -(2 ** 31 - 1),
                  -2 ** 31], ties, [-t for t in ties],
                 [125, 126, 127, 128, 129, 254, 255, 256, -254, -255, -256,
                  2000]]
    acc = torch.zeros((1, 4, len(ties), 16), dtype=torch.int32)
    for i, r in enumerate(edge_rows):
        acc[0, i, :len(r)] = torch.tensor(r, dtype=torch.int32)[:, None]
    acc = acc.to(DEVICE)
    scale = torch.tensor([1.0, 0.5, 0.25, 2.0 ** -10, 1.0, 0.5, 2.0 ** -20,
                          3.0] * 2, device=DEVICE)
    b = torch.tensor([0.0, 0.0, 0.5, 0.0, -0.5, 0.25, 0.0, 0.0] * 2,
                     device=DEVICE)
    qr = torch.from_numpy(rng.integers(-127, 128, tuple(acc.shape)).astype(
        np.int8)).to(DEVICE)
    edges = 0
    for out_dtype in cr.OUT_DTYPES:
        for act in cr.ACTIVATIONS:
            for res_act in (None, "linear", "leaky", "mish"):
                sc = None if res_act is None else cr.Shortcut(qr, 0.5, 1.0,
                                                              res_act)
                args = (acc, scale, b, act, out_dtype, 1.0, sc)
                check(cr.int8_requant(*args), args,
                      f"edge sums {out_dtype} {act} shortcut {res_act}")
                edges += 1
    # a quantized head's 255 sums: _int_mm's 256 columns sliced, rows 256 apart
    wide = torch.randint(-200_000, 200_000, (REQ_BATCH * 76 * 76, 256),
                         device=DEVICE, dtype=torch.int32)
    head = wide[:, :255].reshape(REQ_BATCH, 76, 76, 255)
    args = (head, torch.rand(255, device=DEVICE) * 1e-3,
            torch.randn(255, device=DEVICE), "linear", torch.bfloat16)
    if cr.row_stride(head) != 256:
        raise AssertionError(f"the head's sums lie {cr.row_stride(head)} "
                             f"apart, 256 expected")
    check(cr.int8_requant(*args), args, "a quantized head's 255 sums")
    del wide, head, args
    if bad:
        raise AssertionError(f"requant: {bad} elements differ from the plain "
                             f"version, by up to {err}")
    log(f"[requant] yolov3@608 int8 B={REQ_BATCH}, K6 blocks: one eager walk "
        f"made {got[0]} passes, {got[1]} with a shortcut (output, shortcut: "
        f"{dict(kinds)}); every output, the edge sums ({edges} launches) and "
        f"a quantized head's 255 sums in rows 256 apart bit for bit equal to "
        f"the plain version (0 elements differing, largest difference "
        f"{err})")

    # the head maps against the walk that runs the plain version
    for g, w in zip(heads, plain_walk()):
        n, e = requant_differ(g, w)
        if n:
            raise AssertionError(f"yolov3@608 int8: {n} elements of the head "
                                 f"maps of the walk with the pass differ from "
                                 f"the plain version's, by up to {e}")
        err = max(err, e)
    log(f"[requant] yolov3@{REQ_SIZE} int8 B={REQ_BATCH} head maps bit for "
        f"bit equal to the walk that runs the plain version")
    del heads

    # one forward's passes by graph replay
    ops = [a for a, _ in calls]
    nbytes = sum(a[0].numel() * 4 + out.numel() * out.element_size()
                 + (a[6].q.numel() if a[6] is not None else 0)
                 + a[0].shape[3] * 8 for a, out in calls)
    del calls

    def run(fn):
        return lambda: [fn(*a) for a in ops]

    ms = graph_ms(run(cr.int8_requant), iters=3, warmup=1)
    plain_ms = graph_ms(run(cr.int8_requant_reference), iters=3, warmup=1)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"[requant] yolov3@608 B={REQ_BATCH}, one forward's {len(ops)} passes "
        f"by graph replay: kernel {ms:.3f} ms, bound {bound_ms:.3f} ms "
        f"({nbytes / 1e9:.2f} GB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s; "
        f"{bound_ms / ms:.1%} of it), the plain version (the chain it "
        f"replaces, on PyTorch's kernels) {plain_ms:.3f} ms; {card}")
    del ops
    torch.cuda.empty_cache()

    # K6 beside the pass and beside the chain, in turn in one process; the
    # pass's forward captured twice, so that two placements of the same
    # forward's tensors show what placement alone moves
    k6 = k6_beside({"pass": walk, "chain": plain_walk,
                    "pass, captured again": walk},
                   torch.device(DEVICE, torch.cuda.current_device()))
    for name, r in k6.items():
        log(f"[requant] K6 in a captured yolov3@608 int8 forward B="
            f"{REQ_BATCH} beside {name}: {r['k6']:.3f} ms a forward "
            f"({len(r['blocks'])} launches: "
            + ", ".join(f"{v:.3f}" for v in r["blocks"])
            + f"), int8 products {r['int8_mm']:.3f} ms, all kernels "
            f"{r['all']:.3f} ms; SM clock {r['sm_mhz']} MHz, board power "
            f"{r['power_w']} W (medians of 3 rounds of 20 replays); {card}")

    # the captured path: launches a forward, none a replay
    det = Detector(net, block_impl="pallas", net_hw=hw)
    frames = rng.integers(0, 256, (REQ_BATCH, *SRC_HW, 3), dtype=np.uint8)
    cr.int8_requant.launches = cr.int8_requant.residual_launches = 0
    det.warmup(REQ_BATCH, SRC_HW)
    per_capture = (cr.int8_requant.launches, cr.int8_requant.residual_launches)
    want = tuple(2 * n for n in requant_launches(det))
    if per_capture != want or want != tuple(2 * n for n in REQ_PER_FORWARD):
        raise AssertionError(f"the int8 Detector's warm-up and capture "
                             f"launched the pass {per_capture} times, "
                             f"expected twice {REQ_PER_FORWARD}")
    prog = det._pipeline(REQ_BATCH, SRC_HW)
    replays = prog.replays
    captured = [det.detect_batch(frames) for _ in range(3)]
    steady = (cr.int8_requant.launches, cr.int8_requant.residual_launches)
    if steady != per_capture or prog.replays - replays != 3:
        raise AssertionError(f"3 steady calls launched the pass "
                             f"{steady[0] - per_capture[0]} times and made "
                             f"{prog.replays - replays} replays")
    ref = det._run(det._stage(frames)).cpu()
    res, _, _ = det._detect(frames, SRC_HW, None)
    if not torch.equal(ref, res) or not all(
            same_detections(c, captured[0]) for c in captured[1:]):
        raise AssertionError("the int8 Detector's captured results differ "
                             "from its eager _run's")
    log(f"[requant] captured yolov3@608 int8 K6 + K1 Detector B={REQ_BATCH}: "
        f"warm-up + capture launched the pass {per_capture[0]} times "
        f"({per_capture[1]} with a shortcut), twice a forward's "
        f"{REQ_PER_FORWARD}; 3 steady calls, 3 replays, no launch; captured "
        f"== eager bit for bit")
    del det, prog, net
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bytes": nbytes, "max_abs_err": err, "k6_beside": k6,
            "kinds": {f"{k[0]}{' shortcut' if k[1] else ''}": v
                      for k, v in kinds.items()}}


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
    from yolov3_tpu_torch.bench import smi_id

    card = card_line()
    log(f"card: {smi_id(torch.device(DEVICE, 0))} (torch's uuid "
        f"{torch.cuda.get_device_properties(0).uuid!s}, "
        f"CUDA_VISIBLE_DEVICES={os.environ.get('CUDA_VISIBLE_DEVICES')})")
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
    for name, phase in (("eval", phase_eval), ("cache", phase_cache),
                        ("profile", phase_profile)):
        if name in phases:
            res[name] = phase(card)
    if "probes" in phases:
        res["probes"] = phase_probes(card)
    if "dots" in phases:
        res["dots"] = phase_dots(card)
    if "native" in phases:
        phase_native()
    if "entry" in phases:
        res["entry"] = phase_entry(card)
    if "serve" in phases:
        res["serve"] = phase_serve(card)
    if "mesh" in phases:
        res["mesh"] = phase_mesh(card)
    if "tools" in phases:
        res["tools"] = phase_tools(card)
    if "bench" in phases:
        res["bench"] = phase_bench(card)
    if "epilogue" in phases:
        res["epilogue"] = phase_epilogue(card)
    if "requant" in phases:
        res["requant"] = phase_requant(card)
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
    epi = res["epilogue"]["times"]
    bf16, f32 = torch.bfloat16, torch.float32
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
    requant_row = next(r for r in MAIN_ROWS if r["name"] == REQ_ROUTE)
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
         "library_ms": k4[bf16][2], "ms_eager": k4[bf16][5],
         # float32 operands (split TF32): the bound is the split-TF32 floor;
         # the library's head conv with TF32 allowed and off
         "ms_float32": k4[f32][0], "plain_ms_float32": k4[f32][1],
         "bound_ms_float32": k4[f32][4],
         "library_ms_float32_tf32": k4[f32][2],
         "library_ms_float32_tf32_off": k4[f32][3],
         "ms_eager_float32": k4[f32][5],
         # 601 classes (three 256-column pieces an anchor), the three heads
         "ms_601_classes": k4["open_images"]["bfloat16"]["ms"],
         "plain_ms_601_classes": k4["open_images"]["bfloat16"]["plain_ms"],
         "bound_ms_601_classes": k4["open_images"]["bfloat16"]["bound_ms"],
         "ms_601_classes_float32": k4["open_images"]["float32"]["ms"],
         "plain_ms_601_classes_float32":
             k4["open_images"]["float32"]["plain_ms"],
         "bound_ms_601_classes_float32":
             k4["open_images"]["float32"]["bound_ms"]},
        {"name": "conv3x3_fused", "route": "cuda",
         "source": "yolov3_tpu_torch/csrc/conv3x3.cu",
         "headers": ["yolov3_tpu_torch/csrc/conv3x3_mma.cuh",
                     "yolov3_tpu_torch/csrc/wgmma_common.cuh"],
         "replaces": "yolov3_tpu/ops/pallas_conv.py:289",
         "launches": launches["conv3x3_fused"], "max_abs_err": k5_err,
         "ms": k5[bf16][0], "plain_ms": k5[bf16][1],
         **bound(k5_bytes, k5_flop, BF16_FLOPS_PER_S),
         "library_ms": k5[bf16][2],
         # float32 operands (split TF32), 29 layers: the bound is the
         # split-TF32 floor; cuDNN with TF32 allowed and off
         "ms_float32": k5[f32][0], "plain_ms_float32": k5[f32][1],
         "bound_ms_float32": k5[f32][4],
         "library_ms_float32_tf32": k5[f32][2],
         "library_ms_float32_tf32_off": k5[f32][3]},
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
        {"name": "conv_epilogue", "route": "cuda",
         "source": "yolov3_tpu_torch/csrc/conv_epilogue.cu",
         # XLA fused the bias, activation and shortcut into the conv
         "replaces": None, "max_abs_err": res["epilogue"]["max_abs_err"],
         # one forward of the main phase's yolov3 bf16 + K1 Detector, on
         # its captured path (warm-up and capture, halved)
         "launches": epilogue_row()["per_forward"]["conv_epilogue"],
         "residual_launches":
             epilogue_row()["per_forward"]["conv_epilogue_residual"],
         "ms_of": "one yolov3@608 forward's 75 epilogues at B=32, bf16",
         **{k: epi[32][k] for k in ("ms", "plain_ms", "bound_ms",
                                    "library_ms")},
         "bound_by": "bytes",
         **{f"{k}_b8": epi[8][k] for k in ("ms", "plain_ms", "bound_ms",
                                           "library_ms")},
         # yolov4@608 B=32: the Mish kernel's 72 epilogues, its ulps from
         # the library chain, and the captured Detector's launches a forward
         **{f"yolov4_{k}": v for k, v in
            res["epilogue"]["yolov4"]["times"][32].items()},
         "yolov4_mish_ulps": res["epilogue"]["yolov4"]["mish_ulps"],
         "yolov4_per_forward": res["epilogue"]["yolov4"]["per_forward"]},
        {"name": "int8_requant", "route": "cuda",
         "source": "yolov3_tpu_torch/csrc/int8_requant.cu",
         # XLA fused the int8 conv's epilogue into lax.conv_general_dilated
         "replaces": None, "max_abs_err": res["requant"]["max_abs_err"],
         # one forward's, as the int8 phase's warm-up and capture measured
         # them on the cell's K6 + K1 route (twice a forward)
         **{k: requant_row["per_capture"][w] // 2 for k, w in (
             ("launches", "int8_requant"),
             ("residual_launches", "int8_requant_residual"))},
         "ms_of": "one yolov3@608 int8 forward's 51 passes at B=32",
         "ms": res["requant"]["ms"], "plain_ms": res["requant"]["plain_ms"],
         "bound_ms": res["requant"]["bound_ms"], "bound_by": "bytes",
         # the plain version is the chain it replaces, on PyTorch's kernels
         "library_ms": res["requant"]["plain_ms"]},
        *probe_records(res["dots"], res["probes"], bound),
    ]}
    for entry in kernels["kernels"]:
        if entry["name"] in res["entry"]:
            entry["launches_entry_path"] = res["entry"][entry["name"]]
            entry["launches_serve_path"] = res["serve"][entry["name"]]
        for phase in ("eval", "cache", "profile", "tools"):
            if res[phase].get(entry["name"]):
                entry[f"launches_{phase}_path"] = res[phase][entry["name"]]
        if res["bench"]["launches"].get(entry["name"]):
            entry["launches_bench_path"] = res["bench"]["launches"][entry["name"]]
        if entry["name"] in res["mesh"]["launches"]:
            entry["launches_mesh_path"] = res["mesh"]["launches"][entry["name"]]
    log(card)
    log(json.dumps({"bench": res["bench"]["lines"]}))
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
