"""Scanned multi-batch throughput: ``scan`` pipeline steps in ONE program.

Port of ``tools/bench_scan.py``. The reference runs K full uint8→NMS steps
inside one jitted ``lax.scan`` over a pre-staged (K, B, H, W, 3) input, so
what a dispatch costs amortizes K times. The port's counterpart is
``Detector(scan=k)``: a batch of k·B frames runs as k sub-batches of B back
to back in one cached program (on the card one CUDA graph), whose results
leave the device in one copy.

Before timing, the scanned program's results are held to k unscanned calls
(``scan=1``) on the same sub-batches, bit for bit (the packed results, and
so each step's ``(sum of scores, count of survivors)``, the reference's
per-step outputs). Then ``--dispatches`` distinct inputs are timed twice
(host clock around ``detect_batch``, which ends in the one device→host copy
and the host unpack); ``img_s`` is the better block. On the card the
program's replay is also timed alone (CUDA events).

    python -m yolov3_tpu_torch.tools.bench_scan --cfg yolov3-tiny.cfg \\
        --size 416 --batch 128 --scan 8 [--precision bf16|int8] \\
        [--top-k 512] [--int8-heads] [--block-impl xla|pallas] \\
        [--device cuda|cuda:N|cpu]
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cfg", default="yolov3-tiny.cfg")
    ap.add_argument("--size", type=int, default=416)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--scan", type=int, default=8,
                    help="pipeline steps per program call")
    ap.add_argument("--src-hw", default=None,
                    help="source frame resolution H,W (e.g. 1080,1920 for "
                         "the video-path row; default: net size)")
    ap.add_argument("--dispatches", type=int, default=4,
                    help="timed calls per block (distinct inputs)")
    ap.add_argument("--precision", choices=("bf16", "int8"), default="int8")
    ap.add_argument("--prob-thresh", type=float, default=0.05)
    ap.add_argument("--top-k", type=int, default=512)
    ap.add_argument("--int8-heads", action="store_true")
    ap.add_argument("--block-impl", choices=("xla", "pallas"), default="xla",
                    help="int8: residual blocks through K6 ('pallas')")
    ap.add_argument("--device", default=None,
                    help="cuda (default), cuda:N or cpu")
    return ap


def step_sums(packed: np.ndarray, scan: int):
    """Per step: (sum of the survivors' scores, count of survivors) of the
    packed (scan·B, R, 6) results (``pack_results``: score in lane 4, 0
    where no survivor)."""
    steps = packed.reshape(scan, -1, *packed.shape[1:])
    scores = steps[..., 4]
    return ([float(s) for s in scores.sum(axis=(1, 2), dtype=np.float64)],
            [int(v) for v in (scores > 0).sum(axis=(1, 2))])


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    import torch

    from ..__main__ import _resolve_device
    from ..graph import load_graph
    from ..inference import Detector
    from ..model import Darknet
    from ..weights import fold_raw, random_raw

    device = _resolve_device(args.device)
    cfg = REPO / "models" / args.cfg
    g = load_graph(cfg)
    net_hw = (args.size, args.size)
    src_hw = (tuple(int(v) for v in args.src_hw.split(","))
              if args.src_hw else net_hw)
    net = Darknet(cfg, precision="bf16", device=device).set_params(
        fold_raw(random_raw(g, 0)))
    if args.precision == "int8":
        # the reference's state: calibrated at bf16 on 8 seeded frames,
        # weights quantized, no bias correction
        rng = np.random.default_rng(3)
        net.quantize_int8(rng.integers(0, 256, (8, *net_hw, 3), dtype=np.uint8),
                          net_hw=net_hw, quantize_heads=args.int8_heads,
                          bias_correct=False)
    kw = dict(prob_thresh=args.prob_thresh, net_hw=net_hw, top_k=args.top_k,
              block_impl=args.block_impl)
    det = Detector(net, scan=args.scan, **kw)
    one = Detector(net, **kw)

    rng = np.random.default_rng(7)
    inputs = [rng.integers(0, 256, (args.scan * args.batch, *src_hw, 3),
                           dtype=np.uint8) for _ in range(args.dispatches)]
    # scanned == the same sub-batches one call each, bit for bit
    res, _, _ = det._detect(inputs[0], src_hw, None)
    parts = [one._detect(part, src_hw, None)[0]
             for part in np.split(inputs[0], args.scan)]
    if not torch.equal(res, torch.cat(parts)):
        raise AssertionError(f"{g.name}@{args.size} {args.precision}: the "
                             f"scan={args.scan} program differs from "
                             f"{args.scan} unscanned calls")
    sums = step_sums(res.numpy(), args.scan)
    det.detect_batch(inputs[-1])  # warm

    best = 0.0
    per_block = []
    for _ in range(2):
        t0 = time.perf_counter()
        for frames in inputs:
            det.detect_batch(frames)
        dt = time.perf_counter() - t0
        rate = args.scan * args.batch * args.dispatches / dt
        per_block.append(round(rate, 1))
        best = max(best, rate)
    replay_ms = None
    if device.type == "cuda":
        from .clock import event_ms

        prog = det._pipeline(args.scan * args.batch, src_hw)
        replay_ms = event_ms(prog.graph.replay, iters=10, warmup=1)
    out = {
        "cfg": g.name, "size": args.size, "src_hw": list(src_hw),
        "batch": args.batch, "scan": args.scan, "precision": args.precision,
        "top_k": args.top_k, "int8_heads": args.int8_heads,
        "block_impl": args.block_impl, "route": det.route,
        "device": ("cpu" if device.type == "cpu"
                   else torch.cuda.get_device_name(device)),
        "img_s": round(best, 1), "blocks": per_block,
        "ms_per_batch": round(1e3 * args.batch / best, 3),
        "replay_ms": replay_ms,
        "step_score_sums": sums[0], "step_survivors": sums[1],
        "scanned_equal_unscanned": True,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
