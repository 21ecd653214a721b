"""NMS working-set sweep: K ∈ {512, 256, 128, 64} on the int8 serving step.

Port of ``tools/bench_tiny_k.py``. Per K it measures:

* **throughput**: the full uint8→NMS int8 serving step (residual blocks
  through K6, decode K1, suppression K2) as ``Detector(scan=...,
  top_k=K)``'s captured program, host clock around ``detect_batch`` (on the
  card also one replay's device time);
* **semantics**: the >K truncation contract (``ops/nms.py``: when more
  than K candidates pass the serving threshold, exactly the K
  highest-scoring enter suppression; otherwise the results are IDENTICAL
  for any K). The audit (:func:`all_k_detection_sets`) runs ONE forward
  and then the packed NMS at every K on that same payload, at two
  candidate regimes: realistic-sparse (objectness bias −6, the default)
  and adversarial-dense (bias −2, with thresholds that walk the score
  cluster's upper tail so per-image counts land inside the K range). It
  reports per-image pre-NMS candidate counts, the images K truncates, and
  detection-set equality against the largest K on the untruncated images
  (must be exact; the truncated ones may differ by contract).

    python -m yolov3_tpu_torch.tools.bench_tiny_k [--batch 128 --scan 8] \\
        [--audit-only] [--device cuda|cuda:N|cpu]

Prints one JSON line per K plus an audit line per (regime, threshold);
``main`` returns them.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]


@torch.inference_mode()
def all_k_detection_sets(net, frames_u8, prob_thresh, ks):
    """One int8 forward (``net`` quantized, int8 carrier, its eligible
    blocks through K6), then NMS at every K on the same payload: a second
    forward per K could move a requantization tie and blur the comparison.
    Returns per-image pre-NMS candidate counts and, per K, per-image
    survivor sets keyed by the exact (box tlbr, class) tuples: identical
    candidates through one suppression give bit-identical boxes, so set
    equality is exact."""
    from ..ops.nms import batched_nms_packed
    from ..ops.preprocess import preprocess
    from ..quant import forward_packed_int8

    net_hw = (frames_u8.shape[1], frames_u8.shape[2])
    f = torch.from_numpy(np.ascontiguousarray(frames_u8)).to(net.device)
    x = preprocess(f.flip(-1), net_hw)
    payload, scores = forward_packed_int8(
        net.graph, net.qparams, net.act_scales, x, prob_thresh=prob_thresh,
        precision="bf16", carrier="int8", block_impl="pallas",
        zeros=net.act_zeros, operands=net.qoperands)
    pre = (scores > 0).sum(dim=1).cpu().numpy()
    sets = {}
    for k in ks:
        res = batched_nms_packed(payload, scores, top_k=k)
        vn = res.valid.cpu().numpy()
        bn = res.boxes.cpu().numpy().astype(np.float64)
        cn = res.classes.cpu().numpy()
        sets[k] = [{(tuple(bn[b, j]), int(cn[b, j]))
                    for j in np.nonzero(vn[b])[0]}
                   for b in range(frames_u8.shape[0])]
    return pre, sets


def audit_row(regime, thresh, pre, sets, ks) -> dict:
    """One audit line: candidate-count percentiles and, per K below the
    largest, the truncated images and set equality on the untruncated."""
    ref_sets = sets[max(ks)]
    out = {"audit": regime, "prob_thresh": thresh,
           "pre_nms_per_image":
               [int(v) for v in np.percentile(pre, [0, 50, 100])]}
    for k in sorted(ks):
        if k == max(ks):
            continue
        untrunc = [b for b in range(len(sets[k])) if pre[b] <= k]
        eq = all(sets[k][b] == ref_sets[b] for b in untrunc)
        out[f"K={k}"] = {"truncated_images": int((pre > k).sum()),
                         "untruncated_images": len(untrunc),
                         "untruncated_equal": bool(eq)}
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="yolov3-tiny.cfg",
                    help="model cfg under models/")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--scan", type=int, default=8)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--size", type=int, default=416)
    ap.add_argument("--prob-thresh", type=float, default=0.05)
    ap.add_argument("--ks", type=int, nargs="+", default=[512, 256, 128, 64])
    ap.add_argument("--dense-threshes", type=float, nargs="+",
                    default=[0.072, 0.080, 0.085, 0.090],
                    help="extra audit thresholds for the dense regime, "
                         "tuned to walk the random-weight score cluster's "
                         "upper tail on tiny@416 (sweep around them for "
                         "other graphs if every row reads all-truncated or "
                         "all-empty)")
    ap.add_argument("--audit-images", type=int, default=16)
    ap.add_argument("--audit-only", action="store_true",
                    help="skip the throughput sweep, run only the "
                         "truncation-contract audit")
    ap.add_argument("--device", default=None,
                    help="cuda (default), cuda:N or cpu")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    from ..__main__ import _resolve_device
    from ..graph import load_graph
    from ..inference import Detector
    from ..model import Darknet
    from ..weights import fold_raw, random_raw

    device = _resolve_device(args.device)
    cfg = REPO / "models" / args.config
    graph = load_graph(cfg)
    vpa = 5 + graph.yolo_nodes[0].classes
    net_hw = (args.size, args.size)

    def make_net(obj_bias):
        """random_raw(seed 0) with the heads' objectness bias set, in bf16,
        quantized as the reference quantizes (calibrated at bf16 on 8
        seeded frames, no bias correction)."""
        raw = random_raw(graph, seed=0)
        for node in graph.conv_nodes:
            if not node.batch_normalize:
                raw[node.index]["bias"][4::vpa] = obj_bias
        net = Darknet(cfg, precision="bf16", device=device).set_params(
            fold_raw(raw))
        rng = np.random.default_rng(3)
        return net.quantize_int8(rng.integers(
            0, 256, (8, *net_hw, 3), dtype=np.uint8), net_hw=net_hw,
            bias_correct=False)

    frames = np.random.default_rng(1).integers(
        0, 256, (args.batch * args.scan, args.size, args.size, 3),
        dtype=np.uint8)
    kind = ("cpu" if device.type == "cpu"
            else torch.cuda.get_device_name(device))
    rows = []
    net = make_net(-6.0)  # the realistic-sparse regime
    for k in ([] if args.audit_only else args.ks):
        det = Detector(net, prob_thresh=args.prob_thresh, net_hw=net_hw,
                       top_k=k, scan=args.scan, block_impl="pallas")
        det.detect_batch(frames)  # warm-up: the capture
        blocks = []
        for _ in range(2):
            t0 = time.perf_counter()
            for _ in range(args.iters):
                det.detect_batch(frames)
            blocks.append(len(frames) * args.iters
                          / (time.perf_counter() - t0))
        replay_ms = None
        if device.type == "cuda":
            from .clock import event_ms

            prog = det._pipeline(len(frames), net_hw)
            replay_ms = event_ms(prog.graph.replay, iters=10, warmup=1)
        row = {"row": f"{graph.name}@{args.size} int8 b{args.batch} "
                      f"scan{args.scan} K={k}", "device": kind,
               "route": det.route, "img_s": round(max(blocks), 1),
               "blocks": [round(b, 1) for b in blocks],
               "replay_ms": replay_ms}
        del det
        print(json.dumps(row), flush=True)
        rows.append(row)

    # regimes x thresholds: the bias shifts the whole candidate-count
    # distribution, and the threshold sweep inside the dense regime walks
    # counts down through the K range so at least one row lands mid-range,
    # where "untruncated images are set-identical across K" has bite
    audit_frames = frames[:args.audit_images]
    ks = sorted(args.ks)
    for regime, obj_bias, threshes in (
            ("sparse(bias-6)", -6.0, (args.prob_thresh,)),
            ("dense(bias-2)", -2.0, (args.prob_thresh, *args.dense_threshes))):
        qnet = net if obj_bias == -6.0 else make_net(obj_bias)
        for thresh in threshes:
            pre, sets = all_k_detection_sets(qnet, audit_frames, thresh, ks)
            row = audit_row(regime, thresh, pre, sets, ks)
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    main()
