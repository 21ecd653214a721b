"""Analytic memory-traffic and tensor-core floors per stage of the walk,
against the card's published peaks, beside the measured stage times.

Port of ``tools/traffic_model.py``. For each node of the graph it counts the
activation bytes the op must move and its MACs, exactly as the reference
does (int8 carrier: a quantized conv reads its int8 input once and writes
its int8 output once, a float conv writes bf16; a shortcut reads two
operands and writes one; a route reads all and writes one; the stem reads
the float32 preprocessed input; weights are left out), and groups them by
``profile_int8``'s marks (the downsample boundaries plus full depth). The
counts do not depend on the hardware. ``precision="bf16"`` counts the bf16
walk instead: every activation 2 bytes, every conv at the bf16 peak.

The times use the card's peaks below, the one definition the port and
``chip_smoke.py`` read: the per-op ``max(bytes, MACs)`` sum of a stage is
its floor (ops run one after another), to hold against the measured
marginals of ``tools/profile_int8.py`` (int8) or ``profile_layers.py``
(bf16), which run on the card by default::

    python -m yolov3_tpu_torch.tools.traffic_model [--cfg yolov3.cfg] \\
        [--size 608] [--batch 128] [--precision int8|bf16] \\
        [--int8-heads] [--device cuda|cuda:N|cpu]

``--device cpu`` prints the floors alone (no device clock there).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Optional

REPO = Path(__file__).resolve().parents[2]

# the card's published dense peaks (NVIDIA H100 SXM data sheet, at the
# full 700 W power limit): HBM3 bytes/s, int8 tensor-core ops/s, bf16
# tensor-core FLOP/s, TF32 tensor-core FLOP/s (split-TF32 float32 work
# runs three of them a product), float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 495e12
FP32_FLOPS_PER_S = 67e12
PRECISIONS = ("int8", "bf16")


def node_rows(graph, size: int, batch: int, precision: str = "int8",
              int8_heads: bool = False) -> List[Dict]:
    """Per node: {index, kind, bytes, macs, peak} (peak in ops/s)."""
    from ..quant import eligible

    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    int8 = precision == "int8"

    def quantized(n) -> bool:
        return int8 and eligible(graph, n, int8_heads)

    hw, bytes_out = {}, {}
    for n in graph.nodes:
        src = n.inputs[0]
        cur = (size, size) if src < 0 else hw[src]
        if n.kind in ("convolutional", "maxpool") and n.stride > 1:
            cur = (cur[0] // n.stride, cur[1] // n.stride)
        elif n.kind == "upsample":
            cur = (cur[0] * n.stride, cur[1] * n.stride)
        elif n.kind == "shortcut":
            cur = hw[n.inputs[1]]
        hw[n.index] = cur
        # int8 carrier: quantized-conv outputs and pass-through forwards are
        # 1 B/elem; bf16 otherwise (the eligibility rule approximates it)
        if n.kind == "convolutional":
            bytes_out[n.index] = 1 if quantized(n) else 2
        else:
            src_b = [bytes_out[i] for i in n.inputs if i >= 0]
            bytes_out[n.index] = min(src_b) if src_b else 2

    def elems(idx):
        h, w = hw[idx]
        return batch * h * w * graph.nodes[idx].out_channels

    rows = []
    for n in graph.nodes:
        src = n.inputs[0]
        c_in = graph.in_channels if src < 0 else graph.nodes[src].out_channels
        read = sum(elems(i) * bytes_out[i] for i in n.inputs if i >= 0)
        if src < 0:
            read = batch * size * size * 3 * 4  # f32 preprocessed in
        write = elems(n.index) * bytes_out[n.index]
        macs = 0
        peak = INT8_OPS_PER_S if int8 else BF16_FLOPS_PER_S
        if n.kind == "convolutional":
            h, w = hw[n.index]
            macs = batch * h * w * n.out_channels * c_in * n.size * n.size
            peak = INT8_OPS_PER_S if quantized(n) else BF16_FLOPS_PER_S
        elif n.kind == "yolo":
            read = write = 0
        rows.append({"index": n.index, "kind": n.kind, "bytes": read + write,
                     "macs": macs, "peak": peak})
    return rows


def stage_marks(graph) -> List[int]:
    """``profile_int8``'s marks: after each first stride-2 conv of a new
    resolution, then full depth."""
    marks, seen = [], set()
    for n in graph.nodes:
        if (n.kind == "convolutional" and n.stride > 1
                and n.downsample not in seen):
            seen.add(n.downsample)
            marks.append(n.index + 1)
    marks.append(len(graph.nodes))
    return marks


def stage_floors(graph, size: int, batch: int, precision: str = "int8",
                 int8_heads: bool = False) -> List[Dict]:
    """Per mark [lo, hi): bytes, MACs, the bytes' floor, the MACs' floor
    and the per-op max summed ("sol"), in ms at the card's peaks."""
    rows = node_rows(graph, size, batch, precision, int8_heads)
    out, lo = [], 0
    for hi in stage_marks(graph):
        part = [r for r in rows if lo <= r["index"] < hi]
        bw = [r["bytes"] / HBM_BYTES_PER_S * 1e3 for r in part]
        mxu = [2 * r["macs"] / r["peak"] * 1e3 for r in part]
        out.append({"lo": lo, "hi": hi,
                    "bytes": sum(r["bytes"] for r in part),
                    "macs": sum(r["macs"] for r in part),
                    "bw_ms": sum(bw), "mxu_ms": sum(mxu),
                    # ops run one after another: the per-op max is the floor
                    "sol_ms": sum(max(b, m) for b, m in zip(bw, mxu))})
        lo = hi
    return out


def measured_marks(graph, size: int, batch: int, precision: str,
                   int8_heads: bool, device) -> List[float]:
    """Device ms of each mark's prefix on the card: ``profile_int8``'s
    int8 walk (symmetric, blocks unfused) or ``profile_layers``' bf16 walk
    (cuDNN convs), by graph replay."""
    import numpy as np
    import torch

    from . import profile_int8, profile_layers

    marks = stage_marks(graph)
    if precision == "int8":
        st = profile_int8.State.calibrated(graph, (size, size), "symmetric",
                                           int8_heads, device)
        rows = profile_int8.profile_int8(st, st.frames(batch), marks,
                                         log=lambda s: None)
        return [r["ms"] for r in rows[:len(marks)]]
    params = profile_layers.random_params(graph, "bf16", device)
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (batch, size, size, 3)).astype(np.float32)).to(device)
    with torch.inference_mode():
        rows = profile_layers.profile_layers(graph, params, x, marks, "bf16",
                                             "xla", log=lambda s: None)
    return [r["ms"] for r in rows]


def table(floors: List[Dict], measured: Optional[List[float]] = None,
          log=print) -> None:
    """The reference's table, with each stage's measured marginal beside
    its floor when ``measured`` (cumulative prefix ms) is given."""
    log(f"{'stage':16s} {'bw-floor':>9s} {'mxu-floor':>9s} {'sol':>9s}"
        + (f" {'measured':>9s} {'x floor':>8s}" if measured else ""))
    prev = 0.0
    for i, f in enumerate(floors):
        line = (f"[{f['lo']:3d}:{f['hi']:3d})        {f['bw_ms']:8.4f}  "
                f"{f['mxu_ms']:8.4f}  {f['sol_ms']:8.4f}")
        if measured:
            marginal = measured[i] - prev
            prev = measured[i]
            line += f"  {marginal:8.4f}  {marginal / f['sol_ms']:7.2f}"
        log(line)
    tot = {k: sum(f[k] for f in floors) for k in ("bw_ms", "mxu_ms", "sol_ms")}
    log(f"{'TOTAL':16s} {tot['bw_ms']:8.4f}  {tot['mxu_ms']:8.4f}  "
        f"{tot['sol_ms']:8.4f}" + (f"  {measured[-1]:8.4f}" if measured
                                    else "") + "  (ms)")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cfg", default="yolov3.cfg")
    ap.add_argument("--size", type=int, default=608)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--precision", choices=PRECISIONS, default="int8")
    ap.add_argument("--int8-heads", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default), cuda:N, or cpu for the floors "
                         "alone")
    args = ap.parse_args(argv)
    from ..__main__ import _resolve_device
    from ..graph import load_graph

    device = _resolve_device(args.device)
    g = load_graph(REPO / "models" / args.cfg)
    floors = stage_floors(g, args.size, args.batch, args.precision,
                          args.int8_heads)
    measured = (measured_marks(g, args.size, args.batch, args.precision,
                               args.int8_heads, device)
                if device.type == "cuda" else None)
    table(floors, measured)
    out = {"cfg": args.cfg, "size": args.size, "batch": args.batch,
           "precision": args.precision, "floors": floors,
           "measured_ms": measured}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
