"""Per-layer profile of the float walk on the card: the device time of
each prefix ``graph.nodes[:upto]`` and its marginal over the previous mark.

Port of ``tools/profile_layers.py``. The prefix is the served walk itself,
``model.forward_features(..., upto=)`` (the port's ``_conv`` / ``_maxpool``
/ ``_activate``), not a second implementation, so a mark at full depth
gives ``forward_features``' head maps to the bit; ``conv_impl="pallas"``
sends the eligible 3x3 convs through K5, so the same marks map cuDNN against
K5 layer by layer. Each prefix is timed as device time by CUDA-graph replay
(``clock.graph_ms``: ``--iters`` calls in one graph, the least of
``--reps`` replays), and its graph is freed before the next. The default
marks are the downsample boundaries plus full depth; ``--marks all`` puts
one at every layer, whose marginals are the per-layer map. It prints the
reference's lines, then one JSON line of rows::

    python -m yolov3_tpu_torch.tools.profile_layers [--cfg yolov3.cfg] \\
        [--size 608] [--batch 128] [--marks all|i,j,...] \\
        [--conv-impl xla|pallas] [--device cuda|cuda:N]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..graph import Graph, load_graph
from ..model import forward_features
from ..weights import TorchParams, fold_raw, params_from_jax, random_raw

MODELS = Path(__file__).resolve().parents[2] / "models"


def partial_forward(graph: Graph, params: TorchParams, x: torch.Tensor,
                    upto: int, precision: Optional[str] = None,
                    conv_impl: str = "xla") -> List[torch.Tensor]:
    """The walk of ``graph.nodes[:upto]``: the head maps it reached, then
    the output of node ``upto - 1`` (NHWC)."""
    return forward_features(graph, params, x, precision, conv_impl,
                            upto=upto)


def default_marks(graph: Graph) -> List[int]:
    """The downsample boundaries (after each first stride-2 conv of a new
    resolution) plus full depth, the reference's default."""
    marks, seen = [], set()
    for n in graph.nodes:
        if n.kind == "convolutional" and n.stride > 1 and n.downsample not in seen:
            seen.add(n.downsample)
            marks.append(n.index + 1)
    marks.append(len(graph.nodes))
    return marks


def describe(node, out: torch.Tensor) -> str:
    """One node and its output shape, e.g. ``conv 3x3/1 -> 52x52x256``."""
    what = node.kind[:8]
    if node.kind == "convolutional":
        what = f"conv {node.size}x{node.size}/{node.stride}"
    return f"{what} -> {out.shape[1]}x{out.shape[2]}x{out.shape[3]}"


def profile_layers(graph: Graph, params: TorchParams, x: torch.Tensor,
                   marks: Sequence[int], precision: Optional[str] = "bf16",
                   conv_impl: str = "xla", iters: int = 3, reps: int = 3,
                   log=print) -> List[Dict]:
    """Device milliseconds of each prefix in ``marks`` and its marginal over
    the previous mark; ``log`` gets the reference's line per mark."""
    from .clock import graph_ms

    rows, prev_t = [], 0.0
    for upto in marks:
        out = partial_forward(graph, params, x, upto, precision, conv_impl)
        desc = describe(graph.nodes[upto - 1], out[-1])
        del out
        dt = graph_ms(lambda u=upto: partial_forward(
            graph, params, x, u, precision, conv_impl), iters=iters,
            reps=reps)
        torch.cuda.empty_cache()  # this prefix's graph pool, before the next
        rows.append({"upto": upto, "layer": desc, "ms": dt,
                     "marginal_ms": dt - prev_t})
        log(f"layers[0:{upto:3d}]: {dt:8.4f} ms (marginal "
            f"{dt - prev_t:+8.4f} ms)  {desc}")
        prev_t = dt
    return rows


def random_params(graph: Graph, precision: Optional[str],
                  device) -> TorchParams:
    """``random_raw(graph, 0)`` folded, on ``device``, in the walk's type."""
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    return {i: {k: v.to(dtype) for k, v in p.items()}
            for i, p in params_from_jax(fold_raw(random_raw(graph, 0)),
                                        device).items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cfg", default="yolov3.cfg")
    ap.add_argument("--size", type=int, default=608)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--marks", default=None,
                    help="comma-separated layer indices, or 'all' (default: "
                         "stage boundaries)")
    ap.add_argument("--conv-impl", choices=("xla", "pallas"), default="xla",
                    help="'pallas': the eligible 3x3 convs through K5")
    ap.add_argument("--device", default=None, help="cuda (default) or cuda:N")
    args = ap.parse_args(argv)
    from ..__main__ import _resolve_device

    device = _resolve_device(args.device)
    if device.type != "cuda":
        raise SystemExit("profile_layers times device work: it needs a card")
    g = load_graph(MODELS / args.cfg)
    params = random_params(g, "bf16", device)
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (args.batch, args.size, args.size, 3)).astype(np.float32)
    ).to(device)
    if args.marks == "all":
        marks = list(range(1, len(g.nodes) + 1))
    elif args.marks:
        marks = [int(m) for m in args.marks.split(",")]
    else:
        marks = default_marks(g)
    rows = profile_layers(g, params, x, marks, "bf16", args.conv_impl,
                          iters=args.iters)
    print(json.dumps({"device": torch.cuda.get_device_name(device),
                      "cfg": args.cfg, "size": args.size,
                      "batch": args.batch, "conv_impl": args.conv_impl,
                      "rows": rows}))


if __name__ == "__main__":
    main()
