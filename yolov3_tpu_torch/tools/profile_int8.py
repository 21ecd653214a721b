"""int8 serving path, stage by stage, on the card: the int8-carrier walk
truncated at each mark, then + packed decode (K1), + pair-max selection,
+ suppression (K2).

Port of ``tools/profile_int8.py``. It builds the reference's state (random
weights, activation scales calibrated on 8 seeded frames, symmetric or
asymmetric, weights quantized with or without the heads; no bias
correction) and times the same stages: prefixes of the EXACT int8-carrier
walk (``quant.forward_features_int8_carrier(upto=)``, whose quantization
decisions come from the full graph) at every downsample boundary plus full
depth, then the serving tail. ``block_impl="pallas"`` runs the eligible
residual blocks through K6, as the Detector does. Each stage is timed as
device time by CUDA-graph replay (``clock.graph_ms``); marginals between
rows are the stage costs. The reference times each stage with a
differential scan clock (two scan lengths, differenced) because each call
on its TPU pays a relay round trip that only a difference cancels; a graph
replay on the card pays no such trip, so one replayed graph is the clock
here. Preprocess is outside the timed stages, as there::

    python -m yolov3_tpu_torch.tools.profile_int8 [--cfg yolov3.cfg] \\
        [--size 608] [--batch 128] [--int8-heads] \\
        [--act-scheme symmetric|asymmetric] [--block-impl xla|pallas] \\
        [--device cuda|cuda:N]
"""
from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..graph import Graph, load_graph
from ..ops.nms import _select_pairmax_payload, batched_nms_packed
from ..ops.preprocess import preprocess
from ..quant import (Operands, calibrate_tensors, calibrate_tensors_affine,
                     forward_features_int8_carrier, forward_packed_int8,
                     quantize_weights)
from ..weights import resolve_device
from .profile_layers import MODELS, default_marks

Stage = Tuple[str, Callable[[torch.Tensor], object]]


class State:
    """An int8-carrier quantization state on ``device``: ``qparams``,
    per-tensor ``scales`` (and ``zeros`` of the asymmetric scheme), the net
    size and the generator of the timed frames; :meth:`calibrated` builds
    the reference's."""

    def __init__(self, graph: Graph, qparams, scales: Dict[int, float],
                 zeros: Optional[Dict[int, int]], net_hw: Tuple[int, int],
                 device=None, rng: Optional[np.random.Generator] = None):
        self.graph, self.qparams, self.scales, self.zeros = (
            graph, qparams, scales, zeros)
        self.net_hw, self.device = tuple(net_hw), resolve_device(device)
        self.rng = rng if rng is not None else np.random.default_rng(3)
        # one set of run-time operands for every stage: the warm-up calls
        # fill them, so nothing is built inside a capture
        self.operands = Operands(qparams)

    @classmethod
    def calibrated(cls, graph: Graph, net_hw: Tuple[int, int],
                   act_scheme: str = "symmetric", int8_heads: bool = False,
                   device=None, seed: int = 3) -> "State":
        """The reference's state: folded ``random_raw(graph, 0)`` weights
        in float32, scales (and zero-points) calibrated at bf16 on one
        batch of 8 seeded frames at ``net_hw``, weights quantized (heads
        too with ``int8_heads``), no bias correction; the same generator
        goes on to make the timed frames."""
        from .profile_layers import random_params

        device = resolve_device(device)
        params = random_params(graph, None, device)
        rng = np.random.default_rng(seed)
        calib = [preprocess(torch.from_numpy(rng.integers(
            0, 256, (8, *net_hw, 3), dtype=np.uint8)).to(device), net_hw)]
        zeros = None
        if act_scheme == "asymmetric":
            scales, zeros = calibrate_tensors_affine(graph, params, calib,
                                                     precision="bf16")
        elif act_scheme == "symmetric":
            scales = calibrate_tensors(graph, params, calib, precision="bf16")
        else:
            raise ValueError(f"unknown act_scheme {act_scheme!r}")
        qparams = quantize_weights(graph, params, include_heads=int8_heads)
        return cls(graph, qparams, scales, zeros, net_hw, device, rng)

    def frames(self, batch: int) -> torch.Tensor:
        """``batch`` seeded uint8 BGR frames at net size → the walk's
        preprocessed input (flip to RGB, normalisation)."""
        f = torch.from_numpy(self.rng.integers(
            0, 256, (batch, *self.net_hw, 3), dtype=np.uint8))
        return preprocess(f.to(self.device).flip(-1), self.net_hw)


def stages(st: State, marks: Sequence[int], prob_thresh: float = 0.05,
           top_k: int = 512, block_impl: str = "xla",
           precision: str = "bf16") -> List[Stage]:
    """The reference's stages as (label, fn(x)): the carrier walk at each
    mark, then + packed decode, + pair-max selection, + suppression."""
    g, qp, sc, zeros, ops = (st.graph, st.qparams, st.scales, st.zeros,
                             st.operands)
    out: List[Stage] = []
    for upto in marks:
        out.append((f"conv walk [0:{upto})",
                    lambda x, u=upto: forward_features_int8_carrier(
                        g, qp, sc, x, precision, upto=u, tensor_zeros=zeros,
                        block_impl=block_impl, operands=ops)))

    def packed(x):
        return forward_packed_int8(g, qp, sc, x, prob_thresh=prob_thresh,
                                   precision=precision, carrier="int8",
                                   block_impl=block_impl, zeros=zeros,
                                   operands=ops)

    out.append(("+ packed decode", packed))
    out.append(("+ pair-max selection",
                lambda x: _select_pairmax_payload(*packed(x), top_k)))
    out.append(("+ suppression (full step)",
                lambda x: batched_nms_packed(*packed(x), top_k=top_k)))
    return out


def profile_int8(st: State, x: torch.Tensor, marks: Sequence[int],
                 prob_thresh: float = 0.05, top_k: int = 512,
                 block_impl: str = "xla", iters: int = 3, reps: int = 3,
                 log=print) -> List[Dict]:
    """Device milliseconds of each stage on ``x`` and its marginal over the
    previous row; ``log`` gets the reference's line per stage."""
    from .clock import graph_ms

    rows: List[Dict] = []
    for label, fn in stages(st, marks, prob_thresh, top_k, block_impl):
        dt = graph_ms(lambda: fn(x), iters=iters, reps=reps)
        torch.cuda.empty_cache()  # this stage's graph pool, before the next
        prev = rows[-1]["ms"] if rows else 0.0
        rows.append({"stage": label, "ms": dt, "marginal_ms": dt - prev})
        log(f"{label:28s}: {dt:8.3f} ms (marginal {dt - prev:+7.3f} ms)")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cfg", default="yolov3.cfg")
    ap.add_argument("--size", type=int, default=608)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--reps", type=int, default=3,
                    help="timed replays of each stage's graph (the least)")
    ap.add_argument("--lens", default="8,40",
                    help="accepted for the reference's command lines and "
                         "unused: a graph replay needs no second scan "
                         "length to cancel a round trip")
    ap.add_argument("--prob-thresh", type=float, default=0.05)
    ap.add_argument("--top-k", type=int, default=512)
    ap.add_argument("--int8-heads", action="store_true",
                    help="quantize the no-BN head projections too")
    ap.add_argument("--act-scheme", choices=("symmetric", "asymmetric"),
                    default="symmetric",
                    help="activation quantization scheme")
    ap.add_argument("--block-impl", choices=("xla", "pallas"), default="xla",
                    help="'pallas': eligible residual blocks through K6")
    ap.add_argument("--device", default=None, help="cuda (default) or cuda:N")
    args = ap.parse_args(argv)
    from ..__main__ import _resolve_device

    device = _resolve_device(args.device)
    if device.type != "cuda":
        raise SystemExit("profile_int8 times device work: it needs a card")
    g = load_graph(MODELS / args.cfg)
    net_hw = (args.size, args.size)
    st = State.calibrated(g, net_hw, args.act_scheme, args.int8_heads,
                          device)
    x = st.frames(args.batch)
    rows = profile_int8(st, x, default_marks(g), args.prob_thresh,
                        args.top_k, args.block_impl, reps=args.reps)
    total = rows[-1]["ms"]
    print(f"\nfull int8 device step "
          f"({'heads int8' if args.int8_heads else 'heads bf16'}): "
          f"{total:.2f} ms = {args.batch / total * 1e3:.1f} img/s "
          f"at b{args.batch}@{args.size}")
    print(json.dumps({"device": torch.cuda.get_device_name(device),
                      "cfg": args.cfg, "size": args.size,
                      "batch": args.batch, "block_impl": args.block_impl,
                      "act_scheme": args.act_scheme, "rows": rows}))


if __name__ == "__main__":
    main()
