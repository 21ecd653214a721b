"""Batch-DP calls over a data mesh beside one device's: the call on the
host clock and its stage split.

A ``Detector(mesh=make_mesh(n))`` call at yolov3@416 B=8 of 480x640 frames
(random weights of seed 0) on each route the ``mesh`` phase of
``chip_smoke.py`` drives: bf16 + K1, bf16 + K4 + K5, int8 K6 + K1, and
bf16 + K1 with ``scan=2``. Beside it stands the same route's Detector on
one device at the same batch. Before the clock, each replica's results
on the first input are held to the single device's at the replica's own
batch (B/n, or sub-batches of B/(2n) under ``scan=2``), bit for bit. Then
``--calls`` distinct seeded batches run once each through the mesh and
the single device, in turns (:func:`turns`, which the ``mesh`` phase runs
too). Per route the tool gives the medians of the host-clock call (around
``detect_batch``, which ends in the device→host copies and the unpack)
and of ``Detector.last_stage_s``: ``h2d_s``, ``dispatch_s`` and
``device_fetch_s``.

    python -m yolov3_tpu_torch.tools.bench_mesh [--devices cuda:0,cuda:0] \\
        [--calls 10] [--route "scan=2 bf16 + K1" ...] [--device cpu]

``--devices``: the mesh's devices (default: every visible card, or
``cuda:0`` twice on a one-card machine, as ``chip_smoke.py`` takes them).
``--device cpu`` runs the checks on two CPU shards and reports no time.
The last line is one JSON object: the rows and each card's name and power
limit. To compare commits, run it from the root of a ``git archive`` of
each, in turns (an older checkout takes a copy of this file).
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

REPO = Path(__file__).resolve().parents[2]
STAGES = ("h2d_s", "dispatch_s", "device_fetch_s")
CFG, SIZE, BATCH, SRC_HW = "yolov3.cfg", 416, 8, (480, 640)

# route → (Darknet keywords, Detector keywords, quantized)
ROUTES = {
    "bf16 + K1": ({}, {}, False),
    "bf16 + K4 + K5": ({"conv_impl": "pallas"},
                       {"decode_impl": "pallas-fused"}, False),
    "int8 K6 + K1": ({}, {"block_impl": "pallas"}, True),
    "scan=2 bf16 + K1": ({}, {"scan": 2}, False),
}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", default=None,
                    help="comma-separated mesh devices (default: every "
                         "visible card, or cuda:0 twice)")
    ap.add_argument("--calls", type=int, default=10,
                    help="timed calls a route (distinct inputs)")
    ap.add_argument("--route", action="append", choices=list(ROUTES),
                    help="a route to run (repeatable; default: every one)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu: CPU shards, checks only")
    return ap


def mesh_devices(spec, device) -> list:
    """The mesh's devices: ``spec`` (comma-separated) when given; else every
    visible card, or ``cuda:0`` twice on a one-card machine; on the CPU two
    CPU shards."""
    import torch

    if spec:
        return [torch.device(d) for d in spec.split(",")]
    if device.type == "cpu":
        return [device] * 2
    n = torch.cuda.device_count()
    return ([torch.device("cuda", i) for i in range(n)] if n >= 2
            else [torch.device("cuda", 0)] * 2)


def same_detections(a, b) -> bool:
    """Two lists of detections equal bit for bit."""
    return len(a) == len(b) and all(
        np.array_equal(x.bbox_tlbr, y.bbox_tlbr)
        and np.array_equal(x.class_prob, y.class_prob)
        and np.array_equal(x.class_idx, y.class_idx) for x, y in zip(a, b))


def in_chunks(det, frames: np.ndarray, b: int) -> list:
    """``det.detect_batch`` on consecutive chunks of ``b`` frames."""
    out = []
    for i in range(0, len(frames), b):
        out += det.detect_batch(frames[i:i + b])
    return out


def medians(host: Sequence, stages: List[Dict[str, float]]) -> dict:
    """Median host-clock ms and median ms of each stage (None for none)."""
    out = {"call_ms": float(np.median(host)) if host else None}
    for k in STAGES:
        out[k[:-2] + "_ms"] = (float(np.median([s[k] for s in stages]) * 1e3)
                               if stages else None)
    return out


def turns(mesh, one, inputs: Sequence[np.ndarray],
          check: Optional[Callable] = None) -> dict:
    """Each input once through ``mesh`` and once through ``one``, which goes
    first alternating. The mesh reads every input from ONE caller array,
    overwritten as soon as the call returns; ``check(i, detections)``
    sees each mesh call's result. On the card: the medians (host clock
    around ``detect_batch``, and ``last_stage_s``) of both, keyed
    ``<stat>_mesh`` and ``<stat>_one``; on the CPU they are None."""
    import torch

    cuda = mesh.device.type == "cuda"
    buf = np.empty_like(inputs[0])
    times = {"mesh": ([], []), "one": ([], [])}
    for i, x in enumerate(inputs):
        for which in (("mesh", "one") if i % 2 else ("one", "mesh")):
            det = mesh if which == "mesh" else one
            if det is mesh:
                buf[...] = x
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = det.detect_batch(buf if det is mesh else x)
            ms = (time.perf_counter() - t0) * 1e3
            if det is mesh:
                buf[...] = 0   # the caller reuses its array at once
                if check is not None:
                    check(i, out)
            if cuda:
                times[which][0].append(ms)
                times[which][1].append(dict(det.last_stage_s))
    return {f"{k}_{which}": v for which, (host, stages) in times.items()
            for k, v in medians(host, stages).items()}


def measure_route(route: str, devices, inputs: Sequence[np.ndarray],
                  cfg: str, size: int) -> dict:
    """One route on the mesh and on one device (module docstring); the
    batch and the frames' size are the inputs'."""
    from ..inference import Detector
    from ..model import Darknet
    from ..parallel import make_mesh
    from ..weights import fold_raw, random_raw

    net_kw, det_kw, quantized = ROUTES[route]
    net = Darknet(REPO / "models" / cfg, precision="bf16",
                  device=devices[0], **net_kw)
    net.set_params(fold_raw(random_raw(net.graph, seed=0)))
    net_hw = (size, size)
    if quantized:
        net.quantize_int8(np.random.default_rng(1).integers(
            0, 256, inputs[0].shape, dtype=np.uint8), net_hw=net_hw)
    kw = dict(det_kw, net_hw=net_hw)
    n = len(devices)
    scan = kw.get("scan", 1)
    b = inputs[0].shape[0] // (n * scan)
    mesh = Detector(net, mesh=make_mesh(n, devices=devices), **kw)
    one = Detector(net, **kw)
    sub = Detector(net, **{k: v for k, v in kw.items() if k != "scan"})
    if not same_detections(mesh.detect_batch(inputs[0]),
                           in_chunks(sub, inputs[0], b)):
        raise AssertionError(f"{route}: the mesh's replicas differ from one "
                             f"device at B={b}")
    one.detect_batch(inputs[0])
    return {"route": route, "detector_route": mesh.route, "shards": n,
            "replica_batch": b, "scan": scan, **turns(mesh, one, inputs)}


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    import torch

    from ..__main__ import _resolve_device

    device = _resolve_device(args.device)
    devices = mesh_devices(args.devices, device)
    rng = np.random.default_rng(19)
    inputs = [rng.integers(0, 256, (BATCH, *SRC_HW, 3), dtype=np.uint8)
              for _ in range(args.calls)]
    rows = []
    for route in args.route or ROUTES:
        rows.append(measure_route(route, devices, inputs, CFG, SIZE))
        print(json.dumps(rows[-1]), flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    cards = None
    if device.type == "cuda":
        from ..bench import card_line

        cards = [card_line(d) for d in dict.fromkeys(devices)]
    out = {"cfg": CFG, "size": SIZE, "batch": BATCH, "src_hw": list(SRC_HW),
           "calls": args.calls, "devices": [str(d) for d in devices],
           "cards": cards, "rows": rows}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
