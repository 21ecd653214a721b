"""One run of one cell: set-up, the measured window, the comparison with the
reference, and the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:
``configs/<config>.json`` (and the Darknet cfg it names), ``traffic/<mix>.json``
(read by ``loadgen``) and ``metrics/<metric>.py`` (a ``read(run)`` that
returns the number, or None where it finds nothing to read).

A configuration names its plain reference by its ``"reference"`` key: a
module ``reference/<name>.py``, imported as ``reference.<name>``, that
every use of the reference in a run goes through. Such a module has

* ``read_cfg(path) -> Net``: the Darknet cfg the configuration names;
* ``letterbox(frames_bgr, net_hw)``: (B, H, W, 3) uint8 BGR frames to
  (B, 3, net_h, net_w) float32 RGB in [0, 1];
* ``forward(net, weights, x, cast=None, on_conv=None, rounding=None)``:
  each head's raw map; ``on_conv(layer, y)`` sees each convolution's
  output before its activation and returns the output to go on with (the
  weights' scaling, ``inputs.make_weights``);
* ``detect(net, weights, frames_bgr, prob_thresh, iou_thresh, top_k,
  max_results, cast=None, rounding=None) -> (List[Detections], Decoded)``.

``Net``, ``Decoded`` and ``Detections`` are those of ``reference.yolo``, so
that ``check`` and ``counts`` read every module's results alike; a module
may import the parts it shares (``letterbox``, ``select``, ``iou``, the
dataclasses) from ``reference.yolo`` and replace only what differs. The
float8 control's ``fp8_cast`` is shared; the int4 control walks
``reference.yolo`` (``reference.int8``), so a configuration with that
control names ``"yolo"``.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import re
import sys
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

import check
import devtrace
import inputs
import loadgen
from reference import int8, yolo

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "yolov3_tpu")
REFERENCE_BLOCK = 8  # frames a reference forward takes at once
WALKS = ("float32", "fp8", "int4")  # what ``reference_walk`` builds
CONTRACT = ("read_cfg", "letterbox", "forward", "detect")  # a reference module's
MODULE_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


class Fail(RuntimeError):
    """A run that cannot give a result: the message goes to stderr and the
    process exits with 1."""


@dataclass
class Cell:
    name: str
    entry: Dict
    config: Dict
    traffic: Dict
    cfg_path: Path
    reference: ModuleType  # the plain reference the configuration names
    metrics: Dict[str, Dict] = field(default_factory=dict)

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def load_cell(name: str, trace: bool = False) -> Cell:
    man = json.loads(MANIFEST.read_text())
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise Fail(f"no workload {name!r} in {MANIFEST}")
    conf_entry = next(c for c in man["configs"] if c["name"] == entry["config"])
    conf_path = ROOT / conf_entry["file"]
    config = json.loads(conf_path.read_text())
    traffic = json.loads((HERE / "traffic" / f"{entry['traffic']}.json").read_text())
    group = man["per_layer"] if trace else man["end_to_end"]
    metrics = {m["name"]: m for m in group
               if name in m.get("workloads", [name])}
    return Cell(name, entry, config, traffic, HERE / "configs" / config["cfg"],
                reference_module(config, conf_path), metrics)


def reference_module(config: Dict, conf_path: Path) -> ModuleType:
    """The module ``reference.<name>`` that the configuration's
    ``"reference"`` key names, holding the contract above."""
    name = config.get("reference")
    if not isinstance(name, str) or not MODULE_NAME.match(name):
        raise Fail(f"{conf_path}: \"reference\" must name a module of "
                   f"{HERE / 'reference'}, not {name!r}")
    full = f"reference.{name}"
    if importlib.util.find_spec(full) is None:
        raise Fail(f"{conf_path}: no reference module {full!r}")
    mod = importlib.import_module(full)
    missing = [f for f in CONTRACT if not callable(getattr(mod, f, None))]
    if missing:
        raise Fail(f"{conf_path}: reference module {full!r} lacks {missing}")
    return mod


@dataclass
class Run:
    """What a metric's reader reads."""

    cell: Cell
    net: yolo.Net
    setup_s: float
    window_s: float
    served: loadgen.Served
    trace: Optional[devtrace.Trace] = None
    pool: Optional[np.ndarray] = None  # the frames and weights both sides got
    folded: Optional[Dict] = None
    calib: Optional[np.ndarray] = None  # and the calibration frames
    readings: Optional[check.Readings] = None

    @property
    def batches(self) -> float:
        """Batches whose detections came back in the window."""
        return self.served.returned / int(self.cell.traffic["batch"])


def read_metric(name: str, run: Run) -> Optional[float]:
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def calibration_frames(cell: Cell, seed: int, device) -> Optional[np.ndarray]:
    """A quantizing configuration's calibration frames (BGR, the served
    size), made from the seed; None for a float configuration."""
    quant = cell.config.get("quantize")
    if not quant:
        return None
    return inputs.make_frames(int(quant["frames"]), cell.traffic["frame_hw"],
                              seed, 1, device)


def build_detector(cell: Cell, folded, calib: Optional[np.ndarray], devices):
    """The program under test, built through its public API from the
    seed's weights (and, for the int8 tier, calibration frames)."""
    from yolov3_tpu_torch import Darknet, Detector

    cfg = cell.config
    dev0 = devices[0]
    net = Darknet(str(cell.cfg_path), precision=cfg["precision"],
                  conv_impl=cfg["conv_impl"], device=dev0)
    net.set_params(folded)
    if calib is not None:
        # quantize_int8 takes RGB frames; the served ones arrive BGR
        net.quantize_int8(np.ascontiguousarray(calib[..., ::-1]),
                          **cfg["quantize"].get("options", {}))
    mesh = None
    if len(devices) > 1:
        from yolov3_tpu_torch.parallel import make_mesh

        mesh = make_mesh(devices=list(devices))
    return Detector(net, prob_thresh=cfg["prob_thresh"],
                    iou_thresh=cfg["iou_thresh"], top_k=cfg["top_k"],
                    mesh=mesh, decode_impl=cfg["decode_impl"],
                    max_results=cfg["max_results"],
                    partition=cell.traffic.get("partition", "data"),
                    block_impl=cfg["block_impl"], device=dev0)


def as_reference(d) -> yolo.Detections:
    """A program Detection as the reference's record."""
    return yolo.Detections(np.asarray(d.bbox_tlbr, np.float32),
                           np.asarray(d.class_prob, np.float32),
                           np.asarray(d.class_idx).astype(np.int64))


def reference_walk(ref: ModuleType, net: yolo.Net, weights,
                   calib: Optional[np.ndarray], kind: str) -> Tuple[Dict, Dict]:
    """(weights, ``ref.detect``'s rounding arguments) of a walk held
    against the program: ``"float32"``, the plain reference; ``"fp8"``, it
    with every convolution's operands rounded to float8 (a bf16
    configuration's control); ``"int4"``, the int8 scheme of
    ``reference.int8`` recomputed from the calibration frames at int4 (an
    int8 configuration's control). An int8 walk, tried in the reference's
    place, read the sound int8 program no closer than float32 does: a
    quantized walk moves a level wherever its input moves by a rounding."""
    if kind == "float32":
        return weights, {}
    if kind == "fp8":
        return weights, {"cast": yolo.fp8_cast}
    if kind != "int4" or calib is None:
        raise Fail(f"no {kind} walk for a configuration without calibration frames")
    if ref is not yolo:
        raise Fail(f"the int4 control walks reference.yolo, not {ref.__name__}")
    device = next(iter(weights.values()))[0].device
    x = ref.letterbox(torch.from_numpy(calib).to(device), (net.height, net.width))
    qw, walk = int8.quantize(net, weights, x, int8.INT4)
    return qw, {"rounding": walk}


def reference_readings(cell: Cell, net: yolo.Net, folded, pool: np.ndarray,
                       frames: List[int], served: Optional[Dict[int, List]],
                       device, calib: Optional[np.ndarray] = None
                       ) -> check.Readings:
    """The reference's walk of ``frames`` against ``served[i]``, the
    program's detections for frame ``i`` (every distinct result the window
    gave), or, where ``served`` is None, against the configuration's
    control standing in the program's place (:func:`reference_walk`)."""
    cfg = cell.config
    weights = {i: (torch.from_numpy(f["w"]).permute(3, 2, 0, 1).to(device),
                   torch.from_numpy(f["b"]).to(device))
               for i, f in folded.items()}
    ref = cell.reference
    ref_w, ref_kw = reference_walk(ref, net, weights, calib, "float32")
    if served is None:
        ctrl_w, ctrl_kw = reference_walk(ref, net, weights, calib, cfg["control"])
    kw = dict(prob_thresh=cfg["prob_thresh"], iou_thresh=cfg["iou_thresh"],
              top_k=cfg["top_k"], max_results=cfg["max_results"])
    port, refs, cands = [], [], []
    net_hw = (net.height, net.width)
    with torch.inference_mode():
        for lo in range(0, len(frames), REFERENCE_BLOCK):
            ids = frames[lo:lo + REFERENCE_BLOCK]
            x = torch.from_numpy(pool[ids]).to(device)
            dets, dec = ref.detect(net, ref_w, x, **kw, **ref_kw)
            if served is None:
                ctrl, _ = ref.detect(net, ctrl_w, x, **kw, **ctrl_kw)
            for j, i in enumerate(ids):
                c = check.candidates(dec, j, tuple(pool.shape[1:3]), net_hw)
                got = [ctrl[j]] if served is None else served[i]
                for g in got:
                    port.append(g)
                    refs.append(dets[j])
                    cands.append(c)
    return check.compare(port, refs, cands, cfg["prob_thresh"], cfg["iou_thresh"])


def distinct_results(served: loadgen.Served, frames: List[int]) -> Dict[int, List]:
    """Per sampled frame, every distinct detection set the window served."""
    out: Dict[int, Dict[bytes, yolo.Detections]] = {i: {} for i in frames}
    for i, d in zip(served.frames, served.detections):
        if i in out:
            r = as_reference(d)
            out[i].setdefault(r.boxes.tobytes() + r.scores.tobytes()
                              + r.classes.tobytes(), r)
    return {i: list(v.values()) for i, v in out.items()}


def synchronize(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def card_info(devices) -> Dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(devices[0]),
            "count": len(devices),
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d)
                                     for d in devices)}


def measure(cell: Cell, seed: int, seconds: float, trace: bool, devices,
            t_start: float) -> Tuple[Dict, Run]:
    """One run: returns the result line's object (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, maybe
    ``breakdown``, ``compared``, then ``checked``) and what the metrics
    read."""
    net = cell.reference.read_cfg(cell.cfg_path)
    traffic = cell.traffic
    pool = inputs.make_frames(int(traffic["pool"]), traffic["frame_hw"], seed,
                              0, devices[0])
    folded = inputs.as_folded_hwio(
        inputs.make_weights(cell.reference, net, seed, devices[0]))
    calib = calibration_frames(cell, seed, devices[0])
    det = build_detector(cell, folded, calib, devices)
    drv = loadgen.driver(det, pool, traffic)
    drv.warm()
    synchronize(devices)
    setup_s = time.perf_counter() - t_start
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if devices[0].type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    with torch.profiler.record_function(devtrace.WINDOW) if trace else nullcontext():
        window_s = loadgen.run_window(drv, seconds)
    if prof is not None:
        synchronize(devices)
        prof.stop()
    drv.finish()
    device = (card_info(devices) if devices[0].type == "cuda" else
              {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0})
    run = Run(cell, net, setup_s, window_s, drv.served, pool=pool, folded=folded,
              calib=calib)
    if prof is not None:
        run.trace = devtrace.reduce(prof, [d.index or 0 for d in devices])
        del prof
        device["busy_s"] = run.trace.mean_busy_s
        device["window_s"] = run.trace.window_s
    metrics = {}
    for name, spec in cell.metrics.items():
        value = read_metric(name, run)
        if value is not None:
            metrics[name] = {"value": value, "unit": spec["unit"]}
    # the program's state goes before the reference runs on the same card
    served = drv.served
    frames = loadgen.sample_frames(served, int(traffic["sample"]), seed)
    results = distinct_results(served, frames)
    del drv, det
    gc.collect()
    if devices[0].type == "cuda":
        torch.cuda.empty_cache()
    readings = reference_readings(cell, net, folded, pool, frames, results,
                                  devices[0], calib)
    run.readings = readings
    checked = check.verdict(readings, cell.config["limits"])
    found = forbidden_modules()
    if found:
        raise Fail(f"modules of the JAX stack loaded: {found}")
    lost = served.submitted - served.returned
    out = {"correct": all(v["ok"] for v in checked.values()),
           "attempted": served.submitted, "failed": 0,
           "metrics": metrics, "device": device}
    if run.trace is not None:
        out["breakdown"] = run.trace.breakdown()
    out["compared"] = {"frames": frames, "results": readings.images,
                       "detections": readings.detections,
                       "reference_detections": readings.reference_detections,
                       "left_out": readings.left_out,
                       "strong": readings.strong,
                       "strong_missed": readings.missed,
                       "images_lost": readings.images_lost,
                       "det_gap_max": readings.det_gap_max,
                       "in_flight_at_close": lost}
    out["checked"] = {k: {"value": v["value"], "limit": v["limit"]}
                      for k, v in checked.items()}
    return out, run


def devices_for(chips: int) -> List[torch.device]:
    if not torch.cuda.is_available():
        raise Fail("torch.cuda.is_available() is False: the benchmark runs "
                   "on the card only")
    if torch.cuda.device_count() < chips:
        raise Fail(f"the cell needs {chips} cards, {torch.cuda.device_count()} "
                   "visible")
    return [torch.device("cuda", i) for i in range(chips)]


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="One run of one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = load_cell(args.workload, trace=bool(args.trace))
        devices = devices_for(cell.chips)
        out, _ = measure(cell, args.seed, args.seconds, bool(args.trace),
                         devices, t_start)
    except Fail as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 1
    print(f"compared {json.dumps(out.pop('compared'))}", file=sys.stderr)
    for k, v in out["checked"].items():
        print(f"checked {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0
