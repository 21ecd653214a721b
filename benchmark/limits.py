"""The readings a configuration's limits are set from, on the card.

    python3 benchmark/limits.py --workload <cell> --seeds 1,2,3 --seconds 3 \\
        [--control] [--fault NAME] [--trace 1] [--kernels 60]

For each seed, in one process: a short window of the cell's own traffic
through the program, then the comparison with the reference (the numbers
``check`` compares, printed with the limits of the configuration's file);
with ``--control``, the configuration's control in the program's place (the
reference one precision lower, ``harness.reference_walk``), on the same
frames: the control has to fail. ``--fault`` plants one of
``faults.FAULTS`` under the timed path first. ``--kernels N`` prints the N
longest device ops of a traced window (the names the metrics' patterns
match). One JSON line a seed on standard output. The benchmark's own runs do
not run this.
"""
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import argparse  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

import harness  # noqa: E402
from faults import FAULTS  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=sorted(FAULTS))
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--kernels", type=int, default=0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload, trace=bool(args.trace))
    devices = harness.devices_for(cell.chips)
    if args.fault:
        FAULTS[args.fault](setattr)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out, run = harness.measure(cell, seed, args.seconds, bool(args.trace),
                                   devices, t0)
        line = {"seed": seed, "correct": out["correct"],
                "checked": out["checked"],
                "numbers": run.readings.numbers(),
                "strong": run.readings.strong,
                "metrics": {k: v["value"] for k, v in out["metrics"].items()},
                "compared": {k: v for k, v in out["compared"].items()
                             if k != "frames"},
                "per_image": run.readings.per_image,
                "dets_per_image": float(np.mean(
                    [len(d.class_prob) for d in run.served.detections]))}
        if run.trace is not None:
            line["busy_s"] = run.trace.busy_s
            line["window_s"] = run.trace.window_s
            if args.kernels:
                top = sorted(run.trace.kernel_s.items(), key=lambda kv: -kv[1])
                line["kernels"] = top[:args.kernels]
                line["idle_gaps"] = run.trace.idle_gaps[:20]
        if args.control:
            r = harness.reference_readings(cell, run.net, run.folded, run.pool,
                                           out["compared"]["frames"], None,
                                           devices[0], run.calib)
            line["control"] = {"walk": cell.config["control"], **r.numbers(),
                               "strong": r.strong, "strong_missed": r.missed,
                               "images_lost": r.images_lost,
                               "per_image": r.per_image,
                               "det_gap_max": r.det_gap_max,
                               "detections": r.detections,
                               "reference_detections": r.reference_detections,
                               "left_out": r.left_out}
        print(json.dumps(line), flush=True)
        del out, run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
