"""int8 error-budget probe: which rounding dominates the accuracy gap?

Port of ``tools/probe_quant_error.py``. The pinned synthetic eval
(``tests/data/eval_golden.json``, scored by the port's
``tools/eval_coco.py``) holds the int8 pipeline below the float32 ground
truth's mAP 1.0. This probe fake-quantizes ONE factor at a time in an
otherwise float32 ("highest", no TF32) pipeline and scores each mode:

* ``none``:      nothing quantized; must score mAP50 = mAP50_95 = 1.0;
* ``weights``:   conv weights → per-channel int8 grid (sw·round(w/sw)),
                 activations exact;
* ``acts-sym``:  conv inputs → per-tensor SYMMETRIC int8 fake-quant
                 (s·clip(round(x/s), ±127)), weights exact;
* ``acts-asym``: conv inputs → per-tensor ASYMMETRIC uint8 fake-quant
                 (zero-point at the calibrated min, 255 steps across
                 [min, max]), weights exact.

The eligible convs are ``quant.eligible``'s; the activation ranges come
from :func:`calibrate_minmax` over the fixture's frames::

    python -m yolov3_tpu_torch.tools.probe_quant_error [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from .eval_coco import evaluate
from .gen_eval_golden import CFG, NET_HW, SEED, detections_to_dicts, make_frames

REPO = Path(__file__).resolve().parents[2]
FIXTURE = REPO / "tests" / "data" / "eval_golden.json"
MODES = ("none", "weights", "acts-sym", "acts-asym")


def calibrate_minmax(graph, params, batches) -> Dict[int, Tuple[float, float]]:
    """Per-tensor (min, max) of every node output over the calibration set
    (the asymmetric analogue of ``calibrate_tensors``' absmax), from the
    float32 calibration walk at precision "highest"."""
    from ..quant import _calibration_walk

    agg: Dict[int, Tuple[float, float]] = {}
    for x in batches:
        acc = {}

        def visit(node, inp, out):
            f = out.float()
            acc[node.index] = torch.stack([f.min(), f.max()])

        _calibration_walk(graph, params, x, "highest", visit)
        keys = list(acc)
        vals = torch.stack([acc[k] for k in keys]).cpu().numpy()
        for i, (lo, hi) in zip(keys, vals):
            plo, phi = agg.get(i, (np.inf, -np.inf))
            agg[i] = (min(plo, float(lo)), max(phi, float(hi)))
    return agg


@torch.inference_mode()
def fake_quant_forward(graph, params, x, mode, minmax, qparams):
    """float32 compact forward with ONE factor fake-quantized per eligible
    conv: (boxes, scores, classes) of the plain compact decode."""
    from ..model import FloatOps, _float_input, _head_spec, walk
    from ..ops.decode import decode_compact
    from ..precision import tf32
    from ..quant import eligible

    if mode not in MODES:
        raise ValueError(mode)
    idx = {n.index for n in graph.conv_nodes if eligible(graph, n)}

    fq_params = params
    if mode == "weights":
        fq_params = dict(params)
        for i in idx:
            qp = qparams[i]
            w_dq = qp["wq"].float() * qp["sw"]               # HWIO
            fq_params[i] = {"w": w_dq.permute(3, 2, 0, 1), "b": params[i]["b"]}

    def maybe_fq(node, t):
        if mode in ("none", "weights") or node.index not in idx:
            return t
        lo, hi = minmax[node.inputs[0]]
        f = t.float()
        if mode == "acts-sym":
            s = max(abs(lo), abs(hi), 1e-6) / 127.0
            return torch.clamp(torch.round(f / s), -127, 127) * s
        s = max(hi - lo, 1e-6) / 255.0
        return torch.clamp(torch.round((f - lo) / s), 0, 255) * s + lo

    class FakeQuantOps(FloatOps):
        """The float walk at precision "highest" with the conv-input
        fake-quant hook."""

        def conv(self, node, x, cache, end):
            return super().conv(node, maybe_fq(node, x), cache, end)

    with tf32(False):
        heads = walk(graph, _float_input(x, "highest"),
                     FakeQuantOps(fq_params))
    return decode_compact(heads, *_head_spec(graph),
                          scales=graph.head_scales())


def score_modes(device=None) -> Dict[str, Dict[str, float]]:
    """Each mode's {mAP50, mAP50_95} against the fixture's ground truth,
    computed on ``device`` (the card unless ``"cpu"``)."""
    from ..graph import load_graph
    from ..inference import Detection
    from ..model import Darknet
    from ..ops.nms import batched_nms_compact
    from ..ops.preprocess import preprocess
    from ..quant import quantize_weights
    from ..weights import random_raw, write_weights

    fx = json.loads(FIXTURE.read_text())
    gt = {int(i): {int(c): np.asarray(b, np.float64) for c, b in per.items()}
          for i, per in fx["gt"].items()}
    g = load_graph(CFG)
    with tempfile.TemporaryDirectory() as tmp:
        wpath = Path(tmp) / "probe.weights"
        write_weights(wpath, g, random_raw(g, seed=SEED))
        net = Darknet(CFG, precision="highest", device=device)
        net.load_weights(wpath)
    params = net.params
    frames = make_frames(fx["seed"], n=fx["n_images"], hw=fx["img_hw"],
                         cell=fx["cell"])
    # the ground-truth Detector consumed these frames as BGR (detect_batch's
    # cv2 convention): swap here so the probe sees the same input tensor
    frames = np.ascontiguousarray(frames[..., ::-1])
    batches = [preprocess(torch.from_numpy(frames[i:i + 8]).to(net.device),
                          NET_HW) for i in range(0, len(frames), 8)]
    minmax = calibrate_minmax(g, params, batches)
    qparams = quantize_weights(g, params)
    x = torch.cat(batches)

    hw = fx["img_hw"]
    out = {}
    for mode in MODES:
        b, s, c = fake_quant_forward(g, params, x, mode, minmax, qparams)
        # the ground truth Detector's working set: the auto top_k preset
        # (256 at tiny@192's candidate count) and the max_results=128 cap
        r = batched_nms_compact(b, s, c, prob_thresh=fx["prob_thresh"],
                                iou_thresh=fx["iou_thresh"], top_k=256,
                                max_results=128)
        boxes, scores, classes, valid = (t.cpu().numpy() for t in r)
        results = []
        for i in range(len(frames)):
            m = valid[i]
            # image == net size here: net coords ARE source coords; clip
            # like the Detector's unmap does
            results.append(Detection(bbox_tlbr=np.clip(boxes[i][m], 0, hw),
                                     class_prob=scores[i][m],
                                     class_idx=classes[i][m]))
        res = evaluate(detections_to_dicts(results), gt)
        out[mode] = {"mAP50": res["mAP50"], "mAP50_95": res["mAP50_95"]}
        print(f"{mode:10s}: mAP50 {res['mAP50']:.4f} "
              f"mAP50_95 {res['mAP50_95']:.4f}", flush=True)
    return out


def main(argv=None) -> Dict[str, Dict[str, float]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)
    from ..__main__ import _resolve_device

    return score_modes(_resolve_device(args.device))


if __name__ == "__main__":
    main()
