"""Regenerate the golden regression fixtures through the port.

Port of ``tools/gen_golden.py``: the same three fixtures (``FIXTURES``:
yolov3-tiny@416 at weight scale 1.0, yolov3@320 and yolov3-spp@320 at 0.9),
the same seeded weights and 480x640 frame, the same threshold-gap rule and
asserts. The frozen fixtures ``tests/data/golden_*.json`` were made by the
JAX package and stay as they are: this writes only into ``--out``, a
directory that may not be ``tests/data/``, and :func:`check_against` holds
what it makes to a frozen fixture within ``tests/test_golden.py``'s bars
(counts and classes exact, scores 5e-5, boxes 0.1 px)::

    python -m yolov3_tpu_torch.tools.gen_golden --out DIR [tiny yolov3 spp] \\
        [--device cuda|cuda:N|cpu]

The reference pins an XLA flag because its CPU conv numerics move with
the virtual device count. Here the forward runs at precision "highest"
(TF32 off) at batch 1: the library picks its conv algorithm by batch size,
so the batch is part of the numerics, as the flag was there.

The prob_thresh is placed in the middle of the largest score gap among
sorted-score ranks [lo_rank, top_k-8), so the survivor count is the number
above the threshold (the rank-``top_k`` truncation never engages) and that
cut carries a recorded margin ("threshold_margin") that must stay more
than 3x the score tolerance.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
FROZEN = REPO / "tests" / "data"
SEED = 777
IOU_THRESH = 0.45
TOP_K = 64
SCORE_ATOL = 5e-5  # tests/test_golden.py's score bar
BOX_ATOL = 0.1     # ... and its box bar, in pixels

# name -> (cfg file, net size, weight scale, min rank for the threshold
# cut); the frame shape (1, 480, 640, 3) is shared
FIXTURES = {
    "tiny": ("yolov3-tiny.cfg", 416, 1.0, 16),
    "yolov3": ("yolov3.cfg", 320, 0.9, 24),
    # spp pins the 4-way SPP route + 5/9/13 maxpool chain
    "spp": ("yolov3-spp.cfg", 320, 0.9, 24),
}


@torch.inference_mode()
def make_fixture(name: str, device=None) -> dict:
    """The fixture ``name`` computed by the port on ``device`` (the card
    unless ``"cpu"``)."""
    from ..graph import load_graph
    from ..model import forward_compact
    from ..ops.nms import batched_nms_compact
    from ..ops.preprocess import preprocess
    from ..weights import fold_raw, params_from_jax, random_raw

    cfg, net, scale, lo_rank = FIXTURES[name]
    g = load_graph(REPO / "models" / cfg)
    params = params_from_jax(fold_raw(random_raw(g, seed=SEED, scale=scale)),
                             device)
    frames = np.random.default_rng(SEED).integers(
        0, 256, (1, 480, 640, 3), dtype=np.uint8)
    dev = params[g.conv_nodes[0].index]["w"].device
    x = preprocess(torch.from_numpy(frames).to(dev).flip(-1), (net, net))
    bx, sc, cl = forward_compact(g, params, x, precision="highest")

    scores = np.sort(sc[0].cpu().numpy().astype(np.float64))[::-1]
    lo, hi = lo_rank, TOP_K - 8  # survivor count lands in (lo, top_k-8]
    window = scores[lo:hi]
    gaps = window[:-1] - window[1:]
    i = int(np.argmax(gaps))
    prob_thresh = float((window[i] + window[i + 1]) / 2)
    margin = float(gaps[i])
    n_above = int((scores > prob_thresh).sum())
    assert lo < n_above < TOP_K, (name, n_above)
    assert margin > 3 * SCORE_ATOL, \
        f"[{name}] best gap {margin:.2e} too small for test_golden's tolerance"

    res = batched_nms_compact(bx, sc, cl, prob_thresh=prob_thresh,
                              iou_thresh=IOU_THRESH, top_k=TOP_K)
    v = res.valid[0].cpu().numpy()
    boxes = res.boxes[0].cpu().numpy()[v].astype(np.float64)
    assert np.abs(boxes).max() < 1e4, \
        f"[{name}] boxes blew up ({np.abs(boxes).max():.1e}) — lower scale"
    return {
        "cfg": cfg,
        "net_size": net,
        "seed": SEED,
        "scale": scale,
        "prob_thresh": prob_thresh,
        "iou_thresh": IOU_THRESH,
        "top_k": TOP_K,
        "threshold_margin": margin,
        "boxes": np.round(boxes, 3).tolist(),
        "scores": res.scores[0].cpu().numpy()[v].astype(np.float64).tolist(),
        "classes": res.classes[0].cpu().numpy()[v].tolist(),
    }


def check_against(fixture: dict, frozen: dict) -> dict:
    """Hold a made fixture to a frozen one within ``tests/test_golden.py``'s
    bars: settings equal, survivor count and classes exact, scores within
    ``SCORE_ATOL``, boxes within ``BOX_ATOL`` px. Raises on a miss; returns
    the largest differences."""
    for key in ("cfg", "net_size", "seed", "scale", "iou_thresh", "top_k"):
        if fixture[key] != frozen.get(key, 1.0 if key == "scale" else None):
            raise AssertionError(f"{key}: {fixture[key]} vs frozen "
                                 f"{frozen.get(key)}")
    if len(fixture["scores"]) != len(frozen["scores"]):
        raise AssertionError(f"{frozen['cfg']}: {len(fixture['scores'])} "
                             f"survivors vs frozen {len(frozen['scores'])}")
    np.testing.assert_array_equal(fixture["classes"], frozen["classes"])
    np.testing.assert_allclose(fixture["scores"], frozen["scores"],
                               atol=SCORE_ATOL, rtol=0)
    np.testing.assert_allclose(fixture["boxes"], frozen["boxes"],
                               atol=BOX_ATOL, rtol=0)
    return {"survivors": len(fixture["scores"]),
            "max_score_diff": float(np.abs(np.subtract(
                fixture["scores"], frozen["scores"])).max(initial=0.0)),
            "max_box_diff": float(np.abs(np.subtract(
                fixture["boxes"], frozen["boxes"])).max(initial=0.0)),
            "prob_thresh_diff": abs(fixture["prob_thresh"]
                                    - frozen["prob_thresh"]),
            "threshold_margin": fixture["threshold_margin"]}


def generate(name: str, out_dir: Path, device=None) -> Path:
    fixture = make_fixture(name, device)
    out = Path(out_dir) / f"golden_{name}.json"
    out.write_text(json.dumps(fixture, indent=1))
    print(f"wrote {out}: {len(fixture['scores'])} survivors, "
          f"prob_thresh={fixture['prob_thresh']:.6f}, "
          f"margin={fixture['threshold_margin']:.3e}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="*",
                    help=f"fixtures to make, of {', '.join(FIXTURES)} "
                         "(default: all)")
    ap.add_argument("--out", required=True,
                    help="directory to write golden_<name>.json into")
    ap.add_argument("--device", default=None,
                    help="cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)
    unknown = sorted(set(args.names) - set(FIXTURES))
    if unknown:
        ap.error(f"unknown fixtures {unknown}")
    out = Path(args.out)
    if out.resolve() == FROZEN.resolve():
        raise SystemExit(f"--out {out}: the frozen fixtures stay as they "
                         "are; write the port's elsewhere")
    out.mkdir(parents=True, exist_ok=True)
    from ..__main__ import _resolve_device

    device = _resolve_device(args.device)
    return [generate(name, out, device) for name in args.names or FIXTURES]


if __name__ == "__main__":
    main()
