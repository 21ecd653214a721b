"""Sweep the group-max selection width (``ops/nms._select_pairmax_payload``)
on the serving shape, on the card.

Port of ``tools/bench_select_group.py``: the first sort runs over N/G group
maxima while the final sort grows as G·K, so the width trades one against
the other. Each width's selection is checked EXACTLY against the serving
stage it would replace (``ops/nms._select_topk`` on the same candidates)
before it is timed; every width gives the same bits. The payload's score
lane is the thresholded scores, its index lane the candidate index, the
rest seeded noise, as in the reference. Device ms by CUDA graph replay::

    python -m yolov3_tpu_torch.tools.bench_select_group [--batch 8] \\
        [--n 10647] [--k 512] [--groups 2,4,8,16] [--device cuda|cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from . import bench_topk

GROUPS = (2, 4, 8, 16)


def payload_inputs(batch, n, density=0.02, seed=5, device="cpu"):
    """The reference tool's (B, N, 8) payload: lanes uniform in [0, 416),
    lane 4 the scores (uniform in [0.1, 1) on ~``density`` of the
    candidates, 0 elsewhere), lane 6 the candidate index."""
    rng = np.random.default_rng(seed)
    raw = rng.uniform(0.1, 1.0, (batch, n)).astype(np.float32)
    masked = np.where(rng.uniform(0, 1, (batch, n)) < density, raw, 0.0)
    payload = rng.uniform(0, 416, (batch, n, 8)).astype(np.float32)
    payload[:, :, 4] = masked
    payload[:, :, 6] = np.arange(n, dtype=np.float32)[None]
    return torch.from_numpy(payload).to(device)


def variants(groups=GROUPS):
    def make(scores, boxes, classes, k):
        from ..ops.nms import _select_pairmax_payload

        payload = payload_inputs(*scores.shape, device=scores.device)
        ref = bench_topk.Selection(payload[:, :, 4].contiguous(),
                                   payload[:, :, :4].contiguous(),
                                   payload[:, :, 5].to(torch.int32), k)
        # scores come from the payload's own lane 4 (the serving dataflow)
        return [(f"group={g}",
                 lambda g=g: _select_pairmax_payload(
                     payload, payload[:, :, 4], k, group=g),
                 lambda o, g=g: ref.check(f"group={g}", o[1], o[0], o[2]))
                for g in groups]
    return make


def main(argv=None):
    ap = bench_topk.parser(__doc__)
    ap.add_argument("--groups", default=",".join(map(str, GROUPS)))
    args = ap.parse_args(argv)
    return bench_topk.report(args, variants(
        tuple(int(v) for v in args.groups.split(","))))


if __name__ == "__main__":
    main()
