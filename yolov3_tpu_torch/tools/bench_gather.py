"""Microbenchmark: the top-K candidate GATHER of the selection stage, on
the card.

Port of ``tools/bench_gather.py``: with the indices of the top-K scores
(``torch.topk``, derived from the scores each call, as the serving stage
does), gather the boxes, classes and scores: from the (B, N, 4) boxes,
from their (B, 4, N) transpose, as one flat (B·N, 4) row take, and as a
one-hot bf16 matmul (exact for boxes that bf16 holds: one nonzero product
a sum). Each variant's output is checked EXACTLY against the serving stage
it would replace (``ops/nms._select_topk``; the one-hot product against its
boxes rounded to bf16) before it is timed. The reference's variants that
gather at other indices or from a smaller source (cost shapes, not
selections) and its multi-operand sort (``torch.sort`` takes one key and
no payload: that is ``bench_topk``'s sort + gathers) are not ported.
Device ms by CUDA graph replay::

    python -m yolov3_tpu_torch.tools.bench_gather [--batch 8] [--n 10647] \\
        [--k 512] [--device cuda|cpu]
"""
from __future__ import annotations

import torch

from . import bench_topk


def variants(scores, boxes, classes, k):
    b, n = scores.shape
    ref = bench_topk.Selection(scores, boxes, classes, k)
    boxes_t = boxes.transpose(1, 2).contiguous()
    flat = boxes.reshape(b * n, 4)
    row0 = (torch.arange(b, device=scores.device) * n)[:, None]
    boxes_bf16 = boxes.to(torch.bfloat16)
    ref_bf16 = bench_topk.Selection(scores, boxes_bf16.float(), classes, k)
    g = bench_topk._gather

    def idx():
        return torch.topk(scores, k).indices

    def onehot():
        # built by a scatter: F.one_hot may check its indices on the host
        oh = torch.zeros((b, k, n), dtype=torch.bfloat16, device=scores.device)
        return oh.scatter_(2, idx()[..., None], 1.0) @ boxes_bf16

    return [
        ("topk+box+cls gather", lambda: (
            lambda s, i: (s, g(boxes, i), g(classes, i)))(*torch.topk(scores, k)),
         lambda o: ref.check("topk+gathers", *o)),
        ("box gather (B,N,4)", lambda: g(boxes, idx()),
         lambda o: ref.check("box gather", boxes=o)),
        ("cls gather (B,N)i32", lambda: g(classes, idx()),
         lambda o: ref.check("cls gather", classes=o)),
        ("score gather (B,N)f32", lambda: g(scores, idx()),
         lambda o: ref.check("score gather", scores=o)),
        ("boxT gather (B,4,N)", lambda: torch.gather(
            boxes_t, 2, idx()[:, None, :].expand(b, 4, k)),
         lambda o: ref.check("boxT gather", boxes=o.transpose(1, 2))),
        ("flat take (B*N,4)", lambda: flat.index_select(
            0, (idx() + row0).reshape(-1)).reshape(b, k, 4),
         lambda o: ref.check("flat take", boxes=o)),
        ("onehot matmul bf16", onehot,
         lambda o: ref_bf16.check("onehot matmul", boxes=o.float())),
    ]


def main(argv=None):
    return bench_topk.report(bench_topk.parser(__doc__).parse_args(argv),
                             variants)


if __name__ == "__main__":
    main()
