"""Microbenchmark: the candidate-selection stage (threshold → top-K →
gather) and its alternatives, on the card.

Port of ``tools/bench_topk.py``, ``bench_topk2.py`` and ``bench_topk3.py``,
which shared ``make_inputs`` and one clock; here they are one tool whose
variants carry their source tool's name:

* ``topk:``  the direct top-k + gathers stage, a full-N sort, and the
  shipped exact pair-max selection (``ops/nms._select_pairmax``);
* ``topk2:`` top-k on int32 keys (the bitcast is monotone for
  non-negative floats), a stable (key, index) sort, and top-k's cost
  against K (64, 1,024) and N (half);
* ``topk3:`` the building blocks of a compaction selection for the common
  case of at most K candidates above the threshold: slot positions by
  cumsum, a scatter of one plane or of the packed (B, N, 8) payload into
  (B, K), and the whole fast path (scatter, then a stable sort by score).

Every variant's selection is checked EXACTLY against the stage it would
replace before it is timed: the serving stage ``ops/nms._select_topk``
(score descending, the lower index first among ties) at the same K and N,
on the valid slots (score > 0; the rest must score 0); the compaction
blocks against the candidates above the threshold in index order. Variants
of the reference tools that select nothing (a sort of the first K scores,
gathers at random indices) are not ported. Times are device ms by CUDA
graph replay (``clock.graph_ms``); on the CPU the checks run alone::

    python -m yolov3_tpu_torch.tools.bench_topk [--batch 8] [--n 10647] \\
        [--k 512] [--density 0.02] [--device cuda|cuda:N|cpu]
"""
from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

N_416 = 10647  # yolov3@416 candidates (3 heads, 3 anchors)
N_608 = 22743  # yolov3@608 candidates


def make_inputs(batch, n, density=0.02, seed=0, device="cpu"):
    """Scores thresholded-realistic: ~``density`` of candidates nonzero;
    boxes uniform in a 608 frame; 80 classes."""
    rng = np.random.default_rng(seed)
    raw = rng.uniform(0, 1, (batch, n)).astype(np.float32)
    mask = rng.uniform(0, 1, (batch, n)) < density
    scores = np.where(mask, raw, 0.0).astype(np.float32)
    boxes = rng.uniform(0, 608, (batch, n, 4)).astype(np.float32)
    classes = rng.integers(0, 80, (batch, n), dtype=np.int32)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (scores, boxes, classes))


def payload_of(scores, boxes, classes):
    """The serving path's packed (B, N, 8) candidate records: box, score,
    class, candidate index, 0 (``ops/nms._select_pairmax``'s payload)."""
    b, n = scores.shape
    iota = torch.arange(n, dtype=torch.float32, device=scores.device)
    return torch.cat([boxes, scores[..., None],
                      classes.to(torch.float32)[..., None],
                      iota.expand(b, n)[..., None],
                      torch.zeros_like(scores)[..., None]], dim=-1)


class Selection:
    """The stage a variant replaces, ``_select_topk`` on the same inputs,
    and the exact checks against it."""

    def __init__(self, scores, boxes, classes, k):
        from ..ops.nms import _select_topk

        self.boxes, self.scores, self.classes, self.valid = _select_topk(
            boxes, scores, classes, k)

    def check(self, what, scores=None, boxes=None, classes=None) -> None:
        v = self.valid
        for name, got, want in (("scores", scores, self.scores),
                                ("boxes", boxes, self.boxes),
                                ("classes", classes, self.classes)):
            if got is None:
                continue
            if got.shape != want.shape:
                raise AssertionError(f"{what}: {name} shape {tuple(got.shape)}"
                                     f" != {tuple(want.shape)}")
            if not torch.equal(got[v], want[v]):
                raise AssertionError(f"{what}: {name} differ from the "
                                     f"serving stage's on the valid slots")
        if scores is not None and (scores[~v] != 0).any():
            raise AssertionError(f"{what}: a slot past the valid ones scores")


def in_index_order(scores, values, k):
    """(B, K, ...) ``values`` of the candidates above the threshold in
    index order, zero-filled: what the compaction blocks must produce."""
    b = scores.shape[0]
    out = torch.zeros((b, k, *values.shape[2:]), dtype=values.dtype,
                      device=values.device)
    for i in range(b):
        sel = values[i][scores[i] > 0]
        out[i, :len(sel)] = sel
    return out


def _desc_int32(s):
    return torch.sort(-s.view(torch.int32), dim=1, stable=True).indices


def _gather(t, idx):
    if t.dim() == 3:
        return torch.gather(t, 1, idx[..., None].expand(-1, -1, t.shape[2]))
    return torch.gather(t, 1, idx)


def _positions(s):
    m = s > 0.0
    return torch.cumsum(m, dim=1, dtype=torch.int32), m


def _scatter(s, values, k):
    """Scatter ``values`` (B, N[, C]) of the candidates above the threshold
    into (B, K[, C]) slots in index order; the rest go to a spare slot K,
    dropped (a candidate count over K would overflow: the caller checks)."""
    pos, m = _positions(s)
    idx = torch.where(m, pos - 1, torch.full_like(pos, k)).long()
    shape = (s.shape[0], k + 1, *values.shape[2:])
    out = torch.zeros(shape, dtype=values.dtype, device=values.device)
    if values.dim() == 3:
        idx = idx[..., None].expand(-1, -1, values.shape[2])
    return out.scatter_(1, idx, values)[:, :k]


Variant = Tuple[str, Callable[[], object], Callable[[object], None]]


def variants(scores, boxes, classes, k) -> List[Variant]:
    """(name, fn, check) per variant; ``check(fn())`` raises on a miss."""
    from ..ops.nms import _select_pairmax

    b, n = scores.shape
    ref = Selection(scores, boxes, classes, k)
    payload = payload_of(scores, boxes, classes)

    def topk_gathers():
        s, i = torch.topk(scores, k)
        return s, _gather(boxes, i), _gather(classes, i)

    def at(kk=k, nn=n):
        sub = Selection(scores[:, :nn], boxes[:, :nn], classes[:, :nn], kk)
        return lambda out: sub.check(f"top-{kk} of {nn}", scores=out)

    if int((scores > 0).sum(1).max()) > k:
        raise ValueError("the compaction variants need at most K candidates "
                         "above the threshold an image: lower --density")
    compact_scores = in_index_order(scores, scores, k)
    compact_payload = in_index_order(scores, payload, k)

    def fast_path():
        c = _scatter(scores, payload, k)
        order = _desc_int32(c[:, :, 4].contiguous())
        return _gather(c, order)

    def check_fast(out):
        ref.check("fast path", scores=out[:, :, 4].contiguous(),
                  boxes=out[:, :, :4].contiguous(),
                  classes=out[:, :, 5].to(torch.int32))

    def check_positions(out):
        pos, m = out
        ranks = torch.arange(1, k + 1, dtype=torch.int32,
                             device=scores.device).expand(b, k)
        want = torch.where(ranks <= m.sum(1, keepdim=True), ranks, 0)
        if not torch.equal(in_index_order(scores, pos, k), want):
            raise AssertionError("cumsum positions differ from the ranks of "
                                 "the candidates in index order")

    def check_equal(want, what):
        def check(out):
            if not torch.equal(out, want):
                raise AssertionError(f"{what} differs from the candidates "
                                     f"in index order")
        return check

    return [
        ("topk: topk(score)+gathers", topk_gathers,
         lambda o: ref.check("topk+gathers", *o)),
        ("topk: topk(score) only", lambda: torch.topk(scores, k),
         lambda o: ref.check("topk only", scores=o.values)),
        ("topk: sort1 full-N",
         lambda: torch.sort(scores, dim=1, descending=True).values[:, :k],
         lambda o: ref.check("sort full-N", scores=o)),
        ("topk: pairmax select",
         lambda: _select_pairmax(boxes, scores, classes, k),
         lambda o: ref.check("pairmax", o[1], o[0], o[2])),
        ("topk2: topk512 i32 keys",
         lambda: torch.topk(scores.view(torch.int32), k).values,
         lambda o: ref.check("i32 keys", scores=o.view(torch.float32))),
        ("topk2: sort2 stable (key,iota)",
         lambda: _desc_int32(scores)[:, :k],
         lambda o: ref.check("sort2 stable", scores=_gather(scores, o),
                             boxes=_gather(boxes, o))),
        ("topk2: topk64", lambda: torch.topk(scores, 64).values, at(kk=64)),
        ("topk2: topk1024", lambda: torch.topk(scores, 1024).values,
         at(kk=1024)),
        ("topk2: topk512 half-N",
         lambda: torch.topk(scores[:, :n // 2], k).values, at(nn=n // 2)),
        ("topk3: cumsum (B,N) i32", lambda: _positions(scores),
         check_positions),
        ("topk3: scatter 1 plane", lambda: _scatter(scores, scores, k),
         check_equal(compact_scores, "the scattered scores")),
        ("topk3: scatter (B,N,8) packed",
         lambda: _scatter(scores, payload, k),
         check_equal(compact_payload, "the scattered payload")),
        ("topk3: fast path e2e", fast_path, check_fast),
    ]


def run(batch: int, n: int, k: int, density: float, device,
        variant_list=variants, log=print) -> List[Dict]:
    """Each variant checked, then (on the card) timed by graph replay."""
    scores, boxes, classes = make_inputs(batch, n, density, device=device)
    out = []
    for name, fn, check in variant_list(scores, boxes, classes, k):
        with torch.inference_mode():
            check(fn())
            ms: Optional[float] = None
            if scores.device.type == "cuda":
                from .clock import graph_ms

                ms = graph_ms(fn, iters=10, reps=3)
        out.append({"variant": name, "ms": ms, "checked": True})
        log(f"{name:34s}: " + (f"{ms:7.4f} ms" if ms is not None
                               else "checked (no device clock)"))
    return out


def parser(doc: str) -> argparse.ArgumentParser:
    """The flags the selection microbenches share."""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--n", type=int, default=N_416)
    ap.add_argument("--k", type=int, default=512)
    ap.add_argument("--density", type=float, default=0.02)
    ap.add_argument("--device", default=None,
                    help="cuda (default), cuda:N or cpu")
    return ap


def report(args, variant_list=variants) -> List[Dict]:
    """:func:`run` on the parsed ``args`` of :func:`parser`, printed as
    one JSON line that names the device."""
    from ..__main__ import _resolve_device

    device = _resolve_device(args.device)
    print(f"B={args.batch} N={args.n} K={args.k} density={args.density}")
    rows = run(args.batch, args.n, args.k, args.density, device,
               variant_list)
    print(json.dumps({"device": ("cpu" if device.type == "cpu"
                                 else torch.cuda.get_device_name(device)),
                      "batch": args.batch, "n": args.n, "k": args.k,
                      "density": args.density, "rows": rows}))
    return rows


def main(argv=None):
    return report(parser(__doc__).parse_args(argv))


if __name__ == "__main__":
    main()
