"""The mesh's collectives, on a list of per-shard tensors.

A single controller drives every shard of a :class:`~.sharding.Mesh`: a
sharded value is a list with one tensor per shard, each on that shard's
device, and a replicated value is such a list whose shards on one device
share one tensor. These are the counterparts of the reference's collectives
inside ``shard_map`` (``yolov3_tpu/parallel/spatial.py``):

* :func:`rows_from_above` / :func:`rows_from_below`: ``lax.ppermute`` of k
  rows to the next / previous shard. An edge shard receives ``fill`` (zeros
  by default, as the permute's zero fill, which *is* the conv's padding);
* :func:`all_gather`: ``lax.all_gather(tiled=True)``, the shards
  concatenated in shard order, once per distinct device;
* :func:`psum`: ``lax.psum``, the shards summed in shard order 0..n-1 on
  each distinct device, so every reader gets the same bits.

Each call bumps ``counts[<name>]`` once, however many shards it moves: the
count of collectives a pipeline call issues (the reference's tests count
them in the compiled HLO). It also adds the bytes it hands from one shard
to another to ``shard_bytes[<name>]`` (what moves between cards when each
shard has a card of its own), and the bytes that did cross between
distinct devices to ``device_bytes[<name>]``, each such copy counted in
``copies`` by (name, source device, destination device, shape, dtype), so
that a call's traffic can be replayed alone. Nothing here synchronises the host: a
copy between devices is queued like any other operation.
"""
from __future__ import annotations

from collections import Counter
from typing import Callable, Dict, List, Sequence

import torch

Shards = List[torch.Tensor]

counts: Counter = Counter()
shard_bytes: Counter = Counter()
device_bytes: Counter = Counter()
copies: Counter = Counter()


def reset_counts() -> None:
    """Set every collective's count and byte counts to 0."""
    for c in (counts, shard_bytes, device_bytes, copies):
        c.clear()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _crossed(name: str, t: torch.Tensor, device: torch.device) -> None:
    """``t`` copied to ``device``: counted where the devices differ."""
    if t.device != device:
        device_bytes[name] += _nbytes(t)
        copies[name, t.device, device, tuple(t.shape), t.dtype] += 1


def _send(name: str, t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """One shard's ``t`` handed to another shard, on ``device``."""
    shard_bytes[name] += _nbytes(t)
    _crossed(name, t, device)
    return t.to(device)


def rows_from_above(xs: Sequence[torch.Tensor], k: int, dim: int = 2,
                    fill: float = 0.0) -> Shards:
    """Shard i receives the last ``k`` rows (along ``dim``) of shard i-1's
    tensor, on its own device; shard 0 receives ``fill``."""
    counts["rows_from_above"] += 1
    out = [torch.full_like(xs[0].narrow(dim, 0, k), fill)]
    for prev, x in zip(xs[:-1], xs[1:]):
        out.append(_send("rows_from_above",
                         prev.narrow(dim, prev.shape[dim] - k, k), x.device))
    return out


def rows_from_below(xs: Sequence[torch.Tensor], k: int, dim: int = 2,
                    fill: float = 0.0) -> Shards:
    """Shard i receives the first ``k`` rows (along ``dim``) of shard i+1's
    tensor, on its own device; the last shard receives ``fill``."""
    counts["rows_from_below"] += 1
    out = [_send("rows_from_below", nxt.narrow(dim, 0, k), x.device)
           for x, nxt in zip(xs[:-1], xs[1:])]
    out.append(torch.full_like(xs[-1].narrow(dim, 0, k), fill))
    return out


def _per_device(name: str, xs: Sequence[torch.Tensor],
                fn: Callable[[torch.device], torch.Tensor]) -> Shards:
    """``fn(device)`` once per distinct device of ``xs``, handed to every
    shard on that device: a replicated value made from every shard's
    tensor. Each shard receives the n - 1 others (``shard_bytes``); each
    distinct device copies in those that lie elsewhere (``device_bytes``)."""
    shard_bytes[name] += (len(xs) - 1) * sum(map(_nbytes, xs))
    made: Dict[torch.device, torch.Tensor] = {}
    for x in xs:
        if x.device not in made:
            for other in xs:
                _crossed(name, other, x.device)
            made[x.device] = fn(x.device)
    return [made[x.device] for x in xs]


def all_gather(xs: Sequence[torch.Tensor], dim: int = 2) -> Shards:
    """Every shard receives the shards concatenated along ``dim`` in shard
    order (tiled), made once per distinct device."""
    counts["all_gather"] += 1
    return _per_device("all_gather", xs,
                       lambda d: torch.cat([x.to(d) for x in xs], dim))


def psum(xs: Sequence[torch.Tensor]) -> Shards:
    """Every shard receives the sum of the shards, added in shard order
    0..n-1 on each distinct device (the same bits everywhere)."""
    counts["psum"] += 1

    def total(d: torch.device) -> torch.Tensor:
        acc = xs[0].to(d)
        for x in xs[1:]:
            acc = acc + x.to(d)
        return acc

    return _per_device("psum", xs, total)
