"""Spatial (halo-exchange) partitioning of one image over a mesh.

Port of ``yolov3_tpu/parallel/spatial.py``. Batch-DP (``sharding.py``)
scales throughput; this shards the ROW axis of each image over the mesh so
that several devices cooperate on one call (latency-bound serving):

* nodes before the planned crossover run on their shard's row band; a 3×3
  conv takes one halo row from each neighbour (``collectives.rows_from_
  above`` / ``rows_from_below``), and an edge shard's zero rows are the
  conv's padding;
* at the crossover the running map is gathered once
  (``collectives.all_gather``), and a route / shortcut source that crosses
  it is gathered at its first replicated use;
* past it, the deep 1×1→3×3 pairs run channel-sharded (Megatron col / row:
  the first conv splits its output channels, the second its input
  channels, one ``collectives.psum`` per pair) and the rest replicated;
* decode (K1c, ``ops/cuda_decode.decode_compact``) and NMS (K2) run once on
  the first shard's device, on maps every shard holds alike.

The planner (:func:`plan_spatial`, :func:`_plan_channel_roles`,
:func:`_node_feasible`) is a copy of the reference's pure planning code,
held equal to it. A replicated value is one tensor per distinct device
(as ``collectives.all_gather`` and ``psum`` make it), so shards that
share a device share its replicated work. int8 is out of scope, as in the
reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..graph import Graph, Node
from ..inference import _InterpCache
from ..model import _activate, _conv, _maxpool
from ..ops import decode as plain_decode
from ..ops.cuda_decode import decode_compact, supported as _packed_decode_ok
from ..ops.nms import NMSResult, batched_nms_compact
from ..ops.preprocess import preprocess
from ..precision import tf32
from . import collectives
from .collectives import Shards
from .sharding import Mesh, mesh_devices, shard_params

SPACE_AXIS = "space"


def make_spatial_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D device mesh over the image-row axis."""
    return Mesh(mesh_devices(n_devices, devices), (SPACE_AXIS,))


@dataclass(frozen=True)
class SpatialPlan:
    """Static partition plan: nodes [0, crossover) run row-sharded; past
    the crossover, convs with a ``roles`` entry run channel-sharded
    (``"col"``: output channels split; ``"row"``: input channels split,
    one psum) and the rest replicated."""

    n_shards: int
    crossover: int            # first node index past the row-sharded prefix
    sharded_flop_frac: float  # conv-FLOP fraction inside the sharded prefix
    roles: Tuple[Tuple[int, str], ...] = ()  # (node index, "col"|"row")
    total_sharded_flop_frac: float = 0.0  # prefix + channel-sharded tail


def _node_feasible(node: Node, h_in: int, n: int) -> bool:
    """Can ``node`` run on row bands of h_in/n without global rows?"""
    if h_in % n:
        return False
    local = h_in // n
    if node.kind == "convolutional":
        if node.size == 1:
            return True
        if not node.pad or node.size % 2 == 0:
            return False
        if node.stride == 1:
            return node.size // 2 <= local  # halo within one neighbor hop
        if node.stride == 2 and node.size == 3:
            # stride-2 output rows split cleanly iff the band is even; the
            # darknet bottom pad row is never read for even global H
            return local % 2 == 0 and h_in % 2 == 0
        return False
    if node.kind == "maxpool":
        if node.stride == node.size:
            # non-overlapping windows; feasible only with no LOW vertical
            # pad (the sharded form drops vertical padding: the high pad
            # row is unread for divisible H, a low one would shift every
            # window); darknet's size-2 pool has lo = (2-1)//2 = 0
            return local % node.size == 0 and node.padding // 2 == 0
        if node.stride == 1:
            lo = node.padding // 2
            hi = node.padding - lo
            return max(lo, hi) <= local
        return False
    if node.kind in ("upsample", "shortcut", "route"):
        return True
    return False  # yolo: decode needs global row indices — replicate


def plan_spatial(graph: Graph, n_shards: int, net_hw: Tuple[int, int]
                 ) -> SpatialPlan:
    """Walk the graph; shard every prefix node the arithmetic allows.

    The sharded region is a prefix by construction (once one node needs
    the full map, everything downstream consumes full maps), which keeps
    the runtime to exactly one planned gather plus on-demand gathers of
    route/shortcut sources that cross the boundary.
    """
    in_h, in_w = int(net_hw[0]), int(net_hw[1])
    if n_shards <= 1:
        raise ValueError("spatial partitioning needs a mesh of >= 2 devices")
    if in_h % n_shards:
        raise ValueError(
            f"net height {in_h} not divisible by {n_shards} shards")

    def h_of(idx: int) -> int:
        if idx < 0:
            return in_h
        d = graph.nodes[idx].downsample
        if in_h % d:
            raise ValueError(f"net height {in_h} not divisible by stride {d}")
        return in_h // d

    crossover = len(graph.nodes)
    for node in graph.nodes:
        h_in = h_of(node.inputs[0] if node.inputs else node.index - 1)
        if not _node_feasible(node, h_in, n_shards):
            crossover = node.index
            break

    roles = _plan_channel_roles(graph, crossover, n_shards)

    flops_in = flops_ch = flops_total = 0.0
    for node in graph.nodes:
        if node.kind != "convolutional":
            continue
        src = node.inputs[0]
        cin = graph.in_channels if src < 0 else graph.nodes[src].out_channels
        h_out = in_h // node.downsample
        w_out = in_w // node.downsample
        f = 2.0 * h_out * w_out * node.size * node.size * cin * node.out_channels
        flops_total += f
        if node.index < crossover:
            flops_in += f
        elif node.index in roles:
            flops_ch += f
    frac = flops_in / flops_total if flops_total else 0.0
    total = (flops_in + flops_ch) / flops_total if flops_total else 0.0
    return SpatialPlan(n_shards=n_shards, crossover=crossover,
                       sharded_flop_frac=frac,
                       roles=tuple(sorted(roles.items())),
                       total_sharded_flop_frac=total)


def _plan_channel_roles(graph: Graph, crossover: int, n: int
                        ) -> Dict[int, str]:
    """Megatron-style pair coloring for the replicated tail.

    Darknet's deep structure is chains of 1×1→3×3 convs (residual bodies,
    head branches): the first of each pair splits its OUTPUT channels
    ("col"), the second its INPUT channels ("row") with one psum — the
    pair's activations never replicate and the pair costs exactly one
    all-reduce of one (small, deep-stage) map. A conv may go "col" only
    when its sole consumer is the next conv (a tensor with a route/
    shortcut/yolo consumer must stay replicated) and its width divides the
    mesh; everything else stays replicated (downsample convs — their
    outputs also feed the residual add — and route-tapped 1×1s).
    """
    consumers: Dict[int, List[int]] = {}
    for node in graph.nodes:
        for i in node.inputs:
            if i >= 0:
                consumers.setdefault(i, []).append(node.index)

    roles: Dict[int, str] = {}
    state: Dict[int, str] = {}  # node index -> "rep" | "col"

    def in_state(idx: int) -> str:
        return state.get(idx, "rep") if idx >= 0 else "rep"

    for node in graph.nodes[crossover:]:
        src = node.inputs[0] if node.inputs else node.index - 1
        if node.kind == "convolutional":
            if in_state(src) == "col":
                roles[node.index] = "row"  # psum closes the pair
                state[node.index] = "rep"
                continue
            cs = consumers.get(node.index, [])
            nxt = graph.nodes[cs[0]] if len(cs) == 1 else None
            if (nxt is not None and nxt.kind == "convolutional"
                    and node.out_channels % n == 0
                    and nxt.index >= crossover):
                roles[node.index] = "col"
                state[node.index] = "col"
            else:
                state[node.index] = "rep"
        else:
            # non-conv nodes always see replicated inputs here: a "col"
            # output's sole consumer is by construction the paired conv
            state[node.index] = "rep"
    return roles


# --- the walk on per-shard tensors (NCHW views, rows are dim 2) -----------

def _map(fn, *shards) -> Shards:
    """``fn`` per shard over lists of per-shard arguments, computed once for
    shards whose arguments are the same objects (a replicated value)."""
    done: Dict[Tuple[int, ...], torch.Tensor] = {}
    out = []
    for args in zip(*shards):
        key = tuple(map(id, args))
        if key not in done:
            done[key] = fn(*args)
        out.append(done[key])
    return out


def _check(x: Shards, n: int) -> None:
    if len(x) != n:
        raise ValueError(f"{len(x)} shards given for a mesh of {n}")


def _conv_sharded(x: Shards, w: Shards, b: Shards, node: Node, n: int
                  ) -> Shards:
    """``model._conv`` on row bands: halo rows replace vertical padding."""
    _check(x, n)
    if node.size == 1:
        xx, halo = x, 0
    else:
        halo = node.size // 2
        if node.stride == 1:
            parts = (collectives.rows_from_above(x, halo), x,
                     collectives.rows_from_below(x, halo))
        else:  # stride 2, size 3 (planner-guaranteed): only the top row crosses
            parts = (collectives.rows_from_above(x, 1), x)
        xx = [torch.cat(p, 2) for p in zip(*parts)]
    return [_activate(F.conv2d(t, wt.to(t.dtype), bt.to(t.dtype),
                               stride=node.stride, padding=(0, halo)),
                      node.activation) for t, wt, bt in zip(xx, w, b)]


def _maxpool_sharded(x: Shards, node: Node, n: int) -> Shards:
    _check(x, n)
    lo = node.padding // 2
    hi = node.padding - lo
    inf = float("inf")
    if node.stride == node.size:
        xx = x  # planner: band divisible; darknet's high pad row unread
    else:  # stride 1: overlap rows come from neighbours; mesh edges pool -inf
        parts = [x]
        if lo:
            parts.insert(0, collectives.rows_from_above(x, lo, fill=-inf))
        if hi:
            parts.append(collectives.rows_from_below(x, hi, fill=-inf))
        xx = [torch.cat(p, 2) for p in zip(*parts)]
    return [F.max_pool2d(F.pad(t, (lo, hi, 0, 0), value=-inf), node.size,
                         node.stride) for t in xx]


def _conv_col(x: Shards, p: List[Dict[str, torch.Tensor]], node: Node,
              n: int) -> Shards:
    """Output-channel-sharded conv: shard i computes channels
    ``[i·Cout/n, (i+1)·Cout/n)`` from the replicated input; bias and
    activation are channelwise, so they apply per shard with no
    communication."""
    _check(x, n)
    c = p[0]["w"].shape[0] // n
    pad = node.size // 2 if node.pad else 0
    out = []
    for i, (t, pi) in enumerate(zip(x, p)):
        w, b = pi["w"][i * c:(i + 1) * c], pi["b"][i * c:(i + 1) * c]
        out.append(_activate(F.conv2d(t, w.to(t.dtype), b.to(t.dtype),
                                      stride=node.stride, padding=pad),
                             node.activation))
    return out


def _conv_row(x: Shards, p: List[Dict[str, torch.Tensor]], node: Node,
              n: int) -> Shards:
    """Input-channel-sharded conv closing a col/row pair: each shard
    contracts its Cin/n slice, one psum reduces the partial maps, then
    bias + activation run on the replicated result (the bias is added
    exactly once, after the reduction)."""
    _check(x, n)
    c = p[0]["w"].shape[1] // n
    pad = node.size // 2 if node.pad else 0
    partial = [F.conv2d(t, pi["w"][:, i * c:(i + 1) * c].to(t.dtype),
                        stride=node.stride, padding=pad)
               for i, (t, pi) in enumerate(zip(x, p))]
    return _map(lambda y, pi: _activate(
        y + pi["b"].to(y.dtype)[:, None, None], node.activation),
        collectives.psum(partial), p)


def forward_features_spatial(
    graph: Graph,
    params: List[Dict[int, Dict[str, torch.Tensor]]],
    x_local: List[torch.Tensor],
    *,
    n_shards: int,
    crossover: int,
    precision: Optional[str] = None,
    channel_roles: Optional[Dict[int, str]] = None,
) -> List[torch.Tensor]:
    """``model.forward_features`` on row bands.

    ``params``: one parameter tree per shard (``sharding.shard_params``);
    ``x_local``: each shard's (B, H/n, W, C) NHWC band. Nodes <
    ``crossover`` run sharded with halo exchange; at the boundary the
    running tensor is gathered once, and cached route/shortcut sources that
    cross it are gathered on first replicated use. Past the boundary, convs
    listed in ``channel_roles`` run channel-sharded (col/row pairs, one
    psum per pair). Returns the NHWC head maps, which every shard holds
    alike (the planner never shards a yolo node), as the first shard holds
    them."""
    _check(x_local, n_shards)
    roles = dict(channel_roles or {})
    needed = graph.needed_outputs
    cache: Dict[int, Shards] = {}
    local: Dict[int, bool] = {}
    heads: List[Shards] = []
    prev = [x.permute(0, 3, 1, 2) for x in x_local]
    if precision == "bf16":
        prev = [x.to(torch.bfloat16) for x in prev]
    prev_local = True

    def fetch(i: int, want_full: bool) -> Shards:
        t = cache[i]
        if want_full and local[i]:
            t = collectives.all_gather(t)
            cache[i], local[i] = t, False
        return t

    with tf32(precision is None):
        for node in graph.nodes:
            repl = node.index >= crossover
            if repl and prev_local:
                prev = collectives.all_gather(prev)
                prev_local = False
                if node.index - 1 in cache and local[node.index - 1]:
                    cache[node.index - 1], local[node.index - 1] = prev, False
            if node.kind == "convolutional":
                p = [shard[node.index] for shard in params]
                role = roles.get(node.index) if repl else None
                if role == "col":
                    out = _conv_col(prev, p, node, n_shards)
                elif role == "row":
                    out = _conv_row(prev, p, node, n_shards)
                elif repl:
                    out = _map(lambda t, q: _conv(t, q["w"], q["b"], node),
                               prev, p)
                else:
                    out = _conv_sharded(prev, [q["w"] for q in p],
                                        [q["b"] for q in p], node, n_shards)
            elif node.kind == "maxpool":
                out = (_map(lambda t: _maxpool(t, node), prev) if repl else
                       _maxpool_sharded(prev, node, n_shards))
            elif node.kind == "upsample":
                out = _map(lambda t: F.interpolate(
                    t, scale_factor=node.stride, mode="nearest"), prev)
            elif node.kind == "shortcut":
                out = _map(lambda a, s: _activate(a + s, node.activation),
                           prev, fetch(node.inputs[1], want_full=repl))
            elif node.kind == "route":
                srcs = [prev if i == node.index - 1
                        else fetch(i, want_full=repl) for i in node.inputs]
                out = (srcs[0] if len(srcs) == 1 else
                       _map(lambda *ts: torch.cat(ts, 1), *srcs))
            elif node.kind == "yolo":
                heads.append(prev)
                out = prev
            else:  # pragma: no cover - lower() already validates kinds
                raise ValueError(node.kind)
            if node.index in needed:
                cache[node.index] = out
                local[node.index] = not repl
            prev = out
            prev_local = not repl
    return [h[0].permute(0, 2, 3, 1) for h in heads]


def spatial_pipeline(graph: Graph, mesh: Mesh, net_hw: Tuple[int, int],
                     prob_thresh: float = 0.05, iou_thresh: float = 0.3,
                     top_k: int = 512, mode: str = "letterbox",
                     precision: Optional[str] = None, bgr: bool = True,
                     nms_impl: str = "xla", decode_impl: str = "pallas",
                     max_results: int = 0, tail: str = "channel",
                     select_group: int = 2):
    """Build the row-sharded end-to-end detect step over ``mesh``.

    Returns ``run(params, frames_u8)``: params per shard
    (``sharding.shard_params``; a single tree is sharded here) and uint8
    (B, H, W, 3) frames (any B) → NMSResult on the first shard's device.
    ``tail`` picks the strategy past the row crossover: ``"channel"``
    (default) runs the deep 1×1→3×3 pairs channel-sharded at the cost of
    one psum per pair; ``"replicated"`` runs the tail on every distinct
    device with no collective. The preprocess runs once per distinct
    device; decode (K1c for ``decode_impl="pallas"``, else the plain
    compact decode) and NMS (K2) once, on the first shard's device. Convs
    run on ``F.conv2d`` (the Detector warns for ``conv_impl="pallas"``).
    """
    if tail not in ("channel", "replicated"):
        raise ValueError(f"unknown tail strategy {tail!r}")
    plan = plan_spatial(graph, mesh.size, net_hw)
    if plan.crossover == 0:
        raise ValueError(
            f"no node shardable over {mesh.size} rows at {net_hw} — "
            "use a smaller mesh or larger input")
    yolo_nodes = graph.yolo_nodes
    anchors = [yn.anchors for yn in yolo_nodes]
    if decode_impl == "pallas" and not _packed_decode_ok(anchors):
        decode_impl = "xla"
    decode = (decode_compact if decode_impl == "pallas"
              else plain_decode.decode_compact)
    strides = list(graph.head_strides())
    scales = graph.head_scales()
    n, devices = mesh.size, mesh.devices
    local_h = net_hw[0] // n
    roles = dict(plan.roles) if tail == "channel" else None
    interp = {d: _InterpCache(tuple(net_hw), mode, d)
              for d in dict.fromkeys(devices)}

    def run(params, frames_u8: torch.Tensor) -> NMSResult:
        shards = params if isinstance(params, list) else shard_params(
            params, mesh)
        if not isinstance(frames_u8, torch.Tensor):
            frames_u8 = torch.from_numpy(np.ascontiguousarray(frames_u8))
        src_hw = tuple(frames_u8.shape[1:3])
        # replicated preprocess, once per distinct device; each shard then
        # slices its own row band
        x = {}
        for d in interp:
            f = frames_u8.to(d)
            x[d] = preprocess(f.flip(-1) if bgr else f, net_hw, mode=mode,
                              interp=interp[d](src_hw))
        bands = [x[d][:, i * local_h:(i + 1) * local_h]
                 for i, d in enumerate(devices)]
        heads = forward_features_spatial(
            graph, shards, bands, n_shards=n, crossover=plan.crossover,
            precision=precision, channel_roles=roles)
        boxes, scores, classes = decode(heads, anchors, strides,
                                        yolo_nodes[0].classes, scales=scales)
        return batched_nms_compact(boxes, scores, classes,
                                   prob_thresh=prob_thresh,
                                   iou_thresh=iou_thresh, top_k=top_k,
                                   impl=nms_impl, max_results=max_results,
                                   select_group=select_group)

    return run
