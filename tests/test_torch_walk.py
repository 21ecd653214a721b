"""``model.walk``, the port's one node walk, driven by ops that record each
call and fuse where asked: every node is run in order by the op of its
kind, passed through (a route of one input), skipped as a head conv, or
taken over by an earlier op; only the outputs a later node reads are kept,
a fused span's under its last node; no op consumes at or past ``upto``.

Values are symbols: ("v", i) is node i's output, so each op's inputs can
be checked against the node its graph edge names."""
from __future__ import annotations

from pathlib import Path

import pytest

from yolov3_tpu_torch.graph import load_graph
from yolov3_tpu_torch.model import NodeOps, residual_convs, walk

ROOT = Path(__file__).resolve().parent.parent
CFGS = {"tiny": str(ROOT / "models" / "yolov3-tiny.cfg"),
        "yolov3": str(ROOT / "models" / "yolov3.cfg")}
GRAPHS = {name: load_graph(path) for name, path in CFGS.items()}
FUSIBLE = ("convolutional", "shortcut", "maxpool", "upsample")


def fusion_plan(graph) -> dict:
    """Conv index → the last node its op asks to take over: the shortcut
    ``residual_convs`` hands it, else up to two nodes more of FUSIBLE kinds
    while the output left behind is read by no later node and no head conv
    is crossed (23 of yolov3's spans are its residual shortcuts)."""
    needed = graph.needed_outputs
    head_convs = {yn.inputs[0] for yn in graph.yolo_nodes}
    residual = residual_convs(graph)
    plan = {}
    for node in graph.conv_nodes:
        if node.index in residual:
            plan[node.index] = residual[node.index].index
            continue
        last = node.index
        while (last - node.index < 2 and last + 1 < len(graph.nodes)
               and last not in needed and last + 1 not in head_convs
               and graph.nodes[last + 1].kind in FUSIBLE):
            last += 1
        if last != node.index:
            plan[node.index] = last
    return plan


class Recorder(NodeOps):
    def __init__(self, plan):
        self.plan, self.calls, self.spans, self.cache = plan, [], [], None

    def enter(self, node, x, cache):
        self.cache = cache
        return x

    def conv(self, node, x, cache, end):
        last = self.plan.get(node.index, node.index)
        if last >= end:  # the walk stops inside the span: run alone
            last = node.index
        self.calls.append(("conv", node.index, (x,)))
        self.spans.append((node.index, last, end))
        return ("v", last), last

    def maxpool(self, node, x):
        self.calls.append(("maxpool", node.index, (x,)))
        return ("v", node.index)

    def upsample(self, node, x):
        self.calls.append(("upsample", node.index, (x,)))
        return ("v", node.index)

    def shortcut(self, node, x, other):
        self.calls.append(("shortcut", node.index, (x, other)))
        return ("v", node.index)

    def route(self, node, xs):
        self.calls.append(("route", node.index, tuple(xs)))
        return ("v", node.index)

    def head(self, x):
        return ("head", x)


@pytest.mark.parametrize("stop_before_heads", [False, True])
@pytest.mark.parametrize("cfg, upto", [
    (cfg, upto) for cfg, g in GRAPHS.items()
    for upto in [None, *range(len(g.nodes) + 1)]])
def test_walk_runs_each_node_once_in_order(cfg, upto, stop_before_heads):
    graph = GRAPHS[cfg]
    nodes = graph.nodes[:upto]
    end = len(nodes)
    plan = fusion_plan(graph)
    head_convs = ({yn.inputs[0] for yn in graph.yolo_nodes}
                  if stop_before_heads else set())
    ops, visits = Recorder(plan), []
    heads = walk(graph, ("v", -1), ops, upto=upto,
                 stop_before_heads=stop_before_heads,
                 visit=lambda node, inp, out: visits.append(
                     (node.index, inp, out)))

    # a fused op never consumes at or past upto; every node is stepped on
    # once, or consumed by the op of the span it lies in
    span_last, consumed = {}, set()
    for start, last, limit in ops.spans:
        assert limit == end and start <= last < end
        assert last == plan.get(start, start) or plan[start] >= end
        span_last[start] = last
        consumed |= set(range(start + 1, last + 1))
    stepped = [i for i, _, _ in visits]
    assert stepped == sorted(stepped)
    assert sorted(stepped + sorted(consumed)) == list(range(end))
    out_index = {i: span_last.get(i, i) for i in stepped}

    # the value each node's output stands for, as a later node reads it
    val = {-1: ("v", -1)}
    for node in nodes:
        i = node.index
        if i not in out_index:
            continue
        if i in head_convs or node.kind == "yolo":
            val[i] = val[i - 1]
        elif node.kind == "route" and len(node.inputs) == 1:
            val[i] = val[node.inputs[0]]
        else:
            val[out_index[i]] = ("v", out_index[i])
    for i, inp, out in visits:
        assert inp == val[i - 1] and out == val[out_index[i]]

    # each op is called in node order with the values its edges name;
    # head convs are skipped, single-input routes pass through
    want_calls = []
    for node in nodes:
        i = node.index
        if i not in out_index or i in head_convs or node.kind == "yolo" or (
                node.kind == "route" and len(node.inputs) == 1):
            continue
        kind = "conv" if node.kind == "convolutional" else node.kind
        ins = ((val[i - 1], val[node.inputs[1]]) if kind == "shortcut" else
               tuple(val[j] for j in node.inputs) if kind == "route" else
               (val[i - 1],))
        want_calls.append((kind, i, ins))
    assert ops.calls == want_calls
    assert not any(c[1] in head_convs for c in ops.calls)

    # only outputs a later node reads are kept, a fused span's under the
    # index of its last node, with the value its op returned
    cache = ops.cache if ops.cache is not None else {}
    assert set(cache) == set(out_index.values()) & graph.needed_outputs
    for i in cache:
        assert cache[i] == val[i]

    # the heads: each yolo node's input reached (or, with
    # stop_before_heads, each head conv's input), then the last value
    marks = sorted(head_convs or {yn.index for yn in graph.yolo_nodes})
    want_heads = [("head", val[m - 1]) for m in marks if m < end]
    if upto is not None:
        want_heads.append(("head", val[out_index[stepped[-1]]]
                           if stepped else ("v", -1)))
    assert heads == want_heads
