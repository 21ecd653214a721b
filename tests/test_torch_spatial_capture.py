"""The spatial program over several cards, on the CPU: what its Detector
counts per device and what its collectives move.

* A program over two devices holds bytes on each (``bytes_on``); the
  Detector makes room on each device for that device's bytes alone, before
  the warm-up (the largest cached program of the batch there) and before
  the capture (the warm-up's need there), least recently used first
  (``programs_to_evict``). Fake programs stand in for the captured ones,
  whose graphs need cards.
* The bytes the collectives of one call hand between shards, against a
  count made by hand from ``plan_spatial`` and the layer shapes of
  yolov3-tiny@160 at n = 2 and 4; on shards that share one device none of
  them crosses between devices."""
import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

from yolov3_tpu_torch import Darknet, Detector
from yolov3_tpu_torch.graph import load_graph
from yolov3_tpu_torch.parallel import collectives
from yolov3_tpu_torch.parallel.sharding import Mesh
from yolov3_tpu_torch.parallel.spatial import (SPACE_AXIS, make_spatial_mesh,
                                               plan_spatial, spatial_pipeline)
from yolov3_tpu_torch.weights import fold_raw, params_from_jax, random_raw

torch.set_num_threads(1)

TINY = str(Path(__file__).parent.parent / "models" / "yolov3-tiny.cfg")
SMALL = str(Path(__file__).parent / "data" / "port_small.cfg")
CUDA0, CUDA1 = torch.device("cuda", 0), torch.device("cuda", 1)
inference = importlib.import_module("yolov3_tpu_torch.inference")


class FakeProgram:
    """A captured program's interface with fixed per-device needs; its
    bytes on a device are its need there once captured."""
    needs_of = {}
    events = []

    def __init__(self, key, route, run, keep, device, *others):
        self.key, self.route = key, route
        self.devices = (device, *others)
        self.needs = dict(self.needs_of[key[:2]])
        self.need = self.needs[device]
        self._bytes = {}
        self.events.append(("warm-up", key[:2]))

    def capture(self):
        self._bytes = dict(self.needs)
        self.nbytes = sum(self._bytes.values())
        self.events.append(("capture", self.key[:2]))

    def bytes_on(self, device):
        return self._bytes.get(device, 0)

    def close(self):
        self.events.append(("evict", self.key[:2]))


@pytest.fixture
def two_card_detector(monkeypatch):
    """A spatial Detector whose mesh names two cards, with fake programs,
    a budget of 100 bytes a device and 1,000 free on each."""
    monkeypatch.setattr(inference, "_CapturedProgram", FakeProgram)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (1000, 1000))
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    FakeProgram.events.clear()
    net = Darknet(SMALL, precision="highest", device="cpu")
    net.set_params(fold_raw(random_raw(net.graph, seed=1)))
    det = Detector(net, prob_thresh=0.05)
    det.device, det._pipeline_budget = CUDA0, 100
    det.partition, det.mesh = "spatial", Mesh((CUDA0, CUDA1), (SPACE_AXIS,))
    return det


def test_bytes_on_and_eviction_per_device(two_card_detector):
    det = two_card_detector
    FakeProgram.needs_of = {(1, (10, 10)): {CUDA0: 10, CUDA1: 60},
                            (1, (20, 20)): {CUDA0: 10, CUDA1: 30},
                            (2, (10, 10)): {CUDA0: 95, CUDA1: 5}}
    events = FakeProgram.events

    def add(batch, hw):
        det._cache_pipeline((batch, hw, True, None, 0, det.mesh),
                            lambda f: None)

    add(1, (10, 10))
    (a,) = det._pipelines.values()
    assert a.devices == (CUDA0, CUDA1)
    assert [a.bytes_on(d) for d in (CUDA0, CUDA1)] == [10, 60]
    assert det._held(CUDA0) == [10] and det._held(CUDA1) == [60]
    events.clear()
    # before the warm-up: 10 + 10 fit the first card; 60 + 60 (the largest
    # program of the batch there) pass the second card's budget
    add(1, (20, 20))
    assert events == [("evict", (1, (10, 10))), ("warm-up", (1, (20, 20))),
                      ("capture", (1, (20, 20)))]
    events.clear()
    # no program of batch 2 to estimate from; after the warm-up 10 + 95
    # pass the first card's budget while 30 + 5 fit the second's
    add(2, (10, 10))
    assert events == [("warm-up", (2, (10, 10))), ("evict", (1, (20, 20))),
                      ("capture", (2, (10, 10)))]
    assert det._held(CUDA0) == [95] and det._held(CUDA1) == [5]
    assert det._held(torch.device("cuda", 2)) == [0]


def test_room_on_a_card_counts_only_that_cards_bytes(two_card_detector):
    """``_make_room`` on one card of the mesh: the least recently used
    programs go until that card's bytes fit, whatever the other holds."""
    det = two_card_detector
    FakeProgram.needs_of = {(1, (10, 10)): {CUDA0: 50, CUDA1: 5},
                            (1, (20, 20)): {CUDA0: 5, CUDA1: 50},
                            (1, (30, 30)): {CUDA0: 5, CUDA1: 5}}
    det._pipeline_budget = 200     # all three fit while they are made
    for hw in ((10, 10), (20, 20), (30, 30)):
        det._cache_pipeline((1, hw, True, None, 0, det.mesh), lambda f: None)
    assert not any(e[0] == "evict" for e in FakeProgram.events)
    det._pipeline_budget = 100
    FakeProgram.events.clear()
    det._make_room(60, CUDA1)      # 60 held there: the one holding 50 goes
    assert FakeProgram.events == [("evict", (1, (10, 10))),
                                  ("evict", (1, (20, 20)))]
    assert [k[1] for k in det._pipelines] == [(30, 30)]
    det._make_room(95, CUDA0)      # 5 + 95 fit
    assert len(det._pipelines) == 1


def _hand_count(graph, n, net_hw, elem=4, batch=1):
    """Bytes one call's collectives hand between shards, by name, from the
    plan and the layer shapes: a 3x3 stride-1 conv of the row-sharded
    prefix takes one halo row from above and one from below (n - 1 of
    each), a stride-2 pool of it nothing; the map entering the crossover is
    gathered once (each shard receives the n - 1 other bands); each "row"
    conv of the channel tail sums n partial maps (each shard receives the
    n - 1 others)."""
    plan = plan_spatial(graph, n, net_hw)
    h, w = net_hw
    want = {"rows_from_above": 0, "rows_from_below": 0, "all_gather": 0,
            "psum": 0}

    def shape_in(node):
        src = node.inputs[0]
        c = graph.in_channels if src < 0 else graph.nodes[src].out_channels
        ds = 1 if src < 0 else graph.nodes[src].downsample
        return c, h // ds, w // ds

    for node in graph.nodes[:plan.crossover]:
        c, _, wi = shape_in(node)
        if node.kind == "convolutional" and node.size == 3:
            assert node.stride == 1
            for name in ("rows_from_above", "rows_from_below"):
                want[name] += (n - 1) * batch * c * 1 * wi * elem
        else:
            assert node.kind == "maxpool" and node.stride == node.size
    c, hi, wi = shape_in(graph.nodes[plan.crossover])
    want["all_gather"] += (n - 1) * batch * c * hi * wi * elem
    for idx, role in plan.roles:
        if role == "row":
            node = graph.nodes[idx]
            ho, wo = h // node.downsample, w // node.downsample
            want["psum"] += (n - 1) * n * batch * node.out_channels * ho * wo * elem
    return plan, want


@pytest.mark.parametrize("n", [2, 4])
def test_collective_bytes_equal_the_hand_count(n):
    g = load_graph(TINY)
    plan, want = _hand_count(g, n, (160, 160))
    assert 0 < plan.crossover < len(g.nodes)
    run = spatial_pipeline(g, make_spatial_mesh(n, devices=["cpu"] * n),
                           (160, 160), top_k=16)
    params = params_from_jax(fold_raw(random_raw(g, seed=4)), "cpu")
    collectives.reset_counts()
    run(params, np.zeros((1, 96, 128, 3), np.uint8))
    assert dict(collectives.shard_bytes) == want
    # every shard on the one CPU: nothing crossed between devices
    assert not collectives.device_bytes and not collectives.copies
    assert collectives.counts["all_gather"] == 1
    collectives.reset_counts()
    assert not (collectives.counts or collectives.shard_bytes)


def test_collective_bytes_per_device_copy():
    """Between shards of distinct devices each copy counts once in
    ``device_bytes`` and in ``copies`` (by name, source, destination, shape
    and dtype); a replicated result is made once per distinct device."""
    xs = [torch.ones(1, 2, 3, 4), torch.ones(1, 2, 3, 4)]
    cpu = torch.device("cpu")
    meta = torch.device("meta")
    collectives.reset_counts()
    collectives._per_device("psum", xs, lambda d: xs[0])
    assert collectives.shard_bytes["psum"] == 192   # each receives the other
    assert not collectives.device_bytes
    ys = [xs[0], xs[1].to(meta)]
    collectives._per_device("all_gather", ys, lambda d: ys[0])
    assert collectives.shard_bytes["all_gather"] == 192
    assert collectives.device_bytes["all_gather"] == 2 * 96
    assert collectives.copies == {
        ("all_gather", meta, cpu, (1, 2, 3, 4), torch.float32): 1,
        ("all_gather", cpu, meta, (1, 2, 3, 4), torch.float32): 1}
    collectives.reset_counts()
