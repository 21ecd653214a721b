"""One end-to-end step of both parallel modes on an n-shard mesh.

The counterpart of the reference's ``__graft_entry__.dryrun_multichip``:
yolov3-tiny at 160x160 with ``random_raw(seed=1)`` weights, uint8 frames
of 192x256 from ``default_rng(0)``, ``prob_thresh`` 0.2 and ``top_k`` 64,
through batch-DP (one frame a shard), batch-DP with the head-fused decode,
and spatial + channel partitioning of the first frame; it prints the
reference's three lines. It runs on the card unless asked for the CPU;
with fewer than n cards visible the mesh repeats ``cuda:0`` (a virtual
mesh on one card).
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..graph import load_graph
from ..weights import (Device, fold_raw, params_from_jax, random_raw,
                       resolve_device)
from .sharding import make_mesh, shard_params, sharded_pipeline
from .spatial import make_spatial_mesh, plan_spatial, spatial_pipeline

MODELS = Path(__file__).resolve().parents[2] / "models"


def _dryrun_devices(n_devices: int, device: Device = None):
    """n shard devices: CPU shards for ``device="cpu"``; else the first n
    visible cards, or ``cuda:0`` n times when fewer are visible."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * n_devices
    if torch.cuda.device_count() >= n_devices:
        return None
    return [torch.device("cuda", 0)] * n_devices


def dryrun_multichip(n_devices: int, device: Optional[Device] = None) -> None:
    """One real sharded end-to-end step on an n-device mesh, tiny shapes."""
    devices = _dryrun_devices(n_devices, device)
    mesh = make_mesh(n_devices, devices=devices)
    graph = load_graph(MODELS / "yolov3-tiny.cfg")
    params = shard_params(params_from_jax(fold_raw(random_raw(graph, seed=1)),
                                          mesh.devices[0]), mesh)
    batch = n_devices
    frames = np.random.default_rng(0).integers(
        0, 256, (batch, 192, 256, 3), dtype=np.uint8)

    run = sharded_pipeline(graph, mesh, net_hw=(160, 160), prob_thresh=0.2,
                           top_k=64)
    result = run(params, frames)
    assert tuple(result.boxes.shape) == (batch, 64, 4)
    print(f"dryrun_multichip OK (batch-DP): {n_devices}-device mesh, batch "
          f"{batch}, boxes {tuple(result.boxes.shape)}, survivors "
          f"{int(result.valid.sum())}")

    # head-conv-fused decode on the same mesh: K4 inside each replica
    run_f = sharded_pipeline(graph, mesh, net_hw=(160, 160), prob_thresh=0.2,
                             top_k=64, decode_impl="pallas-fused")
    result_f = run_f(params, frames)
    assert tuple(result_f.boxes.shape) == (batch, 64, 4)
    print(f"dryrun_multichip OK (batch-DP, fused heads): survivors "
          f"{int(result_f.valid.sum())}")

    # spatial + channel partitioning (latency mode): rows shard over the
    # mesh with halo exchange, deep conv pairs over channels with psums
    smesh = make_spatial_mesh(n_devices, devices=devices)
    plan = plan_spatial(graph, n_devices, (160, 160))
    srun = spatial_pipeline(graph, smesh, net_hw=(160, 160), prob_thresh=0.2,
                            top_k=64)
    with torch.inference_mode():
        sres = srun(params, frames[:1])
    assert tuple(sres.boxes.shape) == (1, 64, 4)
    print(f"dryrun_multichip OK (spatial+channel): crossover node "
          f"{plan.crossover}, sharded FLOP fraction "
          f"{plan.total_sharded_flop_frac:.2f}, survivors "
          f"{int(sres.valid.sum())}")

