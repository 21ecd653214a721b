"""Batch data parallelism (batch-DP) on a single-controller mesh.

Port of ``yolov3_tpu/parallel/sharding.py``. The reference shards a batch
over a ``jax.sharding.Mesh`` and runs each shard's whole pipeline
(preprocess → convs → decode → NMS) on its own chip under ``shard_map``,
with zero collectives: the only traffic is the scatter of the input batch.
Here one process drives every shard's device, as ``shard_map`` does: a
:class:`Mesh` is a tuple of ``torch.device``\\ s, and a sharded value is a
list with one tensor per shard. Replica r runs the single-device step of
``inference.detect_step`` on batch rows ``[r·B/n, (r+1)·B/n)`` with its
own copy of the parameters, so nothing crosses between shards in a call
apart from staging each slice in and fetching each result out.

A device may repeat in a mesh only when the caller names it
(``devices=[torch.device("cuda", 0)] * 2``, or ``[torch.device("cpu")] *
8`` in the tests): the counterpart of the reference's virtual CPU mesh.
Shards on one device share their parameters (:func:`shard_params` copies
once per distinct device).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..inference import _InterpCache, decode_route, detect_step, scanned
from ..ops.nms import NMSResult
from ..weights import resolve_device

DATA_AXIS = "data"


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: one device per shard, in shard order, and the name of
    the axis the shards split."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: self.size}


def mesh_devices(n_devices: Optional[int], devices) -> Tuple[torch.device, ...]:
    """The reference's device rule: ``devices`` (default: every visible
    card, distinct), the first ``n_devices`` of them; fewer visible raises
    its ``ValueError``."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"requested {n_devices} devices, only {len(devices)} visible")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs a device: no CUDA device is visible "
                         "(name CPU shards with devices=)")
    return tuple(devices)


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D device mesh over the batch axis. Defaults to all visible cards."""
    return Mesh(mesh_devices(n_devices, devices), (DATA_AXIS,))


@dataclass(frozen=True)
class Sharding:
    """Where a tensor's shards go on ``mesh``: split along ``axis`` (shard
    i takes rows ``[i·n/size, (i+1)·n/size)``), or replicated when
    ``axis`` is None (one copy per distinct device)."""

    mesh: Mesh
    axis: Optional[int]

    def place(self, x) -> List[torch.Tensor]:
        """``x`` (a tensor or an array) as one tensor per shard, each on
        its shard's device."""
        x = torch.as_tensor(x)
        if self.axis is None:
            return shard_params(x, self.mesh)
        n = self.mesh.size
        if x.shape[self.axis] % n:
            raise ValueError(f"axis {self.axis} of size {x.shape[self.axis]} "
                             f"does not split over {n} shards")
        return [part.to(d) for part, d in zip(
            x.split(x.shape[self.axis] // n, self.axis), self.mesh.devices)]


def batch_sharding(mesh: Mesh, ndim: int = 4) -> Sharding:
    """Shard the leading (batch) axis; everything else replicated."""
    del ndim  # a leading-axis split is the same rule at every rank
    return Sharding(mesh, 0)


def replicate(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def _to(tree, device: torch.device):
    """``tree`` (tensors in nested dicts) on ``device``: the same object
    where nothing had to move."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        out = {k: _to(v, device) for k, v in tree.items()}
        return tree if all(out[k] is v for k, v in tree.items()) else out
    return tree


def shard_params(params, mesh: Mesh) -> list:
    """One copy of ``params`` (tensors in nested dicts, or a tensor) per
    shard: copied once per distinct device, shared where a device repeats,
    and the caller's own tree on the device it already lives on."""
    made: Dict[torch.device, object] = {}
    for d in mesh.devices:
        if d not in made:
            made[d] = _to(params, d)
    return [made[d] for d in mesh.devices]


def split_batch(frames, n: int, scan: int = 1) -> list:
    """Replica r's frames of a batch (an array or a tensor) of ``scan``
    sub-batches back to back: rows ``[r·b, (r+1)·b)`` of each sub-batch, b
    = B / (scan·n), in sub-batch order (the reference stages a
    ``(scan, B/scan, ...)`` stack sharded on its second axis). Each part
    is contiguous: at b = 1 under ``scan > 1`` the reshape alone is a
    strided view, which torch would gather on its intra-op threads before
    a host→device copy (33–40 ms of staging a yolov3@416 B=8 call over
    four cards on a busy host, PERF.md §5)."""
    b = frames.shape[0] // (scan * n)
    stack = frames.reshape(scan, n, b, *frames.shape[1:])
    parts = [stack[:, r].reshape(scan * b, *frames.shape[1:])
             for r in range(n)]
    if isinstance(frames, np.ndarray):
        return [np.ascontiguousarray(p) for p in parts]
    return [p.contiguous() for p in parts]


def merge_batch(parts: Sequence[torch.Tensor], scan: int = 1) -> torch.Tensor:
    """The inverse of :func:`split_batch` for per-replica results."""
    b = parts[0].shape[0] // scan
    stack = torch.stack([p.reshape(scan, b, *p.shape[1:]) for p in parts], 1)
    return stack.reshape(-1, *parts[0].shape[1:])


class ShardedPipeline:
    """The batch-DP step, what :func:`sharded_pipeline` returns.

    ``run(params, frames)``: params per shard (:func:`shard_params`; a
    single tree is sharded here) and uint8 frames (B, H, W, 3), or with
    ``scan > 1`` a (scan, B, H, W, 3) stack, B a multiple of the mesh size
    → NMSResult on the host with the input's leading axes. Each replica's
    results leave its device in one copy per field.

    :meth:`replica` is one replica's program body on its own device (what
    the Detector builds, and on the card captures, once per shard)."""

    def __init__(self, mesh: Mesh, scan: int,
                 step: Callable[..., Callable[[torch.Tensor], NMSResult]],
                 net_hw: Tuple[int, int], mode: str):
        self.mesh, self.scan, self._step = mesh, scan, step
        self._interp = {d: _InterpCache(net_hw, mode, d)
                        for d in dict.fromkeys(mesh.devices)}

    def replica(self, params, device: torch.device, operands=None
                ) -> Callable[[torch.Tensor], NMSResult]:
        """Replica body on ``device``: its (scan·b, H, W, 3) uint8 frames
        there → NMSResult, ``scan`` sub-batches back to back. ``params``
        are the replica's (its ``qparams`` on a quantized pipeline, with
        their ``operands``; the int8 walk builds throw-away ones when none
        are given)."""
        run = self._step(params, interp=self._interp[device],
                         operands=operands)
        return scanned(run, self.scan)

    def __call__(self, params, frames) -> NMSResult:
        shards = params if isinstance(params, list) else shard_params(
            params, self.mesh)
        if not isinstance(frames, torch.Tensor):
            frames = torch.from_numpy(np.ascontiguousarray(frames))
        lead = frames.shape[:2] if self.scan > 1 else frames.shape[:1]
        flat = frames.reshape(-1, *frames.shape[-3:])
        n = self.mesh.size
        if flat.shape[0] % (n * self.scan):
            raise ValueError(f"batch {flat.shape[0] // self.scan} does not "
                             f"split over {n} shards")
        with torch.inference_mode():
            outs = [self.replica(p, d)(x.to(d)) for p, d, x in zip(
                shards, self.mesh.devices, split_batch(flat, n, self.scan))]
            host = [[t.cpu() for t in o] for o in outs]
        return NMSResult(*(merge_batch(f, self.scan).reshape(
            *lead, *f[0].shape[1:]) for f in zip(*host)))


def sharded_pipeline(graph, mesh: Mesh, net_hw: Tuple[int, int],
                     prob_thresh: float = 0.05, iou_thresh: float = 0.3,
                     top_k: int = 512, mode: str = "letterbox",
                     precision: Optional[str] = None, bgr: bool = True,
                     act_scales=None, act_zeros=None,
                     carrier: str = "bf16",
                     conv_impl: str = "xla",
                     nms_impl: str = "xla", decode_impl: str = "pallas",
                     max_results: int = 0, scan: int = 1,
                     select_group: int = 2, block_impl: str = "xla"
                     ) -> ShardedPipeline:
    """Build the batch-DP end-to-end detect step over ``mesh``.

    The route follows the reference's gates: "pallas-fused" on a graph the
    head-fused decode refuses, or on the bf16-carrier int8 walk, runs
    "pallas" (K1); heads with more than 4 anchors run "xla" (the plain
    compact decode). Pass ``act_scales`` (and int8 qparams as ``params``)
    for the quantized walk. ``scan > 1`` is the throughput configuration:
    each replica runs ``scan`` sub-batches of its slice back to back in one
    program, and the batch axis never crosses devices."""
    route = decode_route(graph, decode_impl, warn=False,
                         q_ok=act_scales is None or carrier == "int8")
    nms = dict(iou_thresh=iou_thresh, top_k=top_k, impl=nms_impl,
               max_results=max_results, select_group=select_group)

    def step(params, interp, operands):
        return detect_step(graph, params, net_hw, mode, bgr, route, interp,
                           prob_thresh, nms, precision=precision,
                           conv_impl=conv_impl, act_scales=act_scales,
                           act_zeros=act_zeros, carrier=carrier,
                           block_impl=block_impl, operands=operands)

    return ShardedPipeline(mesh, scan, step, tuple(net_hw), mode)
