"""The serving path: uint8 frames → detections, on one device.

Port of ``yolov3_tpu/inference.py``: ``Detection``, the ``Detector``
(``detect_batch``, ``detect_mixed``, ``detect_preletterboxed``, ``warmup``),
``PipelinedDetector``, the one-shot ``inference()`` and the entry points
``detect_image``, ``detect_directory``, ``detect_in_video`` and
``detect_in_cam``. One call runs:

1. one host→device copy of the raw uint8 batch, BGR→RGB flip on the device;
2. ``ops.preprocess.preprocess`` (letterbox or stretch, two fp32 matmuls with
   interpolation matrices cached per source shape);
3. the forward pass and decode of the chosen route (``decode_impl``):
   ``"pallas"`` (default) ``model.forward_packed``, the graph walk then K1;
   ``"pallas-fused"`` ``model.forward_packed_fused``, the walk up to the
   pre-head activations then K4 (head convs inside the decode kernel);
   ``"xla"`` ``model.forward_compact``, the plain-tensor compact decode;
   the net's ``conv_impl`` picks cuDNN or K5 for the eligible convs. A
   quantized net (``Darknet.quantize_int8`` / ``load_quantized``) runs the
   int8 tier's walk instead (``quant.forward_packed_int8``,
   ``forward_packed_fused_int8``, ``forward_compact_int8``), with
   ``block_impl="pallas"`` sending its eligible residual blocks through the
   fused kernel K6;
4. ``ops.nms.batched_nms_packed`` (the packed routes) or
   ``batched_nms_compact`` (the compact route): selection, K2 (suppression
   kernel), compaction to ``max_results``;
5. ``pack_results`` and ONE device→host copy, then rescaling to source
   pixels on the host.

The route gates are the JAX package's graph-shape rules: "pallas-fused" on
a graph that ``fused_heads_eligible`` refuses, or on a net quantized with
the bf16 carrier, runs "pallas", and heads with more than 4 anchors run
"xla", each with the JAX package's warning; ``block_impl="pallas"`` on a
net with nonzero zero-points (the asymmetric scheme) runs its blocks
unfused, with a warning. They are not a fallback from a failing kernel: a
kernel that cannot build or launch raises. ``Detector(mesh=...)`` runs the
multi-device routes of ``parallel/``: batch-DP (``partition="data"``, one
replica program per shard) and spatial (``partition="spatial"``, each
image's rows over the mesh).

``detect_mixed`` takes frames of any sizes: the C++ host loader
(``native.py``) letterboxes them into one RGB uint8 batch at net resolution
and ``detect_preletterboxed`` runs steps 1-5 on it (the device preprocess is
then the normalization alone); without the loader, same-shape groups go
through ``detect_batch``. ``scan=k`` splits a batch into ``k`` sub-batches
that run back to back in one program and leave the device in ONE copy.
``PipelinedDetector`` keeps several batches in flight on a CUDA stream of
its own.

Steps 1-5 run as one cached program per (batch, source shape, channel
order, quantization state, weights), the counterpart of the JAX package's
jitted pipelines (``Detector._pipeline`` / ``_finalize`` /
``_cache_pipeline``, an LRU of 16). On the card a program is ONE CUDA graph
(over every card of a spatial mesh), captured at its first call after one
eager run that builds the kernels and fills every lazy cache; a later call
copies its frames into the graph's static input, replays it, and copies
the static packed output out. On the CPU a program is the eager closure of
the same steps, so both devices key and evict alike. On the card the LRU
is also bounded by bytes: a program holds its memory pool until it is
evicted, so before a warm-up and again before a capture the least
recently used programs go while the programs' bytes would pass
``PROGRAM_MEMORY_SHARE`` of the card, or the card's free memory is under
the new program's need (``programs_to_evict``), card by card. A capture or
a replay that fails raises. ``cv2`` is imported inside the entry points
that need it, never with the package.

Each host stage of a call is a span (``utils.profiling.span``): timed on
the host clock always (``Detector.last_stage_s`` adds them up), and while
a ``torch.profiler`` profile runs also the profiler range
``yolov3.<stage>`` and an entry of ``utils.profiling.RECORD``, under the
call's id. ``Detector.cache_counts`` counts the program cache's hits,
misses (programs built), evictions and the seconds the builds took.
"""
from __future__ import annotations

import gc
import logging
import threading
import time
from collections import OrderedDict
from contextlib import ExitStack, contextmanager
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .model import (Darknet, forward_compact, forward_packed,
                    forward_packed_fused, fused_heads_eligible,
                    resolve_device)
from .ops.cuda_decode import supported as packed_decode_supported
from .ops.nms import IMPLS as NMS_IMPLS, auto_top_k
from .ops.nms import (NMSResult, batched_nms_compact, batched_nms_packed,
                      pack_results)
from .ops.preprocess import Interp, interp_matrices, preprocess, resize_target
from .utils.boxes import unletterbox_tlbr, unstretch_tlbr
from .utils.profiling import new_call, span

log = logging.getLogger("yolov3_tpu_torch")

RESIZE_MODES = ("letterbox", "stretch")
# the share of the card's memory that one Detector's captured programs may
# hold together; the rest is left to the weights, eager calls and the
# warm-up forward of the next program
PROGRAM_MEMORY_SHARE = 0.75
DECODE_IMPLS = ("pallas", "pallas-fused", "xla")
BLOCK_IMPLS = ("xla", "pallas")
PARTITIONS = ("data", "spatial")


def decode_route(graph, decode_impl: str, q_ok: bool = True,
                 warn: bool = True, spatial: bool = False) -> str:
    """The route a Detector runs for ``decode_impl`` on ``graph``, by the
    JAX package's gates (``yolov3_tpu/inference.py``), with its warnings
    unless ``warn`` is False. ``q_ok`` is False for a net quantized with
    the bf16 carrier, whose walk has no head-fused form; ``spatial`` for
    ``partition="spatial"``, which shards the head convs themselves. A
    graph whose heads scale their centres (``scale_x_y``, YOLOv4) leaves
    "pallas-fused" for "pallas": K4 takes no scale, K1 does."""
    if decode_impl not in DECODE_IMPLS:
        raise ValueError(f"decode_impl must be one of {DECODE_IMPLS}, got "
                         f"{decode_impl!r}")
    if decode_impl == "pallas-fused" and (
            not q_ok or spatial or not fused_heads_eligible(graph)):
        if warn:
            log.warning("head-fused decode not applicable here (%s); "
                        "falling back to decode_impl='pallas'",
                        "bf16-carrier int8" if not q_ok else
                        "spatial" if spatial else
                        "scale_x_y" if any(v != 1.0 for v in
                                           graph.head_scales()) else
                        "graph shape")
        decode_impl = "pallas"
    if (decode_impl in ("pallas", "pallas-fused")
            and not packed_decode_supported([n.anchors for n in graph.yolo_nodes])):
        if warn:
            log.warning("pallas decode supports <=4 anchors/head; "
                        "falling back to decode_impl='xla'")
        decode_impl = "xla"
    return decode_impl


def programs_to_evict(sizes: Sequence[int], need: int,
                      budget: Optional[int], free: Optional[int]) -> int:
    """How many cached programs to evict, least recently used first, before
    a program that needs ``need`` device bytes is built: the fewest that
    bring the cached programs' bytes (``sizes``, in LRU order) plus
    ``need`` within ``budget`` and the card's ``free`` bytes up to ``need``,
    an evicted program's bytes counting as freed. ``budget=None`` (the CPU,
    where a program holds no device bytes): none."""
    if budget is None:
        return 0
    held, n = sum(sizes), 0
    while n < len(sizes) and (held + need > budget or free < need):
        held -= sizes[n]
        free += sizes[n]
        n += 1
    return n


def detect_step(graph, params, net_hw: Tuple[int, int], mode: str, bgr: bool,
                route: str, interp, prob_thresh: float, nms: dict,
                precision: Optional[str] = None, conv_impl: str = "xla",
                act_scales=None, act_zeros=None, carrier: str = "int8",
                block_impl: str = "xla", operands=None):
    """The device work of one call by ``route`` on ``params``' device:
    (B, H, W, 3) uint8 frames there → NMSResult, boxes in net-input pixels.
    With ``act_scales``, ``params`` are the int8 ``qparams`` (and
    ``operands`` their run-time forms) and the int8 walk runs. ``interp``
    gives the interpolation matrices of a source shape (``_InterpCache``);
    ``nms`` the NMS keywords. A Detector's program and each batch-DP
    replica (``parallel.sharding``) run this; the closure holds no
    reference to a Detector."""
    if act_scales is not None:
        from .quant import (forward_compact_int8, forward_packed_fused_int8,
                            forward_packed_int8)

        state = (graph, params, act_scales)
        kw = dict(precision=precision or "bf16", carrier=carrier,
                  block_impl=block_impl, zeros=act_zeros, operands=operands)
        compact = lambda x: forward_compact_int8(  # noqa: E731
            *state, x, decode_impl="xla", **kw)
        packed = (forward_packed_fused_int8 if route == "pallas-fused"
                  else forward_packed_int8)
    else:
        state = (graph, params)
        kw = dict(precision=precision, conv_impl=conv_impl)
        compact = lambda x: forward_compact(*state, x, **kw)  # noqa: E731
        packed = (forward_packed_fused if route == "pallas-fused"
                  else forward_packed)

    def run(frames: torch.Tensor) -> NMSResult:
        if bgr:
            frames = frames.flip(-1)  # BGR→RGB on device
        x = preprocess(frames, net_hw, mode=mode,
                       interp=interp(tuple(frames.shape[1:3])))
        if route == "xla":
            return batched_nms_compact(*compact(x), prob_thresh=prob_thresh,
                                       **nms)
        payload, scores = packed(*state, x, prob_thresh=prob_thresh, **kw)
        return batched_nms_packed(payload, scores, **nms)

    return run


def scanned(run, k: int):
    """``run`` over ``k`` sub-batches back to back (the counterpart of the
    reference's ``lax.scan``), results concatenated in submission order;
    ``run`` itself for k = 1."""
    if k == 1:
        return run

    def run_k(frames: torch.Tensor) -> NMSResult:
        parts = [run(part) for part in frames.chunk(k)]
        return NMSResult(*(torch.cat(f) for f in zip(*parts)))

    return run_k


def _packed(run):
    """``run`` ending in ``pack_results``: ONE device tensor for ONE
    device→host copy."""
    def packed(frames: torch.Tensor) -> torch.Tensor:
        return pack_results(run(frames))

    return packed


@dataclass
class Detection:
    """Per-image detection result in original-image pixel coordinates."""

    bbox_tlbr: np.ndarray  # (n, 4) float32
    class_prob: np.ndarray  # (n,) float32  (objectness × class prob)
    class_idx: np.ndarray  # (n,) int32


class _InterpCache(dict):
    """Interpolation matrices per source shape, built at the first call for
    the shape (a host→device copy: in a program's warm-up forward, never
    inside a capture). Callable, so a program's closure holds this cache
    and not its Detector."""

    def __init__(self, net_hw: Tuple[int, int], mode: str,
                 device: torch.device):
        super().__init__()
        self.net_hw, self.mode, self.device = net_hw, mode, device

    def __call__(self, src_hw: Tuple[int, int]) -> Interp:
        if src_hw not in self:
            out_hw = resize_target(src_hw, self.net_hw, self.mode)
            self[src_hw] = interp_matrices(src_hw, out_hw, self.device)
        return self[src_hw]


class _Program:
    """One cached program of a :class:`Detector`, the counterpart of a
    jitted pipeline of the JAX package: (B, H, W, 3) uint8 frames on the
    device → packed (B, R, 6) results. This one is the eager closure (the
    CPU's program); ``keep`` holds the weights and quantization state of its
    key alive, as the reference's closure holds its ``qparams``."""

    def __init__(self, key: Tuple, route: str, run, keep: Tuple):
        self.key, self.route, self.run, self.keep = key, route, run, keep

    def stage(self, frames: np.ndarray, device: torch.device) -> torch.Tensor:
        """The host batch on ``device``, as this program's input."""
        return torch.from_numpy(frames).to(device)

    def __call__(self, frames: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self.run(frames)

    def hold(self, res: torch.Tensor) -> torch.Tensor:
        """A result that outlives the next call (the eager program's own)."""
        return res

    def bytes_on(self, device: torch.device) -> int:
        return 0

    def release(self) -> None:
        """The caller's result has left the program's buffers."""

    def close(self) -> None:
        """Evicted from the cache."""


class _CapturedProgram(_Program):
    """A program captured as ONE CUDA graph on the card: flip, preprocess,
    walk, decode, selection, K2, compaction and pack, reading a static uint8
    input and writing a static packed output, in a memory pool of its own.

    Built in two steps, so that its Detector can make room in between.
    Construction runs one eager forward on the capture stream: it builds
    the kernels and fills every lazy cache (the interpolation matrices, the
    int8 operands, the anchors' device constants, the libraries' handles and
    workspaces), so nothing inside the capture copies from the host or
    synchronises, and its peak sets ``need``, the device bytes the capture
    will hold. :meth:`capture` then captures the graph; ``nbytes`` is what
    the program holds, its pool and static input. A replay overwrites the
    static output, so a caller that holds a result past the next call
    copies it out first; ``release`` records where it did, and the next
    caller's stream waits for that point (``acquire``) before it touches
    the buffers.

    ``others``: further devices the program runs on (a spatial mesh over
    several cards). The input, the output and the graph's launch live on
    ``device``; each other device gets a stream of the program that forks
    from the capture stream (an event it waits for) and joins it again
    before the capture ends, so that work on every card is captured into
    the one graph, and a memory pool of the program (``torch.cuda.MemPool``)
    that takes this thread's allocations on that device while the graph is
    captured. The eager forward runs on the same streams, so the libraries'
    per-stream workspaces exist before the capture. ``needs`` and
    ``bytes_on`` count each device's bytes apart."""

    def __init__(self, key: Tuple, route: str, run, keep: Tuple,
                 device: torch.device, *others: torch.device):
        super().__init__(key, route, run, keep)
        self._t0 = time.perf_counter()
        batch, (h, w) = key[0], key[1]
        self.devices = tuple(dict.fromkeys((device, *others)))
        base = {d: torch.cuda.memory_allocated(d) for d in self.devices}
        for d in self.devices:
            torch.cuda.reset_peak_memory_stats(d)
        self.input = torch.zeros((batch, h, w, 3), dtype=torch.uint8,
                                 device=device)
        self._streams = {d: torch.cuda.Stream(d) for d in self.devices}
        self._stream = self._streams[device]
        self._stream.wait_stream(torch.cuda.current_stream(device))
        with torch.inference_mode(), self._on_streams():
            run(self.input)
        self._stream.synchronize()
        self.needs = {d: torch.cuda.max_memory_allocated(d) - base[d]
                      for d in self.devices}
        self.need = self.needs[device]
        torch.cuda.empty_cache()
        self.replays = 0
        self._released = torch.cuda.Event()
        self._used = False
        self._pools: Dict[torch.device, object] = {}
        self._bytes: Dict[torch.device, int] = {}

    @contextmanager
    def _on_streams(self, pools: Optional[Dict] = None):
        """Inside: the program's stream is the current stream of every device
        it runs on, the other devices' streams forked from the first's
        current point and joined back into it on leaving (inside a capture,
        the fork and the join bring them into the capture). ``pools``: the
        other devices' allocations of this thread go to them."""
        first = self._stream
        sides = [s for s in self._streams.values() if s is not first]
        with ExitStack() as stack:
            stack.enter_context(torch.cuda.stream(first))
            if sides:
                fork = torch.cuda.Event()
                fork.record(first)
            for s in sides:
                s.wait_event(fork)
                stack.enter_context(torch.cuda.stream(s))
                if pools is not None:
                    stack.enter_context(torch.cuda.use_mem_pool(
                        pools[s.device], device=s.device))
            # torch.cuda.stream made each side stream's device the current
            # one: the first device is current inside
            stack.enter_context(torch.cuda.device(first.device))
            yield
            for s in sides:
                join = torch.cuda.Event()
                join.record(s)
                first.wait_event(join)

    def capture(self) -> None:
        """Capture the graph; ``nbytes`` (every device's), ``bytes_on`` and
        ``capture_s`` (warm-up and capture, seconds) follow."""
        device = self.input.device
        reserved = {d: torch.cuda.memory_reserved(d) for d in self.devices}
        for d in self.devices[1:]:
            with torch.cuda.device(d):  # a pool belongs to the current device
                self._pools[d] = torch.cuda.MemPool()
        self.graph = torch.cuda.CUDAGraph()
        # no collection inside the capture: a graph it freed (another
        # program, dropped in a reference cycle) would be destroyed there,
        # which the capture refuses
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.inference_mode(), torch.cuda.graph(
                    self.graph, stream=self._stream), self._on_streams(
                        self._pools):
                self.output = self.run(self.input)
        finally:
            if collecting:
                gc.enable()
        self._bytes = {d: torch.cuda.memory_reserved(d) - reserved[d]
                       for d in self.devices}
        self._bytes[device] += self.input.numel()
        self.nbytes = sum(self._bytes.values())
        self.capture_s = time.perf_counter() - self._t0

    def acquire(self) -> None:
        """Order the current stream after the last caller's copy out."""
        if self._used:
            torch.cuda.current_stream(self.input.device).wait_event(
                self._released)

    def stage(self, frames: np.ndarray, device: torch.device) -> torch.Tensor:
        self.acquire()
        self.input.copy_(torch.from_numpy(frames))
        return self.input

    def stage_pinned(self, frames: torch.Tensor) -> torch.Tensor:
        """Stage from pinned host memory, asynchronously on the current
        stream (the caller keeps ``frames`` alive until the copy ran)."""
        self.acquire()
        self.input.copy_(frames, non_blocking=True)
        return self.input

    def __call__(self, frames: torch.Tensor) -> torch.Tensor:
        if frames is not self.input:
            raise ValueError("a captured program reads its own static input: "
                             "stage the frames with stage()")
        with torch.cuda.device(self.input.device):
            self.graph.replay()
        self.replays += 1
        return self.output

    def hold(self, res: torch.Tensor) -> torch.Tensor:
        # a copy, queued after the replay: the next replay overwrites res
        return res.clone()

    def bytes_on(self, device: torch.device) -> int:
        return self._bytes.get(device, 0)

    def release(self) -> None:
        self._released.record(torch.cuda.current_stream(self.input.device))
        self._used = True

    def close(self) -> None:
        # a replay still running on another stream must not have its memory
        # handed out; the pools go back to the allocator now, even while
        # something still holds this object (the other devices' replays
        # join the first device's stream before the graph ends)
        if self._used:
            self._released.synchronize()
        self.graph.reset()
        self._pools.clear()
        self.input = self.output = None


class _Shards(list):
    """A batch-DP call's packed results: one device tensor per replica.
    ``cpu()`` fetches each (one device→host copy a replica) and merges them
    in submission order, as ``Detector._unpack`` merges the reference's
    sharded results."""

    def __init__(self, parts, scan: int):
        super().__init__(parts)
        self.scan = scan

    def cpu(self) -> torch.Tensor:
        from .parallel.sharding import merge_batch

        return merge_batch([p.cpu() for p in self], self.scan)


class _MeshProgram:
    """A batch-DP program: one replica program per shard of the mesh, each
    on its shard's device (on the card each one CUDA graph, captured on a
    stream of that device), reading the replica's slice of the batch
    (``parallel.sharding.split_batch``). A call stages every slice, then
    queues every replica, so the devices run at once."""

    def __init__(self, key: Tuple, route: str, replicas: List[_Program],
                 devices: Sequence[torch.device], scan: int):
        self.key, self.route, self.replicas = key, route, replicas
        self.devices, self.scan = devices, scan

    def stage(self, frames: np.ndarray, device: torch.device) -> List:
        from .parallel.sharding import split_batch

        parts = split_batch(frames, len(self.replicas), self.scan)
        staged = []
        for i, (r, p, d) in enumerate(zip(self.replicas, parts, self.devices)):
            with span("stage", tag=i):  # one span a replica, its index the tag
                staged.append(r.stage(p, d))
        return staged

    def __call__(self, staged: List[torch.Tensor]) -> _Shards:
        return _Shards([r(s) for r, s in zip(self.replicas, staged)],
                       self.scan)

    def hold(self, res: _Shards) -> _Shards:
        return _Shards([r.hold(p) for r, p in zip(self.replicas, res)],
                       self.scan)

    def bytes_on(self, device: torch.device) -> int:
        return sum(r.bytes_on(device) for r in self.replicas)

    def release(self) -> None:
        for r in self.replicas:
            r.release()

    def close(self) -> None:
        for r in self.replicas:
            r.close()


class Detector:
    """End-to-end detector over a :class:`~yolov3_tpu_torch.model.Darknet`
    on the net's device. The parameters take the JAX Detector's positional
    order, with ``device`` last: when given, it must be the net's device
    (the Detector does not move weights); asking for CUDA without a card
    raises. ``decode_impl`` picks the route (module docstring); the route
    actually run is ``self.route``. ``block_impl="pallas"`` runs a quantized
    net's eligible residual blocks through K6 (no effect on a float net or
    on the bf16-carrier walk). ``nms_impl`` takes the JAX package's "xla"
    and "pallas": its two suppressions are bit-identical and on the card
    both names run the kernel K2. ``scan=k`` runs each batch as ``k``
    sub-batches back to back in one program whose results leave the device
    in one copy (a throughput knob: the batch is padded to a multiple of
    ``k``). The results come back in submission order and equal, bit for
    bit, those of the same sub-batches run one call each. They equal
    ``scan=1``'s on the whole batch only where a conv's result for an image
    does not depend on the batch it is in: true on the CPU, not on the card,
    where the library picks its conv algorithm by batch size (PERF.md,
    Findings).

    ``mesh`` (``parallel.make_mesh``) with ``partition="data"`` runs
    batch-DP: the batch, padded to a multiple of ``mesh.size`` (of ``scan ×
    mesh.size`` with ``scan > 1``), splits over the shards, each shard runs
    one replica of the route above on its own device and its own copy of
    the weights (on the card its own captured program), and the results
    merge in submission order. ``mesh`` from ``parallel.make_spatial_mesh``
    with ``partition="spatial"`` shards each image's rows over the mesh
    (``parallel.spatial_pipeline``; the float tiers only, ``scan`` 1): one
    program whose input and output lie on the first shard's device; on the
    card ONE graph over every card of the mesh (each card's work on a
    stream of the program, forked from and joined into the capture stream;
    :class:`_CapturedProgram`). A device may repeat in a mesh (a virtual
    mesh on one card). ``partition="spatial"`` with no mesh
    runs on one device, as the reference's does.

    Programs are cached per (batch, source shape, channel order,
    quantization state, weights) in an LRU of ``_pipeline_capacity`` (16,
    the reference's) that on the card also holds at most
    ``_pipeline_budget`` device bytes (``PROGRAM_MEMORY_SHARE`` of the
    card; :func:`programs_to_evict`): ``set_params`` / ``load_weights`` /
    ``quantize_int8`` / ``set_quantized`` / ``load_quantized`` change the
    key, so no program replays weights it no longer should. A Detector
    serialises its calls (one lock): a program's buffers serve one call at
    a time."""

    def __init__(self, net: Darknet, prob_thresh: float = 0.05,
                 iou_thresh: float = 0.3, resize_mode: str = "letterbox",
                 top_k: Optional[int] = None, bgr: bool = True,
                 net_hw: Optional[Tuple[int, int]] = None, mesh=None,
                 nms_impl: str = "xla", decode_impl: str = "pallas",
                 max_results: int = 128, scan: int = 1,
                 partition: str = "data", select_group: int = 2,
                 block_impl: str = "xla",
                 device: Union[str, torch.device, None] = None):
        if nms_impl not in NMS_IMPLS:
            raise ValueError(f"unknown nms_impl {nms_impl!r} (expected 'xla' "
                             "or 'pallas')")
        self.nms_impl = nms_impl
        self.scan = int(scan)
        if self.scan < 1:
            raise ValueError(f"scan must be >= 1, got {scan}")
        if self.scan > 1 and mesh is not None and partition != "data":
            # scan is a throughput knob; spatial partitioning is the latency
            # mode (the reference's rule)
            raise ValueError("scan > 1 requires partition='data' on a mesh")
        if partition not in PARTITIONS:
            raise ValueError(f"unknown partition {partition!r}")
        self.partition, self.mesh = partition, mesh
        self.device = net.device
        if device is not None and resolve_device(device) != self.device:
            raise ValueError(f"the net's weights live on {self.device}, not "
                             f"{device}: build Darknet(..., device={str(device)!r})")
        self.net = net
        self.prob_thresh = float(prob_thresh)
        self.iou_thresh = float(iou_thresh)
        if resize_mode not in RESIZE_MODES:
            raise ValueError(f"unknown preprocess mode {resize_mode!r}")
        self.resize_mode = resize_mode
        if top_k is not None and int(top_k) < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        self.bgr = bgr
        # post-NMS compaction: the K-slot working set shrinks to the top
        # max_results survivors before leaving the device
        self.max_results = int(max_results)
        # group-max selection width: bit-identical results for any G >= 2
        self.select_group = int(select_group)
        if self.select_group < 2:
            raise ValueError(f"select_group must be >= 2, got {select_group}")
        self.net_hw = tuple(net_hw) if net_hw else net.net_size
        max_stride = max(net.graph.head_strides())
        if any(v <= 0 or v % max_stride for v in self.net_hw):
            raise ValueError(f"net_hw {self.net_hw} must be positive "
                             f"multiples of the net's max stride "
                             f"({max_stride})")
        self.top_k = (auto_top_k(net.graph, self.net_hw) if top_k is None
                      else int(top_k))
        if not 0.0 <= self.prob_thresh < 1.0:
            raise ValueError(f"prob_thresh must be in [0, 1), got "
                             f"{prob_thresh}")
        if not 0.0 <= self.iou_thresh <= 1.0:
            raise ValueError(f"iou_thresh must be in [0, 1], got "
                             f"{iou_thresh}")
        if block_impl not in BLOCK_IMPLS:
            raise ValueError(f"unknown block_impl {block_impl!r} "
                             "(expected 'xla' or 'pallas')")
        self.block_impl = block_impl
        self.decode_impl = decode_impl
        # the gates depend on the quantization state, which may change after
        # construction: resolved again (and warned about) per program
        self._resolve_route()
        if mesh is not None:
            self._check_mesh()
        # the weights, int8 state and operands of each shard, by the net's
        # state they copy (_replicas)
        self._replica_state: Tuple = ()
        self._interp = _InterpCache(self.net_hw, resize_mode, self.device)
        # the cached programs, LRU-bounded: each holds its weights, its
        # quantization state and, on the card, a graph and its memory pool
        self._pipelines: "OrderedDict[Tuple, _Program]" = OrderedDict()
        self._pipeline_capacity = 16
        # device bytes the programs may hold together (None on the CPU)
        self._pipeline_budget = (
            int(PROGRAM_MEMORY_SHARE * torch.cuda.mem_get_info(self.device)[1])
            if self.device.type == "cuda" else None)
        self._lock = threading.Lock()
        # per-call stage split (seconds) of the last synchronous detect
        # call, written as ONE dict assignment (serve.py publishes it under
        # /stats and /metrics), from the call's spans
        # (``utils.profiling.span``): preprocess_s (``letterbox``: host
        # letterbox, detect_mixed only), h2d_s (``stage``: host→device copy
        # of the frames), dispatch_s (``lookup`` + ``launch``: the program
        # looked up, captured on its first call, and its replay queued, NOT
        # finished), device_fetch_s (``fetch`` + ``unpack``: wait for the
        # device + the one D2H copy + the host unpack). Read it from the
        # thread that ran the call.
        self.last_stage_s: Optional[Dict[str, float]] = None
        # the program cache's events, always counted (serve.py publishes
        # them): lookups that found their program, programs built (on the
        # card: captured), programs evicted, and the seconds the builds took
        self.cache_counts = {"hit": 0, "miss": 0, "evict": 0, "capture_s": 0.0}

    def _check_mesh(self) -> None:
        """The reference's construction checks of ``mesh`` / ``partition``."""
        from .parallel.sharding import DATA_AXIS
        from .parallel.spatial import SPACE_AXIS

        mesh, net = self.mesh, self.net
        if net.params is None:
            raise RuntimeError(
                "Detector(mesh=...) needs loaded weights — call "
                "net.load_weights()/set_params() before constructing")
        if self.partition == "spatial":
            if tuple(mesh.axis_names) != (SPACE_AXIS,):
                raise ValueError(
                    "partition='spatial' needs a make_spatial_mesh() "
                    f"mesh (axis {SPACE_AXIS!r}), got {mesh.axis_names}")
            if net.quantized:
                raise ValueError(
                    "int8 + spatial partitioning is out of scope "
                    "(parallel/spatial.py: the float tiers only; int8 is a "
                    "throughput tier, spatial partitioning the latency mode)")
        elif tuple(mesh.axis_names) != (DATA_AXIS,):
            raise ValueError(
                "partition='data' needs a make_mesh() mesh (axis "
                f"{DATA_AXIS!r}), got {mesh.axis_names}")
        kinds = {d.type for d in mesh.devices}
        if kinds != {self.device.type}:
            raise ValueError(f"the mesh's devices {mesh.devices} are not all "
                             f"of the net's device type ({self.device})")

    def _gates(self, warn: bool) -> str:
        """The route for the net's current quantization state, by the JAX
        package's gates; with ``warn`` their warnings and the block
        fallback's, as the reference gives them per program."""
        net = self.net
        q_ok = not net.quantized or net.qcarrier == "int8"
        route = decode_route(net.graph, self.decode_impl, q_ok, warn=warn,
                             spatial=self.partition == "spatial")
        if (warn and net.quantized and self.block_impl == "pallas"
                and net.act_zeros and any(net.act_zeros.values())):
            log.warning("fused residual blocks implement the symmetric "
                        "quantization contract only; asymmetric "
                        "activations fall back to block_impl='xla'")
        return route

    def _resolve_route(self) -> str:
        """``self.route`` for the net's current quantization state."""
        self.route = self._gates(warn=False)
        return self.route

    def _body(self, bgr: bool, route: str):
        """The device work of one call by ``route`` on the net's current
        weights and quantization state (``detect_step``): (B, H, W, 3)
        uint8 frames on the device → NMSResult, boxes in net-input pixels.
        The closure holds no reference to the Detector, so a dropped
        Detector frees its programs at once, not at a later collection."""
        net = self.net
        if net.params is None:
            raise RuntimeError("call net.load_weights()/set_params() first")
        nms = dict(iou_thresh=self.iou_thresh, top_k=self.top_k,
                   impl=self.nms_impl, max_results=self.max_results,
                   select_group=self.select_group)
        if net.quantized:
            return detect_step(
                net.graph, net.qparams, self.net_hw, self.resize_mode, bgr,
                route, self._interp, self.prob_thresh, nms, net.precision,
                act_scales=net.act_scales, act_zeros=net.act_zeros,
                carrier=net.qcarrier, block_impl=self.block_impl,
                operands=net.qoperands)
        return detect_step(net.graph, net.params, self.net_hw,
                           self.resize_mode, bgr, route, self._interp,
                           self.prob_thresh, nms, net.precision, net.conv_impl)

    def _replicas(self) -> Tuple:
        """(params, qparams, operands), one per shard of a data mesh, of the
        net's current state: copied once per distinct device
        (``parallel.shard_params``), the net's own tensors and
        ``Darknet.qoperands`` where a shard sits on the net's device. Kept
        while the net's state stays the same."""
        from .parallel.sharding import shard_params

        net = self.net
        held = self._replica_state
        if not held or held[0] is not net.params or held[1] is not net.qparams:
            params = shard_params(net.params, self.mesh)
            qparams = operands = None
            if net.quantized:
                from .quant import Operands

                qparams = shard_params(net.qparams, self.mesh)
                made = {id(net.qparams): net.qoperands}
                for q in qparams:
                    if id(q) not in made:
                        made[id(q)] = Operands(q)
                operands = [made[id(q)] for q in qparams]
            self._replica_state = (net.params, net.qparams, params, qparams,
                                   operands)
        return self._replica_state[2:]

    def _sharded(self, bgr: bool):
        """The batch-DP step over the data mesh
        (``parallel.sharded_pipeline``), with the Detector's knobs."""
        from .parallel.sharding import sharded_pipeline

        net = self.net
        quant = (dict(act_scales=net.act_scales, act_zeros=net.act_zeros,
                      carrier=net.qcarrier) if net.quantized else {})
        return sharded_pipeline(
            net.graph, self.mesh, self.net_hw, self.prob_thresh,
            self.iou_thresh, self.top_k, self.resize_mode, net.precision, bgr,
            conv_impl=net.conv_impl, nms_impl=self.nms_impl,
            decode_impl=self.decode_impl, max_results=self.max_results,
            scan=self.scan, select_group=self.select_group,
            block_impl=self.block_impl, **quant)

    def _replica_steps(self, bgr: bool) -> List:
        """One packed step per shard of the data mesh, each on its shard's
        device, weights and int8 operands (``_replicas``)."""
        run = self._sharded(bgr)
        params, qparams, operands = self._replicas()
        return [_packed(run.replica(p, d, operands and operands[r]))
                for r, (p, d) in enumerate(zip(qparams or params,
                                               self.mesh.devices))]

    def _spatial_body(self, bgr: bool, route: str):
        """The row-sharded step over the spatial mesh
        (``parallel.spatial_pipeline``) on the net's current weights: (B,
        H, W, 3) uint8 frames → NMSResult on the first shard's device."""
        from .parallel.sharding import shard_params
        from .parallel.spatial import spatial_pipeline

        net = self.net
        if net.quantized:  # quantized after construction
            raise ValueError("int8 + spatial partitioning is out of scope "
                             "(parallel/spatial.py)")
        if net.conv_impl != "xla":
            log.warning("spatial partitioning does not support "
                        "conv_impl=%r; convs run via F.conv2d", net.conv_impl)
        run = spatial_pipeline(
            net.graph, self.mesh, self.net_hw, self.prob_thresh,
            self.iou_thresh, self.top_k, self.resize_mode, net.precision, bgr,
            self.nms_impl, route, self.max_results,
            select_group=self.select_group)
        params = shard_params(net.params, self.mesh)
        return lambda frames: run(params, frames)

    @torch.inference_mode()
    def _run(self, frames: torch.Tensor, bgr: Optional[bool] = None):
        """Eager, uncached: (B, H, W, 3) uint8 frames on the device →
        packed results (B, R, 6) on the device, boxes in net-input pixels
        (on a data mesh one tensor a replica, ``_Shards``). ``bgr``
        overrides the Detector's channel order for this call (host canvases
        arrive RGB)."""
        bgr = self.bgr if bgr is None else bgr
        route = self._resolve_route()
        if self.mesh is None:
            return pack_results(self._body(bgr, route)(frames))
        if self.partition == "spatial":
            return pack_results(self._spatial_body(bgr, route)(frames))
        from .parallel.sharding import split_batch

        parts = split_batch(frames, self.mesh.size, self.scan)
        return _Shards([step(x.to(d)) for step, x, d in zip(
            self._replica_steps(bgr), parts, self.mesh.devices)], self.scan)

    def _pipeline(self, batch: int, src_hw: Tuple[int, int],
                  bgr: Optional[bool] = None):
        """The cached program for (batch, source shape, channel order) on
        the net's current quantization state and weights, built (on the
        card: captured) on a miss, with the route gates' warnings. On a mesh
        the key carries the mesh too."""
        bgr = self.bgr if bgr is None else bgr
        net = self.net
        if net.params is None:
            raise RuntimeError("call net.load_weights()/set_params() first")
        # a captured program reads the weights through the pointers it saw,
        # so the key carries the identity of the weights as well as that of
        # the quantization state; the entry keeps both alive (``keep``), so
        # neither id() can be reused while it exists
        qstate = id(net.qparams) if net.quantized else None
        key = (batch, tuple(src_hw), bgr, qstate, id(net.params), self.mesh)
        prog = self._pipelines.get(key)
        if prog is not None:
            self._pipelines.move_to_end(key)
            self.cache_counts["hit"] += 1
        else:
            log.info("capturing pipeline: batch=%d src=%s net=%s mode=%s "
                     "precision=%s", batch, src_hw, self.net_hw,
                     self.resize_mode, net.precision or "default")
            self.route = self._gates(warn=True)
            with span("capture") as built:
                if self.mesh is None:
                    prog = self._finalize(key, self._body(bgr, self.route))
                elif self.partition == "spatial":
                    prog = self._finalize(key,
                                          self._spatial_body(bgr, self.route))
                else:
                    # the scan runs inside each replica (the reference's
                    # sharded program); _unpack merges the replicas
                    prog = self._cache_pipeline(key, self._replica_steps(bgr))
            self.cache_counts["miss"] += 1
            self.cache_counts["capture_s"] += built.seconds
        self.route = prog.route
        return prog

    def _finalize(self, key, run):
        """With ``scan > 1``, run the batch as ``scan`` sub-batches back to
        back in one program (the counterpart of the reference's
        ``lax.scan``), results concatenated in submission order into the
        unscanned (scan·B, ...) contract; then cache it."""
        return self._cache_pipeline(key, scanned(run, self.scan))

    def _cache_pipeline(self, key, run):
        """Add the pack (ONE device tensor for ONE device→host copy), build
        the program (on the card: capture it) and keep it in the LRU;
        evicting an entry frees its graph and its memory pool. On the card
        room is made twice (:meth:`_make_room`): before the warm-up for the
        largest program cached at the same batch, and before the capture for
        what the warm-up measured. On a data mesh (``run`` one packed step
        per replica) one program per replica, room made on each device."""
        net = self.net
        keep = (net.params, net.qparams, net.qoperands if net.quantized
                else None)
        if self.mesh is not None and self.partition == "data":
            prog = self._replica_programs(key, run, keep)
        elif self.device.type == "cuda":
            # one device, or a spatial mesh's: one graph over its cards
            first, *others = self._devices()
            for d in (first, *others):
                self._make_room(max(self._held(d, key[0]), default=0), d)
            prog = _CapturedProgram(key, self.route, _packed(run), keep,
                                    first, *others)
            self._make_room(prog.need, first)
            for d in others:
                self._make_room(prog.needs[d], d)
            prog.capture()
        else:
            prog = _Program(key, self.route, _packed(run), keep)
        self._pipelines[key] = prog
        while len(self._pipelines) > self._pipeline_capacity:
            self._evict_oldest()
        return prog

    def _evict_oldest(self) -> None:
        """Close the least recently used program (an ``evict`` span, and
        counted)."""
        with span("evict"):
            self._pipelines.popitem(last=False)[1].close()
        self.cache_counts["evict"] += 1

    def _devices(self) -> Tuple[torch.device, ...]:
        """The distinct devices the programs run on."""
        if self.mesh is None:
            return (self.device,)
        return tuple(dict.fromkeys(self.mesh.devices))

    def _replica_programs(self, key, steps, keep) -> _MeshProgram:
        """One program per shard of the data mesh, each on its device: on
        the card all warmed up, room made on each device for their need,
        then all captured."""
        mesh = self.mesh
        rkey = (key[0] // mesh.size, *key[1:])
        keep = (*keep, *self._replicas())
        if self.device.type != "cuda":
            reps = [_Program(rkey, self.route, s, keep) for s in steps]
        else:
            for d in self._devices():
                self._make_room(max(self._held(d, key[0]), default=0), d)
            reps = [_CapturedProgram(rkey, self.route, s, keep, d)
                    for s, d in zip(steps, mesh.devices)]
            for d in self._devices():
                self._make_room(sum(r.need for r, rd in
                                    zip(reps, mesh.devices) if rd == d), d)
            for r in reps:
                r.capture()
        return _MeshProgram(key, self.route, reps, mesh.devices, self.scan)

    def _make_room(self, need: int, device: Optional[torch.device] = None
                   ) -> None:
        """Evict least recently used programs until ``need`` more bytes fit
        the budget and the free memory of ``device`` (the net's by
        default; on a mesh, every device counts its own programs' bytes)
        (:func:`programs_to_evict`)."""
        device = self.device if device is None else device
        torch.cuda.empty_cache()
        n = programs_to_evict(self._held(device), need, self._pipeline_budget,
                              torch.cuda.mem_get_info(device)[0])
        for _ in range(n):
            self._evict_oldest()
        if n:
            torch.cuda.empty_cache()

    def _held(self, device: torch.device, batch: Optional[int] = None
              ) -> List[int]:
        """The bytes each cached program (of ``batch`` only, when given)
        holds on ``device``, least recently used first."""
        return [p.bytes_on(device) if self.mesh else p.nbytes
                for p in self._pipelines.values()
                if batch is None or p.key[0] == batch]

    def _stage(self, frames: np.ndarray) -> torch.Tensor:
        self._check_frames(frames)
        return torch.from_numpy(frames).to(self.device)

    @staticmethod
    def _check_frames(frames: np.ndarray) -> None:
        if frames.dtype != np.uint8:
            # the on-device preprocess divides by 255: a float frame would be
            # a different image, not an error, without this check
            raise TypeError(f"frames must be uint8 (got {frames.dtype}); "
                            f"pass raw cv2/camera frames, not normalized "
                            f"floats")
        if frames.ndim != 4 or frames.shape[3] != 3:
            raise ValueError(f"frames must be (B, H, W, 3), got {frames.shape}")

    def _pad_batch(self, frames: np.ndarray) -> Tuple[np.ndarray, int]:
        """(checked frames, real batch): padded with zero frames to a
        multiple of ``scan``, on a data mesh of ``scan × mesh.size`` (callers
        drop the pad results)."""
        self._check_frames(frames)
        n_real = frames.shape[0]
        unit = self.scan * (self.mesh.size if self.mesh is not None
                            and self.partition == "data" else 1)
        if n_real % unit:
            pad = unit - n_real % unit
            frames = np.concatenate(
                [frames, np.zeros((pad, *frames.shape[1:]), frames.dtype)])
        return frames, n_real

    def _detect(self, frames: np.ndarray, src_hw: Tuple[int, int],
                bgr: Optional[bool], call: Optional[int] = None
                ) -> Tuple[torch.Tensor, int, Dict[str, float]]:
        """One synchronous call through the cached program: (packed results
        in host memory, real batch, seconds by stage), each stage a span of
        ``call`` (a new call by default): ``pad``, ``lookup``, ``stage``,
        ``launch``, ``fetch``."""
        call = new_call() if call is None else call
        st: Dict[str, float] = {}
        with span("pad", st, call):
            frames, n_real = self._pad_batch(frames)
        with self._lock:
            with span("lookup", st, call):
                prog = self._pipeline(frames.shape[0], src_hw, bgr)
            with span("stage", st, call):
                staged = prog.stage(frames, self.device)
            with span("launch", st, call):
                res = prog(staged)
            with span("fetch", st, call):
                res = res.cpu()  # ONE device→host copy; the output is free again
                prog.release()
        return res, n_real, st

    @staticmethod
    def _stages(st: Dict[str, float]) -> Dict[str, float]:
        """``last_stage_s`` from a call's seconds by stage."""
        return {"h2d_s": st["stage"], "dispatch_s": st["lookup"] + st["launch"],
                "device_fetch_s": st["fetch"] + st["unpack"]}

    def _enqueue(self, frames: np.ndarray, bgr: Optional[bool] = None,
                 call: Optional[int] = None) -> Tuple[torch.Tensor, int]:
        """Stage a same-shape uint8 batch and queue its program; returns
        (packed results on the device, real batch). On the card this returns
        before the device has finished (``_unpack`` waits), and the results
        are a copy, queued after the replay, so the next call's replay
        cannot overwrite them. Spans of ``call`` (a new call by default):
        ``pad``, ``lookup``, ``stage``, ``launch``."""
        call = new_call() if call is None else call
        with span("pad", call=call):
            frames, n_real = self._pad_batch(np.ascontiguousarray(frames))
        with self._lock:
            with span("lookup", call=call):
                prog = self._pipeline(frames.shape[0],
                                      tuple(frames.shape[1:3]), bgr)
            with span("stage", call=call):
                staged = prog.stage(frames, self.device)
            with span("launch", call=call):
                res = prog.hold(prog(staged))
                prog.release()
        return res, n_real

    def _unpack(self, res, src_hw: Optional[Tuple[int, int]]
                ) -> List[Detection]:
        """ONE device→host copy of the packed results (a device tensor, a
        host tensor already copied, or a data mesh's replicas, merged in
        submission order), then per-image survivors rescaled to source
        pixels (``src_hw=None`` keeps net-input pixels)."""
        arr = res.cpu().numpy()
        boxes = arr[..., :4]
        scores = arr[..., 4]
        classes = arr[..., 5].astype(np.int32)
        valid = scores > 0.0
        unmap = unletterbox_tlbr if self.resize_mode == "letterbox" else unstretch_tlbr
        out: List[Detection] = []
        for i in range(valid.shape[0]):
            m = valid[i]
            out.append(Detection(
                bbox_tlbr=(boxes[i][m] if src_hw is None
                           else unmap(boxes[i][m], src_hw, self.net_hw)),
                class_prob=scores[i][m],
                class_idx=classes[i][m],
            ))
        return out

    def _build_canvases(self, frames: Sequence[np.ndarray]) -> np.ndarray:
        """Host-letterbox arbitrary-size frames into one (B, net_h, net_w, 3)
        RGB uint8 batch via the C++ loader."""
        from . import native

        if self.resize_mode != "letterbox":
            return np.concatenate(
                [native.stretch_batch_native(f[None], self.net_hw,
                                             swap_rb=self.bgr)
                 for f in frames])
        return native.letterbox_mixed_native(frames, self.net_hw,
                                             swap_rb=self.bgr)

    def _unmap_one(self, det: Detection, src_hw: Tuple[int, int]) -> Detection:
        """Rescale a net-coordinate Detection to one source image's pixels."""
        unmap = unletterbox_tlbr if self.resize_mode == "letterbox" else unstretch_tlbr
        return Detection(bbox_tlbr=unmap(det.bbox_tlbr, src_hw, self.net_hw),
                         class_prob=det.class_prob, class_idx=det.class_idx)

    def detect_batch(self, frames: np.ndarray) -> List[Detection]:
        """Detect in a batch of same-shape HWC uint8 frames (BGR by default,
        matching cv2 / the reference's input convention)."""
        frames = np.ascontiguousarray(frames)
        if frames.ndim == 3:
            frames = frames[None]
        if frames.shape[0] == 0:
            return []
        src_hw = tuple(frames.shape[1:3])
        call = new_call()
        res, n_real, st = self._detect(frames, src_hw, None, call)
        with span("unpack", st, call):
            out = self._unpack(res, src_hw)[:n_real]
        self.last_stage_s = self._stages(st)
        return out

    def detect_mixed(self, frames: Sequence[np.ndarray]) -> List[Detection]:
        """Detect in a list of arbitrarily-sized HWC uint8 frames.

        The C++ host loader (``yolov3_tpu_torch.native``) letterboxes every
        image into ONE fixed-shape uint8 batch, so a heterogeneous set runs
        as one device batch. Without the loader, frames are grouped by shape
        and each group runs through ``detect_batch``.
        """
        from . import native

        if len(frames) == 0:
            return []
        for f in frames:
            if np.asarray(f).dtype != np.uint8:
                raise TypeError(f"frames must be uint8 (got "
                                f"{np.asarray(f).dtype}); pass raw "
                                f"cv2/camera frames, not normalized floats")

        if not native.available():
            # group same-shape frames into real batches (order preserved);
            # each group pads to the next power of two, the JAX package's
            # policy (it bounds the number of cached programs), so both
            # packages run the same batches
            out: List[Optional[Detection]] = [None] * len(frames)
            groups: Dict[Tuple[int, ...], List[int]] = {}
            for i, f in enumerate(frames):
                groups.setdefault(tuple(f.shape), []).append(i)
            for idxs in groups.values():
                batch = np.stack([frames[i] for i in idxs])
                padded = 1 << (len(idxs) - 1).bit_length()
                if padded > len(idxs):
                    pad = np.zeros((padded - len(idxs), *batch.shape[1:]),
                                   batch.dtype)
                    batch = np.concatenate([batch, pad])
                dets = self.detect_batch(batch)
                for i, d in zip(idxs, dets):
                    out[i] = d
            return out
        call = new_call()
        with span("letterbox", call=call) as letterbox:
            canvases = self._build_canvases(frames)
        src_hws = [f.shape[:2] for f in frames]
        out = self._preletterboxed(canvases, src_hws, call)
        self.last_stage_s = {"preprocess_s": letterbox.seconds,
                             **self.last_stage_s}
        return out

    def detect_preletterboxed(self, canvases: np.ndarray,
                              src_hws: Sequence[Tuple[int, int]]
                              ) -> List[Detection]:
        """Run the device pipeline on host-preprocessed RGB uint8 canvases
        already at net resolution; rescale each result to its own source."""
        return self._preletterboxed(canvases, src_hws, new_call())

    def _preletterboxed(self, canvases: np.ndarray,
                        src_hws: Sequence[Tuple[int, int]], call: int
                        ) -> List[Detection]:
        """``detect_preletterboxed`` as a part of ``call``."""
        canvases = np.ascontiguousarray(canvases)
        res, n_real, st = self._detect(canvases, self.net_hw, False, call)
        with span("unpack", st, call):
            dets = self._unpack(res, None)[:n_real]  # net coords
            out = [self._unmap_one(d, hw) for d, hw in zip(dets, src_hws)]
        self.last_stage_s = self._stages(st)
        return out

    def warmup(self, batch: int, src_hw: Tuple[int, int],
               host_preprocessed: bool = False) -> "Detector":
        """Run one (batch, source-shape) call before traffic arrives: builds
        the kernels on first use and the program of that key (on the card:
        its CUDA graph, captured), so the first request pays neither.
        ``host_preprocessed`` warms the program of ``detect_preletterboxed``
        (canvases at net resolution) instead of ``detect_batch``'s."""
        shape_hw = self.net_hw if host_preprocessed else src_hw
        frames = np.zeros((batch, *shape_hw, 3), dtype=np.uint8)
        if host_preprocessed:
            self.detect_preletterboxed(frames, [src_hw] * batch)
        else:
            self.detect_batch(frames)
        return self

    def __call__(self, frames) -> List[Detection]:
        return self.detect_batch(np.asarray(frames))


class PipelinedDetector:
    """Serving wrapper that keeps up to ``depth`` batches in flight on the
    device, materializing results in submission order.

    On the card ``submit()`` queues, on a CUDA stream of its own, the
    host→device copy (from pinned memory) into the program's static input,
    the program's replay and the copy of its packed output into pinned host
    memory (which frees the output for the next replay), and returns;
    results are waited for only when more than ``depth`` batches are in
    flight (or on ``flush()``), so host work (decode, drawing, I/O) overlaps
    device compute. On the CPU, and for a Detector on a mesh, it keeps the
    same ordering with no stream of its own: each batch is queued at
    ``submit()`` (``Detector._enqueue``: on the card the replays of every
    replica and the copies of their results, not waited for) and handed
    back ``depth`` submissions later. A batch's spans
    (``utils.profiling.span``) share one call id: at ``submit()`` ``pad``,
    ``pin`` (the card's stream only), ``lookup``, ``stage``, ``launch``,
    ``d2h`` (the card's stream only: the pinned result buffer and the copy
    into it queued), then, where it is handed back, ``wait`` and ``unpack``.
    """

    def __init__(self, detector: Detector, depth: int = 2):
        self.detector = detector
        self.depth = max(1, int(depth))
        self._stream = (torch.cuda.Stream(detector.device)
                        if detector.device.type == "cuda"
                        and detector.mesh is None else None)
        self._inflight: List[Tuple] = []

    def submit(self, frames: np.ndarray) -> List[List[Detection]]:
        """Enqueue one same-shape uint8 batch; returns any batches that
        completed to keep the in-flight depth bounded (oldest first)."""
        frames = np.ascontiguousarray(frames)
        if frames.ndim == 3:
            frames = frames[None]
        if frames.shape[0] == 0:
            return []
        det = self.detector
        src_hw = tuple(frames.shape[1:3])
        call = new_call()  # the batch's spans at submit and at materialize
        if self._stream is None:
            res, n_real = det._enqueue(frames, call=call)
            self._inflight.append((src_hw, n_real, res, None, None, call))
        else:
            with span("pad", call=call):
                frames, n_real = det._pad_batch(frames)
            with span("pin", call=call):
                staged = torch.from_numpy(frames).pin_memory()
            with det._lock:
                with span("lookup", call=call):
                    prog = det._pipeline(staged.shape[0], src_hw)
                self._stream.wait_stream(torch.cuda.current_stream(det.device))
                with torch.cuda.stream(self._stream):
                    with span("stage", call=call):
                        staged_dev = prog.stage_pinned(staged)
                    with span("launch", call=call):
                        res = prog(staged_dev)
                    with span("d2h", call=call):
                        host = torch.empty(res.shape, dtype=res.dtype,
                                           pin_memory=True)
                        host.copy_(res, non_blocking=True)
                        prog.release()
                        done = torch.cuda.Event()
                        done.record(self._stream)
            # `staged` stays referenced until its copy has run
            self._inflight.append((src_hw, n_real, host, done, staged, call))
        out: List[List[Detection]] = []
        while len(self._inflight) > self.depth:
            out.append(self._materialize(self._inflight.pop(0)))
        return out

    def _materialize(self, item) -> List[Detection]:
        src_hw, n_real, res, done, _, call = item
        with span("wait", call=call):
            if done is not None:
                done.synchronize()
            res = res.cpu()  # a mesh's replicas: each waited for, fetched
        with span("unpack", call=call):
            return self.detector._unpack(res, src_hw)[:n_real]

    def flush(self) -> List[List[Detection]]:
        """Materialize everything still in flight (submission order)."""
        out = [self._materialize(item) for item in self._inflight]
        self._inflight.clear()
        return out


# process-level Detector cache for the one-shot API: calling inference() in
# a loop (the reference's own usage pattern) reuses one Detector and its
# interpolation matrices. Entries hold a strong reference to their net, so
# id() keys cannot be recycled while cached. LRU-bounded: each entry pins a
# full param set, so a threshold sweep through this API must evict, not grow
# without bound.
_ONESHOT_DETECTORS: "OrderedDict[Tuple, Detector]" = OrderedDict()
_ONESHOT_CAPACITY = 8


def inference(net: Darknet, images, prob_thresh: float = 0.05,
              nms_iou_thresh: float = 0.3, resize_mode: str = "letterbox"
              ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Reference-compatible one-shot API (``yolov3/inference.py::inference``):
    BGR frame(s) in → per-image ``(bbox_tlbr, class_prob, class_idx)`` tuples
    in source-image pixels. Detectors are reused per (net, thresholds, mode);
    for batching, pipelining and repeated calls use a :class:`Detector`
    directly."""
    key = (id(net), float(prob_thresh), float(nms_iou_thresh), resize_mode)
    det = _ONESHOT_DETECTORS.get(key)
    if det is None or det.net is not net:
        det = Detector(net, prob_thresh=prob_thresh,
                       iou_thresh=nms_iou_thresh, resize_mode=resize_mode)
        _ONESHOT_DETECTORS[key] = det
        while len(_ONESHOT_DETECTORS) > _ONESHOT_CAPACITY:
            _ONESHOT_DETECTORS.popitem(last=False)
    else:
        _ONESHOT_DETECTORS.move_to_end(key)
    results = det.detect_batch(np.asarray(images))
    return [(r.bbox_tlbr, r.class_prob, r.class_idx) for r in results]


# ---------------------------------------------------------------------------
# Entry points (the reference's detect_image / detect_directory /
# detect_in_video / detect_in_cam)
# ---------------------------------------------------------------------------

WINDOW_NAME = "yolov3"


def detect_image(detector: Detector, image_path, class_names=None,
                 output_path=None, show: bool = True, verbose: bool = False):
    """Single-image detect (the CLI's ``--image`` path)."""
    import cv2

    frame = cv2.imread(str(image_path))
    if frame is None:
        raise FileNotFoundError(f"could not read image {image_path}")
    t0 = time.perf_counter()
    (result,) = detector.detect_batch(frame)
    if verbose:
        print(f"{image_path}: {len(result.bbox_tlbr)} detections "
              f"in {(time.perf_counter() - t0) * 1e3:.1f} ms")
    from .utils.drawing import draw_boxes

    draw_boxes(frame, result, class_names=class_names)
    if output_path:
        cv2.imwrite(str(output_path), frame)
    if show:
        cv2.imshow(WINDOW_NAME, frame)
        cv2.waitKey(0)
    return result


def detect_directory(detector: Detector, dir_path, batch_size: int = 32,
                     class_names=None, output_dir=None, verbose: bool = False,
                     extensions=(".jpg", ".jpeg", ".png", ".bmp")):
    """Batched directory inference.

    With the C++ host loader, images of any shapes are letterboxed on the
    host into fixed-shape uint8 batches of ``batch_size`` (the final partial
    chunk zero-padded to the full batch and the pad results dropped), in
    streaming order, two batches in flight: the host decode and letterbox
    of chunk i+1 overlap the device work of chunk i. Without it, images are
    bucketed by source resolution and each bucket runs through
    ``detect_batch`` as it fills.
    """
    import cv2

    paths = sorted(p for p in Path(dir_path).iterdir()
                   if p.suffix.lower() in extensions)
    if not paths:
        return {}

    # threaded decode with a bounded window: cv2.imread releases the GIL so
    # reads overlap, but only ~4 batches of frames are resident at once (a
    # large directory of large images must not be decoded up front)
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(max_workers=8)
    window = max(4 * batch_size, 64)

    def decoded_iter():
        pending = []
        it = iter(paths)
        try:
            for p in it:
                pending.append((p, pool.submit(cv2.imread, str(p))))
                if len(pending) >= window:
                    q, fut = pending.pop(0)
                    yield q, fut.result()
            for q, fut in pending:
                yield q, fut.result()
        finally:
            pool.shutdown(wait=False)

    results: Dict[str, Detection] = {}
    t0 = time.perf_counter()
    n_images = 0

    from . import native as native_mod

    def emit(chunk, dets):
        nonlocal n_images
        for (p, frame), det in zip(chunk, dets):
            results[p.name] = det
            n_images += 1
            if output_dir:
                from .utils.drawing import draw_boxes

                draw_boxes(frame, det, class_names=class_names)
                cv2.imwrite(str(Path(output_dir) / p.name), frame)

    if native_mod.available():
        in_flight: List[Tuple[List, List, torch.Tensor]] = []

        def submit(chunk):
            frames = [f for _, f in chunk]
            canvases = detector._build_canvases(frames)
            if len(chunk) < batch_size:
                # zero-pad the final partial chunk to the full batch shape,
                # so every device step has one shape
                pad = np.zeros((batch_size - len(chunk), *canvases.shape[1:]),
                               canvases.dtype)
                canvases = np.concatenate([canvases, pad])
            res, _ = detector._enqueue(canvases, bgr=False)
            in_flight.append((chunk, [f.shape[:2] for f in frames], res))
            while len(in_flight) > 2:
                drain()

        def drain():
            chunk, src_hws, res = in_flight.pop(0)
            dets = detector._unpack(res, None)[:len(chunk)]  # net coords
            emit(chunk, [detector._unmap_one(d, hw)
                         for d, hw in zip(dets, src_hws)])

        chunk: List[Tuple[Path, np.ndarray]] = []
        for p, frame in decoded_iter():
            if frame is None:
                continue
            chunk.append((p, frame))
            if len(chunk) == batch_size:
                submit(chunk)
                chunk = []
        if chunk:
            submit(chunk)
        while in_flight:
            drain()
    else:
        # per-shape route: bucket incrementally by source shape, flush each
        # bucket as it fills (memory ≤ #shapes × batch_size frames)
        buckets: Dict[Tuple[int, int], List[Tuple[Path, np.ndarray]]] = {}
        for p, frame in decoded_iter():
            if frame is None:
                continue
            bucket = buckets.setdefault(frame.shape[:2], [])
            bucket.append((p, frame))
            if len(bucket) == batch_size:
                frames = np.stack([f for _, f in bucket])
                emit(bucket, detector.detect_batch(frames))
                buckets[frame.shape[:2]] = []
        for shape_hw, bucket in buckets.items():
            if not bucket:
                continue
            frames = np.stack([f for _, f in bucket])
            if len(bucket) < batch_size:
                # final partial bucket: pad to the full batch shape; emit()
                # zips against the real bucket so pad results drop
                pad = np.zeros((batch_size - len(bucket), *frames.shape[1:]),
                               frames.dtype)
                frames = np.concatenate([frames, pad])
            emit(bucket, detector.detect_batch(frames))
    if verbose:
        dt = time.perf_counter() - t0
        print(f"{n_images} images in {dt:.2f}s "
              f"({n_images / dt:.1f} img/s incl. host I/O)")
    return results


def detect_in_video(detector: Detector, filepath, class_names=None,
                    output_path=None, show: bool = False,
                    show_fps: bool = False, frame_batch: int = 1,
                    pipeline_depth: int = 1, verbose: bool = False):
    """Video-file streaming pipeline: every frame processed, optional
    annotated output video.

    A capture thread decodes ahead into a bounded queue; the main thread
    assembles ``frame_batch`` frames, queues the device step (PyTorch
    returns before the card has finished), and materializes batch i's
    results only once ``pipeline_depth`` newer batches are queued, so device
    compute overlaps host decode / draw / encode. cv2 releases the GIL
    inside native calls, so the threads genuinely overlap. Deeper pipelines
    hide more of the host's work at the cost of ``depth × frame_batch``
    frames of extra output lag; 0 = fully synchronous.
    """
    import queue as queue_mod
    import threading

    import cv2

    from .utils.drawing import draw_boxes
    from .utils.profiling import FPSCounter, StageTimers

    cap = cv2.VideoCapture(str(filepath))
    if not cap.isOpened():
        raise FileNotFoundError(f"could not open video {filepath}")
    fps_in = cap.get(cv2.CAP_PROP_FPS) or 30.0
    timers = StageTimers()

    frame_q: "queue_mod.Queue" = queue_mod.Queue(maxsize=max(4 * frame_batch, 8))
    stop = threading.Event()

    def _reader():
        # the reader OWNS the capture: cv2.VideoCapture is not thread-safe,
        # so release() must not race a concurrent read() from another thread
        try:
            while not stop.is_set():
                ok, frame = cap.read()
                if not ok:
                    break
                while not stop.is_set():
                    try:
                        frame_q.put(frame, timeout=0.1)
                        break
                    except queue_mod.Full:
                        continue
        finally:
            cap.release()
            try:
                frame_q.put_nowait(None)  # EOF sentinel (best effort)
            except queue_mod.Full:
                pass

    reader = threading.Thread(target=_reader, daemon=True)
    reader.start()

    def _next_frame():
        """Queue get that can't deadlock if the reader died with a full
        queue (sentinel drop): poll with the reader's liveness as backstop."""
        while True:
            try:
                return frame_q.get(timeout=0.25)
            except queue_mod.Empty:
                if not reader.is_alive():
                    return None

    writer = None
    fps = FPSCounter()
    shower = None
    if show:
        from .utils.video import VideoShower

        shower = VideoShower().start()

    def _drain(frames, res):
        nonlocal writer, n
        dets = detector._unpack(res, (frames[0].shape[0], frames[0].shape[1]))
        for frame, det in zip(frames, dets):
            draw_boxes(frame, det, class_names=class_names)
            fps.tick()
            if show_fps:
                fps.overlay(frame)
            if writer is None and output_path:
                writer = cv2.VideoWriter(
                    str(output_path), cv2.VideoWriter_fourcc(*"mp4v"),
                    fps_in, (frame.shape[1], frame.shape[0]))
            if writer is not None:
                writer.write(frame)
            if shower is not None:
                shower.frame = frame
            n += 1

    n = 0
    depth = max(0, int(pipeline_depth))
    in_flight: List[Tuple[List[np.ndarray], torch.Tensor]] = []  # oldest first
    try:
        eof = False
        while not eof:
            frames: List[np.ndarray] = []
            while len(frames) < frame_batch:
                item = _next_frame()
                if item is None:
                    eof = True
                    break
                frames.append(item)
            if frames:
                with timers.stage("dispatch"):
                    res, _ = detector._enqueue(np.stack(frames))  # queued
                in_flight.append((frames, res))
                while len(in_flight) > depth:
                    with timers.stage("drain+draw+encode"):
                        _drain(*in_flight.pop(0))  # i while i+depth computes
        while in_flight:
            _drain(*in_flight.pop(0))
    finally:
        stop.set()  # reader releases the capture itself (it owns it)
        if writer is not None:
            writer.release()
        if shower is not None:
            shower.stop()
    if verbose:
        print(f"processed {n} frames at {fps.fps():.1f} FPS")
        if timers.totals:
            print(f"per-batch stages: {timers.report()}")
    return n


def detect_in_cam(detector: Detector, cam_id=0, class_names=None,
                  show_fps: bool = False, output_path=None,
                  show: bool = True, max_frames: Optional[int] = None,
                  pipeline_depth: int = 0,
                  output_fps: Optional[float] = None):
    """Real-time webcam loop: getter thread (latest-frame-wins, deliberately
    dropping frames) → device pipeline → shower thread. ``cam_id`` may be a
    device index or any cv2-openable source (file/URL); ``show=False`` runs
    headless; ``max_frames`` bounds the loop (tests, bounded captures).

    ``pipeline_depth > 0`` routes frames through a :class:`PipelinedDetector`
    keeping that many frames in flight on the device: each displayed frame
    lags the camera by ``depth`` frames, but device work overlaps host
    draw/show. 0 = the synchronous loop."""
    import cv2

    from .utils.drawing import draw_boxes
    from .utils.profiling import FPSCounter
    from .utils.video import VideoGetter, VideoShower

    getter = VideoGetter(cam_id).start()
    shower = VideoShower(window_name=WINDOW_NAME).start() if show else None
    fps = FPSCounter()
    writer = None
    warmup: List[np.ndarray] = []  # frames held until the writer opens
    n_done = 0
    pipe = (PipelinedDetector(detector, depth=pipeline_depth)
            if pipeline_depth > 0 else None)
    pending: List[np.ndarray] = []  # source frames awaiting pipelined results

    def emit(frame, det):
        nonlocal n_done, writer
        draw_boxes(frame, det, class_names=class_names)
        fps.tick()
        if show_fps:
            fps.overlay(frame)
        if output_path:
            # write incrementally (buffering every frame until exit grows
            # memory without bound on long captures). ``output_fps=None``:
            # buffer only a short warmup, then open the writer at the
            # MEASURED loop rate (latest-frame-wins makes the true rate
            # unknowable upfront) and flush the buffer.
            if writer is None:
                warmup.append(frame)
                if (output_fps is not None or len(warmup) >= 10
                        or (max_frames is not None
                            and n_done + 1 >= max_frames)):
                    rate = (float(output_fps) if output_fps is not None
                            else fps.fps())
                    h, w = frame.shape[:2]
                    writer = cv2.VideoWriter(
                        str(output_path), cv2.VideoWriter_fourcc(*"mp4v"),
                        max(rate, 1.0), (w, h))
                    for f in warmup:
                        writer.write(f)
                    warmup.clear()
            else:
                writer.write(frame)
        if shower is not None:
            shower.frame = frame
        n_done += 1

    try:
        while (not getter.stopped
               and (shower is None or not shower.stopped)
               and (max_frames is None or n_done < max_frames)):
            frame = getter.frame
            if frame is None:
                time.sleep(0.005)
                continue
            frame = frame.copy()
            if pipe is None:
                (det,) = detector.detect_batch(frame)
                emit(frame, det)
            else:
                done = pipe.submit(frame)
                pending.append(frame)
                for dets in done:
                    emit(pending.pop(0), dets[0])
        if pipe is not None:
            for dets in pipe.flush():
                if max_frames is not None and n_done >= max_frames:
                    break
                emit(pending.pop(0), dets[0])
    except KeyboardInterrupt:
        pass
    finally:
        getter.stop()
        if shower is not None:
            shower.stop()
        if writer is None and warmup and output_path:
            # loop ended before the warmup threshold: flush at measured rate
            h, w = warmup[0].shape[:2]
            writer = cv2.VideoWriter(str(output_path),
                                     cv2.VideoWriter_fourcc(*"mp4v"),
                                     max(fps.fps(), 1.0), (w, h))
            for f in warmup:
                writer.write(f)
        if writer is not None:
            writer.release()
    return n_done
