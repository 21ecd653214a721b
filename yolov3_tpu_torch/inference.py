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
kernel that cannot build or launch raises. The multi-device routes wait for
``parallel/`` (ROADMAP.md): ``Detector(mesh=...)`` raises.

``detect_mixed`` takes frames of any sizes: the C++ host loader
(``native.py``) letterboxes them into one RGB uint8 batch at net resolution
and ``detect_preletterboxed`` runs steps 1-5 on it (the device preprocess is
then the normalization alone); without the loader, same-shape groups go
through ``detect_batch``. ``scan=k`` splits a batch into ``k`` sub-batches
that are enqueued back to back with no host synchronisation between them
and leave the device in ONE copy. ``PipelinedDetector`` keeps several
batches in flight on a CUDA stream of its own.

PyTorch runs eagerly, so there is nothing to compile per (batch, shape); the
Detector caches only the interpolation matrices. ``cv2`` is imported inside
the entry points that need it, never with the package.
"""
from __future__ import annotations

import logging
import time
from collections import OrderedDict
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
from .ops.nms import batched_nms_compact, batched_nms_packed, pack_results
from .ops.preprocess import Interp, interp_matrices, preprocess, resize_target
from .utils.boxes import unletterbox_tlbr, unstretch_tlbr

log = logging.getLogger("yolov3_tpu_torch")

RESIZE_MODES = ("letterbox", "stretch")
DECODE_IMPLS = ("pallas", "pallas-fused", "xla")
BLOCK_IMPLS = ("xla", "pallas")
PARTITIONS = ("data", "spatial")


def decode_route(graph, decode_impl: str, q_ok: bool = True) -> str:
    """The route a Detector runs for ``decode_impl`` on ``graph``, by the
    JAX package's gates (``yolov3_tpu/inference.py``), with its warnings.
    ``q_ok`` is False for a net quantized with the bf16 carrier, whose walk
    has no head-fused form."""
    if decode_impl not in DECODE_IMPLS:
        raise ValueError(f"decode_impl must be one of {DECODE_IMPLS}, got "
                         f"{decode_impl!r}")
    if decode_impl == "pallas-fused" and not (
            q_ok and fused_heads_eligible(graph)):
        log.warning("head-fused decode not applicable here (%s); "
                    "falling back to decode_impl='pallas'",
                    "bf16-carrier int8" if not q_ok else "graph shape")
        decode_impl = "pallas"
    if (decode_impl in ("pallas", "pallas-fused")
            and not packed_decode_supported([n.anchors for n in graph.yolo_nodes])):
        log.warning("pallas decode supports <=4 anchors/head; "
                    "falling back to decode_impl='xla'")
        decode_impl = "xla"
    return decode_impl


@dataclass
class Detection:
    """Per-image detection result in original-image pixel coordinates."""

    bbox_tlbr: np.ndarray  # (n, 4) float32
    class_prob: np.ndarray  # (n,) float32  (objectness × class prob)
    class_idx: np.ndarray  # (n,) int32


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
    sub-batches enqueued back to back whose results leave the device in one
    copy (a throughput knob: the batch is padded to a multiple of ``k``).
    The results come back in submission order and equal, bit for bit, those
    of the same sub-batches run one call each. They equal ``scan=1``'s on
    the whole batch only where a conv's result for an image does not depend
    on the batch it is in: true on the CPU, not on the card, where the
    library picks its conv algorithm by batch size (PERF.md, Findings).
    ``mesh`` / ``partition="spatial"`` (several devices) are not ported yet
    and raise."""

    def __init__(self, net: Darknet, prob_thresh: float = 0.05,
                 iou_thresh: float = 0.3, resize_mode: str = "letterbox",
                 top_k: Optional[int] = None, bgr: bool = True,
                 net_hw: Optional[Tuple[int, int]] = None, mesh=None,
                 nms_impl: str = "xla", decode_impl: str = "pallas",
                 max_results: int = 128, scan: int = 1,
                 partition: str = "data", select_group: int = 2,
                 block_impl: str = "xla",
                 device: Union[str, torch.device, None] = None):
        if partition not in PARTITIONS:
            raise ValueError(f"unknown partition {partition!r}")
        if mesh is not None or partition == "spatial":
            raise NotImplementedError(
                "Detector(mesh=..., partition=...): the multi-device routes "
                "(parallel/) are not ported yet, see ROADMAP.md; this "
                "Detector runs on one device and will not stand in for them")
        if nms_impl not in NMS_IMPLS:
            raise ValueError(f"unknown nms_impl {nms_impl!r} (expected 'xla' "
                             "or 'pallas')")
        self.nms_impl = nms_impl
        self.scan = int(scan)
        if self.scan < 1:
            raise ValueError(f"scan must be >= 1, got {scan}")
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
        # the gates depend on the quantization state, which may change
        # after construction: resolved (and warned about) once per state
        self._route_state: object = self
        self._resolve_route()
        self._interp: Dict[Tuple[int, int], Interp] = {}
        # per-call stage split (seconds) of the last synchronous detect
        # call, written as ONE dict assignment (serve.py publishes it under
        # /stats and /metrics): preprocess_s (host letterbox, detect_mixed
        # only), h2d_s (host→device copy of the frames), dispatch_s (the
        # device work queued, NOT finished), device_fetch_s (wait for the
        # device + the one D2H copy). Read it from the thread that ran the
        # call.
        self.last_stage_s: Optional[Dict[str, float]] = None

    def _resolve_route(self) -> str:
        """``self.route`` for the net's current quantization state."""
        net = self.net
        state = net.qparams
        if state is not self._route_state:
            self._route_state = state
            q_ok = not net.quantized or net.qcarrier == "int8"
            self.route = decode_route(net.graph, self.decode_impl, q_ok)
            if (net.quantized and self.block_impl == "pallas"
                    and net.act_zeros and any(net.act_zeros.values())):
                log.warning("fused residual blocks implement the symmetric "
                            "quantization contract only; asymmetric "
                            "activations fall back to block_impl='xla'")
        return self.route

    def _interp_for(self, src_hw: Tuple[int, int]) -> Interp:
        """Interpolation matrices for one source shape, built once."""
        if src_hw not in self._interp:
            out_hw = resize_target(src_hw, self.net_hw, self.resize_mode)
            self._interp[src_hw] = interp_matrices(src_hw, out_hw, self.device)
        return self._interp[src_hw]

    @torch.inference_mode()
    def _run(self, frames: torch.Tensor, bgr: Optional[bool] = None
             ) -> torch.Tensor:
        """(B, H, W, 3) uint8 frames on the device → packed results
        (B, R, 6) on the device, boxes in net-input pixels. ``bgr``
        overrides the Detector's channel order for this call (host
        canvases arrive RGB)."""
        if self.net.params is None:
            raise RuntimeError("call net.load_weights()/set_params() first")
        if self.bgr if bgr is None else bgr:
            frames = frames.flip(-1)  # BGR→RGB on device
        src_hw = tuple(frames.shape[1:3])
        x = preprocess(frames, self.net_hw, mode=self.resize_mode,
                       interp=self._interp_for(src_hw))
        net = self.net
        decode = self._resolve_route()
        if net.quantized:
            return pack_results(self._run_quantized(x, decode))
        route = dict(precision=net.precision, conv_impl=net.conv_impl)
        if decode == "xla":
            boxes, scores, classes = forward_compact(net.graph, net.params, x,
                                                     **route)
            res = batched_nms_compact(boxes, scores, classes,
                                      prob_thresh=self.prob_thresh,
                                      iou_thresh=self.iou_thresh,
                                      top_k=self.top_k, impl=self.nms_impl,
                                      max_results=self.max_results,
                                      select_group=self.select_group)
        else:
            fwd = (forward_packed_fused if decode == "pallas-fused"
                   else forward_packed)
            payload, scores = fwd(net.graph, net.params, x,
                                  prob_thresh=self.prob_thresh, **route)
            res = batched_nms_packed(payload, scores,
                                     iou_thresh=self.iou_thresh,
                                     top_k=self.top_k, impl=self.nms_impl,
                                     max_results=self.max_results,
                                     select_group=self.select_group)
        return pack_results(res)

    def _run_quantized(self, x: torch.Tensor, decode: str):
        """The int8 tier: the quantized walk of the net's carrier, then the
        decode and NMS of the route."""
        from .quant import (forward_compact_int8, forward_packed_fused_int8,
                            forward_packed_int8)

        net = self.net
        kw = dict(precision=net.precision or "bf16", carrier=net.qcarrier,
                  block_impl=self.block_impl, zeros=net.act_zeros,
                  operands=net.qoperands)
        nms = dict(iou_thresh=self.iou_thresh, top_k=self.top_k,
                   impl=self.nms_impl, max_results=self.max_results,
                   select_group=self.select_group)
        if decode == "xla":
            boxes, scores, classes = forward_compact_int8(
                net.graph, net.qparams, net.act_scales, x, decode_impl="xla",
                **kw)
            return batched_nms_compact(boxes, scores, classes,
                                       prob_thresh=self.prob_thresh, **nms)
        fwd = (forward_packed_fused_int8 if decode == "pallas-fused"
               else forward_packed_int8)
        payload, scores = fwd(net.graph, net.qparams, net.act_scales, x,
                              prob_thresh=self.prob_thresh, **kw)
        return batched_nms_packed(payload, scores, **nms)

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

    def _stage_batch(self, frames: np.ndarray, pinned: bool = False
                     ) -> Tuple[torch.Tensor, int]:
        """Host batch → (frames on the device, real batch). With ``scan > 1``
        the batch is padded with zero frames to a multiple of ``scan``
        (``_run_staged`` splits it; callers drop the pad results).
        ``pinned`` stops before the copy: the batch in pinned host memory,
        for an asynchronous host→device copy."""
        n_real = frames.shape[0]
        if self.scan > 1 and n_real % self.scan:
            pad = self.scan - n_real % self.scan
            frames = np.concatenate(
                [frames, np.zeros((pad, *frames.shape[1:]), frames.dtype)])
        if pinned:
            self._check_frames(frames)
            return torch.from_numpy(frames).pin_memory(), n_real
        return self._stage(frames), n_real

    def _run_staged(self, device_frames: torch.Tensor,
                    bgr: Optional[bool] = None) -> torch.Tensor:
        """``_run`` on staged frames; with ``scan > 1`` as ``scan``
        sub-batches enqueued back to back (no host synchronisation between
        them) whose packed results are stacked on the device, in
        submission order, and so leave in one device→host copy."""
        if self.scan == 1:
            return self._run(device_frames, bgr)
        return torch.cat([self._run(part, bgr)
                          for part in device_frames.chunk(self.scan)])

    def _enqueue(self, frames: np.ndarray, bgr: Optional[bool] = None
                 ) -> Tuple[torch.Tensor, int]:
        """Stage a same-shape uint8 batch and queue its device work; returns
        (packed results on the device, real batch). On the card this returns
        before the device has finished: ``_unpack`` waits."""
        device_frames, n_real = self._stage_batch(frames)
        return self._run_staged(device_frames, bgr), n_real

    def _unpack(self, res, src_hw: Optional[Tuple[int, int]]
                ) -> List[Detection]:
        """ONE device→host copy of the packed results (a device tensor, or a
        host tensor already copied), then per-image survivors rescaled to
        source pixels (``src_hw=None`` keeps net-input pixels)."""
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
        t0 = time.perf_counter()
        device_frames, n_real = self._stage_batch(frames)
        t1 = time.perf_counter()
        res = self._run_staged(device_frames)
        t2 = time.perf_counter()
        out = self._unpack(res, tuple(frames.shape[1:3]))[:n_real]
        self.last_stage_s = {"h2d_s": t1 - t0, "dispatch_s": t2 - t1,
                             "device_fetch_s": time.perf_counter() - t2}
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
            # policy (there it bounds the number of compiled programs), so
            # both packages run the same batches
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
        t0 = time.perf_counter()
        canvases = self._build_canvases(frames)
        pre_s = time.perf_counter() - t0
        src_hws = [f.shape[:2] for f in frames]
        out = self.detect_preletterboxed(canvases, src_hws)
        self.last_stage_s = {"preprocess_s": pre_s,
                             **(self.last_stage_s or {})}
        return out

    def detect_preletterboxed(self, canvases: np.ndarray,
                              src_hws: Sequence[Tuple[int, int]]
                              ) -> List[Detection]:
        """Run the device pipeline on host-preprocessed RGB uint8 canvases
        already at net resolution; rescale each result to its own source."""
        canvases = np.ascontiguousarray(canvases)
        t0 = time.perf_counter()
        device_frames, n_real = self._stage_batch(canvases)
        t1 = time.perf_counter()
        res = self._run_staged(device_frames, bgr=False)
        t2 = time.perf_counter()
        dets = self._unpack(res, None)[:n_real]  # net coords
        out = [self._unmap_one(d, hw) for d, hw in zip(dets, src_hws)]
        self.last_stage_s = {"h2d_s": t1 - t0, "dispatch_s": t2 - t1,
                             "device_fetch_s": time.perf_counter() - t2}
        return out

    def warmup(self, batch: int, src_hw: Tuple[int, int],
               host_preprocessed: bool = False) -> "Detector":
        """Run one (batch, source-shape) call before traffic arrives: builds
        the kernels on first use, fills the interpolation-matrix cache and
        initializes cuDNN, so the first request pays none of it.
        ``host_preprocessed`` warms the route of ``detect_preletterboxed``
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

    On the card ``submit()`` queues the host→device copy (from pinned
    memory), the forward, the pack and the copy of the packed results into
    pinned host memory on a CUDA stream of its own, and returns; results are
    waited for only when more than ``depth`` batches are in flight (or on
    ``flush()``), so host work (decode, drawing, I/O) overlaps device
    compute. On the CPU it keeps the same ordering with no streams: each
    batch is computed at ``submit()`` and handed back ``depth`` submissions
    later.
    """

    def __init__(self, detector: Detector, depth: int = 2):
        self.detector = detector
        self.depth = max(1, int(depth))
        self._stream = (torch.cuda.Stream(detector.device)
                        if detector.device.type == "cuda" else None)
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
        if self._stream is None:
            res, n_real = det._enqueue(frames)
            self._inflight.append((src_hw, n_real, res, None, None))
        else:
            det._interp_for(src_hw)  # built on the caller's stream, once
            self._stream.wait_stream(torch.cuda.current_stream(det.device))
            with torch.cuda.stream(self._stream):
                staged, n_real = det._stage_batch(frames, pinned=True)
                res = det._run_staged(staged.to(det.device, non_blocking=True))
                host = torch.empty(res.shape, dtype=res.dtype, pin_memory=True)
                host.copy_(res, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self._stream)
            # `staged` stays referenced until its copy has run
            self._inflight.append((src_hw, n_real, host, done, staged))
        out: List[List[Detection]] = []
        while len(self._inflight) > self.depth:
            out.append(self._materialize(self._inflight.pop(0)))
        return out

    def _materialize(self, item) -> List[Detection]:
        src_hw, n_real, res, done, _ = item
        if done is not None:
            done.synchronize()
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
