"""The serving path: uint8 frames → detections, on one device.

Port of ``yolov3_tpu/inference.py`` (``Detection``, ``Detector.detect_batch``
/ ``warmup`` / ``__call__``, the one-shot ``inference()``). One call runs:

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
unfused, with a warning. The multi-device routes wait for ``parallel/``. They are
not a fallback from a failing kernel: a kernel that cannot build or launch
raises.

PyTorch runs eagerly, so there is nothing to compile per (batch, shape); the
Detector caches only the interpolation matrices.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .model import (Darknet, forward_compact, forward_packed,
                    forward_packed_fused, fused_heads_eligible,
                    resolve_device)
from .ops.cuda_decode import supported as packed_decode_supported
from .ops.nms import (auto_top_k, batched_nms_compact, batched_nms_packed,
                      pack_results)
from .ops.preprocess import Interp, interp_matrices, preprocess, resize_target
from .utils.boxes import unletterbox_tlbr, unstretch_tlbr

log = logging.getLogger("yolov3_tpu_torch")

RESIZE_MODES = ("letterbox", "stretch")
DECODE_IMPLS = ("pallas", "pallas-fused", "xla")
BLOCK_IMPLS = ("xla", "pallas")


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
    on the net's device. ``device``, when given, must be that device (the
    Detector does not move weights); asking for CUDA without a card
    raises. ``decode_impl`` picks the route (module docstring); the route
    actually run is ``self.route``. ``block_impl="pallas"`` runs a quantized
    net's eligible residual blocks through K6 (no effect on a float net or
    on the bf16-carrier walk)."""

    def __init__(self, net: Darknet, prob_thresh: float = 0.05,
                 iou_thresh: float = 0.3, resize_mode: str = "letterbox",
                 top_k: Optional[int] = None, bgr: bool = True,
                 net_hw: Optional[Tuple[int, int]] = None,
                 max_results: int = 128, select_group: int = 2,
                 device: Union[str, torch.device, None] = None,
                 decode_impl: str = "pallas", block_impl: str = "xla"):
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
        # per-call stage split (seconds) of the last detect_batch:
        # h2d_s (host→device copy of the frames), enqueue_s (the device work
        # queued, not finished), device_fetch_s (wait + the one D2H copy)
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
    def _run(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 frames on the device → packed results
        (B, R, 6) on the device, boxes in net-input pixels."""
        if self.net.params is None:
            raise RuntimeError("call net.load_weights()/set_params() first")
        if self.bgr:
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
                                      top_k=self.top_k,
                                      max_results=self.max_results,
                                      select_group=self.select_group)
        else:
            fwd = (forward_packed_fused if decode == "pallas-fused"
                   else forward_packed)
            payload, scores = fwd(net.graph, net.params, x,
                                  prob_thresh=self.prob_thresh, **route)
            res = batched_nms_packed(payload, scores,
                                     iou_thresh=self.iou_thresh,
                                     top_k=self.top_k,
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
                   max_results=self.max_results,
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
        if frames.dtype != np.uint8:
            # the on-device preprocess divides by 255: a float frame would be
            # a different image, not an error, without this check
            raise TypeError(f"frames must be uint8 (got {frames.dtype}); "
                            f"pass raw cv2/camera frames, not normalized "
                            f"floats")
        if frames.ndim != 4 or frames.shape[3] != 3:
            raise ValueError(f"frames must be (B, H, W, 3), got {frames.shape}")
        return torch.from_numpy(frames).to(self.device)

    def _unpack(self, res: torch.Tensor, src_hw: Optional[Tuple[int, int]]
                ) -> List[Detection]:
        """ONE device→host copy of the packed results, then per-image
        survivors rescaled to source pixels (``src_hw=None`` keeps net-input
        pixels)."""
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

    def detect_batch(self, frames: np.ndarray) -> List[Detection]:
        """Detect in a batch of same-shape HWC uint8 frames (BGR by default,
        matching cv2 / the reference's input convention)."""
        frames = np.ascontiguousarray(frames)
        if frames.ndim == 3:
            frames = frames[None]
        if frames.shape[0] == 0:
            return []
        t0 = time.perf_counter()
        device_frames = self._stage(frames)
        t1 = time.perf_counter()
        res = self._run(device_frames)
        t2 = time.perf_counter()
        out = self._unpack(res, tuple(frames.shape[1:3]))
        self.last_stage_s = {"h2d_s": t1 - t0, "enqueue_s": t2 - t1,
                             "device_fetch_s": time.perf_counter() - t2}
        return out

    def warmup(self, batch: int, src_hw: Tuple[int, int]) -> "Detector":
        """Run one (batch, source-shape) call before traffic arrives: builds
        the kernels on first use, fills the interpolation-matrix cache and
        initializes cuDNN, so the first request pays none of it."""
        self.detect_batch(np.zeros((batch, *src_hw, 3), dtype=np.uint8))
        return self

    def __call__(self, frames) -> List[Detection]:
        return self.detect_batch(np.asarray(frames))


def inference(net: Darknet, images, prob_thresh: float = 0.05,
              nms_iou_thresh: float = 0.3, resize_mode: str = "letterbox"
              ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Reference-compatible one-shot API (``yolov3/inference.py::inference``):
    BGR frame(s) in → per-image ``(bbox_tlbr, class_prob, class_idx)`` tuples
    in source-image pixels. Builds a :class:`Detector` per call (nothing is
    compiled, so there is nothing to cache); for batching and repeated calls
    use a Detector directly."""
    det = Detector(net, prob_thresh=prob_thresh, iou_thresh=nms_iou_thresh,
                   resize_mode=resize_mode)
    results = det.detect_batch(np.asarray(images))
    return [(r.bbox_tlbr, r.class_prob, r.class_idx) for r in results]
