"""Forward passes over the lowered graph, and the ``Darknet`` module.

Port of ``yolov3_tpu/model.py`` (float tiers ``"highest"``, ``None`` and
``"bf16"``; the int8 tier's walks live in ``quant.py`` and ``Darknet``
carries their state: ``quantize_int8``, ``save_quantized``,
``load_quantized``). The lowered :class:`~yolov3_tpu_torch.graph.Graph` is walked by
a plain function:

* convs are ``F.conv2d`` (cuDNN on the card) on NCHW tensors in
  ``torch.channels_last`` memory, + folded-BN bias + LeakyReLU; on the card
  the bias, the activation and the add of a shortcut right after the conv
  (:func:`residual_convs`) are one pass of the epilogue kernel
  (``ops/cuda_epilogue.py``); with ``conv_impl="pallas"`` each eligible
  3×3/s1 conv runs the fused K5 kernel instead (``ops/cuda_conv.py``);
* darknet maxpool: ``-inf`` pad with ``lo = padding // 2``, ``hi = padding -
  lo``, then an unpadded ``F.max_pool2d`` (tiny's stride-1 size-2 pool pads
  ``lo=0, hi=1``);
* nearest ×2 upsample, route = channel concat, shortcut = add with the
  activation applied after the add (darknet semantics);
* only outputs on a skip edge are kept alive (``Graph.needed_outputs``).

Entry points: :func:`forward` (decoded (B, N, 5+C), the reference
``Darknet.forward`` contract), :func:`forward_packed` (K1 records),
:func:`forward_packed_fused` (K4: head convs inside the decode kernel) and
:func:`forward_compact` (boxes / scores / classes, plain decode or K1c).

Public functions keep the JAX package's layout: input NHWC (B, H, W, C),
heads NHWC (B, g, g, C) — a ``permute`` of the channels_last conv output,
which is contiguous, so the decode kernels read it with no copy. The TPU's
128-lane head padding (``pad_head_params``) is not needed: the decode
kernels take the map's strides.

Precision: ``"highest"`` forbids TF32 in the convs (the parity tier, the
analogue of ``lax.Precision.HIGHEST``); ``None`` allows it, the analogue of
the TPU's default one-pass precision; ``"bf16"`` runs the walk in bfloat16
(weights, activations, convs, shortcut and route), the throughput tier.
Head maps are decoded in float32 on every route.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from .graph import Graph, Node, load_graph
from .ops import cuda_conv, cuda_epilogue
from .ops import decode as plain_decode
from .ops.cuda_decode import (decode_all, decode_compact, decode_packed,
                              decode_packed_fused, fused_head_supported)
from .ops.cuda_epilogue import activate as _activate
from .precision import tf32
from .weights import (Params, TorchParams, load_weights,
                      load_weights_cached, param_count,
                      params_from_jax, quant_state_from_jax,
                      resolve_device)

PRECISIONS = (None, "highest", "bf16")
CONV_IMPLS = ("xla", "pallas")
COMPACT_DECODE_IMPLS = ("xla", "pallas")  # forward_compact's decode routes


def _check_route(precision: Optional[str], conv_impl: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if conv_impl not in CONV_IMPLS:
        raise ValueError(f"conv_impl must be one of {CONV_IMPLS}, got {conv_impl!r}")


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, node: Node,
          conv_impl: str = "xla", residual: Optional[torch.Tensor] = None,
          residual_activation: str = "linear") -> torch.Tensor:
    """Conv + bias + activation of NCHW (channels_last) ``x``; with
    ``residual`` (x's layout) also the add and the activation of the
    shortcut right after the conv (:func:`residual_convs`)."""
    if (conv_impl == "pallas" and node.pad
            and cuda_conv.supported(node.size, node.stride, w.shape[1],
                                    node.activation)):
        y = cuda_conv.conv3x3_fused(x.permute(0, 2, 3, 1), w, b,
                                    activation=node.activation)
        y = y.permute(0, 3, 1, 2)
        return y if residual is None else _activate(y + residual,
                                                    residual_activation)
    pad = node.size // 2 if node.pad else 0
    # weights follow the activations' type, as in the JAX package
    w, b = w.to(x.dtype), b.to(x.dtype)
    # The CPU's convs add the bias inside their sum (bf16 rounds once
    # there), so it stays there. On the card PyTorch runs cuDNN's conv
    # without the bias and adds it in a pass of its own: the epilogue kernel
    # makes that add, the activation and the residual's add one pass, bit
    # for bit the same. cuDNN writes channels_last (the weights are), so
    # the NHWC view is dense; the kernel raises where it is not.
    on_cpu = x.device.type == "cpu"
    y = F.conv2d(x, w, b if on_cpu else None, stride=node.stride,
                 padding=pad).permute(0, 2, 3, 1)
    r = None if residual is None else residual.permute(0, 2, 3, 1)
    if on_cpu:
        y = cuda_epilogue.conv_epilogue_reference(y, None, node.activation, r,
                                                  residual_activation)
    else:
        y = cuda_epilogue.conv_epilogue(y, b, node.activation, r,
                                        residual_activation)
    return y.permute(0, 3, 1, 2)


def residual_convs(graph: Graph, upto: Optional[int] = None
                   ) -> Dict[int, Node]:
    """Conv index → the shortcut node right after it whose add and
    activation the conv's epilogue takes over, in a walk of
    ``graph.nodes[:upto]``: the shortcut's first input is the conv, its
    other input is another node, and nothing else reads the conv's own
    output (it is not in ``graph.needed_outputs``). 23 convs of yolov3 and
    of yolov3-spp, none of tiny."""
    needed = graph.needed_outputs
    nodes = graph.nodes[:upto]
    return {sc.index - 1: sc for sc in nodes[1:]
            if sc.kind == "shortcut" and sc.inputs[0] == sc.index - 1
            and sc.inputs[1] != sc.index - 1
            and graph.nodes[sc.index - 1].kind == "convolutional"
            and sc.index - 1 not in needed}


def _maxpool(x: torch.Tensor, node: Node) -> torch.Tensor:
    # darknet rule: total pad = node.padding (default size-1), low = pad//2
    lo = node.padding // 2
    hi = node.padding - lo
    x = F.pad(x, (lo, hi, lo, hi), value=float("-inf"))
    return F.max_pool2d(x, node.size, node.stride)


def forward_features(graph: Graph, params: TorchParams, x: torch.Tensor,
                     precision: Optional[str] = None, conv_impl: str = "xla",
                     stop_before_heads: bool = False,
                     upto: Optional[int] = None) -> List[torch.Tensor]:
    """Walk the graph; return the raw NHWC feature map feeding each yolo
    head. ``x``: (B, H, W, C) float input in [0, 1] (cast to bfloat16 at
    precision "bf16"). ``stop_before_heads=True`` returns the PRE-head
    activations instead and skips the 1×1 head convs (their projection runs
    inside K4, :func:`forward_packed_fused`); callers gate on
    :func:`fused_heads_eligible` first. ``upto``: walk ``graph.nodes[:upto]``
    only and append the last node's output (NHWC) to the heads reached, as
    ``quant.forward_features_int8_carrier`` does (the per-layer profile,
    ``tools/profile_layers.py``)."""
    _check_route(precision, conv_impl)
    needed = graph.needed_outputs
    fused = residual_convs(graph, upto)
    head_convs = ({yn.inputs[0] for yn in graph.yolo_nodes}
                  if stop_before_heads else frozenset())
    cache: Dict[int, torch.Tensor] = {}
    heads: List[torch.Tensor] = []
    prev = x.permute(0, 3, 1, 2)  # NHWC memory = NCHW channels_last
    if precision == "bf16":
        prev = prev.to(torch.bfloat16)
    with tf32(precision is None):
        for node in graph.nodes[:upto]:
            if node.index in head_convs:
                # the head branch ends here; the skipped conv's only
                # consumer is its yolo node (eligibility-gated)
                heads.append(prev.permute(0, 2, 3, 1))
                out = prev
            elif node.kind == "convolutional":
                p = params[node.index]
                sc = fused.get(node.index)
                out = (_conv(prev, p["w"], p["b"], node, conv_impl)
                       if sc is None else
                       _conv(prev, p["w"], p["b"], node, conv_impl,
                             cache[sc.inputs[1]], sc.activation))
            elif node.kind == "maxpool":
                out = _maxpool(prev, node)
            elif node.kind == "upsample":
                out = F.interpolate(prev, scale_factor=node.stride, mode="nearest")
            elif node.kind == "shortcut":
                # taken over by the epilogue of the conv before it
                out = (prev if node.inputs[0] in fused else
                       _activate(prev + cache[node.inputs[1]], node.activation))
            elif node.kind == "route":
                srcs = [prev if i == node.index - 1 else cache[i]
                        for i in node.inputs]
                out = srcs[0] if len(srcs) == 1 else torch.cat(srcs, dim=1)
            elif node.kind == "yolo":
                if not stop_before_heads:
                    heads.append(prev.permute(0, 2, 3, 1))
                out = prev
            else:  # pragma: no cover - lower() already validates kinds
                raise ValueError(node.kind)
            if node.index in needed:
                cache[node.index] = out
            prev = out
    if upto is not None:
        return heads + [prev.permute(0, 2, 3, 1)]
    return heads


def _head_spec(graph: Graph):
    yolo_nodes = graph.yolo_nodes
    return ([n.anchors for n in yolo_nodes], list(graph.head_strides()),
            yolo_nodes[0].classes)


def forward(graph: Graph, params: TorchParams, x: torch.Tensor,
            precision: Optional[str] = None, conv_impl: str = "xla"
            ) -> torch.Tensor:
    """Full decoded forward: (B, H, W, C) → (B, N, 5+C) net-pixel
    detections, the reference ``Darknet.forward`` contract: center-xywh in
    net-input pixels, sigmoid objectness and class scores, cell-major within
    a head, heads in cfg order. The full decode is K3 (``ops.cuda_decode.
    decode_all``); the maps widen to float32 before any math."""
    heads = forward_features(graph, params, x, precision, conv_impl)
    return decode_all(heads, *_head_spec(graph), scales=graph.head_scales())


def forward_compact(graph: Graph, params: TorchParams, x: torch.Tensor,
                    precision: Optional[str] = None, conv_impl: str = "xla",
                    decode_impl: str = "xla"):
    """Serving forward → (tlbr boxes (B, N, 4), scores (B, N), classes
    (B, N) int32) without the (B, N, 5+C) tensor. ``decode_impl="xla"``:
    the plain-tensor ``ops.decode.decode_compact`` (cell-major);
    ``"pallas"``: K1c (anchor-major; the same detection sets)."""
    if decode_impl not in COMPACT_DECODE_IMPLS:
        raise ValueError(f"decode_impl must be one of {COMPACT_DECODE_IMPLS}, "
                         f"got {decode_impl!r}")
    heads = forward_features(graph, params, x, precision, conv_impl)
    fn = decode_compact if decode_impl == "pallas" else plain_decode.decode_compact
    return fn(heads, *_head_spec(graph), scales=graph.head_scales())


def forward_packed(graph: Graph, params: TorchParams, x: torch.Tensor,
                   prob_thresh: float, precision: Optional[str] = None,
                   conv_impl: str = "xla"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Serving forward → (payload (B, N, 8), scores (B, N)) for
    ``ops.nms.batched_nms_packed``: the decode kernel (K1) emits the
    thresholded candidate records. ``prob_thresh`` is the serving threshold
    (the NMS applies none on this path)."""
    heads = forward_features(graph, params, x, precision, conv_impl)
    anchors, strides, classes = _head_spec(graph)
    return decode_packed(heads, anchors, strides, classes,
                         prob_thresh=prob_thresh, scales=graph.head_scales())


def _consumer_counts(graph: Graph) -> Dict[int, int]:
    """node index → number of graph nodes consuming its output."""
    consumers: Dict[int, int] = {}
    for n in graph.nodes:
        for i in n.inputs:
            if i >= 0:
                consumers[i] = consumers.get(i, 0) + 1
    return consumers


def fused_heads_eligible(graph: Graph) -> bool:
    """Gate for :func:`forward_packed_fused`, the JAX package's: every head
    branch ends in a 1×1/s1 linear conv whose ONLY consumer is its yolo
    node, whose yolo node feeds nothing, and whose input channel count and
    anchor count pass K4's shape gate (``fused_head_supported``: Cin % 128
    == 0, ≤ 4 anchors). True for yolov3 / tiny / spp. The port adds one
    condition: no head scales its centre (``scale_x_y`` 1), since K4 takes
    no scale; false for yolov4."""
    if any(s != 1.0 for s in graph.head_scales()):
        return False
    consumers = _consumer_counts(graph)
    for yn in graph.yolo_nodes:
        hc = yn.inputs[0]
        node = graph.nodes[hc]
        cin = (graph.nodes[node.inputs[0]].out_channels
               if node.inputs[0] >= 0 else graph.in_channels)
        if not (node.kind == "convolutional" and node.size == 1
                and node.stride == 1 and node.activation == "linear"
                and consumers.get(hc, 0) == 1
                and consumers.get(yn.index, 0) == 0
                and fused_head_supported(cin, yn.anchors)):
            return False
    return True


def forward_packed_fused(graph: Graph, params: TorchParams, x: torch.Tensor,
                         prob_thresh: float, precision: Optional[str] = None,
                         conv_impl: str = "xla"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`forward_packed` with the 1×1 head convs inside the decode
    kernel (K4): the walk stops at each pre-head activation and the head
    maps never reach device memory. Same record contract and candidate
    order; the head projection accumulates in float32 at every precision.
    Raises unless :func:`fused_heads_eligible`."""
    if not fused_heads_eligible(graph):
        raise ValueError("graph is not eligible for the head-fused decode "
                         "(fused_heads_eligible)")
    pre = forward_features(graph, params, x, precision, conv_impl,
                           stop_before_heads=True)
    ws, bs = [], []
    for yn in graph.yolo_nodes:
        p = params[yn.inputs[0]]
        w = p["w"]  # (Cout, Cin, 1, 1), channels_last: a (Cout, Cin) view
        ws.append(w.reshape(w.shape[0], w.shape[1]))
        bs.append(p["b"])
    anchors, strides, classes = _head_spec(graph)
    return decode_packed_fused(pre, ws, bs, anchors, strides, classes,
                               prob_thresh=prob_thresh)


class Darknet(nn.Module):
    """A cfg's network with folded weights on one device.

    ``Darknet(cfg_path, precision, param_dtype, conv_impl, device)`` (the
    JAX class's order, ``device`` last), then ``load_weights(path)`` (a
    darknet ``.weights`` file) or ``set_params(params)`` (the folded HWIO
    numpy form of
    ``weights.fold_raw``); calling it on an NHWC batch returns the decoded
    (B, N, 5+C) tensor of :func:`forward`. Weights are buffers, so
    ``.to(device)`` moves them; they are bfloat16 at precision "bf16" and
    float32 otherwise unless ``param_dtype`` says. ``device=None`` is the
    card (it raises when there is none); the CPU has to be asked for, and
    everything made from the net (``quantize_int8``, ``load_quantized``,
    ``set_quantized``, a ``Detector``) lives where the net does."""

    def __init__(self, cfg_path: Union[str, Path], precision: Optional[str] = None,
                 param_dtype: Optional[torch.dtype] = None,
                 conv_impl: str = "xla",
                 device: Union[str, torch.device, None] = None):
        super().__init__()
        _check_route(precision, conv_impl)
        self.graph = load_graph(cfg_path)
        self.precision = precision
        self.conv_impl = conv_impl
        if param_dtype is None:
            param_dtype = torch.bfloat16 if precision == "bf16" else torch.float32
        self.param_dtype = param_dtype
        self._device = resolve_device(device)
        self._loaded = False
        # the int8 tier's state (quantize_int8 / load_quantized)
        self.qparams = None
        self.act_scales: Optional[Dict[int, float]] = None
        self.act_zeros: Optional[Dict[int, int]] = None  # asymmetric scheme
        self.qcarrier = "int8"  # activation carrier of the int8 path
        self._qoperands = None
        self._params_view: Optional[TorchParams] = None

    @property
    def device(self) -> torch.device:
        return next(self.buffers()).device if self._loaded else self._device

    @property
    def num_classes(self) -> int:
        return self.graph.yolo_nodes[0].classes

    @property
    def net_size(self) -> Tuple[int, int]:
        return (self.graph.in_height, self.graph.in_width)

    @property
    def params(self) -> Optional[TorchParams]:
        """``{layer_index: {"w": OIHW, "b": (C,)}}`` views of the buffers:
        ONE dict for one set of weights, so its identity names them (a
        Detector's cached programs key on it); ``set_params`` and moving the
        net make a new one."""
        if not self._loaded:
            return None
        if self._params_view is None:
            self._params_view = {n.index: {"w": getattr(self, f"w{n.index}"),
                                           "b": getattr(self, f"b{n.index}")}
                                 for n in self.graph.conv_nodes}
        return self._params_view

    def _apply(self, fn, *args, **kwargs):
        # .to() / .cuda() / .half() replace the buffers
        self._params_view = None
        return super()._apply(fn, *args, **kwargs)

    def set_params(self, params: Params) -> "Darknet":
        """Install folded HWIO numpy params (``weights.fold_raw`` form)."""
        missing = [n.index for n in self.graph.conv_nodes
                   if n.index not in params]
        if missing:
            raise ValueError(f"params missing conv layers {missing}")
        for idx, p in params_from_jax(params, self.device).items():
            # .to keeps the weights' channels_last memory
            self.register_buffer(f"w{idx}", p["w"].to(self.param_dtype))
            self.register_buffer(f"b{idx}", p["b"].to(self.param_dtype))
        self._loaded = True
        self._params_view = None
        return self

    def load_weights(self, weights_path: Union[str, Path, bytes],
                     cache: bool = False) -> "Darknet":
        """Load a darknet ``.weights`` file (BN folded at load).
        ``cache=True`` keeps an npz of the converted params beside the file
        (``weights.load_weights_cached``)."""
        loader = load_weights_cached if cache else load_weights
        return self.set_params(loader(weights_path, self.graph))

    @torch.inference_mode()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self._loaded:
            raise RuntimeError("call load_weights()/set_params() first")
        return forward(self.graph, self.params, x, self.precision,
                       self.conv_impl)

    # ------------------------------------------------------ the int8 tier

    @property
    def quantized(self) -> bool:
        return self.qparams is not None

    @property
    def qoperands(self):
        """The run-time operands of the current ``qparams``
        (``quant.Operands``), rebuilt when the quantization state changes."""
        from .quant import Operands

        if self._qoperands is None or self._qoperands.qparams is not self.qparams:
            self._qoperands = Operands(self.qparams)
        return self._qoperands

    @torch.inference_mode()
    def quantize_int8(self, calibration_frames, net_hw=None,
                      mode: str = "letterbox", carrier: str = "int8",
                      quantize_heads: bool = False,
                      quantize_stem: bool = False,
                      calib_method: str = "absmax",
                      calib_percentile: float = 99.9,
                      bias_correct: bool = True,
                      act_scheme: str = "symmetric") -> "Darknet":
        """Post-training int8 quantization (``quant.py``).

        ``calibration_frames``: (N, H, W, 3) uint8 RGB frames, or a list of
        frames of different sizes; they are preprocessed to the net input
        size as the serving path does and calibrate the activation scales.
        ``carrier="int8"`` (default) keeps activations int8 BETWEEN ops
        (``quant.forward_features_int8_carrier``); ``carrier="bf16"``
        quantizes at each conv input. ``quantize_heads`` also quantizes the
        no-BN head projections, ``quantize_stem`` the Cin=3 stem conv through
        the exact-u8 input scheme (``quant.eligible``). ``calib_method``:
        ``"absmax"`` or ``"percentile"`` with ``calib_percentile``
        (``quant._make_stat_fn``). ``bias_correct`` folds the expected
        per-channel pre-activation shift of the rounding, measured on the
        same batches, into each quantized conv's bias
        (``quant.bias_correct``). ``act_scheme="asymmetric"`` (int8 carrier
        only) gives every tensor a zero-point
        (``quant.calibrate_tensors_affine``); ``calib_method`` then maps to
        the affine calibrator: absmax → the exact min/max range, percentile
        → the two-sided (100−q, q) range."""
        import numpy as np

        from .ops.preprocess import preprocess
        from .quant import (bias_correct as _bias_correct, calibrate,
                            calibrate_tensors, calibrate_tensors_affine,
                            quantize_weights)

        if not self._loaded:
            raise RuntimeError("load_weights() before quantize_int8()")
        net_hw = tuple(net_hw) if net_hw else self.net_size
        if len(calibration_frames) == 0:
            # an empty calibration set would produce an empty scale dict
            # that breaks every later detect with a KeyError
            raise ValueError("quantize_int8 needs at least one calibration "
                             "frame (a few dozen representative images)")

        def _u8(f) -> torch.Tensor:
            # same contract as the detect entry points: a float frame is a
            # different image, not an error, without this check
            a = np.ascontiguousarray(f)
            if a.dtype != np.uint8:
                raise TypeError(f"calibration frames must be uint8 (got "
                                f"{a.dtype}); pass raw cv2/camera frames")
            return torch.from_numpy(a).to(self.device)

        if isinstance(calibration_frames, (list, tuple)):
            # variable-size calibration images: preprocess each on its own
            batches = [preprocess(_u8(f)[None], net_hw, mode=mode)
                       for f in calibration_frames]
        else:
            frames = _u8(calibration_frames)
            batches = [preprocess(frames[i:i + 8], net_hw, mode=mode)
                       for i in range(0, frames.shape[0], 8)]
        if act_scheme not in ("symmetric", "asymmetric"):
            raise ValueError(f"unknown act_scheme {act_scheme!r} "
                             "(expected 'symmetric' or 'asymmetric')")
        if act_scheme == "asymmetric" and carrier != "int8":
            raise ValueError("act_scheme='asymmetric' needs the int8 "
                             "activation carrier (carrier='int8')")
        precision = self.precision or "bf16"
        self.act_zeros = None
        if act_scheme == "asymmetric":
            self.act_scales, self.act_zeros = calibrate_tensors_affine(
                self.graph, self.params, batches, precision=precision,
                method={"absmax": "minmax"}.get(calib_method, calib_method),
                percentile=calib_percentile)
        elif carrier == "int8":
            self.act_scales = calibrate_tensors(
                self.graph, self.params, batches, precision=precision,
                method=calib_method, percentile=calib_percentile)
        else:
            self.act_scales = calibrate(
                self.graph, self.params, batches, precision=precision,
                include_heads=quantize_heads, method=calib_method,
                percentile=calib_percentile)
        self.qcarrier = carrier
        self.qparams = quantize_weights(self.graph, self.params,
                                        include_heads=quantize_heads,
                                        include_stem=quantize_stem)
        if bias_correct:
            self.qparams = _bias_correct(
                self.graph, self.params, self.qparams, self.act_scales,
                batches, carrier=carrier, precision=precision,
                zeros=self.act_zeros)
        return self

    def set_quantized(self, qparams_np, act_scales, act_zeros=None,
                      carrier: str = "int8") -> "Darknet":
        """Install a quantization state given as numpy arrays in the JAX
        package's form (``weights.quant_state_from_jax``), on this net's
        device."""
        self.qparams = quant_state_from_jax(qparams_np, self.device)
        self.act_scales = {int(i): float(s) for i, s in act_scales.items()}
        self.act_zeros = (None if act_zeros is None else
                          {int(i): int(z) for i, z in act_zeros.items()})
        self.qcarrier = carrier
        return self

    def save_quantized(self, path) -> "Darknet":
        """Persist the int8 quantization state (qparams + activation scales
        + carrier) as one npz, so a serving restart skips calibration
        (:meth:`load_quantized`). The file has the JAX package's keys and
        layout (``wq`` / ``w`` HWIO, ``__meta__.*``, bfloat16 as tagged
        uint16 bits), so either package loads the other's. It is keyed to
        the architecture (graph name + param count), not to the weight
        file: qparams fully determine the int8 forward."""
        import numpy as np

        if not self.quantized:
            raise RuntimeError("quantize_int8() before save_quantized()")
        flat = {
            "__meta__.graph": np.asarray(self.graph.name),
            "__meta__.nparams": np.asarray(param_count(self.graph)),
            "__meta__.carrier": np.asarray(self.qcarrier),
            "__meta__.scale_idx": np.asarray(sorted(self.act_scales), np.int64),
            "__meta__.scale_val": np.asarray(
                [self.act_scales[i] for i in sorted(self.act_scales)],
                np.float64),
        }
        if self.act_zeros is not None:  # asymmetric activation scheme
            flat["__meta__.zero_idx"] = np.asarray(sorted(self.act_zeros),
                                                   np.int64)
            flat["__meta__.zero_val"] = np.asarray(
                [self.act_zeros[i] for i in sorted(self.act_zeros)], np.int64)
        for i, qp in self.qparams.items():
            for name, t in qp.items():
                t = t.detach().cpu().contiguous()
                if t.dtype == torch.bfloat16:
                    # numpy has no bfloat16: persist the raw bits with a
                    # dtype tag (exact round trip)
                    flat[f"{i}.{name}:bf16"] = t.view(torch.int16).numpy().view(
                        np.uint16)
                else:
                    flat[f"{i}.{name}"] = t.numpy()
        path = Path(path)
        tmp = path.with_suffix(path.suffix + ".tmp")
        with open(tmp, "wb") as f:  # a file handle: savez appends no .npz
            np.savez(f, **flat)
        tmp.replace(path)
        return self

    def load_quantized(self, path) -> "Darknet":
        """Restore a quantization state saved by :meth:`save_quantized` of
        either package. Validates the architecture key (graph name + param
        count), so a state file of another cfg fails loudly."""
        import numpy as np

        with np.load(path) as z:
            name = str(z["__meta__.graph"])
            nparams = int(z["__meta__.nparams"])
            if (name, nparams) != (self.graph.name, param_count(self.graph)):
                raise ValueError(
                    f"quantized state {path} was saved for graph "
                    f"{name!r} ({nparams} params); this net is "
                    f"{self.graph.name!r} ({param_count(self.graph)})")
            carrier = str(z["__meta__.carrier"])
            scales = dict(zip(z["__meta__.scale_idx"], z["__meta__.scale_val"]))
            zeros = None
            if "__meta__.zero_idx" in z.files:
                zeros = dict(zip(z["__meta__.zero_idx"], z["__meta__.zero_val"]))
            qparams_np: Dict[int, Dict[str, object]] = {}
            for file in z.files:
                if file.startswith("__meta__"):
                    continue
                i, field = file.split(".", 1)
                qparams_np.setdefault(int(i), {})[field] = z[file]
        return self.set_quantized(qparams_np, scales, zeros, carrier)
