"""Float forward pass over the lowered graph, and the ``Darknet`` module.

Port of ``yolov3_tpu/model.py`` (float tiers ``"highest"`` and ``None``).
The lowered :class:`~yolov3_tpu_torch.graph.Graph` is walked by a plain
function:

* convs are ``F.conv2d`` (cuDNN on the card) on NCHW tensors in
  ``torch.channels_last`` memory, + folded-BN bias + LeakyReLU;
* darknet maxpool: ``-inf`` pad with ``lo = padding // 2``, ``hi = padding -
  lo``, then an unpadded ``F.max_pool2d`` (tiny's stride-1 size-2 pool pads
  ``lo=0, hi=1``);
* nearest ×2 upsample, route = channel concat, shortcut = add with the
  activation applied after the add (darknet semantics);
* only outputs on a skip edge are kept alive (``Graph.needed_outputs``).

Public functions keep the JAX package's layout: input NHWC (B, H, W, C),
heads NHWC (B, g, g, C) — a ``permute`` of the channels_last conv output,
which is contiguous, so the decode kernel reads it with no copy. The TPU's
128-lane head padding (``pad_head_params``) is not needed: the decode kernel
takes the map's strides.

Precision: ``"highest"`` forbids TF32 in the convs (the parity tier, the
analogue of ``lax.Precision.HIGHEST``); ``None`` allows it, the analogue of
the TPU's default one-pass precision.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from .graph import Graph, Node, load_graph
from .ops.cuda_decode import decode_packed
from .precision import tf32
from .weights import Params, TorchParams, load_weights, params_from_jax

PRECISIONS = (None, "highest")


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """``device`` as a torch.device with an explicit CUDA index; raises for
    CUDA when there is no card (no silent fall back to the CPU)."""
    dev = torch.device(device if device is not None else "cpu")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but "
                               "torch.cuda.is_available() is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _activate(y: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "leaky":
        return F.leaky_relu(y, 0.1)
    if activation == "relu":
        return F.relu(y)
    if activation != "linear":
        raise ValueError(f"unsupported activation {activation!r}")
    return y


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          node: Node) -> torch.Tensor:
    pad = node.size // 2 if node.pad else 0
    return _activate(F.conv2d(x, w, b, stride=node.stride, padding=pad),
                     node.activation)


def _maxpool(x: torch.Tensor, node: Node) -> torch.Tensor:
    # darknet rule: total pad = node.padding (default size-1), low = pad//2
    lo = node.padding // 2
    hi = node.padding - lo
    x = F.pad(x, (lo, hi, lo, hi), value=float("-inf"))
    return F.max_pool2d(x, node.size, node.stride)


def forward_features(graph: Graph, params: TorchParams, x: torch.Tensor,
                     precision: Optional[str] = None) -> List[torch.Tensor]:
    """Walk the graph; return the raw NHWC feature map feeding each yolo
    head. ``x``: (B, H, W, C) float32 input in [0, 1]."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    needed = graph.needed_outputs
    cache: Dict[int, torch.Tensor] = {}
    heads: List[torch.Tensor] = []
    prev = x.permute(0, 3, 1, 2)  # NHWC memory = NCHW channels_last
    with tf32(precision is None):
        for node in graph.nodes:
            if node.kind == "convolutional":
                p = params[node.index]
                out = _conv(prev, p["w"], p["b"], node)
            elif node.kind == "maxpool":
                out = _maxpool(prev, node)
            elif node.kind == "upsample":
                out = F.interpolate(prev, scale_factor=node.stride, mode="nearest")
            elif node.kind == "shortcut":
                out = _activate(prev + cache[node.inputs[1]], node.activation)
            elif node.kind == "route":
                srcs = [prev if i == node.index - 1 else cache[i]
                        for i in node.inputs]
                out = srcs[0] if len(srcs) == 1 else torch.cat(srcs, dim=1)
            elif node.kind == "yolo":
                heads.append(prev.permute(0, 2, 3, 1))
                out = prev
            else:  # pragma: no cover - lower() already validates kinds
                raise ValueError(node.kind)
            if node.index in needed:
                cache[node.index] = out
            prev = out
    return heads


def forward_packed(graph: Graph, params: TorchParams, x: torch.Tensor,
                   prob_thresh: float, precision: Optional[str] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Serving forward → (payload (B, N, 8), scores (B, N)) for
    ``ops.nms.batched_nms_packed``: the decode kernel (K1) emits the
    thresholded candidate records. ``prob_thresh`` is the serving threshold
    (the NMS applies none on this path)."""
    heads = forward_features(graph, params, x, precision)
    yolo_nodes = graph.yolo_nodes
    return decode_packed(heads, [n.anchors for n in yolo_nodes],
                         list(graph.head_strides()), yolo_nodes[0].classes,
                         prob_thresh=prob_thresh)


class Darknet(nn.Module):
    """A cfg's network with folded float32 weights on one device.

    ``Darknet(cfg_path, precision, device)``, then ``load_weights(path)`` (a
    darknet ``.weights`` file) or ``set_params(params_np)`` (the folded HWIO
    numpy form of ``weights.fold_raw``); calling it on an NHWC batch returns
    the NHWC head maps. Weights are buffers, so ``.to(device)`` moves them."""

    def __init__(self, cfg_path: Union[str, Path], precision: Optional[str] = None,
                 device: Union[str, torch.device, None] = None):
        super().__init__()
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got "
                             f"{precision!r}")
        self.graph = load_graph(cfg_path)
        self.precision = precision
        self._device = resolve_device(device)
        self._loaded = False

    @property
    def device(self) -> torch.device:
        return next(self.buffers()).device if self._loaded else self._device

    @property
    def net_size(self) -> Tuple[int, int]:
        return (self.graph.in_height, self.graph.in_width)

    @property
    def params(self) -> Optional[TorchParams]:
        """``{layer_index: {"w": OIHW, "b": (C,)}}`` views of the buffers."""
        if not self._loaded:
            return None
        return {n.index: {"w": getattr(self, f"w{n.index}"),
                          "b": getattr(self, f"b{n.index}")}
                for n in self.graph.conv_nodes}

    def set_params(self, params_np: Params) -> "Darknet":
        """Install folded HWIO numpy params (``weights.fold_raw`` form)."""
        missing = [n.index for n in self.graph.conv_nodes
                   if n.index not in params_np]
        if missing:
            raise ValueError(f"params missing conv layers {missing}")
        for idx, p in params_from_jax(params_np, self.device).items():
            self.register_buffer(f"w{idx}", p["w"])
            self.register_buffer(f"b{idx}", p["b"])
        self._loaded = True
        return self

    def load_weights(self, weights_path: Union[str, Path, bytes]) -> "Darknet":
        """Load a darknet ``.weights`` file (BN folded at load)."""
        return self.set_params(load_weights(weights_path, self.graph))

    @torch.inference_mode()
    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        if not self._loaded:
            raise RuntimeError("call load_weights()/set_params() first")
        return forward_features(self.graph, self.params, x, self.precision)
