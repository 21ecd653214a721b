"""Static layer-graph IR lowered from Darknet cfg blocks.

Design stance (SURVEY.md §7): **not a module-list interpreter**. The cfg lowers
once, host-side, to a small typed IR — nodes with an op kind, static params and
*absolute* input edges — which a plain function walks (see ``model.py``).
This replaces the reference's per-layer ``nn.ModuleList`` of layer objects
(``yolov3/darknet.py::Darknet.__init__`` / ``blocks2modules``, SURVEY.md
§2.2/§2.4) with one static graph.

Everything here is host-side and static: channel arithmetic through
route/shortcut, downsample factor (detection stride) per layer, per-head anchor
sets resolved from ``mask``. No JAX imports — the IR is backend-agnostic.

This module is a copy of ``yolov3_tpu/graph.py`` (the PyTorch port walks the
same IR in ``yolov3_tpu_torch/model.py``); ``tests/test_torch_frontend.py``
holds ``lower()`` equal to the original field by field.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple, Union

from .config import Block, layer_blocks, net_options, parse_config

SUPPORTED_LAYERS = ("convolutional", "shortcut", "route", "upsample", "maxpool", "yolo")


@dataclass(frozen=True)
class Node:
    """One layer of the lowered graph.

    index:    Darknet layer index (0-based, [net] excluded).
    kind:     one of SUPPORTED_LAYERS.
    inputs:   absolute indices of input layers (-1 sentinel = network input).
    out_channels: channel count of this node's output feature map.
    downsample:   cumulative spatial downsample factor of the output
                  (the detection stride for yolo nodes' *input*).
    """

    index: int
    kind: str
    inputs: Tuple[int, ...]
    out_channels: int
    downsample: int
    # convolutional
    filters: int = 0
    size: int = 0
    stride: int = 1
    pad: int = 0
    batch_normalize: bool = False
    activation: str = "linear"
    # maxpool reuses size/stride; padding = total pad (darknet default size-1,
    # split low = padding//2, high = padding - padding//2, pool over -inf pad)
    padding: int = 0
    # yolo
    anchors: Tuple[Tuple[float, float], ...] = ()
    classes: int = 0


@dataclass(frozen=True)
class Graph:
    """Lowered model graph plus the [net] input spec."""

    nodes: Tuple[Node, ...]
    in_width: int
    in_height: int
    in_channels: int
    name: str = "darknet"

    @property
    def yolo_nodes(self) -> Tuple[Node, ...]:
        return tuple(n for n in self.nodes if n.kind == "yolo")

    @property
    def conv_nodes(self) -> Tuple[Node, ...]:
        return tuple(n for n in self.nodes if n.kind == "convolutional")

    def head_strides(self) -> Tuple[int, ...]:
        """Detection stride of each yolo head (net input px per grid cell)."""
        return tuple(self.nodes[n.inputs[0]].downsample for n in self.yolo_nodes)

    def num_detections(self, height: int, width: int) -> int:
        """Total anchors*cells across heads at a given input resolution."""
        total = 0
        for n in self.yolo_nodes:
            s = self.nodes[n.inputs[0]].downsample
            total += len(n.anchors) * (height // s) * (width // s)
        return total

    def summary(self, height: Optional[int] = None,
                width: Optional[int] = None) -> str:
        """darknet-style layer table (index, kind, params, output shape)."""
        h = height or self.in_height
        w = width or self.in_width
        lines = [f"{self.name}: input {h}x{w}x{self.in_channels}",
                 f"{'idx':>4} {'type':<14} {'params':<24} {'output':<18}"]
        for n in self.nodes:
            oh, ow = h // n.downsample, w // n.downsample
            if n.kind == "convolutional":
                detail = (f"{n.size}x{n.size}/{n.stride} -> {n.filters}"
                          f"{' +bn' if n.batch_normalize else ''}"
                          f" {n.activation}")
            elif n.kind == "maxpool":
                detail = f"{n.size}x{n.size}/{n.stride}"
            elif n.kind == "upsample":
                detail = f"x{n.stride}"
            elif n.kind == "shortcut":
                detail = f"from {n.inputs[1]}"
            elif n.kind == "route":
                detail = ",".join(str(i) for i in n.inputs)
            else:  # yolo
                detail = f"{len(n.anchors)} anchors, {n.classes} cls"
            out = f"{oh}x{ow}x{n.out_channels}"
            lines.append(f"{n.index:>4} {n.kind:<14} {detail:<24} {out:<18}")
        return "\n".join(lines)

    @property
    def needed_outputs(self) -> frozenset:
        """Layer indices whose outputs are consumed by a *later* non-adjacent
        node (route/shortcut skip-edge targets). The immediate-predecessor
        edge is threaded through the walk directly, so only these need
        caching — unlike the reference's ``Darknet.forward``, which retains
        all ~107 outputs (SURVEY.md §3.4)."""
        needed = set()
        for n in self.nodes:
            for i in n.inputs:
                if 0 <= i != n.index - 1:
                    needed.add(i)
        return frozenset(needed)


def _abs_index(rel_or_abs: int, current: int) -> int:
    """Darknet route/shortcut indices may be relative (negative) or absolute."""
    idx = rel_or_abs + current if rel_or_abs < 0 else rel_or_abs
    if not (0 <= idx < current):
        raise ValueError(
            f"layer {current}: reference {rel_or_abs} resolves to {idx}, out of range"
        )
    return idx


def lower(blocks: List[Block], name: str = "darknet") -> Graph:
    """Lower parsed cfg blocks to a :class:`Graph` with absolute edges."""
    net = net_options(blocks)
    layers = layer_blocks(blocks)
    nodes: List[Node] = []
    channels: List[int] = []  # out_channels per layer
    downs: List[int] = []  # cumulative downsample per layer

    for i, b in enumerate(layers):
        kind = b["type"]
        if kind not in SUPPORTED_LAYERS:
            raise ValueError(f"layer {i}: unsupported layer type [{kind}]")
        prev_c = channels[i - 1] if i > 0 else int(net.get("channels", 3))
        prev_d = downs[i - 1] if i > 0 else 1

        if kind == "convolutional":
            filters = int(b["filters"])
            size = int(b["size"])
            stride = int(b.get("stride", 1))
            node = Node(
                index=i, kind=kind, inputs=(i - 1,) if i > 0 else (-1,),
                out_channels=filters, downsample=prev_d * stride,
                filters=filters, size=size, stride=stride,
                pad=int(b.get("pad", 0)), batch_normalize=bool(b.get("batch_normalize", 0)),
                activation=str(b.get("activation", "linear")),
            )
        elif kind == "maxpool":
            size = int(b["size"])
            stride = int(b.get("stride", 1))
            node = Node(
                index=i, kind=kind, inputs=(i - 1,) if i > 0 else (-1,),
                out_channels=prev_c, downsample=prev_d * stride,
                size=size, stride=stride,
                padding=int(b.get("padding", size - 1)),
            )
        elif kind == "upsample":
            stride = int(b.get("stride", 2))
            if prev_d % stride:
                raise ValueError(f"layer {i}: upsample x{stride} from downsample {prev_d}")
            node = Node(
                index=i, kind=kind, inputs=(i - 1,),
                out_channels=prev_c, downsample=prev_d // stride, stride=stride,
            )
        elif kind == "shortcut":
            frm = b["from"]
            frm = frm[0] if isinstance(frm, list) else int(frm)
            j = _abs_index(frm, i)
            if channels[j] != prev_c:
                raise ValueError(
                    f"layer {i}: shortcut channel mismatch {channels[j]} vs {prev_c}"
                )
            if downs[j] != prev_d:
                raise ValueError(f"layer {i}: shortcut spatial mismatch")
            node = Node(
                index=i, kind=kind, inputs=(i - 1, j),
                out_channels=prev_c, downsample=prev_d,
                activation=str(b.get("activation", "linear")),
            )
        elif kind == "route":
            refs = b["layers"]
            if not isinstance(refs, list):
                refs = [refs]
            idxs = tuple(_abs_index(int(r), i) for r in refs)
            ds = {downs[j] for j in idxs}
            if len(ds) != 1:
                raise ValueError(f"layer {i}: route mixes spatial scales {ds}")
            node = Node(
                index=i, kind=kind, inputs=idxs,
                out_channels=sum(channels[j] for j in idxs), downsample=ds.pop(),
            )
        elif kind == "yolo":
            mask = b.get("mask", [])
            anchors_flat = b.get("anchors", [])
            all_anchors = [
                (float(anchors_flat[k]), float(anchors_flat[k + 1]))
                for k in range(0, len(anchors_flat), 2)
            ]
            anchors = tuple(all_anchors[int(m)] for m in mask)
            node = Node(
                index=i, kind=kind, inputs=(i - 1,),
                out_channels=prev_c, downsample=prev_d,
                anchors=anchors, classes=int(b.get("classes", 80)),
            )
            expected = len(anchors) * (5 + node.classes)
            if prev_c != expected:
                raise ValueError(
                    f"layer {i}: yolo input has {prev_c} channels, expected {expected}"
                )
        nodes.append(node)
        channels.append(node.out_channels)
        downs.append(node.downsample)

    return Graph(
        nodes=tuple(nodes),
        in_width=int(net.get("width", 416)),
        in_height=int(net.get("height", 416)),
        in_channels=int(net.get("channels", 3)),
        name=name,
    )


def load_graph(cfg_path: Union[str, Path]) -> Graph:
    """Parse + lower a ``.cfg`` file in one call."""
    path = Path(cfg_path)
    return lower(parse_config(path), name=path.stem)
