"""Minimal faithful PyTorch Darknet harness: the parity oracle.

A copy of ``tools/torch_ref.py`` inside the port: the reference repo's
semantics (``nrsyed/pytorch-yolov3``) rebuilt from the Darknet format
contracts, ``torch.nn.Conv2d(bias=not bn)`` + ``BatchNorm2d`` (eps=1e-5) +
``LeakyReLU(0.1)`` per conv block, nearest x2 upsample, channel-concat
routes, residual shortcuts, and a per-head sigmoid/exp anchor-grid decode
producing ``(B, ΣA·g², 5+C)``, the same output contract as ``Darknet(x)``.
The only change is the graph it walks: the port's ``graph`` module, not the
JAX package's. Its output is bit-equal to the original's
(``tests/test_torch_tools.py``).

It uses idiomatic torch (a module list and a per-layer Python forward
loop, like the reference) rather than the port's graph walk, so it stays
an independent oracle for ``Darknet(x)``.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..graph import Graph, Node


class _YoloDecode(nn.Module):
    def __init__(self, node: Node):
        super().__init__()
        self.anchors = node.anchors
        self.classes = node.classes

    def forward(self, feat: torch.Tensor, stride: int) -> torch.Tensor:
        b, _, gy, gx = feat.shape
        a, c = len(self.anchors), self.classes
        f = feat.view(b, a, 5 + c, gy, gx).permute(0, 3, 4, 1, 2)  # B,gy,gx,A,5+C
        col = torch.arange(gx, dtype=f.dtype).view(1, 1, gx, 1)
        row = torch.arange(gy, dtype=f.dtype).view(1, gy, 1, 1)
        anchors = torch.tensor(self.anchors, dtype=f.dtype)  # (A,2)
        xy = (torch.sigmoid(f[..., 0:2])
              + torch.stack(torch.broadcast_tensors(col.expand(1, gy, gx, a),
                                                    row.expand(1, gy, gx, a)), dim=-1)
              ) * stride
        wh = torch.exp(f[..., 2:4]) * anchors
        conf = torch.sigmoid(f[..., 4:])
        out = torch.cat([xy, wh, conf], dim=-1)
        return out.reshape(b, gy * gx * a, 5 + c)


class TorchDarknet(nn.Module):
    """Reference-faithful module-list Darknet (NCHW, per-layer Python loop)."""

    def __init__(self, graph: Graph):
        super().__init__()
        self.graph = graph
        mods: List[nn.Module] = []
        for node in graph.nodes:
            if node.kind == "convolutional":
                in_c = (graph.in_channels if node.inputs[0] < 0
                        else graph.nodes[node.inputs[0]].out_channels)
                pad = node.size // 2 if node.pad else 0
                seq: List[nn.Module] = [
                    nn.Conv2d(in_c, node.filters, node.size, node.stride, pad,
                              bias=not node.batch_normalize)
                ]
                if node.batch_normalize:
                    seq.append(nn.BatchNorm2d(node.filters))
                if node.activation == "leaky":
                    seq.append(nn.LeakyReLU(0.1))
                mods.append(nn.Sequential(*seq))
            elif node.kind == "yolo":
                mods.append(_YoloDecode(node))
            else:
                mods.append(nn.Identity())  # resolved in forward
        self.module_list = nn.ModuleList(mods)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.graph
        outputs: Dict[int, torch.Tensor] = {}
        detections: List[torch.Tensor] = []
        prev = x
        for node, mod in zip(g.nodes, self.module_list):
            if node.kind == "convolutional":
                out = mod(prev)
            elif node.kind == "maxpool":
                lo = node.padding // 2
                hi = node.padding - lo
                padded = F.pad(prev, (lo, hi, lo, hi), value=float("-inf"))
                out = F.max_pool2d(padded, node.size, node.stride)
            elif node.kind == "upsample":
                out = F.interpolate(prev, scale_factor=node.stride, mode="nearest")
            elif node.kind == "shortcut":
                out = prev + outputs[node.inputs[1]]
                if node.activation == "leaky":  # darknet: activation post-add
                    out = F.leaky_relu(out, 0.1)
                elif node.activation == "relu":
                    out = F.relu(out)
            elif node.kind == "route":
                srcs = [prev if i == node.index - 1 else outputs[i]
                        for i in node.inputs]
                out = srcs[0] if len(srcs) == 1 else torch.cat(srcs, dim=1)
            elif node.kind == "yolo":
                stride = g.nodes[node.inputs[0]].downsample
                detections.append(mod(prev, stride))
                out = prev
            outputs[node.index] = out
            prev = out
        return torch.cat(detections, dim=1)

    def load_raw(self, raw: Dict[int, Dict[str, np.ndarray]]) -> "TorchDarknet":
        """Load unfolded darknet raw params (from ``weights.read_raw``/
        ``random_raw``) into the torch modules — the reference's
        ``load_weights`` placement contract (SURVEY.md §3.5)."""
        for node in self.graph.conv_nodes:
            p = raw[node.index]
            seq = self.module_list[node.index]
            conv: nn.Conv2d = seq[0]
            with torch.no_grad():
                conv.weight.copy_(torch.from_numpy(np.asarray(p["weight"])))
                if node.batch_normalize:
                    bn: nn.BatchNorm2d = seq[1]
                    bn.bias.copy_(torch.from_numpy(np.asarray(p["bn_beta"])))
                    bn.weight.copy_(torch.from_numpy(np.asarray(p["bn_gamma"])))
                    bn.running_mean.copy_(torch.from_numpy(np.asarray(p["bn_mean"])))
                    bn.running_var.copy_(torch.from_numpy(np.asarray(p["bn_var"])))
                else:
                    conv.bias.copy_(torch.from_numpy(np.asarray(p["bias"])))
        self.eval()
        return self


@torch.no_grad()
def torch_forward(graph: Graph, raw, x_nchw: np.ndarray) -> np.ndarray:
    """One-shot reference forward: raw darknet params + NCHW input → (B,N,5+C)."""
    model = TorchDarknet(graph).load_raw(raw)
    return model(torch.from_numpy(np.asarray(x_nchw, dtype=np.float32))).numpy()
