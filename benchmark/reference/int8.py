"""The int8 tier as a configuration with ``quantize`` states it, in plain
PyTorch. At int4 it is such a configuration's control; at int8 the CPU
tests hold its state to the program's. It is not the reference that
decides ``correct``: a quantized walk moves a level wherever its input moves
by a rounding, so it tracks the program no closer than the float32 walk.

Written from the scheme's description (post-training quantization,
symmetric, absmax, per-output-channel weights, per-tensor activations,
bias correction as in Nagel et al., arXiv:1906.04721 §4), not from the
program: it imports nothing of the port and takes none of its scales or
weights. Everything is recomputed here from the seed's weights and the
seed's calibration frames.

* **Which convolutions run on integers.** The batch-normalised ones with at
  least 16 input channels. The stem and the linear head projections stay
  in the float type, bf16.
* **Weights.** The served bf16 weights. Each output channel of a quantized
  convolution is rounded to ``levels`` symmetric steps over its largest
  magnitude.
* **Activations.** A layer's output travels rounded to its own scale when
  every consumer takes integers. A consumer takes integers if it is a
  quantized convolution, a shortcut or a route of several inputs, or a
  pool, upsample or single route whose own consumers all do. The scale is
  the output's largest magnitude over the calibration frames over
  ``levels``. A pool, an upsample or a single route passes its input's
  scale on. A route of several inputs rounds to its own scale only if all
  of its inputs are rounded. Every other output travels in bf16.
* **Calibration.** The scales and the bias correction come from a walk in
  bf16 (every output rounded to bf16) over the calibration frames, letterboxed
  as served, in blocks of ``BLOCK``.
* **Bias correction.** Each quantized convolution's bias gains
  ``Σ (W − W̃)·μ + Σ W̃·ε`` per output channel, in float64. ``W̃`` is the
  rounded weight. ``μ`` is the mean of the convolution's float input per
  channel over the calibration walk. ``ε`` is the mean of what rounding
  that input to its scale takes away.
* **Arithmetic.** float32 with TF32 off, every round half to even and
  clipped to ±``levels``. The program sums an integer product exactly in
  int32; here it sums to float32's rounding.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Set, Tuple

import torch

from reference.yolo import Net, conv_in_channels, forward

INT8 = 127  # symmetric steps a side: int8 without its most negative value
INT4 = 7    # the control: int4 likewise
BLOCK = 8   # calibration frames a walk takes at once
MIN_QUANT_CIN = 16

Weights = Dict[int, Tuple[torch.Tensor, torch.Tensor]]


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def round_to(x: torch.Tensor, scale: float, levels: int) -> torch.Tensor:
    """``x`` rounded to ``scale``'s steps, clipped to ±``levels``, back in
    float32. ``1 / scale`` is rounded once to float32."""
    inv = float(torch.tensor(1.0 / scale, dtype=torch.float32))
    s = float(torch.tensor(scale, dtype=torch.float32))
    return torch.clamp(torch.round(x * inv), -levels, levels) * s


@dataclass
class Plan:
    """Which convolutions run on integers, and which layers' outputs travel
    rounded to their own scale."""

    quantized: Set[int]
    rounded: Set[int]


def plan(net: Net) -> Plan:
    quantized = {l.index for l in net.convs
                 if int(l.opts.get("batch_normalize", 0))
                 and l.inputs[0] >= 0
                 and conv_in_channels(net, l) >= MIN_QUANT_CIN}
    consumers: Dict[int, list] = {l.index: [] for l in net.layers}
    for l in net.layers:
        for j in l.inputs:
            if j >= 0:
                consumers[j].append(l)
    takes_int: Dict[int, bool] = {}
    for l in reversed(net.layers):
        if l.kind == "convolutional":
            ok = l.index in quantized
        elif l.kind == "shortcut" or (l.kind == "route" and len(l.inputs) > 1):
            ok = True
        elif l.kind in ("maxpool", "upsample", "route"):
            ok = bool(consumers[l.index]) and all(
                takes_int[c.index] for c in consumers[l.index])
        else:  # yolo
            ok = False
        takes_int[l.index] = ok
    rounded = {l.index for l in net.layers
               if consumers[l.index]
               and all(takes_int[c.index] for c in consumers[l.index])}
    return Plan(quantized, rounded)


def passes_through(layer) -> bool:
    return (layer.kind in ("maxpool", "upsample")
            or (layer.kind == "route" and len(layer.inputs) == 1))


@dataclass
class Walk:
    """The rounding ``yolo.forward`` takes for the quantized walk: the plan,
    every layer's calibrated scale, and ``levels``."""

    plan: Plan
    scales: Dict[int, float]
    levels: int
    # per layer of the current walk: the scale its output is rounded to,
    # or None where it travels in bf16
    carried: Dict[int, object] = field(default_factory=dict)

    def conv_input(self, layer, x):
        src = layer.inputs[0]
        if layer.index not in self.plan.quantized:
            return bf16(x)
        if self.carried.get(src) is not None:
            return x
        return round_to(x, self.scales[src], self.levels)

    def pre_activation(self, layer, y):
        return y if layer.index in self.plan.quantized else bf16(y)

    def output(self, layer, y):
        i = layer.index
        if layer.kind == "convolutional" and i not in self.plan.quantized:
            y = bf16(y)  # a float convolution's activation runs in bf16
        if passes_through(layer):
            self.carried[i] = self.carried.get(layer.inputs[0])
            return y
        if layer.kind == "yolo":
            self.carried[i] = None
            return y
        emit = i in self.plan.rounded and (
            layer.kind != "route"
            or all(self.carried.get(j) is not None for j in layer.inputs))
        self.carried[i] = self.scales[i] if emit else None
        return round_to(y, self.scales[i], self.levels) if emit else bf16(y)


class _Bf16Walk:
    """The calibration walk's rounding: every convolution's input and output
    and every layer's output in bf16; ``record(layer, kind, x)`` sees each
    layer's output (``"out"``) and each convolution's input (``"in"``)."""

    def __init__(self, record):
        self.record = record

    def conv_input(self, layer, x):
        x = bf16(x)
        self.record(layer, "in", x)
        return x

    def pre_activation(self, layer, y):
        return bf16(y)

    def output(self, layer, y):
        y = bf16(y)
        self.record(layer, "out", y)
        return y


def _walk_blocks(net: Net, weights: Weights, x: torch.Tensor, record) -> None:
    with torch.inference_mode():
        for lo in range(0, x.shape[0], BLOCK):
            forward(net, weights, x[lo:lo + BLOCK], rounding=_Bf16Walk(record))


def quantize(net: Net, weights: Weights, calib: torch.Tensor,
             levels: int = INT8) -> Tuple[Weights, Walk]:
    """The quantized walk's weights (rounded, biases corrected) and its
    rounding, from float32 ``weights`` (OIHW) and ``calib``, the calibration
    frames letterboxed to the net's size (B, 3, H, W) float32."""
    served = {i: (bf16(w), bf16(b)) for i, (w, b) in weights.items()}
    p = plan(net)
    amax: Dict[int, float] = {}

    def absmax(layer, kind, x):
        if kind == "out":
            amax[layer.index] = max(amax.get(layer.index, 0.0),
                                    float(x.abs().max()))

    _walk_blocks(net, served, calib, absmax)
    scales = {i: max(m, 1e-6) / levels for i, m in amax.items()}

    rounded: Weights = {}
    for i, (w, b) in served.items():
        if i not in p.quantized:
            rounded[i] = (w, b)
            continue
        sw = (w.abs().amax(dim=(1, 2, 3)) / levels).clamp_min(1e-12)
        rounded[i] = (torch.clamp(torch.round(w / sw[:, None, None, None]),
                                  -levels, levels) * sw[:, None, None, None], b)

    sums: Dict[int, list] = {}

    def input_means(layer, kind, x):
        if kind != "in" or layer.index not in p.quantized:
            return
        s = scales[layer.inputs[0]]
        eps = x - round_to(x, s, levels)
        acc = sums.setdefault(layer.index, [0.0, 0.0, 0])
        acc[0] = acc[0] + x.double().sum(dim=(0, 2, 3))
        acc[1] = acc[1] + eps.double().sum(dim=(0, 2, 3))
        acc[2] += x.shape[0] * x.shape[2] * x.shape[3]

    _walk_blocks(net, served, calib, input_means)
    for i, (mu_sum, eps_sum, n) in sums.items():
        w, b = served[i]
        wq = rounded[i][0]
        mu, eps = mu_sum / n, eps_sum / n
        delta = ((w.double() - wq.double()).sum(dim=(2, 3)) @ mu
                 + wq.double().sum(dim=(2, 3)) @ eps)
        rounded[i] = (wq, (b.double() + delta).float())
    return rounded, Walk(p, scales, levels)
