"""The yardstick's arithmetic: operations and bytes of the work a cfg
needs at a given input size and batch, and the card's published peaks.

Counts follow the algorithm, not a kernel: a convolution is 2 x MACs at its
output resolution; it reads its input once and its weights once and writes
its output once. The peaks are NVIDIA's H100 SXM data sheet (dense, at the
700 W power limit). Rewritten here from the arithmetic of the port's
``tools/traffic_model.py`` so that later changes to the program do not move
the yardstick.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

from reference.yolo import Net, conv_in_channels

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}
K6_WIDTHS = (128, 256)  # the residual blocks K6 takes (C; the middle is C / 2)


@dataclass(frozen=True)
class Conv:
    index: int
    cin: int
    cout: int
    size: int
    out_hw: tuple
    in_hw: tuple
    batch_norm: bool
    stem: bool

    @property
    def macs(self) -> int:
        h, w = self.out_hw
        return h * w * self.cout * self.cin * self.size * self.size

    def weight_elems(self) -> int:
        return self.cout * self.cin * self.size * self.size


def resolutions(net: Net, size: int) -> Dict[int, tuple]:
    """Each layer's output (h, w) at a square input of ``size``."""
    return {l.index: (size // l.stride, size // l.stride) for l in net.layers}


def convs(net: Net, size: int) -> List[Conv]:
    hw = resolutions(net, size)
    out = []
    for l in net.convs:
        src = l.inputs[0]
        out.append(Conv(l.index, conv_in_channels(net, l), l.channels,
                        int(l.opts.get("size", 1)), hw[l.index],
                        (size, size) if src < 0 else hw[src],
                        bool(int(l.opts.get("batch_normalize", 0))), src < 0))
    return out


def int8_quantized(c: Conv) -> bool:
    """The int8 configuration's rule: batch-normalised convolutions with at
    least 16 input channels run in int8; the stem and the linear head
    projections stay bf16."""
    return c.batch_norm and not c.stem and c.cin >= 16


def precision_of(c: Conv, tier: str) -> str:
    """The unit a conv runs on in a configuration's ``tier``."""
    return "int8" if tier == "int8" and int8_quantized(c) else "bf16"


def conv_bytes(c: Conv, batch: int, tier: str) -> int:
    """Input, weights and output each moved once: 1 byte an element for an
    int8 conv, 2 for bf16 (the stem reads the float32 image)."""
    eb = 1 if precision_of(c, tier) == "int8" else 2
    (ih, iw), (oh, ow) = c.in_hw, c.out_hw
    read = batch * ih * iw * c.cin * (4 if c.stem else eb)
    return read + c.weight_elems() * eb + batch * oh * ow * c.cout * eb


def conv_bound_s(c: Conv, batch: int, tier: str) -> float:
    """The least time the card needs for the conv: the larger of its
    operations at the unit's peak and its bytes at the memory's."""
    ops = 2 * c.macs * batch
    return max(ops / PEAK_OPS_PER_S[precision_of(c, tier)],
               conv_bytes(c, batch, tier) / HBM_BYTES_PER_S)


def image_ops(net: Net, size: int) -> int:
    """Operations of one image's walk (2 x MACs of every conv)."""
    return sum(2 * c.macs for c in convs(net, size))


def image_peak_s(net: Net, size: int, tier: str) -> float:
    """The least time one image's operations take at the published peaks
    of the units they run on (the denominator of a whole-step MFU)."""
    return sum(2 * c.macs / PEAK_OPS_PER_S[precision_of(c, tier)]
               for c in convs(net, size))


def residual_blocks(net: Net, widths=K6_WIDTHS) -> List[tuple]:
    """(1x1 conv, 3x3 conv, shortcut) layer indices of every Darknet residual
    block whose width C is in ``widths``: 1x1 C → C/2, 3x3 C/2 → C, then
    the shortcut from the block's input."""
    out = []
    for l in net.layers:
        if l.kind != "shortcut" or l.inputs[1] != l.index - 3:
            continue
        a, b = net.layers[l.index - 2], net.layers[l.index - 1]
        if (a.kind == b.kind == "convolutional"
                and int(a.opts.get("size", 1)) == 1
                and int(b.opts.get("size", 1)) == 3
                and b.channels == l.channels and l.channels in widths):
            out.append((a.index, b.index, l.index))
    return out


def block_bound_s(net: Net, size: int, batch: int, widths=K6_WIDTHS) -> float:
    """The least time of the int8 residual blocks of ``widths``: each reads
    its int8 input and both weights once and writes its int8 output once;
    its operations are both convolutions' at the int8 peak."""
    by = {c.index: c for c in convs(net, size)}
    total = 0.0
    for i1, i3, _ in residual_blocks(net, widths):
        c1, c3 = by[i1], by[i3]
        (h, w) = c1.in_hw
        act = batch * h * w * c1.cin  # int8 in and out, same shape
        nbytes = 2 * act + c1.weight_elems() + c3.weight_elems()
        ops = 2 * (c1.macs + c3.macs) * batch
        total += max(ops / PEAK_OPS_PER_S["int8"], nbytes / HBM_BYTES_PER_S)
    return total
