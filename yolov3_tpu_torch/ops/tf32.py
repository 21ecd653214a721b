"""The split of float32 operands into TF32 parts that K5's and K4's float32
kernels make on the tensor cores (``csrc/wgmma_common.cuh`` ::
``wg_split_tf32``), as plain PyTorch.

TF32 keeps float32's sign and exponent and the top 10 of its 23 mantissa
bits. :func:`tf32_round` rounds to it as ``cvt.rna.tf32.f32`` does: to
nearest, ties away from zero, which on the bit pattern is ``(bits + 0x1000)
& ~0x1fff``. :func:`split_tf32` gives hi = tf32(x) and lo = x − hi, which is
exact in float32: hi + lo == x. The kernels feed hi and tf32(lo) to the
tensor cores (``wg_split_tf32``, bit for bit); tf32(lo) misses lo by at most
2⁻¹¹ of itself, under 2⁻²² |x| (dropping lo's low bits instead would leave
2⁻²¹ |x|). A product a·b then runs as three TF32 products, hi_a·hi_b +
hi_a·lo_b + lo_a·hi_b, within about 2⁻²¹ |a b| of the float32 product:
float32 accuracy at the TF32 rate. One TF32 pass (hi_a·hi_b) is only within
about 2⁻¹⁰ |a b|.

The kernels split the activations in registers; the weights reach them
split already, by :func:`tf32_operands`, once per weight tensor.

Inputs are finite: the split of an infinity is (inf, nan).
"""
from __future__ import annotations

from typing import Tuple

import torch

TF32_DROPPED_BITS = 13  # float32 mantissa bits TF32 does not keep
_HALF = 1 << (TF32_DROPPED_BITS - 1)
_MASK = -(1 << TF32_DROPPED_BITS)  # ~0x1fff as a signed 32-bit integer


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (to nearest, ties away from zero), as
    float32 values whose low 13 mantissa bits are zero."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + _HALF) & _MASK).view(torch.float32)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of float32 ``x``: hi = tf32(x), lo = x − hi (exact, so hi +
    lo == x); the kernels' operands are hi and ``tf32_round(lo)``."""
    x = x.to(torch.float32)
    hi = tf32_round(x)
    return hi, x - hi


def tf32_operands(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The float32 kernels' weight operands of float32 ``w``: (hi,
    tf32_round(lo)), each contiguous in ``w``'s logical order.

    Kept on the tensor whose memory ``w`` views (``w._base``, else ``w``),
    keyed by the view, and reused while that tensor is unmodified (its
    ``_version``), so a walk splits each weight once per parameter tree and
    the pair lives as long as the weights: a Detector program's warm-up
    forward fills it before the capture, and the captured graph reads the
    same pair at every replay. An inference tensor (no version counter) is
    split anew at every call."""
    if w.is_inference():
        hi, lo = split_tf32(w)
        return hi, tf32_round(lo)
    root = w if w._base is None else w._base
    key = (w.data_ptr(), tuple(w.shape), tuple(w.stride()))
    cache = getattr(root, "_tf32_operands", None)
    if cache is None:
        cache = root._tf32_operands = {}
    hit = cache.get(key)
    if hit is None or hit[0] != root._version:
        hi, lo = split_tf32(w)
        hit = cache[key] = (root._version, hi, tf32_round(lo))
    return hit[1], hit[2]
