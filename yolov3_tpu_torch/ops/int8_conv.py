"""Exact int8 × int8 → int32 convolution of NHWC activations.

The JAX package computes its quantized convs with
``lax.conv_general_dilated(..., preferred_element_type=int32)``, outside any
Pallas kernel, so the port leaves them to a library call as well. Eager
PyTorch has no int8 convolution on CUDA, so the two devices take two forms
of the same integer sum, which agree bit for bit:

* CUDA: im2col (one strided gather of the padded NHWC tensor into
  (B·Ho·Wo, k·k·Cin) rows, columns in (ky, kx, cin) order, the order of an
  HWIO weight's ``reshape(k·k·Cin, Cout)``) and ``torch._int_mm``. The
  weight operand is stored (Cout, K) and passed transposed, the layout
  cuBLASLt's int8 tensor-core kernels take; ``_int_mm`` wants more than 16
  rows and K, N in multiples of 8, so K and N are zero-padded once in the
  operand (the stem's K = 27, a quantized head's N = 255) and short row
  counts per call.
* CPU: ``F.conv2d`` on int32 tensors.

A float32 conv on the int8 values would not do: 9·1024 products of up to
127² pass float32's 24-bit mantissa.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

_INT_MM_MIN_ROWS = 17   # torch._int_mm on CUDA: self.size(0) > 16
_INT_MM_MULTIPLE = 8    # ... and K, N multiples of 8


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def weight_operand(wq: torch.Tensor) -> Dict[str, object]:
    """The run-time form of an HWIO int8 weight on its device: ``mm`` (the
    (K_pad, N_pad) transposed view of a (N_pad, K_pad) contiguous matrix)
    on CUDA, ``i32`` (OIHW int32) on the CPU."""
    if wq.dtype != torch.int8 or wq.dim() != 4 or wq.shape[0] != wq.shape[1]:
        raise ValueError(f"wq must be a square HWIO int8 weight, got "
                         f"{tuple(wq.shape)} {wq.dtype}")
    k, _, cin, cout = wq.shape
    op: Dict[str, object] = {"k": k, "cin": cin, "cout": cout}
    if wq.device.type == "cuda":
        kk = k * k * cin
        mat = torch.zeros((_round_up(cout, _INT_MM_MULTIPLE),
                           _round_up(kk, _INT_MM_MULTIPLE)),
                          dtype=torch.int8, device=wq.device)
        mat[:cout, :kk] = wq.reshape(kk, cout).t()
        op["mm"] = mat.t()
    else:
        op["i32"] = wq.permute(3, 2, 0, 1).to(torch.int32).contiguous()
    return op


def im2col(xq: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """(B, H, W, C) contiguous, already padded → (B·Ho·Wo, k·k·C) rows in
    (ky, kx, c) column order: a view for 1×1 / stride 1, else one copy."""
    b, h, w, c = xq.shape
    ho, wo = (h - k) // stride + 1, (w - k) // stride + 1
    if k == 1 and stride == 1:
        return xq.reshape(b * h * w, c)
    sb, sh, sw, sc = xq.stride()
    win = xq.as_strided((b, ho, wo, k, k, c),
                        (sb, sh * stride, sw * stride, sh, sw, sc))
    return win.reshape(b * ho * wo, k * k * c)


def conv_int8(xq: torch.Tensor, op: Dict[str, object], stride: int, pad: int,
              pad_value: int = 0) -> torch.Tensor:
    """int8 NHWC ``xq`` (B, H, W, Cin) ⊛ the weight of ``op``
    (:func:`weight_operand`) → int32 NHWC (B, Ho, Wo, Cout), exact.
    ``pad`` border pixels hold ``pad_value`` (0, or −128 for the stem's
    exact-u8 input, whose zero is q = −128)."""
    if xq.dtype != torch.int8 or xq.dim() != 4 or xq.shape[3] != op["cin"]:
        raise ValueError(f"xq must be int8 (B, H, W, {op['cin']}), got "
                         f"{tuple(xq.shape)} {xq.dtype}")
    k, cout = op["k"], op["cout"]
    if pad:
        xq = F.pad(xq, (0, 0, pad, pad, pad, pad), value=pad_value)
    xq = xq.contiguous()
    b, h, w, _ = xq.shape
    ho, wo = (h - k) // stride + 1, (w - k) // stride + 1
    if "i32" in op:
        y = F.conv2d(xq.permute(0, 3, 1, 2).to(torch.int32), op["i32"],
                     stride=stride)
        return y.permute(0, 2, 3, 1).contiguous()
    mm = op["mm"]
    cols = im2col(xq, k, stride)
    m, kk = cols.shape
    rows, kpad = max(m, _INT_MM_MIN_ROWS), mm.shape[0]
    if rows != m or kpad != kk:
        cols = F.pad(cols, (0, kpad - kk, 0, rows - m))
    y = torch._int_mm(cols, mm)
    if rows != m or mm.shape[1] != cout:
        y = y[:m, :cout]
    return y.reshape(b, ho, wo, cout)
