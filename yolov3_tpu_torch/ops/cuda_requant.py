"""The int8 walk's requantize pass: an int8 conv's int32 sums to its next
activation in one pass — CUDA wrapper and its plain version.

``int8_requant(acc, scale, b, activation, out_dtype, s_out, shortcut)``
computes, over the int32 NHWC sums ``acc`` (B, H, W, C) of one int8 conv
(``ops/int8_conv.conv_int8``: dense, or rows of C channels a padded N
apart), ``act(float(acc) · scale + b)`` with ``scale`` the conv's
per-channel dequantize scale (``quant.Operands.dequant_scale``), ``b`` its
bias and ``act`` its activation; with a :class:`Shortcut` (the shortcut right after the conv,
``model.residual_convs``, whose other input is int8) it then forms the
conv's int8 output ``q3`` at the conv's own scale in registers and adds the
shortcut, ``act2(q3 · s3 + qr · sr)``. The result is int8 at ``s_out``
(``out_dtype`` int8: every consumer reads int8) or the float carrier
(bf16 / float32). It replaces no TPU kernel (XLA fused this epilogue into the
conv); on the card it replaces the chain of float32 passes the walk ran
after ``torch._int_mm`` — the cast, the scale, the bias, ``F.leaky_relu``,
the quantize (scale, round, clamp, cast), and for a shortcut both operands'
dequantize, the add and one more quantize — by one read of ``acc`` (and
``qr``) and one write (``csrc/int8_requant.cu``), rounding at the same
points, so bit for bit the same result.

Where :func:`supported` takes the operands, :func:`int8_requant` launches
``int8_requant_kernel`` (``int8_requant_mish_kernel`` where an activation
is mish) on the current stream into a new tensor (counted in
``int8_requant.launches``, and in ``int8_requant.residual_launches`` when it
took a shortcut); anywhere else it raises. In the symmetric scheme
``quant.forward_features_int8_carrier`` hands every quantized conv but the
stem to :func:`int8_requant` on the card and to
:func:`int8_requant_reference`, the chain as one function, on the CPU; the
asymmetric scheme runs the chain with its zero-point terms itself.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ._build import check_launch, load_kernels
from .cuda_epilogue import activate

ACTIVATIONS = ("linear", "leaky", "relu", "mish")       # RQ_LINEAR, ...
OUT_DTYPES = (torch.int8, torch.bfloat16, torch.float32)  # RQ_INT8, ...
THREADS = 256            # RQ_THREADS: the most threads a block
VEC = 8                  # RQ_VEC: channels a thread on the vector path
GRID_Y_MAX = 65535
MAX_ELEMENTS = 2 ** 62   # RQ_MAX_ELEMENTS: 64-bit indexes with a row stride


class Shortcut(NamedTuple):
    """The shortcut right after the conv, taken over by the pass."""
    q: torch.Tensor      # its other input: int8 NHWC of the sums' shape
    scale: float         # q's scale
    conv_scale: float    # the conv's own output scale, s3 (q3's)
    activation: str      # the shortcut's activation


def _to_int8(f: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(f), -127, 127).to(torch.int8)


def int8_requant_reference(acc: torch.Tensor, scale: torch.Tensor,
                           b: torch.Tensor, activation: str,
                           out_dtype: torch.dtype,
                           s_out: Optional[float] = None,
                           shortcut: Optional[Shortcut] = None
                           ) -> torch.Tensor:
    """Plain PyTorch: the chain the kernel replaces, each step a float32
    tensor rounded where the walk's passes round; ``1 / s`` a double
    rounded once to float32 by the scalar product. Returns a new tensor."""
    y = activate(acc.float() * scale + b, activation)
    if shortcut is not None:
        q3 = _to_int8(y * (1.0 / shortcut.conv_scale))
        y = activate(q3.float() * shortcut.conv_scale
                     + shortcut.q.float() * shortcut.scale,
                     shortcut.activation)
    if out_dtype == torch.int8:
        return _to_int8(y * (1.0 / s_out))
    return y.to(out_dtype)


def row_stride(acc: torch.Tensor) -> Optional[int]:
    """The elements between one pixel's C sums and the next's where ``acc``
    (B, H, W, C) is rows of C channels at one stride (C for a dense tensor,
    a padded N for ``conv_int8``'s slice of ``_int_mm``'s output), else
    None."""
    if acc.dim() != 4 or acc.numel() == 0:
        return None
    c = acc.shape[3]
    if c > 1 and acc.stride(3) != 1:
        return None
    try:
        rows = acc.view(-1, c)
    except RuntimeError:  # the pixels do not lie at one stride
        return None
    lda = rows.stride(0) if rows.shape[0] > 1 else c
    return lda if lda >= c else None


def supported(acc: torch.Tensor, activation: str,
              shortcut: Optional[Shortcut] = None) -> bool:
    """Where the kernel runs: ``acc`` a non-empty (B, H, W, C) int32 CUDA
    tensor of rows at one stride (:func:`row_stride`), an activation of
    :data:`ACTIVATIONS`, and a shortcut, if any, int8 of acc's shape on its
    device, dense, with an activation of :data:`ACTIVATIONS`."""
    if not (acc.device.type == "cuda" and acc.dtype == torch.int32
            and row_stride(acc) is not None and activation in ACTIVATIONS):
        return False
    if shortcut is None:
        return True
    q = shortcut.q
    return (q.dtype == torch.int8 and q.shape == acc.shape
            and q.device == acc.device and q.is_contiguous()
            and shortcut.activation in ACTIVATIONS)


class RequantPlan(NamedTuple):
    """The grid of a launch (``int8_requant_kernel``)."""
    grid: Tuple[int, int]     # (chunks of threads_x pieces, runs of rows)
    threads: Tuple[int, int]  # (pieces of a row, rows)
    vec: bool                 # 8-channel pieces; else one element a thread


def plan_int8_requant(rows: int, c: int, aligned: bool = True
                      ) -> RequantPlan:
    """The grid for ``rows`` pixels of ``c`` channels. A piece is 8
    channels (two 16-byte loads of int32, one 8-byte int8 store) where C is
    a multiple of 8 and the tensors and the sums' rows lie on the 16-byte
    grid (``aligned``), else one element. A block's x covers a row's pieces (up to
    :data:`THREADS`), its y the rows that fill the rest of :data:`THREADS`;
    grid x the chunks of a wider row, grid y one row a thread up to the
    grid's limit and a stride past it. yolov3@608, B = 32: 304x304x32 is 4
    pieces a pixel, 64 pixels a block, 46,208 blocks; 304x304x64 reaches
    the grid's 65,535 rows of blocks; 19x19x1024 is 128 pieces, 2 pixels a
    block, 5,776 blocks."""
    if rows < 1 or c < 1:
        raise ValueError(f"the requantize pass needs rows and channels, got "
                         f"{(rows, c)}")
    if rows * c > MAX_ELEMENTS:
        raise ValueError(f"the requantize pass: {rows * c} elements, past "
                         f"the 2^62 its 64-bit indexes take")
    vec = aligned and c % VEC == 0
    pieces = c // VEC if vec else c
    tx = min(pieces, THREADS)
    ty = THREADS // tx
    grid_y = max(1, min(-(-rows // ty), GRID_Y_MAX))
    return RequantPlan((-(-pieces // tx), grid_y), (tx, ty), vec)


def _f32(x: float) -> float:
    """A Python double rounded once to float32, as PyTorch rounds a scalar
    operand of a float32 product."""
    return float(np.float32(x))


def _check(acc, scale, b, activation, out_dtype, s_out, shortcut) -> None:
    if not supported(acc, activation, shortcut):
        sc = None if shortcut is None else (
            tuple(shortcut.q.shape), shortcut.q.dtype,
            tuple(shortcut.q.stride()), shortcut.activation)
        raise ValueError(f"the requantize kernel needs NHWC int32 CUDA sums "
                         f"in rows at one stride, an activation of "
                         f"{ACTIVATIONS} and a dense int8 shortcut of their "
                         f"shape, got sums {tuple(acc.shape)} "
                         f"{acc.dtype} strides {tuple(acc.stride())} on "
                         f"{acc.device}, activation {activation!r}, "
                         f"shortcut {sc}")
    c = acc.shape[3]
    for name, t in (("scale", scale), ("b", b)):
        if (t.shape != (c,) or t.dtype != torch.float32
                or t.device != acc.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({c},) float32 on "
                             f"{acc.device}, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {OUT_DTYPES}, got "
                         f"{out_dtype}")
    if out_dtype == torch.int8 and not (s_out and s_out > 0):
        raise ValueError(f"an int8 output needs its scale, got {s_out!r}")


def int8_requant(acc: torch.Tensor, scale: torch.Tensor, b: torch.Tensor,
                 activation: str, out_dtype: torch.dtype,
                 s_out: Optional[float] = None,
                 shortcut: Optional[Shortcut] = None) -> torch.Tensor:
    """:func:`int8_requant_reference` as one pass: the NHWC output of
    ``out_dtype`` (int8 at ``s_out``, or bf16 / float32).

    Launches the kernel on the current stream into a new tensor and returns
    it; raises unless :func:`supported` takes the operands."""
    _check(acc, scale, b, activation, out_dtype, s_out, shortcut)
    out = torch.empty(acc.shape, dtype=out_dtype, device=acc.device)
    c, lda = acc.shape[3], row_stride(acc)
    rows = acc.numel() // c
    qr = None if shortcut is None else shortcut.q
    aligned = lda % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (acc, scale, b, out, qr)
        if t is not None)
    plan = plan_int8_requant(rows, c, aligned)
    inv_out = _f32(1.0 / s_out) if out_dtype == torch.int8 else 0.0
    s3 = inv_s3 = sr = 0.0
    if shortcut is not None:
        s3, inv_s3 = (_f32(shortcut.conv_scale),
                      _f32(1.0 / shortcut.conv_scale))
        sr = _f32(shortcut.scale)
    with torch.cuda.device(acc.device):
        rc = load_kernels().yolo_int8_requant(
            acc.data_ptr(), scale.data_ptr(), b.data_ptr(),
            None if qr is None else qr.data_ptr(), out.data_ptr(),
            rows, c, lda, OUT_DTYPES.index(out_dtype),
            ACTIVATIONS.index(activation),
            ACTIVATIONS.index(shortcut.activation) if shortcut else 0,
            inv_out, s3, inv_s3, sr, int(plan.vec), *plan.threads,
            *plan.grid, torch.cuda.current_stream(acc.device).cuda_stream)
    check_launch(rc, "int8_requant")
    int8_requant.launches += 1
    int8_requant.residual_launches += shortcut is not None
    return out


int8_requant.launches = 0
int8_requant.residual_launches = 0
