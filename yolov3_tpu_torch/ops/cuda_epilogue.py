"""The float walk's conv epilogue: bias, activation and the shortcut's add
over a cuDNN conv's output in one pass — CUDA wrapper and its plain version.

``conv_epilogue(y, b, activation, residual, residual_activation)`` computes
``act2(act1(y + b) + r)`` over the NHWC output ``y`` (B, H, W, C) of one
conv: ``b`` the conv's bias, ``act1`` its activation, ``r`` the other input
of a shortcut right after the conv (``model.residual_convs``) and ``act2``
the shortcut's activation; without ``r`` it stops after ``act1``. It replaces
no TPU kernel (XLA fused this epilogue into the conv); on the card it
replaces PyTorch's three passes after a cuDNN conv — the broadcast bias add,
``F.leaky_relu`` and the shortcut's add — by one read of ``y`` (and ``r``)
and one write (``csrc/conv_epilogue.cu``), rounding at the same points, so
bit for bit the same result in bf16 and in float32.

Where :func:`supported` takes the operands, :func:`conv_epilogue` launches
the kernel on the current stream and writes the result into ``y`` (counted
in ``conv_epilogue.launches``, and in ``conv_epilogue.residual_launches``
when it took a residual); anywhere else it raises. On the CPU
``model._conv`` runs :func:`conv_epilogue_reference` instead.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ._build import check_launch, load_kernels

ACTIVATIONS = ("linear", "leaky", "relu")  # CE_LINEAR, CE_LEAKY, CE_RELU
DTYPES = (torch.float32, torch.bfloat16)
THREADS = 256            # CE_THREADS: the most threads a block
GRID_Y_MAX = 65535
MAX_ELEMENTS = 2 ** 62   # CE_MAX_ELEMENTS: 64-bit indexes with a row stride


def activate(y: torch.Tensor, activation: str) -> torch.Tensor:
    """A darknet activation in PyTorch: leaky (0.1), relu or linear."""
    if activation == "leaky":
        return F.leaky_relu(y, 0.1)
    if activation == "relu":
        return F.relu(y)
    if activation != "linear":
        raise ValueError(f"unsupported activation {activation!r}")
    return y


def conv_epilogue_reference(y: torch.Tensor, b: Optional[torch.Tensor],
                            activation: str = "leaky",
                            residual: Optional[torch.Tensor] = None,
                            residual_activation: str = "linear"
                            ) -> torch.Tensor:
    """Plain PyTorch: the chain the kernel replaces, ``y + b`` (skipped when
    ``b`` is None: a conv that added its bias itself), the activation, then
    ``+ residual`` and the residual's activation, each rounded to y's type.
    Returns a new tensor."""
    if b is not None:
        y = y + b
    y = activate(y, activation)
    if residual is None:
        return y
    return activate(y + residual, residual_activation)


def supported(y: torch.Tensor, residual: Optional[torch.Tensor] = None
              ) -> bool:
    """Where the kernel runs: ``y`` a non-empty CUDA tensor of bf16 or
    float32, NHWC (B, H, W, C) and dense (``is_contiguous``: cuDNN's
    channels_last output viewed ``permute(0, 2, 3, 1)``), and a residual,
    if any, of y's shape, type and device, dense too."""
    if not (y.device.type == "cuda" and y.dtype in DTYPES and y.dim() == 4
            and y.numel() > 0 and y.is_contiguous()):
        return False
    return residual is None or (
        residual.shape == y.shape and residual.dtype == y.dtype
        and residual.device == y.device and residual.is_contiguous())


class ConvEpiloguePlan(NamedTuple):
    """The grid of a launch (``conv_epilogue_kernel``)."""
    grid: Tuple[int, int]     # (chunks of threads_x pieces, runs of rows)
    threads: Tuple[int, int]  # (pieces of a row, rows)
    vec: bool                 # 16-byte pieces; else one element a thread


def plan_conv_epilogue(rows: int, c: int, elem_size: int,
                       aligned: bool = True) -> ConvEpiloguePlan:
    """The grid for ``rows`` pixels of ``c`` channels of ``elem_size``
    bytes. A piece is 16 bytes (8 bf16, 4 float32 channels) where C is a
    multiple of it and the operands lie on the 16-byte grid (``aligned``),
    else one element. A block's x covers a row's pieces (up to
    :data:`THREADS`), its y the rows that fill the rest of :data:`THREADS`;
    grid x the chunks of a wider row, grid y one row a thread up to the
    grid's limit and a stride past it. yolov3@608, B = 32: the stem's 32
    bf16 channels are 4 pieces, 64 rows a block, 65,535 blocks; the
    255-channel heads one element a thread, 255 a block."""
    if rows < 1 or c < 1:
        raise ValueError(f"the epilogue needs rows and channels, got "
                         f"{(rows, c)}")
    if rows * c > MAX_ELEMENTS:
        raise ValueError(f"the epilogue: {rows * c} elements, past the "
                         f"2^62 its 64-bit indexes take")
    per_piece = 16 // elem_size
    vec = aligned and c % per_piece == 0
    pieces = c // per_piece if vec else c
    tx = min(pieces, THREADS)
    ty = THREADS // tx
    grid_y = max(1, min(-(-rows // ty), GRID_Y_MAX))
    return ConvEpiloguePlan((-(-pieces // tx), grid_y), (tx, ty), vec)


def _check(y: torch.Tensor, b: torch.Tensor, activation: str,
           residual: Optional[torch.Tensor], residual_activation: str) -> None:
    if not supported(y, residual):
        r = None if residual is None else (tuple(residual.shape),
                                           residual.dtype,
                                           tuple(residual.stride()))
        raise ValueError(f"the epilogue kernel needs a dense NHWC CUDA y of "
                         f"float32 or bfloat16 and a residual like it, got y "
                         f"{tuple(y.shape)} {y.dtype} strides "
                         f"{tuple(y.stride())} on {y.device}, residual {r}")
    if (b.shape != (y.shape[3],) or b.dtype != y.dtype or b.device != y.device
            or not b.is_contiguous()):
        raise ValueError(f"bias must be a contiguous ({y.shape[3]},) "
                         f"{y.dtype} on {y.device}, got {tuple(b.shape)} "
                         f"{b.dtype} on {b.device}")
    for act in (activation, residual_activation):
        if act not in ACTIVATIONS:
            raise ValueError(f"activation must be one of {ACTIVATIONS}, got "
                             f"{act!r}")


def conv_epilogue(y: torch.Tensor, b: torch.Tensor, activation: str = "leaky",
                  residual: Optional[torch.Tensor] = None,
                  residual_activation: str = "linear") -> torch.Tensor:
    """``act2(act1(y + b) + residual)`` over NHWC ``y`` (without
    ``residual``: ``act1(y + b)``); ``b`` (C,) and ``residual`` of y's type.

    Launches the kernel on the current stream, in place, and returns
    ``y``; raises unless :func:`supported` takes ``y`` and ``residual``."""
    _check(y, b, activation, residual, residual_activation)
    c = y.shape[3]
    aligned = all(t.data_ptr() % 16 == 0 for t in (y, residual)
                  if t is not None)
    plan = plan_conv_epilogue(y.numel() // c, c, y.element_size(), aligned)
    with torch.cuda.device(y.device):
        rc = load_kernels().yolo_conv_epilogue(
            y.data_ptr(), b.data_ptr(),
            None if residual is None else residual.data_ptr(),
            y.numel() // c, c, int(y.dtype == torch.bfloat16),
            ACTIVATIONS.index(activation),
            ACTIVATIONS.index(residual_activation), int(plan.vec),
            *plan.threads, *plan.grid,
            torch.cuda.current_stream(y.device).cuda_stream)
    check_launch(rc, "conv_epilogue")
    conv_epilogue.launches += 1
    conv_epilogue.residual_launches += residual is not None
    return y


conv_epilogue.launches = 0
conv_epilogue.residual_launches = 0
