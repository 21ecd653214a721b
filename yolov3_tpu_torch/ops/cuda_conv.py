"""K5: fused 3×3 / stride-1 SAME conv + bias + LeakyReLU or linear — CUDA
wrapper and its plain version.

Port of ``yolov3_tpu/ops/pallas_conv.py :: conv3x3_fused_roll2``, the
kernel behind ``conv_impl="pallas"``; its twins ``conv3x3_fused_roll`` and
``conv3x3_fused`` compute the same function with other TPU layouts and map
onto the same kernel (``csrc/conv3x3.cu``): for bfloat16 operands an
implicit GEMM on the tensor cores (``wgmma``, ``csrc/conv3x3_mma.cuh``, tiled
by :func:`plan_tiles`), for float32 operands a CUDA-core kernel (TF32 would
miss the float32 bar). Eligible convs (:func:`supported`, the JAX package's
predicate) go through it; every other conv stays on ``F.conv2d``.

Layouts are the port's: ``x`` NHWC (B, H, W, Cin) with channel stride 1 —
the ``permute(0, 2, 3, 1)`` view of a channels_last activation, read in
place — and ``w`` the OIHW weight buffer in channels_last memory, i.e.
(Cout, 3, 3, Cin) contiguous. The result is a contiguous NHWC tensor in
``x``'s type: float32 accumulation, one rounding at the store.

For a CUDA tensor :func:`conv3x3_fused` launches the kernel on the current
stream (counted in ``conv3x3_fused.launches``) or raises; for a CPU tensor,
and only then, it runs :func:`conv3x3_fused_reference`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..precision import tf32
from ._build import check_launch, load_kernels, sm_count

ACTIVATIONS = ("leaky", "linear")
CIN_MULTIPLE = 128
BLOCK_N = 128  # output channels of a tile of the tensor-core kernel


def plan_tiles(m: int, n: int, sm_count: int) -> int:
    """Rows of the bf16 kernel's output tiles (``block_m`` x 128, grid
    ceil(M / block_m) x ceil(N / 128); ``csrc/conv3x3_mma.cuh``) for M =
    B·H·W pixels and N = Cout channels on a card with ``sm_count``
    multiprocessors: 64 or 128.

    128 x 128 tiles, two warpgroups a block, move the fewest bytes per
    product. 64 x 128 tiles pay only while each of them gets a
    multiprocessor of its own: then halving the tile halves the time. With
    more tiles than that the busiest multiprocessor does the same work
    either way and the small tile re-reads the weights twice as often
    (measured at yolov3@416's 13 x 13 layers, B = 8: 88 tiles of 128 rows
    beat 176 of 64, ``PERF.md``)."""
    return 64 if -(-m // 64) * -(-n // BLOCK_N) <= sm_count else 128


def supported(node_size: int, node_stride: int, c_in: int,
              activation: str) -> bool:
    """Eligibility, the JAX package's ``pallas_conv.supported``: 3×3
    stride-1 convs with Cin % 128 == 0 and a leaky or linear activation
    (callers also require SAME padding, ``node.pad``)."""
    return (node_size == 3 and node_stride == 1 and c_in % CIN_MULTIPLE == 0
            and activation in ACTIVATIONS)


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           activation: str) -> None:
    if x.dim() != 4 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be NHWC (B, H, W, Cin) float32 or bfloat16, "
                         f"got {tuple(x.shape)} {x.dtype}")
    cin = x.shape[3]
    if w.dim() != 4 or w.shape[1:] != (cin, 3, 3):
        raise ValueError(f"w must be OIHW (Cout, {cin}, 3, 3), got {tuple(w.shape)}")
    if b.shape != (w.shape[0],):
        raise ValueError(f"bias must be ({w.shape[0]},), got {tuple(b.shape)}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {ACTIVATIONS}, got {activation!r}")


def conv3x3_fused_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                            activation: str = "leaky") -> torch.Tensor:
    """Plain PyTorch K5: ``F.conv2d`` in float32 on the float32 values of x
    and w (TF32 off), plus the bias and the activation, rounded once to x's
    type → NHWC (B, H, W, Cout) contiguous."""
    _check(x, w, b, activation)
    with tf32(False):
        y = F.conv2d(x.permute(0, 3, 1, 2).float(), w.float(), padding=1)
    y = y + b.float()[None, :, None, None]
    if activation == "leaky":
        y = F.leaky_relu(y, 0.1)
    return y.to(x.dtype).permute(0, 2, 3, 1).contiguous()


def _check_layout(x: torch.Tensor, w_ohwi: torch.Tensor) -> None:
    """What the kernels read in place: ``x`` NHWC with channel stride 1 and
    rows that start on 16-byte boundaries, ``w_ohwi`` (Cout, 3, 3, Cin)
    contiguous."""
    if not w_ohwi.is_contiguous():
        raise ValueError("K5 needs channels_last OIHW weights ((Cout, 3, 3, "
                         "Cin) contiguous in memory)")
    # rows are read in 16-byte pieces: 4 float32 or 8 bfloat16 elements
    row_multiple = 16 // x.element_size()
    if (x.stride(3) != 1 or any(s % row_multiple for s in x.stride()[:3])
            or x.data_ptr() % 16 or w_ohwi.data_ptr() % 16):
        raise ValueError(f"K5 needs an NHWC {x.dtype} input with channel "
                         f"stride 1, batch / row / pixel strides that are "
                         f"multiples of {row_multiple} elements and 16-byte "
                         f"aligned x and w, got strides {tuple(x.stride())}")


def conv3x3_fused(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  activation: str = "leaky") -> torch.Tensor:
    """3×3 / s1 SAME conv + bias + activation of NHWC ``x`` with OIHW
    ``w`` (cast to x's type, as the JAX package casts: a weight of another
    type costs a copy per call) → NHWC output in x's type. The bias is read
    as it is when float32 or bfloat16. Cin must be a multiple of 128 on the
    card (:func:`supported`).

    CUDA tensor: launches K5 on the current stream or raises. CPU tensor:
    the plain version."""
    _check(x, w, b, activation)
    if x.device.type == "cpu":
        return conv3x3_fused_reference(x, w, b, activation)
    if x.device.type != "cuda":
        raise ValueError(f"K5 runs on CUDA or CPU tensors, got {x.device}")
    bsz, h, wd, cin = x.shape
    cout = w.shape[0]
    if cin % CIN_MULTIPLE:
        raise ValueError(f"K5 needs Cin % {CIN_MULTIPLE} == 0, got {cin}")
    w_ohwi = w.to(x.dtype).permute(0, 2, 3, 1)  # (Cout, 3, 3, Cin) memory
    # the kernel reads a float32 or bf16 bias as it is
    bias = (b if b.dtype in (torch.float32, torch.bfloat16) else b.float()
            ).contiguous()
    _check_layout(x, w_ohwi)
    if not (x.device == w_ohwi.device == bias.device):
        raise ValueError("K5 needs x, w and b on one device")
    is_bf16 = x.dtype == torch.bfloat16
    block_m = 0  # the float32 kernel's tiles are fixed
    if is_bf16:
        block_m = plan_tiles(bsz * h * wd, cout, sm_count(x.get_device()))
    y = torch.empty((bsz, h, wd, cout), dtype=x.dtype, device=x.device)
    lib = load_kernels()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.yolo_conv3x3_fused(
            x.data_ptr(), x.stride(0), x.stride(1), x.stride(2), int(is_bf16),
            w_ohwi.data_ptr(), bias.data_ptr(),
            int(bias.dtype == torch.bfloat16), bsz, h, wd, cin, cout,
            int(activation == "leaky"), block_m, y.data_ptr(), stream)
    check_launch(rc, "conv3x3_fused")
    conv3x3_fused.launches += 1
    return y


conv3x3_fused.launches = 0
