"""K5: fused 3×3 / stride-1 SAME conv + bias + LeakyReLU or linear — CUDA
wrapper and its plain version.

Port of ``yolov3_tpu/ops/pallas_conv.py :: conv3x3_fused_roll2``, the
kernel behind ``conv_impl="pallas"``; its twins ``conv3x3_fused_roll`` and
``conv3x3_fused`` compute the same function with other TPU layouts and map
onto the same kernels (``csrc/conv3x3.cu``), implicit GEMMs on the tensor
cores (``wgmma``) tiled by :func:`plan_tiles`: for bfloat16 operands
``csrc/conv3x3_mma.cuh``, for float32 operands split TF32 (each operand
split into two TF32 parts, three TF32 products a product: float32 accuracy,
``ops/tf32.py``). Eligible convs (:func:`supported`, the JAX package's
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
from .tf32 import tf32_operands

ACTIVATIONS = ("leaky", "linear")
CIN_MULTIPLE = 128
BLOCK_N = 128  # output channels of a tile of the tensor-core kernel


# float32 (split TF32): a 64-row tile takes this share of a 128-row tile's
# time on a multiprocessor of its own (chip_smoke.py's k5 phase at
# yolov3@416's three layer shapes, one image: 0.56-0.59, PERF.md)
F32_HALF_TILE_COST = 0.57


def plan_tiles(m: int, n: int, sm_count: int, elem_size: int = 2) -> int:
    """Rows of the kernels' output tiles (``block_m`` x 128, grid
    ceil(M / block_m) x ceil(N / 128); ``csrc/conv3x3.cu``) for M = B·H·W
    pixels, N = Cout channels and operands of ``elem_size`` bytes (2: bf16,
    4: float32) on a card with ``sm_count`` multiprocessors: 64 or 128.

    128 x 128 tiles, two warpgroups a block, move the fewest bytes per
    product. bf16: 64 x 128 tiles pay only while each of them gets a
    multiprocessor of its own: then halving the tile halves the time. With
    more tiles than that the busiest multiprocessor does the same work
    either way and the small tile re-reads the weights twice as often
    (measured at yolov3@416's 13 x 13 layers, B = 8: 88 tiles of 128 rows
    beat 176 of 64, ``PERF.md``). float32: a tile's many K steps make its
    time what counts, so the plan compares the waves of tiles each height
    needs, a 64-row tile costing ``F32_HALF_TILE_COST`` of a 128-row one:
    at yolov3@416's 26 x 26 layers, B = 8, three waves of 64-row tiles (340)
    beat two of 128-row tiles (172), as measured."""
    cols = -(-n // BLOCK_N)
    tiles64 = -(-m // 64) * cols
    if elem_size == 2:
        return 64 if tiles64 <= sm_count else 128
    waves64 = -(-tiles64 // sm_count)
    waves128 = -(-(-(-m // 128) * cols) // sm_count)
    return 64 if waves64 * F32_HALF_TILE_COST < waves128 else 128


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
    card (:func:`supported`). At float32 the kernel reads the weights split
    into two TF32 halves, made at the first call and kept on ``w``
    (:func:`~yolov3_tpu_torch.ops.tf32.tf32_operands`).

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
    block_m = plan_tiles(bsz * h * wd, cout, sm_count(x.get_device()),
                         x.element_size())
    w_hi, w_lo = w_ohwi, None  # float32: the weights split once, kept on w
    if not is_bf16:
        w_hi, w_lo = tf32_operands(w_ohwi)
    y = torch.empty((bsz, h, wd, cout), dtype=x.dtype, device=x.device)
    lib = load_kernels()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.yolo_conv3x3_fused(
            x.data_ptr(), x.stride(0), x.stride(1), x.stride(2), int(is_bf16),
            w_hi.data_ptr(), None if w_lo is None else w_lo.data_ptr(),
            bias.data_ptr(), int(bias.dtype == torch.bfloat16), bsz, h, wd,
            cin, cout, int(activation == "leaky"), block_m, y.data_ptr(),
            stream)
    check_launch(rc, "conv3x3_fused")
    conv3x3_fused.launches += 1
    return y


conv3x3_fused.launches = 0
