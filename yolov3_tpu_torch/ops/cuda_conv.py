"""K5: fused 3×3 / stride-1 SAME conv + bias + LeakyReLU or linear — CUDA
wrapper and its plain version.

Port of ``yolov3_tpu/ops/pallas_conv.py :: conv3x3_fused_roll2``, the
kernel behind ``conv_impl="pallas"``; its twins ``conv3x3_fused_roll`` and
``conv3x3_fused`` compute the same function with other TPU layouts and map
onto the same kernel (``csrc/conv3x3.cu``). Eligible convs (:func:`supported`,
the JAX package's predicate) go through it; every other conv stays on
``F.conv2d``.

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
from ._build import check_launch, load_kernels

ACTIVATIONS = ("leaky", "linear")
CIN_MULTIPLE = 128


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


def conv3x3_fused(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  activation: str = "leaky") -> torch.Tensor:
    """3×3 / s1 SAME conv + bias + activation of NHWC ``x`` with OIHW
    ``w`` (cast to x's type, as the JAX package casts) → NHWC output in x's
    type. Cin must be a multiple of 128 on the card (:func:`supported`).

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
    if not w_ohwi.is_contiguous():
        raise ValueError("K5 needs channels_last OIHW weights ((Cout, 3, 3, "
                         "Cin) contiguous in memory)")
    bias = b.float().contiguous()
    strides = x.stride()
    if (x.stride(3) != 1 or any(s % 4 for s in strides[:3])
            or x.data_ptr() % 16 or w_ohwi.data_ptr() % 16):
        raise ValueError("K5 needs an NHWC input with channel stride 1, "
                         "row strides that are multiples of 4 elements and "
                         "16-byte aligned x and w")
    if not (x.device == w_ohwi.device == bias.device):
        raise ValueError("K5 needs x, w and b on one device")
    y = torch.empty((bsz, h, wd, cout), dtype=x.dtype, device=x.device)
    lib = load_kernels()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.yolo_conv3x3_fused(
            x.data_ptr(), strides[0], strides[1], strides[2],
            int(x.dtype == torch.bfloat16), w_ohwi.data_ptr(), bias.data_ptr(),
            bsz, h, wd, cin, cout, int(activation == "leaky"), y.data_ptr(),
            stream)
    check_launch(rc, "conv3x3_fused")
    conv3x3_fused.launches += 1
    return y


conv3x3_fused.launches = 0
