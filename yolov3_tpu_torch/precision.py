"""Scoped TF32 switch for float32 convolutions and matmuls.

A float32 convolution on the card runs through cuDNN in TF32 unless
``torch.backends.cudnn.allow_tf32`` is False, and a float32 matmul does so
when ``torch.backends.cuda.matmul.allow_tf32`` is True. Both flags are
process-wide, so they are set for the extent of one call and restored
after, never left flipped. Threads that run forward passes with different
precisions at the same time share the flags.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def tf32(allow: bool) -> Iterator[None]:
    """Allow (True) or forbid (False) TF32 in cuDNN convs and cuBLAS matmuls
    inside the block."""
    cudnn = torch.backends.cudnn
    prev_matmul = torch.backends.cuda.matmul.allow_tf32
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=allow):
        torch.backends.cuda.matmul.allow_tf32 = allow
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev_matmul
