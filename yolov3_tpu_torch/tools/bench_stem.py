"""Microbenchmark: the yolov3 stem (conv1 3->32 + conv2 32->64 s2) on the
card, against its space-to-depth (s2d) reformulations.

Port of ``tools/bench_stem.py``. conv1 reads 3 channels (K = 27 products
an output) and writes the walk's widest activation, the costliest single
layer of the bf16 walk at 416 (``PERF.md`` §5). The s2d forms trade the
thin-Cin conv for a denser one:

  conv1_s2d: input (B, S/2, S/2, 12) [2x2 blocks], 3x3 conv →
             (B, S/2, S/2, 128) = the four H/W phases of conv1's output,
             channel-blocked; K = 9·12 = 108 (against 27); the output IS
             y1 in s2d layout.
  conv2_s2d: 2x2 conv over y1-s2d, K = 4·128 = 512, N = 64; taps (0, +1)
             on the S/2 grid cover conv2's 3x3/s2 receptive field exactly.

The rearranged weights (:func:`conv1_s2d_weights`, :func:`conv2_s2d_weights`,
numpy, bit-equal to the reference's) are exact rearrangements of the
originals, zero-filled where a tap falls outside the 3x3 support. Parity
against the naive stem is asserted before any timing. Then conv1 and the
whole stem are timed naive (cuDNN) and in s2d form (the rearrangement of
the input included), as device time by CUDA graph replay, at bf16 and at
float32 with TF32 off. No kernel of the port's runs here: this is what a
stem kernel would start from::

    python -m yolov3_tpu_torch.tools.bench_stem [--batch 8] [--size 416] \\
        [--dtype bf16|f32] [--device cuda|cuda:N|cpu]

``--device cpu`` checks parity only (no device clock there).
"""
from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
# max |s2d - naive| / max |naive| allowed before timing: the reference's
# 2e-2 at bf16 (its outputs round differently), float32 sums in another
# order otherwise
PARITY_REL = {"bf16": 2e-2, "f32": 1e-5}


def leaky(y):
    return F.leaky_relu(y, 0.1)


def conv(x, w, b, stride=1, crop=False):
    """Conv + bias + leaky of NHWC ``x`` (a channels_last NCHW view) with
    OIHW ``w`` in ``x``'s type, padded by 1 on every side; ``crop`` drops
    the last output row and column (the same as a pad of one low only)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=stride, padding=1)
    if crop:
        y = y[:, :, :-1, :-1]
    return leaky(y).permute(0, 2, 3, 1)


def s2d(x):
    """(B, H, W, C) -> (B, H/2, W/2, 4C); channel order (ph, pw, c)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)
    return x.transpose(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)


def s2d_torch(x: torch.Tensor) -> torch.Tensor:
    """:func:`s2d` on a tensor (``permute`` for numpy's ``transpose``)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)


def conv1_s2d_weights(w1):
    """(3,3,3,32) -> (3,3,12,128) computing all four phases of conv1 on the
    s2d input. Output channel block (ph, pw, co); input channel (ih, iw, ci).

    Phase (ph, pw) of y1 at s2d cell (H', W') is y1[2H'+ph, 2W'+pw] =
    sum_{dh,dw} w1[dh,dw] * in[2H'+ph+dh-1, 2W'+pw+dw-1]. Input pixel
    (2H'+ph+dh-1) lives at s2d cell H'+ (ph+dh-1)//2, phase (ph+dh-1)%2 —
    cells H'-1..H'+1, i.e. a 3x3 s2d conv with ~half the taps zero.
    """
    w = np.zeros((3, 3, 12, 128), np.float32)
    w1 = np.asarray(w1, np.float32)
    for ph in range(2):
        for pw in range(2):
            for dh in range(3):
                for dw in range(3):
                    # pixel offset o = ph+dh-1 in -1..2 -> s2d cell
                    # floor(o/2) in -1..1 (kernel tap sh = cell+1), phase
                    # o mod 2; divmod(o+2, 2) = (cell+1, phase) directly
                    sh, ih = divmod(ph + dh - 1 + 2, 2)
                    sw, iw = divmod(pw + dw - 1 + 2, 2)
                    for ci in range(3):
                        w[sh, sw, (ih * 2 + iw) * 3 + ci,
                          (ph * 2 + pw) * 32:(ph * 2 + pw + 1) * 32] += \
                            w1[dh, dw, ci]
    return w


def conv2_s2d_weights(w2):
    """(3,3,32,64) -> (2,2,128,64): conv2 (s2) over y1-s2d.

    conv2 out[h,w] = sum_{dh,dw} w2[dh,dw] * y1[2h+dh-1, 2w+dw-1]; the y1
    rows 2h-1, 2h, 2h+1 live at s2d cells h-1 (phase 1), h (phase 0) and
    h (phase 1). A 2x2 conv over cells {h-1, h}, padded by one cell low
    only, covers them.
    """
    w = np.zeros((2, 2, 128, 64), np.float32)
    w2 = np.asarray(w2, np.float32)
    for dh in range(3):
        for dw in range(3):
            ch, ph = divmod(dh - 1 + 2, 2)  # cell offset in {0,1}, phase
            cw, pw = divmod(dw - 1 + 2, 2)
            for ci in range(32):
                w[ch, cw, (ph * 2 + pw) * 32 + ci] += w2[dh, dw, ci]
    return w


def stem_weights(seed: int = 0) -> Dict[str, np.ndarray]:
    """Seeded stem weights (HWIO) at the reference tool's scales, float32."""
    rng = np.random.default_rng(seed)
    out = {"w1": rng.normal(0, 0.2, (3, 3, 3, 32)),
           "b1": rng.normal(0, 0.1, (32,)),
           "w2": rng.normal(0, 0.08, (3, 3, 32, 64)),
           "b2": rng.normal(0, 0.1, (64,))}
    return {k: v.astype(np.float32) for k, v in out.items()}


def stem_forms(p: Dict[str, np.ndarray], device, dtype: torch.dtype
               ) -> Dict[str, Callable]:
    """The four timed functions of an NHWC input of ``dtype``: conv1 and
    the stem, each naive and in s2d form (the input's rearrangement
    included); weights cast once, here."""
    def oihw(hwio):
        w = torch.from_numpy(hwio).permute(3, 2, 0, 1).to(device, dtype)
        return w.contiguous(memory_format=torch.channels_last)

    def vec(v):
        return torch.from_numpy(v).to(device, dtype)

    w1, w2 = oihw(p["w1"]), oihw(p["w2"])
    w1s, w2s = oihw(conv1_s2d_weights(p["w1"])), oihw(conv2_s2d_weights(p["w2"]))
    b1, b2, b1s = vec(p["b1"]), vec(p["b2"]), vec(np.tile(p["b1"], 4))

    def conv1(x):
        return conv(x, w1, b1)

    def conv1_s2d(x):
        return conv(s2d_torch(x), w1s, b1s)   # (B, S/2, S/2, 128) = y1 phases

    def stem(x):
        return conv(conv1(x), w2, b2, stride=2)

    def stem_s2d(x):
        # the 2x2 conv over cells {h-1, h}: one cell of pad low only
        return conv(conv1_s2d(x), w2s, b2, crop=True)

    return {"conv1": conv1, "conv1_s2d": conv1_s2d, "stem": stem,
            "stem_s2d": stem_s2d}


def parity(forms: Dict[str, Callable], x: torch.Tensor) -> float:
    """max |stem_s2d - stem| / max |stem| on ``x``."""
    with torch.inference_mode():
        ref = forms["stem"](x).float()
        out = forms["stem_s2d"](x).float()
    return float((out - ref).abs().max() / (ref.abs().max() + 1e-6))


def run(size: int, batch: int, dtype: str, device, seed: int = 0,
        iters: int = 10) -> dict:
    """Parity, then (on the card) the four forms' device ms by graph
    replay, with TF32 off at float32."""
    from ..precision import tf32

    rng = np.random.default_rng(seed)
    p = stem_weights(seed)
    x = torch.from_numpy(rng.uniform(0, 1, (batch, size, size, 3)).astype(
        np.float32)).to(device, DTYPES[dtype])
    forms = stem_forms(p, device, DTYPES[dtype])
    out: dict = {"size": size, "batch": batch, "dtype": dtype}
    with tf32(False):
        rel = parity(forms, x[:2])
        out["parity_rel"] = rel
        if not rel < PARITY_REL[dtype]:
            raise AssertionError(f"s2d stem diverges at {size} {dtype}: max "
                                 f"rel {rel:.2e} >= {PARITY_REL[dtype]:.0e}")
        ms: Optional[Dict[str, float]] = None
        if x.device.type == "cuda":
            from .clock import graph_ms

            with torch.inference_mode():
                ms = {name: graph_ms(lambda f=f: f(x), iters=iters, reps=3)
                      for name, f in forms.items()}
        out["ms"] = ms
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=416)
    ap.add_argument("--dtype", default="bf16", choices=tuple(DTYPES))
    ap.add_argument("--device", default=None,
                    help="cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)
    from ..__main__ import _resolve_device

    device = _resolve_device(args.device)
    out = run(args.size, args.batch, args.dtype, device)
    out["device"] = ("cpu" if device.type == "cpu"
                     else torch.cuda.get_device_name(device))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
