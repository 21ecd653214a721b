"""Where K2's, K1's, K3's and T2's time goes: each kernel timed with one
phase stopped.

Builds ``csrc/nms_suppress.cu`` (K2), ``csrc/decode_packed.cu`` (K1, K1c),
``csrc/decode_full.cu`` (K3) and ``csrc/probe.cu`` (T2) again with the
library's own flags and one macro each, into ``build/ablate/phases/``, and
times each build by CUDA graph replay beside the library's:

  K2 phase1   -DK2_SKIP_PHASE2: the conflict bits alone
  K2 phase2   -DK2_SKIP_PHASE1: the greedy walk alone, over the bits that a
              whole call left in the scratch (so its keep mask is right)
  K1 copy     -DK1_SKIP_DECODE: the staging of the cells alone
  K1 decode   -DK1_SKIP_COPY: the decode and the stores, from whatever
              shared memory holds
  K3 nomath   -DK3_SKIP_MATH: staging and stores, the input widened as it is
  K3 nostore  -DK3_SKIP_STORE: staging and decode, nothing stored
  T2 product  -DT2_SKIP_PROJECT: the bare products, no projection

Only times are read from the ablated builds; the library's calls are
checked against their plain versions first. ``chip_smoke.py``'s ``k1``,
``k2``, ``k3`` and ``dots`` phases call :func:`nms_phase_times`,
:func:`decode_phase_times`, :func:`full_decode_phase_times` and
:func:`grid_phase_times` on their own inputs.

Run on a machine with the card: ``python -m yolov3_tpu_torch.tools.ablate_phases``
(K2 at B=8, K = 256, 512 and 1024 on clustered boxes, IoU threshold 0.45;
K1 and K3 on yolov3@416 B=8's three heads, float32 and bf16; T2 at the
tool's shapes).
"""
from __future__ import annotations

import ctypes
import functools
import subprocess
from pathlib import Path
from typing import Dict, Sequence

import numpy as np
import torch

from ..ops import _build, cuda_decode, cuda_nms, cuda_probe
from ..weights import resolve_device
from .clock import graph_ms

OUT_DIR = _build.BUILD_DIR.parent / "ablate" / "phases"
# kernel -> (source, its C entry, {build name: macro})
VARIANTS = {
    "nms": ("nms_suppress.cu", "yolo_nms_suppress",
            {"phase1": "K2_SKIP_PHASE2", "phase2": "K2_SKIP_PHASE1"}),
    "decode": ("decode_packed.cu", "yolo_decode_heads",
               {"copy": "K1_SKIP_DECODE", "decode": "K1_SKIP_COPY"}),
    "full": ("decode_full.cu", "yolo_decode_full",
             {"nomath": "K3_SKIP_MATH", "nostore": "K3_SKIP_STORE"}),
    "grid": ("probe.cu", "yolo_probe_dot_grid",
             {"product": "T2_SKIP_PROJECT"}),
}


def variants(kernel: str):
    """(source, its C entry, {build name: macro}) of ``kernel``: "nms" (K2),
    "decode" (K1), "full" (K3) or "grid" (T2)."""
    source, entry, macros = VARIANTS[kernel]
    return _build.CSRC / source, entry, macros


@functools.lru_cache(maxsize=None)
def build_variants(kernel: str) -> Dict[str, ctypes.CDLL]:
    """{build name: the library built with its macro} for ``kernel`` (a key
    of :data:`VARIANTS`), compiled in parallel; raises with nvcc's
    output."""
    nvcc = _build.find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found: the ablated builds are made from "
                           "yolov3_tpu_torch/csrc")
    source, entry, macros = variants(kernel)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    tag = _build.library_path().stem.rsplit("-", 1)[1]
    procs = {}
    for name, macro in macros.items():
        lib = OUT_DIR / f"{kernel}_{name}-{tag}.so"
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, f"-D{macro}", "-shared", "-I",
             str(_build.CSRC), "-o", str(lib), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    whole = getattr(_build.load_kernels(), entry)
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} build of "
                               f"{Path(source).name}:\n{log}")
        dll = ctypes.CDLL(str(lib))
        fn = getattr(dll, entry)
        fn.argtypes, fn.restype = whole.argtypes, ctypes.c_int
        libs[name] = dll
    return libs


def nms_phase_times(boxes: torch.Tensor, classes: torch.Tensor,
                    valid: torch.Tensor, iou_thresh: float) -> Dict[str, float]:
    """Device ms by CUDA graph replay of the whole K2 call and of each
    build of ``variants("nms")``, on CUDA inputs that
    ``cuda_nms.suppress`` takes."""
    keep, bits = cuda_nms.suppress_bits(boxes, classes, valid, iou_thresh)
    libs = {"whole": _build.load_kernels(), **build_variants("nms")}
    return {name: graph_ms(lambda lib=lib: cuda_nms.launch(
                lib, boxes, classes, valid, iou_thresh, keep, bits))
            for name, lib in libs.items()}


def decode_phase_times(feats: Sequence[torch.Tensor], anchors_per_head,
                       strides: Sequence[int], num_classes: int,
                       prob_thresh: float) -> Dict[str, float]:
    """Device ms by CUDA graph replay of K1's one launch over these CUDA
    head maps and of each build of ``variants("decode")``."""
    offsets = cuda_decode.candidate_offsets(feats, anchors_per_head)
    payload = torch.empty((feats[0].shape[0], offsets[-1], 8),
                          dtype=torch.float32, device=feats[0].device)
    libs = {"whole": _build.load_kernels(), **build_variants("decode")}
    return {name: graph_ms(lambda lib=lib: cuda_decode.launch_decode(
                feats, anchors_per_head, strides, num_classes, prob_thresh,
                offsets, [payload], "K1", lib=lib))
            for name, lib in libs.items()}


def full_decode_phase_times(feats: Sequence[torch.Tensor], anchors_per_head,
                            strides: Sequence[int], num_classes: int
                            ) -> Dict[str, float]:
    """Device ms by CUDA graph replay of K3's one launch over these CUDA
    head maps and of each build of ``variants("full")``."""
    offsets = cuda_decode.candidate_offsets(feats, anchors_per_head)
    out = torch.empty((feats[0].shape[0], offsets[-1], 5 + num_classes),
                      dtype=torch.float32, device=feats[0].device)
    libs = {"whole": _build.load_kernels(), **build_variants("full")}
    return {name: graph_ms(lambda lib=lib: cuda_decode.launch_full_decode(
                feats, anchors_per_head, strides, num_classes, offsets[:-1],
                out, lib=lib))
            for name, lib in libs.items()}


def grid_phase_times(args, grid: int = 1024) -> Dict[str, float]:
    """Device ms per product of T2 (``grid`` of them in one launch, by CUDA
    graph replay) on CUDA operands ``args`` (lhs, rhs, p1, p2), whole and
    for each build of ``variants("grid")``."""
    out = torch.empty((grid, 8, 128), dtype=torch.bfloat16,
                      device=args[0].device)
    libs = {"whole": _build.load_kernels(), **build_variants("grid")}
    return {name: graph_ms(lambda lib=lib: cuda_probe.launch_grid(
                *args, grid, out, lib=lib), iters=5) / grid
            for name, lib in libs.items()}


def clustered(b: int, k: int, seed: int):
    """B images of K boxes around 24 centres, 3 classes, 10% of the slots
    invalid: numpy (boxes, classes, valid)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 416, (b, 24, 2))
    pick = rng.integers(0, 24, (b, k))
    c = np.take_along_axis(centers, pick[..., None], axis=1)
    c = c + rng.normal(0, 6, c.shape)
    wh = rng.uniform(20, 90, (b, k, 2))
    boxes = np.round(np.concatenate([c - wh / 2, c + wh / 2], -1) * 2) / 2
    return (boxes.astype(np.float32),
            rng.integers(0, 3, (b, k)).astype(np.int32),
            rng.uniform(0, 1, (b, k)) > 0.1)


def main() -> int:
    from ..graph import load_graph

    device = resolve_device(None)  # raises without a card
    print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    for k in (256, 512, 1024):
        b, c, v = (torch.from_numpy(a).to(device) for a in clustered(8, k, k))
        got = cuda_nms.suppress(b, c, v, 0.45)
        if not torch.equal(got, cuda_nms.suppress_reference(b, c, v, 0.45)):
            raise AssertionError(f"K2 at K={k}: not exact against the plain "
                                 f"version")
        t = nms_phase_times(b, c, v, 0.45)
        print(f"K2 B=8 K={k}, us by graph replay: " + ", ".join(
            f"{name} {ms * 1e3:.2f}" for name, ms in t.items()), flush=True)
    graph = load_graph(_build.CSRC.parents[1] / "models" / "yolov3.cfg")
    anchors = [n.anchors for n in graph.yolo_nodes]
    strides = list(graph.head_strides())
    ncls = graph.yolo_nodes[0].classes
    rng = np.random.default_rng(0)
    for dtype in (torch.float32, torch.bfloat16):
        feats = [torch.from_numpy(rng.normal(0, 2, (
            8, 416 // s, 416 // s, len(a) * (5 + ncls))).astype(np.float32)
        ).to(device, dtype) for a, s in zip(anchors, strides)]
        t = decode_phase_times(feats, anchors, strides, ncls, 0.3)
        print(f"K1 yolov3@416 B=8 {dtype}, us by graph replay: " + ", ".join(
            f"{name} {ms * 1e3:.2f}" for name, ms in t.items()), flush=True)
        t = full_decode_phase_times(feats, anchors, strides, ncls)
        print(f"K3 yolov3@416 B=8 {dtype}, us by graph replay: " + ", ".join(
            f"{name} {ms * 1e3:.2f}" for name, ms in t.items()), flush=True)
    from .bench_dot import SHAPES

    for m, k, n in SHAPES:
        args = cuda_probe.dot_operands(m, k, n, torch.bfloat16, rng,
                                       device)[1:]
        t = grid_phase_times(args)
        print(f"T2 M={m} K={k} N={n}, us a product by graph replay: "
              + ", ".join(f"{name} {ms * 1e3:.3f}" for name, ms in t.items()),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
