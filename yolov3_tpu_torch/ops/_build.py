"""Build and load the port's CUDA kernels.

``csrc/*.cu`` (the serving kernels K1-K6 and ``probe.cu``, the diagnostic
tools' kernels) compile with ``nvcc`` into ONE shared library with a plain C
interface, loaded with ``ctypes``; ``decode_common.cuh`` (the decode body),
``block_int8_common.cuh`` (K6's arithmetic, shared with the probes),
``wgmma_common.cuh`` (the tensor-core building blocks of K4's and K5's bf16
kernels, K6's int8 kernel and T1's ``wgmma`` cores) and ``conv3x3_mma.cuh``
(K5's tensor-core kernel) are their headers. The build
runs at first use from the sources in the checkout and lands in
``build/kernels/`` at the repository root (git-ignored): one ``nvcc -c`` per
source, all started together, then one link. The library's file name carries
a hash of the sources, headers and flags, so an edited source is rebuilt,
never silently reused.

There is no fallback: without ``nvcc``, or when it fails, or when the
library does not load, :func:`build_kernels` / :func:`load_kernels` raise
with the compiler's output. Only the wrappers' CPU branch (a tensor on the
CPU) runs without this module.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Union

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("decode_packed.cu", "decode_fused.cu", "decode_full.cu",
           "conv3x3.cu", "block_int8.cu", "nms_suppress.cu", "probe.cu")
HEADERS = ("decode_common.cuh", "block_int8_common.cuh",
           "wgmma_common.cuh", "conv3x3_mma.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
# -fmad=false and no --use_fast_math: the decode and suppression epilogues
# must match their plain PyTorch versions bit for bit (see the notes in each
# .cu file); the conv / head-projection loops use __fmaf_rn explicitly.
# -Xptxas -v writes registers / shared memory / spills into the build log.
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> Optional[str]:
    """``nvcc`` on PATH, else under ``$CUDA_HOME/bin`` or the toolkit's
    default prefix; None when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    return None


def library_path(build_dir: Union[str, Path, None] = None) -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        digest.update((CSRC / name).read_bytes())
    return Path(build_dir or BUILD_DIR) / f"libyolov3_kernels-{digest.hexdigest()[:16]}.so"


def build_kernels(build_dir: Union[str, Path, None] = None) -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists;
    return its path. Raises RuntimeError when ``nvcc`` is missing or fails."""
    lib = library_path(build_dir)
    if lib.is_file():
        return lib
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
            "port's CUDA kernels are built from yolov3_tpu_torch/csrc at "
            "first use and have no fallback for CUDA tensors")
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{Path(s).stem}.o") for s in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)]
            for s, o in zip(SOURCES, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    logs, rc = [], 0
    for cmd, proc in zip(cmds, procs):
        out, err = proc.communicate()
        logs.append(f"$ {' '.join(cmd)}\n{out}{err}")
        rc = rc or proc.returncode
    if rc == 0:
        cmd = [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        rc = proc.returncode
    for o in objs:
        o.unlink(missing_ok=True)
    log = "".join(logs)
    if rc != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with exit code {rc}:\n{log}")
    lib.with_suffix(".log").write_text(log)
    os.replace(tmp, lib)  # atomic: a concurrent builder sees all or nothing
    return lib


@functools.lru_cache(maxsize=None)
def load_kernels() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every C entry's
    argument and result types declared."""
    lib = ctypes.CDLL(str(build_kernels()))
    p, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)
    anchors = ctypes.POINTER(ctypes.c_float)
    lib.yolo_decode_heads.argtypes = [
        ctypes.POINTER(ctypes.c_longlong), anchors, i32, anchors, i32, i32,
        i32, i32, i32, i32, i32, i32, f32, i32, p, p, p, p, p]
    lib.yolo_decode_packed_fused_head.argtypes = [
        p, i64, i64, i64, i32, p, p, i32, i32, i32, i32, i32, i32, anchors,
        f32, f32, i32, i32, i32, i32, i32, p, p]
    lib.yolo_conv3x3_fused.argtypes = [
        p, i64, i64, i64, i32, p, p, i32, i32, i32, i32, i32, i32, i32, i32,
        p, p]
    lib.yolo_nms_suppress.argtypes = [p, p, p, i32, i32, f32, p, p, p]
    lib.yolo_decode_full.argtypes = [
        ctypes.POINTER(ctypes.c_longlong), anchors, i32, anchors, i32, i32,
        i32, i32, i32, p, p]
    lib.yolo_residual_block_int8.argtypes = [
        p, p, p, p, p, p, p, i32, i32, i32, i32, i32, f32, f32, f32, f32, f32,
        i32, p, i32, p]
    lib.yolo_probe_dot.argtypes = [p, p, p, p, p, i32, i32, i32, i32, i32, p,
                                   p, p, p, i32, p]
    lib.yolo_probe_dot_grid.argtypes = [p, p, p, p, i32, i32, i32, i32, i32,
                                        i32, p, p]
    lib.yolo_probe_round_clip.argtypes = [p, p, i32, p]
    lib.yolo_probe_roll.argtypes = [p, p, i32, i32, i32, p]
    lib.yolo_probe_mask.argtypes = [p, i32, i32, i32, i32, i32, i32, p]
    lib.yolo_probe_epilogue.argtypes = [p, p, p, f32, p, i32, i32, p]
    for fn in (lib.yolo_probe_dot, lib.yolo_probe_dot_grid,
               lib.yolo_probe_round_clip, lib.yolo_probe_roll,
               lib.yolo_probe_mask, lib.yolo_probe_epilogue,
               lib.yolo_decode_heads,
               lib.yolo_decode_packed_fused_head, lib.yolo_conv3x3_fused,
               lib.yolo_nms_suppress, lib.yolo_decode_full,
               lib.yolo_residual_block_int8):
        fn.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Multiprocessors of CUDA device ``index`` (the tile plans' input)."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def check_launch(rc: int, kernel: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc}")
