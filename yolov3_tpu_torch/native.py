"""ctypes binding of the C++ host data loader (``native/preproc.cpp``).

The port's own binding of the loader the JAX package uses
(``yolov3_tpu/native/__init__.py``): batched uint8 letterbox / stretch
resize with the BGR→RGB swap and the 128 pad, which assembles frames of any
size into one fixed-shape uint8 batch on the host.

The library is built with ``g++`` at first use from ``native/preproc.cpp``
(read, never edited) into ``build/native/`` at the repository root
(git-ignored). Its file name carries a hash of the source and the flags, and
the compiler writes to a temporary name that is moved into place with
``os.replace``, so concurrent processes (test workers) see a whole library or
none; ``native/libpreproc.so`` is neither loaded nor written.

As in the JAX package, :func:`available` is False when there is no compiler
(or no source) and callers then take the per-shape device route. That is a
host-side choice: it hides neither the device nor a kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "preproc.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
# the JAX package's flags, so both libraries round alike byte for byte
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-fopenmp")

# uint8 letterbox pad: one pad contract across every path (darknet's 0.5 is
# not representable in uint8); ops.preprocess pads PAD_FLOAT = 128/255
PAD_VALUE = 128

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path(flags: Sequence[str] = CXX_FLAGS,
                 build_dir: Union[str, Path, None] = None) -> Path:
    """Where the library for the current source and ``flags`` lives."""
    digest = hashlib.sha256(" ".join(flags).encode())
    digest.update(SOURCE.read_bytes())
    return Path(build_dir or BUILD_DIR) / f"libpreproc-{digest.hexdigest()[:16]}.so"


def build(build_dir: Union[str, Path, None] = None) -> Optional[Path]:
    """Compile the loader unless its library exists; return the library's
    path, or None when the source or a working ``g++`` is missing. Tries
    again without OpenMP for toolchains that lack libgomp."""
    if not SOURCE.is_file():
        return None
    for flags in (CXX_FLAGS, tuple(f for f in CXX_FLAGS if f != "-fopenmp")):
        lib = library_path(flags, build_dir)
        if lib.is_file():
            return lib
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        try:
            subprocess.run(["g++", *flags, str(SOURCE), "-o", str(tmp)],
                           check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, lib)  # atomic: a concurrent process sees all or nothing
        return lib
    return None


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.letterbox_batch.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, u8p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int]
    lib.letterbox_mixed.argtypes = [ctypes.POINTER(u8p),
                                    ctypes.POINTER(ctypes.c_int),
                                    ctypes.POINTER(ctypes.c_int),
                                    ctypes.c_int, u8p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int]
    lib.stretch_batch.argtypes = lib.letterbox_batch.argtypes
    lib.preproc_version.argtypes = []
    for f in (lib.letterbox_batch, lib.letterbox_mixed, lib.stretch_batch,
              lib.preproc_version):
        f.restype = ctypes.c_int
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is None and not _tried:
            _tried = True
            path = build()
            if path is not None:
                try:
                    _lib = _declare(ctypes.CDLL(str(path)))
                except OSError:
                    _lib = None
        return _lib


def available() -> bool:
    """True when the loader is built (now, if need be) and loaded."""
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native preproc library unavailable")
    return lib


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _check_frames(frames: np.ndarray) -> np.ndarray:
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    if frames.ndim != 4 or frames.shape[3] != 3 or 0 in frames.shape:
        raise ValueError(f"frames must be a non-empty (B, H, W, 3) batch, got "
                         f"{frames.shape}")
    return frames


def letterbox_batch_native(frames: np.ndarray, net_hw, swap_rb: bool = True
                           ) -> np.ndarray:
    """(B, H, W, 3) uint8 → (B, nh, nw, 3) uint8 letterboxed (RGB if swap_rb)."""
    lib = _require()
    frames = _check_frames(frames)
    b, h, w, _ = frames.shape
    nh, nw = net_hw
    out = np.full((b, nh, nw, 3), PAD_VALUE, dtype=np.uint8)
    rc = lib.letterbox_batch(_u8ptr(frames), b, h, w, _u8ptr(out), nh, nw,
                             int(swap_rb))
    if rc != 0:
        raise RuntimeError(f"letterbox_batch failed rc={rc}")
    return out


def letterbox_mixed_native(frames: Sequence[np.ndarray], net_hw,
                           swap_rb: bool = True) -> np.ndarray:
    """List of HWC uint8 images (any sizes) → one (B, nh, nw, 3) uint8 batch."""
    lib = _require()
    frames = [np.ascontiguousarray(f, dtype=np.uint8) for f in frames]
    for f in frames:
        if f.ndim != 3 or f.shape[2] != 3 or 0 in f.shape:
            raise ValueError(f"every frame must be a non-empty (H, W, 3) "
                             f"image, got {f.shape}")
    b = len(frames)
    nh, nw = net_hw
    out = np.full((b, nh, nw, 3), PAD_VALUE, dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    ptrs = (u8p * b)(*[_u8ptr(f) for f in frames])
    shs = (ctypes.c_int * b)(*[f.shape[0] for f in frames])
    sws = (ctypes.c_int * b)(*[f.shape[1] for f in frames])
    rc = lib.letterbox_mixed(ptrs, shs, sws, b, _u8ptr(out), nh, nw,
                             int(swap_rb))
    if rc != 0:
        raise RuntimeError(f"letterbox_mixed failed rc={rc}")
    return out


def stretch_batch_native(frames: np.ndarray, net_hw, swap_rb: bool = True
                         ) -> np.ndarray:
    """(B, H, W, 3) uint8 → (B, nh, nw, 3) uint8, plain bilinear resize."""
    lib = _require()
    frames = _check_frames(frames)
    b, h, w, _ = frames.shape
    nh, nw = net_hw
    out = np.empty((b, nh, nw, 3), dtype=np.uint8)
    rc = lib.stretch_batch(_u8ptr(frames), b, h, w, _u8ptr(out), nh, nw,
                           int(swap_rb))
    if rc != 0:
        raise RuntimeError(f"stretch_batch failed rc={rc}")
    return out
