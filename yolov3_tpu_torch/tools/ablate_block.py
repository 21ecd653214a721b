"""Where K6's time goes: the fused int8 residual block timed with one part
of the kernel taken out.

Builds copies of ``csrc/block_int8.cu`` with one part removed each
(:data:`ABLATIONS`) into ``build/ablate/`` with the library's own flags, and
times each by CUDA graph replay at yolov3@416's and @608's block shapes
(B=8, at both tile heights), beside the whole kernel. An ablated kernel
computes wrong values and only its time is read; the whole kernel is
checked exact against its plain version first. The difference between the
whole kernel and an ablated one is the most that part costs; parts that
overlap can each cost less than their difference.

  noload    the 3x3's ring stops streaming w2 after its first two steps
  nomma3    the 3x3's products
  noepi     the 3x3's epilogue (its arithmetic and its stores)
  skeleton  noload and nomma3 together: the copies, the 1x1 and its
            epilogue, the loop's waits and barriers, the 3x3's epilogue

Run on a machine with the card: ``python -m yolov3_tpu_torch.tools.ablate_block``.
"""
from __future__ import annotations

import ctypes
import hashlib
import subprocess
from typing import Dict

import numpy as np
import torch

from ..ops import _build, cuda_block
from ..weights import resolve_device
from .clock import graph_ms

SOURCE = _build.CSRC / "block_int8.cu"
OUT_DIR = _build.BUILD_DIR.parent / "ablate"
SHAPES = ((8, 104, 104, 128, 64), (8, 52, 52, 256, 128),
          (8, 152, 152, 128, 64), (8, 76, 76, 256, 128))
_NO_LOAD = ("    load_w2(st == 0 ? K6_STAGES - 1 : st - 1);\n",
            "    wg_cp_async_commit();\n")
_NO_MMA3 = ("      wg_mma_m64k32_s8<C>(acc2, da, db + 2 * kk, 1);\n", "")
ABLATIONS = {
    "noload": (_NO_LOAD,),
    "nomma3": (_NO_MMA3,),
    # the stores never run, so the compiler drops the arithmetic before them
    "noepi": (("      if (p.out_kind == K6_OUT_INT8) {\n",
               "      if (p.batch < 0) {\n"),
              ("      } else if (p.out_kind == K6_OUT_BF16) {\n",
               "      } else if (p.batch < -1) {\n"),
              ("      } else {\n        *reinterpret_cast<float2*>",
               "      } else if (p.batch < -2) {\n"
               "        *reinterpret_cast<float2*>")),
    "skeleton": (_NO_LOAD, _NO_MMA3),
}


def ablated_sources(source: str) -> Dict[str, str]:
    """{name: the kernel's source with that part removed}; raises if the
    kernel no longer has the code an ablation removes."""
    out = {}
    for name, edits in ABLATIONS.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise ValueError(f"ablation {name!r}: {old.strip()!r} is not "
                                 f"in block_int8.cu exactly once")
            text = text.replace(old, new)
        out[name] = text
    return out


def _build_all(sources: Dict[str, str]) -> Dict[str, ctypes.CDLL]:
    nvcc = _build.find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found: the ablated kernels are built "
                           "from yolov3_tpu_torch/csrc")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        tag = hashlib.sha256(text.encode()).hexdigest()[:12]
        src, lib = OUT_DIR / f"{name}-{tag}.cu", OUT_DIR / f"{name}-{tag}.so"
        src.write_text(text)
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC),
             "-o", str(lib), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} kernel:\n{log}")
        dll = ctypes.CDLL(str(lib))
        dll.yolo_residual_block_int8.argtypes = \
            _build.load_kernels().yolo_residual_block_int8.argtypes
        dll.yolo_residual_block_int8.restype = ctypes.c_int
        libs[name] = dll
    return libs


def main() -> int:
    device = resolve_device(None)  # raises without a card
    print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    libs = {"whole": _build.load_kernels(),
            **_build_all(ablated_sources(SOURCE.read_text()))}
    rng = np.random.default_rng(6)
    for b, h, w, c, cmid in SHAPES:
        x = torch.from_numpy(rng.integers(-127, 128, (b, h, w, c),
                                          dtype=np.int8)).to(device)
        qp = [{"wq": torch.from_numpy(rng.integers(
                   -127, 128, (k, k, ci, co), dtype=np.int8)).to(device),
               "sw": torch.full((co,), 1e-4, device=device),
               "b": torch.zeros(co, device=device)}
              for k, ci, co in ((1, c, cmid), (3, cmid, c))]
        s = dict(s_in=0.05, s_mid=0.03, s_mid2=0.02, s_out=0.06)
        bp = cuda_block.prepare_block_params(qp[0], qp[1], s["s_in"],
                                             s["s_mid"])
        want = cuda_block.residual_block_int8_reference(x, bp, emit_q=True, **s)
        out = torch.empty_like(x)
        for th in cuda_block.TILE_HEIGHTS:
            if cuda_block.block_smem_bytes(th, c, cmid) > cuda_block.SMEM_LIMIT:
                continue
            times = {}
            for name, lib in libs.items():
                def call(lib=lib):
                    rc = lib.yolo_residual_block_int8(
                        x.data_ptr(), bp["w1k"].data_ptr(),
                        bp["w2k"].data_ptr(), bp["deq1"].data_ptr(),
                        bp["b1"].data_ptr(), bp["deq2"].data_ptr(),
                        bp["b2"].data_ptr(), b, h, w, c, cmid,
                        1.0 / s["s_mid"], 1.0 / s["s_mid2"], s["s_mid2"],
                        s["s_in"], 1.0 / s["s_out"], 0, out.data_ptr(), th,
                        torch.cuda.current_stream(device).cuda_stream)
                    _build.check_launch(rc, f"ablated K6 ({name})")
                call()
                torch.cuda.synchronize()
                if name == "whole" and not torch.equal(out, want):
                    raise AssertionError(f"K6 {(b, h, w, c, cmid)} {th} rows: "
                                         f"not exact against the plain version")
                times[name] = graph_ms(call) * 1e3
            print(f"K6 B={b} {h}x{w} C={c} cmid={cmid}, {th}-row tiles, us "
                  f"by graph replay: " + ", ".join(
                      f"{k} {v:.1f}" for k, v in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
