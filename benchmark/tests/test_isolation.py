"""Nothing the benchmark runs loads JAX or the JAX package: every module of
``benchmark/`` and the program modules a run drives, imported in a fresh
interpreter, leave no top-level module named ``jax``, ``jaxlib``, ``flax``
or ``yolov3_tpu`` (whole names: ``yolov3_tpu_torch`` is the program)."""
import json
import subprocess
import sys
import types

import harness
from conftest import BENCH, ROOT

PROBE = r"""
import importlib.util, json, sys
sys.path[:0] = [{bench!r}, {root!r}]
import harness, check, counts, devtrace, inputs, loadgen, limits
from reference import yolo
import readers
for sub in ("metrics", "drivers"):
    for path in sorted(__import__("pathlib").Path({bench!r}, sub).glob("*.py")):
        spec = importlib.util.spec_from_file_location("m_" + path.stem, path)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
from reference import int8
import yolov3_tpu_torch, yolov3_tpu_torch.inference, yolov3_tpu_torch.parallel
import yolov3_tpu_torch.quant, yolov3_tpu_torch.ops.cuda_block
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_no_jax_in_a_run():
    code = PROBE.format(bench=str(BENCH), root=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT), check=True)
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "yolov3_tpu_torch" in names and "harness" in names
    assert not names & set(harness.FORBIDDEN), names & set(harness.FORBIDDEN)


def test_forbidden_compares_whole_names(monkeypatch):
    for name in ("yolov3_tpu_torchx", "jaxtyping", "flaxen.sub"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "yolov3_tpu.model",
                        types.ModuleType("yolov3_tpu.model"))
    assert harness.forbidden_modules() == ["jax", "yolov3_tpu"]
