"""The plain reference is the configuration's choice: the module its
``"reference"`` key names is the one a run parses the cfg with, scales the
weights with, and reads the program and the control against; with
``"yolo"`` named, the weights and the readings are bit for bit those of
``reference.yolo`` called directly; a missing key or module ends the run."""
import importlib
import json
import sys

import numpy as np
import pytest
import torch

import harness
import inputs
from reference import yolo
from test_correct_check import run, small_cell

torch.set_num_threads(2)
CELL = "yolov3-608-bf16.cams8"

# a reference that counts each use and walks ``reference.yolo``
PROBE = '''
from collections import Counter

from reference import yolo

CALLS = Counter()


def read_cfg(path):
    CALLS["read_cfg"] += 1
    return yolo.read_cfg(path)


def letterbox(frames_bgr, net_hw):
    CALLS["letterbox"] += 1
    return yolo.letterbox(frames_bgr, net_hw)


def forward(net, weights, x, cast=None, on_conv=None, rounding=None):
    CALLS["forward" if on_conv is None else "forward_scaling"] += 1
    return yolo.forward(net, weights, x, cast, on_conv, rounding)


def detect(net, weights, frames_bgr, *args, cast=None, rounding=None, **kw):
    CALLS["detect" if cast is None and rounding is None else "detect_control"] += 1
    return yolo.detect(net, weights, frames_bgr, *args, cast=cast,
                       rounding=rounding, **kw)
'''


@pytest.fixture(autouse=True)
def dense(monkeypatch):
    # more candidates over the threshold at this size
    monkeypatch.setattr(inputs, "CANDIDATE_SHARE", 0.05)


@pytest.fixture
def probe(tmp_path, monkeypatch):
    """``reference.probe``, from a ``reference`` directory of the test's own
    that the namespace package takes in beside ``benchmark/reference``."""
    (tmp_path / "reference").mkdir()
    (tmp_path / "reference" / "probe.py").write_text(PROBE)
    monkeypatch.syspath_prepend(str(tmp_path))
    yield importlib.import_module("reference.probe")
    sys.modules.pop("reference.probe", None)


def name_reference(value, tmp_path, monkeypatch, cell=CELL):
    """``BENCHMARK.json`` as it is, but with the cell's configuration file
    copied with ``"reference"`` set to ``value`` (left out where None);
    returns the copy's path."""
    man = json.loads(harness.MANIFEST.read_text())
    conf_name = next(w["config"] for w in man["workloads"] if w["name"] == cell)
    entry = next(c for c in man["configs"] if c["name"] == conf_name)
    config = json.loads((harness.ROOT / entry["file"]).read_text())
    config.pop("reference")
    if value is not None:
        config["reference"] = value
    path = tmp_path / f"{conf_name}.json"
    path.write_text(json.dumps(config))
    entry["file"] = str(path)
    manifest = tmp_path / "BENCHMARK.json"
    manifest.write_text(json.dumps(man))
    monkeypatch.setattr(harness, "MANIFEST", manifest)
    return path


def test_named_module_is_the_one_used(probe, tiny_cfg, tmp_path, monkeypatch):
    name_reference("probe", tmp_path, monkeypatch)
    cell = small_cell(CELL, tiny_cfg)
    assert cell.reference is probe
    out, r = run(cell, keep=True)
    assert out["correct"], out["checked"]
    blocks = -(-len(out["compared"]["frames"]) // harness.REFERENCE_BLOCK)
    # the cfg parsed, the weights scaled (letterbox and forward with
    # ``on_conv``), the program's answers read against ``detect``
    assert probe.CALLS == {"read_cfg": 1, "letterbox": 1, "forward_scaling": 1,
                           "detect": blocks}
    probe.CALLS.clear()
    harness.reference_readings(cell, r.net, r.folded, r.pool,
                               out["compared"]["frames"], None, "cpu", r.calib)
    # the float8 control: the reference and the control, both by ``detect``
    assert probe.CALLS == {"detect": blocks, "detect_control": blocks}


def test_yolo_named_reads_as_yolo_direct(probe, tiny_cfg):
    """Weights and readings through the module a configuration names are
    bit for bit those of ``reference.yolo`` called directly, at one seed."""
    cell = small_cell(CELL, tiny_cfg)
    assert cell.reference is yolo
    net = yolo.read_cfg(tiny_cfg)
    direct = inputs.make_weights(yolo, net, 5, "cpu")
    routed = inputs.make_weights(probe, probe.read_cfg(tiny_cfg), 5, "cpu")
    assert direct.keys() == routed.keys()
    for i in direct:
        for a, b in zip(direct[i], routed[i]):
            assert torch.equal(a, b), i
    out, r = run(cell, keep=True)
    frames = out["compared"]["frames"]
    readings = {}
    for ref in (yolo, probe):
        cell.reference = ref
        readings[ref.__name__] = [
            harness.reference_readings(cell, r.net, r.folded, r.pool, frames,
                                       served, "cpu", r.calib).numbers()
            for served in (harness.distinct_results(r.served, frames), None)]
    assert readings["reference.yolo"] == readings["reference.probe"]
    assert readings["reference.yolo"][0]["det_gap"] == out["checked"]["det_gap"]["value"]
    assert probe.CALLS["detect_control"] > 0


@pytest.mark.parametrize("value", [None, "no_such_module", "../yolo", "int8"])
def test_missing_reference_fails(value, tmp_path, monkeypatch):
    """No key, a module that is not there, a path, a module that does not
    hold the contract (``int8`` has no ``read_cfg``): the run ends, naming
    the configuration's file."""
    path = name_reference(value, tmp_path, monkeypatch)
    with pytest.raises(harness.Fail, match=str(path)):
        harness.load_cell(CELL)


def test_int4_control_walks_yolo_only(probe, tiny_cfg):
    net = probe.read_cfg(tiny_cfg)
    with pytest.raises(harness.Fail, match="int4"):
        harness.reference_walk(probe, net, {}, np.zeros((1, 8, 8, 3), np.uint8),
                               "int4")
