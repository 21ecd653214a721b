"""``correct`` on the CPU at a small size: a sound run passes, and the run
comes out not correct with the timed path broken underneath it (``faults``:
half of each batch's answers left out; an answer altered where it is
produced; every frame given another's answers; on the mesh, one card's
answers standing in for another's), and each configuration's control (the
float8 walk for bf16, the int4 walk for int8) reads far above the program.

At this size the sound readings lie well under the configuration's limits,
which were set at 608 on the card; the faults are held to limits three
times this size's sound readings, as a limit is set above the readings it
comes from."""
import json
import time
from pathlib import Path

import pytest
import torch

import harness
import inputs
from faults import FAULTS
torch.set_num_threads(2)
SEED = 2 ** 31 + 11


@pytest.fixture(autouse=True)
def dense(monkeypatch):
    # more candidates over the threshold at this size
    monkeypatch.setattr(inputs, "CANDIDATE_SHARE", 0.05)


def mesh_cell() -> harness.Cell:
    """The four-card batch-DP cell, out of ``BENCHMARK.json`` until its rate
    is steady (PERF.md), built from the files it keeps under ``benchmark/``:
    the bf16 configuration and ``traffic/dp4-batch128.json``."""
    base = harness.load_cell("yolov3-608-bf16.cams8")
    traffic = json.loads((harness.HERE / "traffic" / "dp4-batch128.json")
                         .read_text())
    return harness.Cell("yolov3-608-bf16.dp4-batch128",
                        dict(base.entry, chips=4, traffic="dp4-batch128"),
                        base.config, traffic, base.cfg_path, base.reference)


def small_cell(name, cfg: Path) -> harness.Cell:
    cell = harness.load_cell(name) if isinstance(name, str) else name
    cell.cfg_path = cfg
    cell.config = dict(cell.config, width=96, height=96, top_k=256)
    if cell.config["quantize"]:
        cell.config["quantize"] = dict(cell.config["quantize"], frames=8)
    cell.traffic = dict(cell.traffic, batch=4, pool=8, frame_hw=[96, 128],
                        sample=8)
    return cell


def run(cell, devices=("cpu",), seed=SEED, keep=False):
    out, r = harness.measure(cell, seed, 0.5, False,
                             [torch.device(d) for d in devices],
                             time.perf_counter())
    return (out, r) if keep else out


def broken(cell, fault, monkeypatch, devices=("cpu",)):
    """The run with ``fault`` planted, held to three times the sound run's
    readings at this size."""
    sound = run(cell, devices)["checked"]
    cell.config = dict(cell.config, limits={
        k: 3 * max(v["value"], 1e-3) for k, v in sound.items()})
    FAULTS[fault](monkeypatch.setattr)
    return run(cell, devices)


ONE_CARD = ["yolov3-608-bf16.stream32", "yolov3-608-bf16.cams8",
            "yolov3-608-int8.stream32"]


@pytest.mark.parametrize("name", ONE_CARD)
def test_sound_run_is_correct(name, tiny_cfg):
    out = run(small_cell(name, tiny_cfg))
    assert out["correct"], out["checked"]
    assert out["compared"]["detections"] > 20
    assert list(out)[-1] == "checked"


@pytest.mark.parametrize("name", ONE_CARD)
@pytest.mark.parametrize("fault", ["drop_half", "alter_one", "stale"])
def test_broken_path_is_not_correct(name, fault, tiny_cfg, monkeypatch):
    out = broken(small_cell(name, tiny_cfg), fault, monkeypatch)
    assert not out["correct"], out["checked"]


MESH = ("cpu",) * 4


def test_sound_mesh_run_is_correct(tiny_cfg):
    out = run(small_cell(mesh_cell(), tiny_cfg), devices=MESH)
    assert out["correct"], out["checked"]


@pytest.mark.parametrize("fault", ["swap_replicas", "drop_half", "alter_one"])
def test_broken_mesh_is_not_correct(fault, tiny_cfg, monkeypatch):
    out = broken(small_cell(mesh_cell(), tiny_cfg), fault, monkeypatch,
                 devices=MESH)
    assert not out["correct"], out["checked"]


@pytest.mark.parametrize("name", ["yolov3-608-bf16.cams8",
                                  "yolov3-608-int8.stream32"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_controls_read_far_above_the_program(name, seed, tiny_cfg):
    cell = small_cell(name, tiny_cfg)
    out, r = run(cell, seed=seed, keep=True)
    prog = out["checked"]
    ctrl = harness.reference_readings(cell, r.net, r.folded, r.pool,
                                      out["compared"]["frames"], None, "cpu",
                                      r.calib).numbers()
    assert any(ctrl[k] >= 3 * max(prog[k]["value"], 1e-3) for k in prog), (
        prog, ctrl)
