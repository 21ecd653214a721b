"""``BENCHMARK.json`` against the rules it is checked by, and every file it
names present."""
import json
import math
import re

import pytest

import check
import counts
import harness
from conftest import BENCH, ROOT

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = MAN["end_to_end"] + MAN["per_layer"]
CELLS = {w["name"]: w for w in MAN["workloads"]}


def cells_of(metric):
    return set(metric.get("workloads", CELLS))


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s at this window
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(MAN)) <= 64 * 1024


def test_names_and_units():
    names = [m["name"] for m in METRICS] + list(CELLS) + [c["name"] for c in MAN["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in MAN["workloads"]]:
        assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")


def test_entry_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["reduced"] == []
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_config_keeps_a_cell_and_its_file():
    used = {w["config"] for w in MAN["workloads"]}
    for c in MAN["configs"]:
        assert c["name"] in used
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"]
        assert (BENCH / "configs" / conf["cfg"]).is_file()
        assert conf["limits"] and set(conf["limits"]) <= set(check.COMPARED)
        assert conf["tier"] in counts.PEAK_OPS_PER_S
        assert conf["control"] in harness.WALKS


@pytest.mark.parametrize("config", [c["name"] for c in MAN["configs"]])
def test_config_names_its_reference(config):
    """A module of ``benchmark/reference/`` that holds the contract; the
    int4 control walks ``reference.yolo``, so its configurations name it."""
    path = ROOT / next(c["file"] for c in MAN["configs"] if c["name"] == config)
    conf = json.loads(path.read_text())
    assert (BENCH / "reference" / f"{conf['reference']}.py").is_file()
    assert harness.reference_module(conf, path).__name__ == f"reference.{conf['reference']}"
    if conf["control"] == "int4":
        assert conf["reference"] == "yolo"


def test_at_most_one_four_chip_cell():
    four = [w for w in MAN["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, math.floor(0.25 * len(CELLS)))
    assert all(w["chips"] in (1, 4) for w in MAN["workloads"])


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for cell in CELLS:
        e2e = [m["name"] for m in MAN["end_to_end"] if cell in cells_of(m)]
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert any(cell in cells_of(m) for m in MAN["per_layer"]), cell


def test_each_layer_metric_moves_what_its_cells_report():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        assert cells_of(m) <= cells_of(e2e[m["moves"]]), m["name"]
        assert 1 <= len(m["layer"]) <= 200


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader_exists(metric):
    assert (BENCH / "metrics" / f"{metric}.py").is_file()


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_traffic_file(cell):
    t = json.loads((BENCH / "traffic" / f"{CELLS[cell]['traffic']}.json").read_text())
    assert (BENCH / "drivers" / f"{t['driver']}.py").is_file()
    assert t["pool"] % t["batch"] == 0
    if CELLS[cell]["chips"] > 1:
        assert t["batch"] % CELLS[cell]["chips"] == 0
