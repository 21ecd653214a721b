"""The port's copies of the reference's generators and analytic tools
against the originals in ``tools/``, on the CPU:

* ``gen_golden``: the constants equal the original's; ``golden_tiny.json``
  regenerated through the port into ``tmp_path`` meets the frozen fixture
  within ``tests/test_golden.py``'s bars (counts and classes exact, scores
  5e-5, boxes 0.1 px) with a threshold margin over 3 x 5e-5; ``--out
  tests/data`` is refused.
* ``probe_quant_error``: mode ``none`` scores mAP50 = mAP50_95 = 1.0
  exactly; ``weights`` equals the original tool's mAP to 1e-4; the two
  activation modes are within 0.03 of it (the fake-quant rounding of
  float32 activations that torch and XLA sum in other orders flips at
  round-half boundaries, and each flip moves near-threshold detections);
  the min/max calibration equals the original's to 1e-5 relative.
* ``bench_stem``: the s2d rearrangements equal the original's bit for bit
  (numpy), and the s2d stem matches the naive stem (float32 1e-5, bf16
  2e-2 relative: the tool's own bars).
* ``traffic_model``: per-mark bytes and MACs equal the original tool's
  (read through its printed table with its peaks set to unit rates) on
  every shipped cfg, at int8 with and without the heads.
* ``gen_cfgs``: byte-equal to ``models/*.cfg`` and ``coco.names``.
* ``torch_ref``: the port's copy gives the original's output bit for bit.
"""
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tools import bench_stem as jstem
from tools import gen_golden as jgolden
from tools import torch_ref as jtorch_ref
from tools import traffic_model as jtraffic
from yolov3_tpu.graph import load_graph as jload_graph
from yolov3_tpu.weights import random_raw as jrandom_raw
from yolov3_tpu_torch.graph import load_graph
from yolov3_tpu_torch.tools import bench_stem as tstem
from yolov3_tpu_torch.tools import gen_cfgs as tgen_cfgs
from yolov3_tpu_torch.tools import gen_golden as tgolden
from yolov3_tpu_torch.tools import probe_quant_error as tprobe
from yolov3_tpu_torch.tools import torch_ref as ttorch_ref
from yolov3_tpu_torch.tools import traffic_model as ttraffic

torch.set_num_threads(1)

REPO = Path(__file__).parent.parent
DATA = REPO / "tests" / "data"
CFGS = ("yolov3.cfg", "yolov3-tiny.cfg", "yolov3-spp.cfg")


# --- gen_golden ---------------------------------------------------------

def test_golden_constants_equal_the_originals():
    for name in ("SEED", "IOU_THRESH", "TOP_K", "SCORE_ATOL", "FIXTURES"):
        assert getattr(tgolden, name) == getattr(jgolden, name), name


def test_gen_golden_tiny_meets_the_frozen_fixture(tmp_path):
    (out,) = tgolden.main(["--out", str(tmp_path), "tiny", "--device", "cpu"])
    made = json.loads(out.read_text())
    frozen = json.loads((DATA / "golden_tiny.json").read_text())
    diffs = tgolden.check_against(made, frozen)
    assert diffs["survivors"] == len(frozen["scores"])
    assert diffs["max_score_diff"] <= 5e-5 and diffs["max_box_diff"] <= 0.1
    assert made["threshold_margin"] > 3 * 5e-5
    assert abs(made["prob_thresh"] - frozen["prob_thresh"]) < made["threshold_margin"]


def test_gen_golden_refuses_the_frozen_directory():
    with pytest.raises(SystemExit, match="frozen"):
        tgolden.main(["--out", str(DATA), "tiny", "--device", "cpu"])


def test_check_against_catches_a_moved_score():
    frozen = json.loads((DATA / "golden_tiny.json").read_text())
    moved = dict(frozen, scores=[s + 1e-4 for s in frozen["scores"]])
    with pytest.raises(AssertionError):
        tgolden.check_against(moved, frozen)


# --- probe_quant_error --------------------------------------------------

def _reference_probe_maps(capsys):
    import probe_quant_error as jprobe  # tools/ on sys.path, as it runs

    capsys.readouterr()
    jprobe.main()
    maps = {}
    for line in capsys.readouterr().out.splitlines():
        m = re.match(r"(\S+)\s*: mAP50 ([\d.]+) mAP50_95 ([\d.]+)", line)
        if m:
            maps[m.group(1)] = (float(m.group(2)), float(m.group(3)))
    return maps


@pytest.fixture(scope="module")
def probe_maps():
    return tprobe.score_modes("cpu")


def test_probe_none_scores_exactly_one(probe_maps):
    assert probe_maps["none"] == {"mAP50": 1.0, "mAP50_95": 1.0}


def test_probe_modes_against_the_reference_tool(probe_maps, capsys,
                                                monkeypatch):
    monkeypatch.syspath_prepend(str(REPO / "tools"))
    ref = _reference_probe_maps(capsys)
    assert set(ref) == set(tprobe.MODES)
    bars = {"none": 1e-4, "weights": 1e-4, "acts-sym": 0.03, "acts-asym": 0.03}
    for mode, (m50, m5095) in ref.items():
        got = probe_maps[mode]
        # the reference prints 4 decimals
        assert abs(got["mAP50"] - m50) <= bars[mode], (mode, got, ref[mode])
        assert abs(got["mAP50_95"] - m5095) <= bars[mode], (mode, got, ref[mode])


def test_probe_minmax_equals_the_reference(monkeypatch):
    import jax.numpy as jnp

    from yolov3_tpu.ops.preprocess import preprocess as jpreprocess
    from yolov3_tpu.weights import fold_raw
    from yolov3_tpu_torch.ops.preprocess import preprocess
    from yolov3_tpu_torch.weights import params_from_jax
    monkeypatch.syspath_prepend(str(REPO / "tools"))
    import probe_quant_error as jprobe

    g = jload_graph(REPO / "models" / "yolov3-tiny.cfg")
    folded = fold_raw(jrandom_raw(g, seed=3))
    frames = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3),
                                               dtype=np.uint8)
    ref = jprobe.calibrate_minmax(
        g, {i: {k: jnp.asarray(v) for k, v in p.items()}
            for i, p in folded.items()},
        [jpreprocess(jnp.asarray(frames), (64, 64))])
    got = tprobe.calibrate_minmax(
        load_graph(REPO / "models" / "yolov3-tiny.cfg"),
        params_from_jax(folded, "cpu"),
        [preprocess(torch.from_numpy(frames), (64, 64))])
    assert set(got) == set(ref)
    for i, (lo, hi) in ref.items():
        np.testing.assert_allclose(got[i], (lo, hi), rtol=1e-5, atol=1e-6)


# --- bench_stem ---------------------------------------------------------

def test_s2d_rearrangements_bit_equal_to_the_reference():
    p = tstem.stem_weights(4)
    np.testing.assert_array_equal(tstem.conv1_s2d_weights(p["w1"]),
                                  np.asarray(jstem.conv1_s2d_weights(p["w1"])))
    np.testing.assert_array_equal(tstem.conv2_s2d_weights(p["w2"]),
                                  np.asarray(jstem.conv2_s2d_weights(p["w2"])))
    x = np.random.default_rng(1).uniform(0, 1, (2, 8, 12, 3)).astype(np.float32)
    np.testing.assert_array_equal(tstem.s2d(x), np.asarray(jstem.s2d(x)))
    np.testing.assert_array_equal(
        tstem.s2d_torch(torch.from_numpy(x)).numpy(), tstem.s2d(x))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_s2d_stem_matches_the_naive_stem(dtype):
    out = tstem.run(32, 2, dtype, "cpu")
    assert out["parity_rel"] < tstem.PARITY_REL[dtype]
    assert out["ms"] is None  # no device clock on the CPU


# --- traffic_model ------------------------------------------------------

def _reference_counts(cfg, size, batch, int8_heads, capsys, monkeypatch):
    """The original tool's per-mark bytes and MACs: its table printed with
    unit peaks (1 byte/ms, 1 MAC/ms)."""
    monkeypatch.setattr(jtraffic, "HBM_GBPS", 1e-6)
    monkeypatch.setattr(jtraffic, "INT8_TOPS", 2e-9)
    monkeypatch.setattr(jtraffic, "BF16_TFLOPS", 2e-9)
    argv = ["traffic_model.py", "--cfg", cfg, "--size", str(size),
            "--batch", str(batch)] + (["--int8-heads"] if int8_heads else [])
    monkeypatch.setattr(sys, "argv", argv)
    capsys.readouterr()
    jtraffic.main()
    rows = []
    for line in capsys.readouterr().out.splitlines():
        m = re.match(r"\[\s*(\d+):\s*(\d+)\)\s+([\d.]+)\s+([\d.]+)", line)
        if m:
            rows.append((int(m.group(1)), int(m.group(2)),
                         round(float(m.group(3))), round(float(m.group(4)))))
    return rows


@pytest.mark.parametrize("cfg", CFGS)
@pytest.mark.parametrize("int8_heads", [False, True])
def test_traffic_counts_equal_the_reference(cfg, int8_heads, capsys,
                                            monkeypatch):
    ref = _reference_counts(cfg, 416, 8, int8_heads, capsys, monkeypatch)
    floors = ttraffic.stage_floors(load_graph(REPO / "models" / cfg), 416, 8,
                                   "int8", int8_heads)
    assert [(f["lo"], f["hi"], f["bytes"], f["macs"]) for f in floors] == ref


def test_traffic_bf16_walk_counts():
    g = load_graph(REPO / "models" / "yolov3.cfg")
    int8 = ttraffic.stage_floors(g, 416, 8, "int8")
    bf16 = ttraffic.stage_floors(g, 416, 8, "bf16")
    assert [f["macs"] for f in bf16] == [f["macs"] for f in int8]
    assert all(b["bytes"] >= i["bytes"] for b, i in zip(bf16, int8))
    for f in bf16:  # every conv at the bf16 peak
        assert f["mxu_ms"] == pytest.approx(
            2 * f["macs"] / ttraffic.BF16_FLOPS_PER_S * 1e3)
    assert ttraffic.stage_marks(g) == [2, 6, 13, 38, 63, 107]


# --- gen_cfgs -----------------------------------------------------------

@pytest.fixture(scope="module")
def generated_cfgs(tmp_path_factory):
    out = tmp_path_factory.mktemp("cfgs")
    tgen_cfgs.main(str(out))
    return out


@pytest.mark.parametrize("name", [*CFGS, "coco.names"])
def test_gen_cfgs_byte_equal_to_models(generated_cfgs, name):
    assert (generated_cfgs / name).read_bytes() == \
        (REPO / "models" / name).read_bytes()


# --- torch_ref ----------------------------------------------------------

@pytest.mark.parametrize("cfg", CFGS)
def test_torch_ref_bit_equal_to_the_original(cfg):
    jg = jload_graph(REPO / "models" / cfg)
    raw = jrandom_raw(jg, seed=2, scale=0.9)
    x = np.random.default_rng(5).uniform(0, 1, (1, 3, 64, 64)).astype(np.float32)
    want = jtorch_ref.torch_forward(jg, raw, x)
    got = ttorch_ref.torch_forward(load_graph(REPO / "models" / cfg), raw, x)
    np.testing.assert_array_equal(got, want)
