"""The port's serving and selection measuring tools, end to end on the CPU
at a small size (their timings are the card's; here their checks run):

* ``bench_serve`` on tiny@96: both modes answer every request (0 errors),
  the concurrent burst's device batches are the batcher's padded size, and
  no program is captured inside a timed run.
* ``bench_scan`` on tiny@96 at bf16 and int8: the scanned program's packed
  results equal the unscanned calls' bit for bit (the tool raises
  otherwise), and its per-step sums are those of the packed results.
* ``bench_tiny_k``: the truncation audit holds its contract (the
  untruncated images' detection sets equal at every K) with rows on both
  sides of a K; a truncated image does not count against it.
* the selection microbenches (``bench_topk``, ``bench_select_group``,
  ``bench_gather``): every variant passes its exact check at N = 10,647
  and 22,743, K = 512; the port's serving stage picks the reference's
  ``stage_topk`` selection (``tools/bench_topk.py``) on the reference's own
  ``make_inputs``, exactly, on the valid slots; a wrong selection fails its
  check.
* ``examples/demo_torch.py`` runs with ``--device cpu``, writes its image,
  and loads nothing of JAX.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tools import bench_topk as jtopk
from yolov3_tpu_torch.tools import bench_gather, bench_scan, bench_select_group
from yolov3_tpu_torch.tools import bench_serve, bench_tiny_k, bench_topk

torch.set_num_threads(1)

REPO = Path(__file__).parent.parent


# --- bench_serve --------------------------------------------------------

def test_bench_serve_both_modes_no_errors(capsys):
    rows = bench_serve.main([
        "--config", "models/yolov3-tiny.cfg", "--size", "96",
        "--src-hw", "120x160", "--clients", "4", "--requests", "2",
        "--seq-requests", "3", "--max-batch", "4", "--device", "cpu"])
    seq, conc = rows
    assert seq["mode"] == "sequential" and conc["mode"] == "concurrent"
    keys = {"mode", "server", "device", "max_results", "src_hw", "requests",
            "errors", "p50_ms", "p90_ms", "p95_ms", "p99_ms", "req_s",
            "stages"}
    assert set(seq) == keys
    assert set(conc) == keys | {"clients", "window_ms", "max_batch",
                                "batch_size_hist_le", "mean_fill"}
    for row in rows:
        assert row["errors"] == 0 and row["device"] == "cpu"
        assert row["p50_ms"] > 0 and row["req_s"] > 0
        assert {"decode_s", "h2d_s", "dispatch_s",
                "device_fetch_s"} <= set(row["stages"])
    assert seq["requests"] == 3 and conc["requests"] == 8
    # every device batch is padded to max_batch; the histogram counts real
    # requests, 8 of them in the timed run
    assert sum(int(s) * n for s, n in conc["batch_size_hist_le"].items()) == 8
    assert 1 <= conc["mean_fill"] <= 4
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("{")]
    assert printed == rows


# --- bench_scan ---------------------------------------------------------

@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_bench_scan_scanned_equals_unscanned(precision):
    out = bench_scan.main([
        "--cfg", "yolov3-tiny.cfg", "--size", "96", "--batch", "2",
        "--scan", "3", "--dispatches", "1", "--precision", precision,
        "--top-k", "64", "--block-impl", "pallas", "--device", "cpu"])
    assert out["scanned_equal_unscanned"] and out["replay_ms"] is None
    assert len(out["step_score_sums"]) == len(out["step_survivors"]) == 3
    assert out["img_s"] > 0 and all(n > 0 for n in out["step_survivors"])


def test_step_sums_of_packed_results():
    packed = np.zeros((4, 3, 6), np.float32)
    packed[0, 0, 4], packed[1, 2, 4], packed[3, 1, 4] = 0.5, 0.25, 0.75
    assert bench_scan.step_sums(packed, 2) == ([0.75, 0.75], [2, 1])


# --- bench_tiny_k -------------------------------------------------------

def test_tiny_k_audit_holds_its_contract():
    rows = bench_tiny_k.main([
        "--size", "96", "--batch", "4", "--scan", "2", "--iters", "1",
        "--ks", "128", "64", "32", "18", "--audit-images", "8",
        "--device", "cpu"])
    sweep = [r for r in rows if "row" in r]
    audit = [r for r in rows if "audit" in r]
    assert [r["row"].rsplit("K=", 1)[1] for r in sweep] == ["128", "64", "32", "18"]
    assert len(audit) == 6
    bite = False
    for row in audit:
        for k in ("K=18", "K=32", "K=64"):
            cell = row[k]
            assert cell["untruncated_equal"], (row, k)
            bite |= cell["untruncated_images"] > 0 and cell["truncated_images"] > 0
    # at least one (threshold, K) splits the images: the check has bite
    assert bite


def test_audit_row_flags_a_differing_set():
    pre = np.array([3, 10])
    same = [{((0.0, 0.0, 1.0, 1.0), 1)}, {((0.0, 0.0, 2.0, 2.0), 2)}]
    moved = [{((0.0, 0.0, 1.0, 1.5), 1)}, same[1]]
    row = bench_tiny_k.audit_row("x", 0.1, pre, {8: moved, 16: same}, [8, 16])
    assert row["K=8"] == {"truncated_images": 1, "untruncated_images": 1,
                          "untruncated_equal": False}


# --- the selection microbenches -----------------------------------------

@pytest.mark.parametrize("n", [bench_topk.N_416, bench_topk.N_608])
@pytest.mark.parametrize("tool", [bench_topk, bench_select_group, bench_gather])
def test_selection_variants_pass_their_checks(tool, n):
    make = (bench_select_group.variants() if tool is bench_select_group
            else tool.variants)
    rows = bench_topk.run(2, n, 512, 0.02, "cpu", make, log=lambda s: None)
    assert rows and all(r["checked"] and r["ms"] is None for r in rows)


@pytest.mark.parametrize("n", [bench_topk.N_416, bench_topk.N_608])
def test_serving_stage_picks_the_reference_selection(n):
    import jax.numpy as jnp

    s, b, c = (np.asarray(a) for a in jtopk.make_inputs(2, n))
    ts, tb, tc = bench_topk.make_inputs(2, n)
    for mine, theirs in ((ts, s), (tb, b), (tc, c)):
        np.testing.assert_array_equal(mine.numpy(), theirs)
    ref_s, ref_b, ref_c = (np.asarray(a) for a in jtopk.stage_topk(
        jnp.asarray(s), jnp.asarray(b), jnp.asarray(c), 512))
    sel = bench_topk.Selection(ts, tb, tc, 512)
    v = sel.valid.numpy()
    assert v.sum() > 0
    np.testing.assert_array_equal(sel.scores.numpy()[v], ref_s[v])
    np.testing.assert_array_equal(sel.boxes.numpy()[v], ref_b[v])
    np.testing.assert_array_equal(sel.classes.numpy()[v], ref_c[v])
    np.testing.assert_array_equal(v, ref_s > 0)


def test_selection_check_catches_a_wrong_selection():
    s, b, c = bench_topk.make_inputs(2, 4096)
    sel = bench_topk.Selection(s, b, c, 512)
    wrong = torch.topk(s, 512).values.clone()
    wrong[0, 0] = wrong[0, 1]
    with pytest.raises(AssertionError):
        sel.check("wrong", scores=wrong)


def test_compaction_refuses_more_candidates_than_slots():
    s, b, c = bench_topk.make_inputs(1, 4096, density=0.5)
    with pytest.raises(ValueError, match="at most K"):
        bench_topk.variants(s, b, c, 512)


# --- the demo -----------------------------------------------------------

def test_demo_torch_runs_on_the_cpu(tmp_path):
    sys.path.insert(0, str(REPO / "examples"))
    try:
        import demo_torch
    finally:
        sys.path.remove(str(REPO / "examples"))
    out = tmp_path / "demo.jpg"
    res = demo_torch.main(["--device", "cpu", "--out", str(out),
                           "--precision", "highest"])
    assert out.stat().st_size > 0
    assert res.bbox_tlbr.shape == (len(res.class_prob), 4)


def test_demo_torch_imports_no_jax(tmp_path):
    """The demo, run to its end in a fresh interpreter, loads nothing of
    JAX, the JAX package or ``tools/``."""
    code = ("import sys\nsys.path.insert(0, 'examples')\n"
            "import demo_torch\n"
            f"demo_torch.main(['--device', 'cpu', '--out', {str(tmp_path / 'd.jpg')!r}])\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'yolov3_tpu', 'tools'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
