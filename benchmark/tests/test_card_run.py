"""One short run of a cell, as the benchmark's command makes it, on the card
(skips without one): the result line's keys, in order, and a correct run."""
import json
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.card
def test_short_run_prints_a_correct_result(card):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "yolov3-608-bf16.cams8", "--seed", str(2 ** 31 + 3), "--seconds", "2",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=600, check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checked"]
    assert line["correct"], line["checked"]
    assert line["device"]["platform"] == "gpu"
    assert {"call_p50_ms", "call_p95_ms", "setup_s"} <= set(line["metrics"])
    assert out.stderr.strip().splitlines()[-1].startswith("checked det_gap")


def test_no_card_no_result(tmp_path):
    """Where the card or the program is missing, no result line."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
         "yolov3-608-bf16.cams8", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=600, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert not out.stdout.strip()
