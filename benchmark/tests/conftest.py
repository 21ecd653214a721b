"""CPU tests of the benchmark, and one marked ``card`` that runs a cell on
the card (``python -m pytest benchmark/tests -q`` runs them all; the
``card`` test skips where there is no card)."""
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: the benchmark's runs need one")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny_cfg(tmp_path):
    """yolov3-tiny at 96 x 96: every layer kind the reference walks but the
    shortcut, small enough for the CPU."""
    text = (ROOT / "models" / "yolov3-tiny.cfg").read_text()
    text = text.replace("width=416", "width=96").replace("height=416", "height=96")
    path = tmp_path / "tiny96.cfg"
    path.write_text(text)
    return path


@pytest.fixture
def small_cfg(tmp_path):
    """yolov3 itself (the shortcut and every route) at 64 x 64."""
    text = (BENCH / "configs" / "yolov3.cfg").read_text()
    text = text.replace("width=608", "width=64").replace("height=608", "height=64")
    path = tmp_path / "yolov3_64.cfg"
    path.write_text(text)
    return path
