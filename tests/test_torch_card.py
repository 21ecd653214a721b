"""The card the bench and ``chip_smoke.py`` name beside their numbers: both
ask ``nvidia-smi`` for the card a device is by its UUID
(``--id=GPU-<uuid>``), never by the device's index, which nvidia-smi reads
in its own numbering of every card of the machine whatever
``CUDA_VISIBLE_DEVICES`` hides. ``subprocess.run`` and the device
properties are stubbed: no card is needed."""
import subprocess
from types import SimpleNamespace

import pytest
import torch

import chip_smoke
from yolov3_tpu_torch import bench

# as torch prints a CUDA device's uuid, and with nvidia-smi's prefix
UUIDS = {0: "6f1d0b52-1c3e-8a47-2b90-3d5e6f708192",
         3: "GPU-0a1b2c3d-4e5f-6071-8293-a4b5c6d7e8f9"}
LINE = "NVIDIA H100 80GB HBM3, 700.00 W"


@pytest.fixture
def smi(monkeypatch):
    calls = []

    def run(argv, **kw):
        calls.append(list(argv))
        return SimpleNamespace(stdout=LINE + "\n", returncode=0)

    monkeypatch.setattr(subprocess, "run", run)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: SimpleNamespace(
                            uuid=UUIDS[torch.device(d).index]))
    return calls


@pytest.mark.parametrize("index", sorted(UUIDS))
@pytest.mark.parametrize("helper", ["bench", "chip_smoke"])
def test_card_helpers_ask_for_the_card_by_uuid(smi, helper, index):
    device = torch.device("cuda", index)
    line = (bench.card_line(device) if helper == "bench"
            else chip_smoke.card_line(device))
    assert line == LINE
    (argv,) = smi
    uuid = UUIDS[index].removeprefix("GPU-")
    assert argv[0] == "nvidia-smi"
    assert argv[1] == f"--id=GPU-{uuid}"
    assert "--query-gpu=name,power.limit" in argv
    assert "--format=csv,noheader" in argv


def test_smoke_default_is_the_first_visible_card(smi):
    assert chip_smoke.card_line() == LINE
    assert smi[0][1] == f"--id=GPU-{UUIDS[0]}"


def test_bench_names_the_cpu_without_asking(smi):
    assert bench.card_line(torch.device("cpu")) == "cpu"
    assert smi == []
