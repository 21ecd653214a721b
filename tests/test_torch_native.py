"""The port's binding of the C++ host loader (``yolov3_tpu_torch/native.py``)
against the JAX package's (``yolov3_tpu.native``), byte for byte, the pad
contract, and the build: where it lands, and that concurrent builds never
load a half-written library."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from yolov3_tpu import native as jnative
from yolov3_tpu_torch import native as tnative
from yolov3_tpu_torch.ops.preprocess import PAD_FLOAT, preprocess
from yolov3_tpu_torch.utils.boxes import letterbox_geometry
from tests.test_torch_jax_loader import private_jax_loader

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
NET_HW = (96, 128)


@pytest.fixture(scope="module", autouse=True)
def jax_loader(tmp_path_factory):
    """The JAX loader this module holds the port's to, built privately
    (``private_jax_loader``)."""
    with private_jax_loader(tmp_path_factory.mktemp("jax_loader")):
        yield


def _frames(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in shapes]


def test_builds_into_build_native_and_loads():
    """g++ is part of the test environment: a failed build fails here."""
    assert tnative.available()
    lib = tnative.library_path()
    assert lib.is_file()
    assert lib.parent == REPO / "build" / "native"
    assert lib.name.startswith("libpreproc-") and lib.suffix == ".so"
    assert tnative.PAD_VALUE == jnative.PAD_VALUE == 128


@pytest.mark.parametrize("swap_rb", [True, False])
@pytest.mark.parametrize("fn", ["letterbox_batch_native",
                                "stretch_batch_native"])
def test_batch_functions_equal_jax_binding(fn, swap_rb):
    assert jnative.available()
    for seed, (h, w) in enumerate([(60, 80), (200, 150), (97, 131)]):
        frames = np.stack(_frames(seed, [(h, w)] * 3))
        got = getattr(tnative, fn)(frames, NET_HW, swap_rb=swap_rb)
        want = getattr(jnative, fn)(frames, NET_HW, swap_rb=swap_rb)
        assert got.dtype == np.uint8 and got.shape == (3, *NET_HW, 3)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("swap_rb", [True, False])
def test_letterbox_mixed_equals_jax_binding(swap_rb):
    frames = _frames(7, [(60, 80), (200, 150), (97, 131), (96, 128), (1, 1)])
    got = tnative.letterbox_mixed_native(frames, NET_HW, swap_rb=swap_rb)
    want = jnative.letterbox_mixed_native(frames, NET_HW, swap_rb=swap_rb)
    np.testing.assert_array_equal(got, want)
    # and the mixed call equals the per-shape batch call, frame by frame
    for i, f in enumerate(frames):
        one = tnative.letterbox_batch_native(f[None], NET_HW, swap_rb=swap_rb)
        np.testing.assert_array_equal(got[i], one[0])


def test_pad_contract_host_and_device():
    """The loader pads 128 exactly; the device preprocess pads 128/255, so
    the normalized borders of both routes are bit-identical."""
    (frame,) = _frames(3, [(50, 128)])
    canvas = tnative.letterbox_mixed_native([frame], NET_HW)[0]
    _, top, left, new_h, new_w = letterbox_geometry(frame.shape[:2], NET_HW)
    inside = np.zeros(NET_HW, bool)
    inside[top:top + new_h, left:left + new_w] = True
    assert (~inside).any()
    assert (canvas[~inside] == tnative.PAD_VALUE).all()
    dev = preprocess(torch.from_numpy(frame[None]), NET_HW)[0].numpy()
    assert (dev[~inside] == np.float32(PAD_FLOAT)).all()
    host = canvas.astype(np.float32) * np.float32(1.0 / 255.0)
    np.testing.assert_array_equal(host[~inside], dev[~inside])
    # interior: uint8 rounding of the host resize against the float resize
    # (tests/test_native_preproc.py's bar: one LSB)
    diff = np.abs(host[inside] - dev[inside][..., ::-1])
    assert diff.max() <= 1.0 / 255.0 + 1e-6


def test_bad_input_raises():
    with pytest.raises(ValueError, match="B, H, W, 3"):
        tnative.letterbox_batch_native(np.zeros((4, 4, 3), np.uint8), NET_HW)
    with pytest.raises(ValueError, match="H, W, 3"):
        tnative.letterbox_mixed_native([np.zeros((4, 4), np.uint8)], NET_HW)


def test_no_compiler_means_unavailable_not_an_error(tmp_path, monkeypatch):
    def no_gxx(*a, **k):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(tnative.subprocess, "run", no_gxx)
    assert tnative.build(tmp_path) is None
    assert not list(tmp_path.glob("*"))


BUILD_AND_LOAD = """
import ctypes, sys
from yolov3_tpu_torch import native
lib = native.build(sys.argv[1])
assert lib is not None and lib.is_file(), lib
print(ctypes.CDLL(str(lib)).preproc_version(), lib.name)
"""


def test_four_processes_build_at_once(tmp_path):
    """Four processes race to build for one fresh directory: each loads a whole
    library (the compiler writes to a private name, moved into place)."""
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_AND_LOAD,
                               str(tmp_path)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        finally:
            if p.poll() is None:
                p.kill()
        assert p.returncode == 0, err
        outs.append(out.split())
    assert {o[0] for o in outs} == {"1"}
    assert len({o[1] for o in outs}) == 1
    left = sorted(f.name for f in tmp_path.iterdir())
    assert left == [outs[0][1]], left  # no temporary files stay behind
    assert not (REPO / "native" / outs[0][1]).exists()
