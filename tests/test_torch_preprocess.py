"""The port's on-device preprocess against ``yolov3_tpu.ops.preprocess``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu.ops import preprocess as jpre
from yolov3_tpu_torch.ops import preprocess as tpre
from yolov3_tpu_torch.utils.boxes import letterbox_geometry

torch.set_num_threads(1)

SHAPES = [(480, 640), (501, 832), (300, 300), (97, 203)]


def test_constants_match():
    assert tpre.PAD_UINT8 == jpre.PAD_UINT8
    assert tpre.PAD_FLOAT == jpre.PAD_FLOAT
    for src, dst in ((480, 416), (640, 312), (97, 416), (416, 416)):
        np.testing.assert_array_equal(tpre._interp_matrix(src, dst),
                                      jpre._interp_matrix(src, dst))


@pytest.mark.parametrize("mode", ["letterbox", "stretch"])
@pytest.mark.parametrize("src_hw", SHAPES)
def test_preprocess_matches_jax(mode, src_hw):
    net = (416, 320)
    frames = np.random.default_rng(sum(src_hw)).integers(
        0, 256, (2, *src_hw, 3), dtype=np.uint8)
    want = np.asarray(jpre.preprocess(jnp.asarray(frames), net, mode=mode))
    got = tpre.preprocess(torch.from_numpy(frames), net, mode=mode).numpy()
    assert got.shape == want.shape == (2, *net, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if mode == "letterbox":
        _, top, left, nh, nw = letterbox_geometry(src_hw, net)
        pad = np.ones(got.shape[1:3], bool)
        pad[top:top + nh, left:left + nw] = False
        assert np.all(got[:, pad] == np.float32(tpre.PAD_FLOAT))


def test_cached_interp_matrices_give_same_result():
    frames = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (1, 480, 640, 3), dtype=np.uint8))
    out_hw = tpre.resize_target((480, 640), (416, 416), "letterbox")
    interp = tpre.interp_matrices((480, 640), out_hw, torch.device("cpu"))
    a = tpre.preprocess(frames, (416, 416))
    b = tpre.preprocess(frames, (416, 416), interp=interp)
    assert torch.equal(a, b)


def test_preprocess_rejects_bad_input():
    with pytest.raises(TypeError):
        tpre.preprocess(torch.zeros(1, 8, 8, 3), (32, 32))
    with pytest.raises(ValueError, match="mode"):
        tpre.preprocess(torch.zeros(1, 8, 8, 3, dtype=torch.uint8), (32, 32),
                        mode="crop")
