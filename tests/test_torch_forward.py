"""The reference ``Darknet.forward`` contract in the port: ``ops/decode.py``
and ``model.forward`` against the JAX package's on the same inputs, and the
port's ``Darknet(x)`` returning the decoded (B, N, 5+C) tensor as the JAX
``Darknet(x)`` does."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu import model as jmodel
from yolov3_tpu.graph import load_graph as jload_graph
from yolov3_tpu.ops import decode as jdecode
from yolov3_tpu_torch import model as tmodel
from yolov3_tpu_torch.graph import load_graph
from yolov3_tpu_torch.ops import decode as tdecode
from yolov3_tpu_torch.weights import fold_raw, params_from_jax, random_raw

torch.set_num_threads(1)

SMALL_CFG = os.path.join(os.path.dirname(__file__), "data", "port_small.cfg")
ANCHORS = [((10.0, 14.0), (23.0, 27.0), (37.0, 58.0)),
           ((81.0, 82.0), (135.0, 169.0), (344.0, 319.0))]
STRIDES = [32, 16]
GRIDS = [(5, 5), (10, 8)]


def _heads(num_classes, seed):
    """Two head maps (B=2) with tie-heavy logits (1/8 grid) and box logits
    past the exp clamp at 60."""
    rng = np.random.default_rng(seed)
    per = 5 + num_classes
    heads = []
    for gy, gx in GRIDS:
        f = rng.normal(0, 2, (2, gy, gx, 3, per)).astype(np.float32)
        f[..., 4:] = np.round(f[..., 4:] * 8) / 8            # exact ties
        big = rng.uniform(0, 1, f[..., 2:4].shape) < 0.05
        f[..., 2:4] = np.where(big, rng.uniform(60, 90, big.shape), f[..., 2:4])
        heads.append(np.ascontiguousarray(f.reshape(2, gy, gx, 3 * per)))
    return heads


def _assert_float_lanes(got, want):
    # sigmoid and exp differ in the last ulps between XLA's CPU backend and
    # torch: the float lanes' tolerance of tests/test_torch_decode.py
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


def _jparams(params_np):
    return {k: {n: jnp.asarray(v) for n, v in p.items()}
            for k, p in params_np.items()}


@pytest.mark.parametrize("num_classes", [3, 80])
def test_decode_all_matches_jax(num_classes):
    heads = _heads(num_classes, seed=num_classes)
    want = np.asarray(jdecode.decode_all([jnp.asarray(h) for h in heads],
                                         ANCHORS, STRIDES, num_classes))
    got = tdecode.decode_all([torch.from_numpy(h) for h in heads], ANCHORS,
                             STRIDES, num_classes).numpy()
    assert got.shape == want.shape == (2, 3 * (25 + 80), 5 + num_classes)
    assert np.isfinite(got).all()
    _assert_float_lanes(got, want)
    # decode_all is the heads' decode_head outputs concatenated
    one = tdecode.decode_head(torch.from_numpy(heads[1]), ANCHORS[1],
                              STRIDES[1], num_classes).numpy()
    np.testing.assert_array_equal(got[:, 75:], one)


@pytest.mark.parametrize("num_classes", [3, 80])
def test_decode_compact_matches_jax(num_classes):
    heads = _heads(num_classes, seed=10 + num_classes)
    want = [np.asarray(a) for a in jdecode.decode_compact(
        [jnp.asarray(h) for h in heads], ANCHORS, STRIDES, num_classes)]
    got = [t.numpy() for t in tdecode.decode_compact(
        [torch.from_numpy(h) for h in heads], ANCHORS, STRIDES, num_classes)]
    assert got[2].dtype == np.int32
    # first-argmax class over tie-heavy logits: exact
    np.testing.assert_array_equal(got[2], want[2])
    _assert_float_lanes(got[0], want[0])
    _assert_float_lanes(got[1], want[1])


@pytest.mark.parametrize("hw", [(64, 64), (48, 80)])
def test_forward_matches_jax(hw):
    params_np = fold_raw(random_raw(load_graph(SMALL_CFG), seed=5))
    x = np.random.default_rng(1).uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    want = np.asarray(jmodel.forward(jload_graph(SMALL_CFG), _jparams(params_np),
                                     jnp.asarray(x), precision="highest"))
    got = tmodel.forward(load_graph(SMALL_CFG), params_from_jax(params_np, device="cpu"),
                         torch.from_numpy(x), precision="highest").numpy()
    assert got.shape == want.shape
    _assert_float_lanes(got, want)


def test_darknet_call_returns_decoded_detections():
    """The port's ``Darknet(x)`` is the reference ``Darknet.forward``: the
    decoded (B, N, 5+C) tensor, equal to the JAX ``Darknet(x)`` on the same
    folded params (it returned the NHWC head maps before)."""
    params_np = fold_raw(random_raw(load_graph(SMALL_CFG), seed=7))
    x = np.random.default_rng(2).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jmodel.Darknet(SMALL_CFG, precision="highest")
                      .set_params(params_np)(jnp.asarray(x)))
    net = tmodel.Darknet(SMALL_CFG, precision="highest", device="cpu").set_params(params_np)
    got = net(torch.from_numpy(x))
    assert isinstance(got, torch.Tensor)
    assert tuple(got.shape) == want.shape == (2, 3 * (8 * 8 + 16 * 16), 8)
    _assert_float_lanes(got.numpy(), want)
