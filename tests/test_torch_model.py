"""The port's float forward pass against ``yolov3_tpu.model`` at
``precision="highest"``, and the ``Darknet`` module's weight loading."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu import model as jmodel
from yolov3_tpu.graph import load_graph as jload_graph
from yolov3_tpu_torch import model as tmodel
from yolov3_tpu_torch.graph import load_graph
from yolov3_tpu_torch.weights import (fold_raw, params_from_jax,
                                      quant_state_from_jax, random_raw,
                                      write_weights)

torch.set_num_threads(1)

SMALL_CFG = os.path.join(os.path.dirname(__file__), "data", "port_small.cfg")


def _inputs(seed, hw, batch=2):
    return np.random.default_rng(seed).uniform(
        0, 1, (batch, *hw, 3)).astype(np.float32)


@pytest.mark.parametrize("hw", [(64, 64), (48, 80)])
def test_forward_features_matches_jax(hw):
    g = load_graph(SMALL_CFG)
    params_np = fold_raw(random_raw(g, seed=4))
    x = _inputs(0, hw)
    want = jmodel.forward_features(
        jload_graph(SMALL_CFG),
        {k: {n: jnp.asarray(v) for n, v in p.items()} for k, p in params_np.items()},
        jnp.asarray(x), precision="highest")
    got = tmodel.forward_features(g, params_from_jax(params_np, device="cpu"),
                                  torch.from_numpy(x), precision="highest")
    assert len(got) == len(want) == 2
    for gh, wh in zip(got, want):
        assert tuple(gh.shape) == wh.shape
        assert gh.is_contiguous()  # NHWC view of a channels_last conv output
        np.testing.assert_allclose(gh.numpy(), np.asarray(wh),
                                   rtol=1e-4, atol=1e-5)


def test_forward_features_tiny_maxpool_padding(cfg_paths):
    """yolov3-tiny's stride-1 size-2 pool against the JAX walk at 96x96."""
    g = load_graph(cfg_paths["yolov3-tiny"])
    params_np = fold_raw(random_raw(g, seed=8))
    x = _inputs(1, (96, 96), batch=1)
    want = jmodel.forward_features(
        jload_graph(cfg_paths["yolov3-tiny"]),
        {k: {n: jnp.asarray(v) for n, v in p.items()} for k, p in params_np.items()},
        jnp.asarray(x), precision="highest")
    got = tmodel.forward_features(g, params_from_jax(params_np, device="cpu"),
                                  torch.from_numpy(x), precision="highest")
    for gh, wh in zip(got, want):
        np.testing.assert_allclose(gh.numpy(), np.asarray(wh),
                                   rtol=1e-4, atol=1e-5)


def test_darknet_load_weights_equals_set_params(tmp_path):
    g = load_graph(SMALL_CFG)
    raw = random_raw(g, seed=6)
    path = tmp_path / "small.weights"
    write_weights(path, g, raw)
    a = tmodel.Darknet(SMALL_CFG, precision="highest", device="cpu").load_weights(path)
    b = tmodel.Darknet(SMALL_CFG, precision="highest", device="cpu").set_params(fold_raw(raw))
    for idx in a.params:
        for key in ("w", "b"):
            assert torch.equal(a.params[idx][key], b.params[idx][key])
    x = torch.from_numpy(_inputs(2, (64, 64)))
    for ha, hb in zip(a(x), b(x)):
        assert torch.equal(ha, hb)


def test_darknet_errors():
    with pytest.raises(ValueError, match="precision"):
        tmodel.Darknet(SMALL_CFG, precision="fp16", device="cpu")
    net = tmodel.Darknet(SMALL_CFG, device="cpu")
    with pytest.raises(RuntimeError, match="load_weights"):
        net(torch.zeros(1, 64, 64, 3))
    with pytest.raises(ValueError, match="missing"):
        net.set_params({})


def test_cuda_device_without_card_raises(monkeypatch):
    """No silent fall back to the CPU when CUDA is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tmodel.Darknet(SMALL_CFG, device="cuda")


def test_default_device_is_the_card(monkeypatch):
    """With no ``device`` the net, and the weight converters beside it, go
    to the card; without one they raise rather than land on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params_np = fold_raw(random_raw(load_graph(SMALL_CFG), seed=0))
    with pytest.raises(RuntimeError, match="cuda"):
        tmodel.Darknet(SMALL_CFG)
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_jax(params_np)
    with pytest.raises(RuntimeError, match="cuda"):
        quant_state_from_jax({0: {"w": params_np[0]["w"], "b": params_np[0]["b"]}})
