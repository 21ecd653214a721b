"""The port's float forward pass against ``yolov3_tpu.model`` at
``precision="highest"`` (the heads, and every layer of yolov3 and
yolov3-spp at full depth), and the ``Darknet`` module's weight loading."""
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


def _jax_layers(jg, params_np, x):
    """Every layer's output of a walk built from ``yolov3_tpu.model``'s own
    ``_conv`` / ``_maxpool`` / ``_upsample_nearest`` at precision
    "highest" (shortcuts and routes as its ``forward_features`` does)."""
    params = {k: {n: jnp.asarray(v) for n, v in p.items()}
              for k, p in params_np.items()}
    prec = jmodel._PRECISIONS["highest"]
    cache, outs, prev = {}, [], jnp.asarray(x)
    for node in jg.nodes:
        if node.kind == "convolutional":
            p = params[node.index]
            out = jmodel._conv(prev, p["w"], p["b"], node, prec)
        elif node.kind == "maxpool":
            out = jmodel._maxpool(prev, node)
        elif node.kind == "upsample":
            out = jmodel._upsample_nearest(prev, node.stride)
        elif node.kind == "shortcut":
            assert node.activation == "linear"
            out = prev + cache[node.inputs[1]]
        elif node.kind == "route":
            srcs = [prev if i == node.index - 1 else cache[i]
                    for i in node.inputs]
            out = srcs[0] if len(srcs) == 1 else jnp.concatenate(srcs, -1)
        else:
            out = prev
        if node.index in jg.needed_outputs:
            cache[node.index] = out
        outs.append(np.asarray(out))
        prev = out
    return outs


def _layer_parity(cfg, hw):
    """Every layer of the port's walk (``forward_features(upto=k + 1)``,
    the served walk truncated) against the same layer of the JAX walk, and
    the heads against ``yolov3_tpu.model.forward_features`` itself, at
    "highest", B=1, full depth and width. Bar: 1e-5 of the layer's largest
    magnitude (float32 summation order; measured under 2e-6 through
    yolov3's 107 layers at 96x96, where activations grow to about 220)."""
    g, jg = load_graph(cfg), jload_graph(cfg)
    params_np = fold_raw(random_raw(g, seed=1))
    x = _inputs(1, hw, batch=1)
    want = _jax_layers(jg, params_np, x)
    tp = params_from_jax(params_np, device="cpu")
    for k, node in enumerate(g.nodes):
        got = tmodel.forward_features(g, tp, torch.from_numpy(x), "highest",
                                      upto=k + 1)[-1].numpy()
        assert got.shape == want[k].shape, (k, node.kind)
        bar = 1e-5 * max(float(np.abs(want[k]).max()), 1.0)
        assert np.abs(got - want[k]).max() <= bar, (k, node.kind)
    heads = jmodel.forward_features(
        jg, {k: {n: jnp.asarray(v) for n, v in p.items()}
             for k, p in params_np.items()}, jnp.asarray(x),
        precision="highest")
    got = tmodel.forward_features(g, tp, torch.from_numpy(x), "highest")
    assert len(got) == len(heads) == 3
    for gh, wh in zip(got, heads):
        bar = 1e-5 * max(float(np.abs(np.asarray(wh)).max()), 1.0)
        assert np.abs(gh.numpy() - np.asarray(wh)).max() <= bar


@pytest.mark.parametrize("name", ["yolov3", "yolov3-spp"])
def test_every_layer_matches_the_jax_walk(cfg_paths, name):
    _layer_parity(cfg_paths[name], (96, 96))


@pytest.mark.slow
@pytest.mark.parametrize("name,size", [("yolov3", 320), ("yolov3-spp", 416)])
def test_every_layer_matches_the_jax_walk_at_size(cfg_paths, name, size):
    _layer_parity(cfg_paths[name], (size, size))
