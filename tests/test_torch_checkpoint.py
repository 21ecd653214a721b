"""The port's parameter checkpoint (``weights.save_params`` /
``load_params``) against the JAX package's orbax pair
(``yolov3_tpu.weights.save_params_orbax`` / ``load_params_orbax``), CPU.

* The round trip is exact (``np.testing.assert_array_equal``): the file read
  by ``np.load`` holds the JAX package's ``fold_raw(random_raw(g, seed=8))``
  arrays unchanged, as ``tests/test_sharding.py``'s orbax test holds its
  own, on yolov3-tiny.
* ``load_params`` feeds ``params_from_jax`` and ``Darknet.set_params``
  with no other conversion: a net on the reloaded tree gives the original
  net's output bit for bit.
* The write goes through a temp file replaced into place.
"""
import numpy as np
import pytest
import torch

from yolov3_tpu.graph import load_graph as jload_graph
from yolov3_tpu.weights import fold_raw as jfold_raw
from yolov3_tpu.weights import load_params_orbax, random_raw as jrandom_raw
from yolov3_tpu.weights import save_params_orbax
from yolov3_tpu_torch.model import Darknet
from yolov3_tpu_torch.weights import (load_params, params_from_jax,
                                      save_params)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny_params(cfg_paths):
    return jfold_raw(jrandom_raw(jload_graph(cfg_paths["yolov3-tiny"]), seed=8))


def test_round_trip_exact_against_the_jax_tree(tiny_params, tmp_path):
    path = tmp_path / "ckpt.npz"
    save_params(path, tiny_params)
    with np.load(path) as z:
        assert sorted(z.files) == sorted(
            f"{i}.{k}" for i in tiny_params for k in ("w", "b"))
        for idx, p in tiny_params.items():
            for k in ("w", "b"):
                assert z[f"{idx}.{k}"].dtype == np.float32
                np.testing.assert_array_equal(z[f"{idx}.{k}"], p[k])
    restored = load_params(path)
    assert set(restored) == set(tiny_params)
    for idx, p in tiny_params.items():
        np.testing.assert_array_equal(restored[idx]["w"], p["w"])
        np.testing.assert_array_equal(restored[idx]["b"], p["b"])
    assert not list(tmp_path.glob("*.tmp")), "temp file left behind"


def test_same_tree_as_the_orbax_checkpoint(tiny_params, tmp_path):
    save_params_orbax(tmp_path / "orbax", tiny_params)
    save_params(tmp_path / "ckpt.npz", tiny_params)
    ours, theirs = (load_params(tmp_path / "ckpt.npz"),
                    load_params_orbax(tmp_path / "orbax"))
    assert set(ours) == set(theirs)
    for idx in theirs:
        for k in ("w", "b"):
            np.testing.assert_array_equal(ours[idx][k], theirs[idx][k])


def test_overwrite_replaces_the_checkpoint(tiny_params, tmp_path):
    path = tmp_path / "ckpt.npz"
    save_params(path, {i: {"w": p["w"] * 0, "b": p["b"] * 0}
                       for i, p in tiny_params.items()})
    save_params(path, tiny_params)
    restored = load_params(path)
    for idx, p in tiny_params.items():
        np.testing.assert_array_equal(restored[idx]["w"], p["w"])


def test_reloaded_tree_feeds_darknet_bit_for_bit(tiny_params, cfg_paths,
                                                 tmp_path):
    path = tmp_path / "ckpt.npz"
    save_params(path, tiny_params)
    restored = load_params(path)
    converted = params_from_jax(restored, device="cpu")
    for idx, p in params_from_jax(tiny_params, device="cpu").items():
        assert torch.equal(converted[idx]["w"], p["w"])
        assert torch.equal(converted[idx]["b"], p["b"])
    x = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 1, (1, 96, 96, 3)).astype(np.float32))
    cfg = cfg_paths["yolov3-tiny"]
    a = Darknet(cfg, precision="highest", device="cpu").set_params(tiny_params)
    b = Darknet(cfg, precision="highest", device="cpu").set_params(restored)
    assert torch.equal(a(x), b(x))
