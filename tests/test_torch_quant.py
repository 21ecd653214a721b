"""The port's int8 quantize sites, weight quantization, graph predicates and
exact int8 convs against the JAX package on seeded numpy inputs (CPU)."""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu import quant as jq
from yolov3_tpu.graph import load_graph as jload_graph
from yolov3_tpu_torch import quant as tq
from yolov3_tpu_torch.graph import load_graph
from yolov3_tpu_torch.ops import int8_conv
from yolov3_tpu_torch.weights import (fold_raw, params_from_jax,
                                      quant_state_from_jax, random_raw)

torch.set_num_threads(1)

DATA = Path(__file__).parent / "data"
MODELS = Path(__file__).parent.parent / "models"
CFGS = {"small": DATA / "port_small.cfg", "wide": DATA / "port_wide.cfg",
        "block": DATA / "port_block.cfg", "tiny": MODELS / "yolov3-tiny.cfg",
        "yolov3": MODELS / "yolov3.cfg"}


def _values_with_ties(scale: float, seed: int) -> np.ndarray:
    """Random values plus exact half-way points (k + 0.5)·scale, where the
    rounding mode shows, and values past the clip."""
    rng = np.random.default_rng(seed)
    ties = (np.arange(-140, 140) + 0.5) * scale
    return np.concatenate([rng.normal(0, 40 * scale, 4000), ties,
                           [0.0, 200 * scale, -200 * scale]]).astype(np.float32)


@pytest.mark.parametrize("scale,zero", [(0.037, 0), (0.25, 0), (0.0123, -41),
                                        (0.5, 17), (1.0 / 127, 127)])
def test_quantize_sites_match_jax(scale, zero):
    """Round half to even, one float32 rounding of 1/scale, clip at ±127:
    exact against the JAX sites, ties included."""
    y = _values_with_ties(scale, seed=1)
    got = tq._quantize_affine(torch.from_numpy(y), scale, zero)
    want = np.asarray(jq._quantize_affine(jnp.asarray(y), scale, zero))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    if zero == 0:
        np.testing.assert_array_equal(
            tq._quantize_to(torch.from_numpy(y), scale).numpy(),
            np.asarray(jq._quantize_to(jnp.asarray(y), scale)))
    # 0.5 rounds to 0 and 1.5 to 2: not round-half-away
    half = torch.tensor([0.5 * scale, 1.5 * scale, -0.5 * scale, -2.5 * scale])
    if scale in (0.25, 0.5):  # 1/scale exact, so the ties are exact
        assert tq._quantize_affine(half, scale).tolist() == [0, 2, 0, -2]


@pytest.mark.parametrize("scale,zero", [(0.037, 0), (0.0123, -41), (0.31, 17),
                                        (7.3e-3, 127)])
def test_dequantize_affine(scale, zero):
    """``q = z`` dequantizes to exactly 0.0 (both products in float32); every
    value is within 1 ulp of the JAX site, which folds z·s in double."""
    q = np.arange(-127, 128, dtype=np.int8)
    got = tq._dequantize_affine(torch.from_numpy(q), scale, zero).numpy()
    want = np.asarray(jq._dequantize_affine(jnp.asarray(q), scale, zero))
    assert got[q == zero] == 0.0
    ulp = np.spacing(np.maximum(np.abs(want), np.float32(abs(zero) * scale))
                     .astype(np.float32))
    assert (np.abs(got - want) <= ulp).all()
    if zero == 0:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("s_in,z_in,s_out,z_out", [
    (0.02, 0, 0.031, 0), (0.02, -30, 0.031, 12), (0.05, 99, 0.01, -100)])
def test_requantize_affine_matches_jax(s_in, z_in, s_out, z_out):
    """The fused requantize folds its constant in float32, the JAX site in
    double: equal except at ties, never more than one step apart."""
    q = np.arange(-127, 128, dtype=np.int8)
    got = tq._requantize_affine(torch.from_numpy(q), s_in, z_in, s_out, z_out)
    want = np.asarray(jq._requantize_affine(jnp.asarray(q), s_in, z_in,
                                            s_out, z_out))
    d = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d == 0).mean() >= 0.98
    # the zero-point maps onto the zero-point
    assert int(tq._requantize_affine(torch.tensor([z_in], dtype=torch.int8),
                                     s_in, z_in, s_out, z_out)) == z_out


def _both_params(cfg, seed=3):
    g = load_graph(cfg)
    params = fold_raw(random_raw(g, seed=seed))
    return g, params_from_jax(params, device="cpu"), {i: {k: jnp.asarray(v) for k, v in p.items()}
                                        for i, p in params.items()}


@pytest.mark.parametrize("heads,stem", [(False, False), (True, False),
                                        (False, True), (True, True)])
def test_quantize_weights_exact(heads, stem):
    g, tparams, jparams = _both_params(CFGS["small"])
    got = tq.quantize_weights(g, tparams, heads, stem)
    want = jq.quantize_weights(jload_graph(CFGS["small"]), jparams, heads, stem)
    assert set(got) == set(want)
    for i, qp in want.items():
        assert set(got[i]) == set(qp)
        for name, a in qp.items():
            np.testing.assert_array_equal(got[i][name].numpy(), np.asarray(a),
                                          err_msg=f"{i}.{name}")
    assert ("wq" in got[0]) == stem
    if stem:  # the +128 zero-point fold changed the stem's bias
        assert not np.array_equal(got[0]["b"].numpy(),
                                  tparams[0]["b"].numpy())


@pytest.mark.parametrize("cfg", ["small", "wide", "tiny", "yolov3"])
def test_eligible_chain_targets_consumers_match_jax(cfg):
    g, jg = load_graph(CFGS[cfg]), jload_graph(CFGS[cfg])
    for heads in (False, True):
        for stem in (False, True):
            assert ([tq.eligible(g, n, heads, stem) for n in g.conv_nodes]
                    == [jq.eligible(jg, n, heads, stem) for n in jg.conv_nodes])
    fake = {n.index: ({"wq": 0} if tq.eligible(g, n) else {"w": 0})
            for n in g.conv_nodes}
    assert tq.chain_targets(g, fake) == jq.chain_targets(jg, fake)
    assert ({i: [n.index for n in ns] for i, ns in tq.consumers_of(g).items()}
            == {i: [n.index for n in ns] for i, ns in jq.consumers_of(jg).items()})
    if cfg == "yolov3":  # every residual bottleneck's 1x1 chains
        assert len(tq.chain_targets(g, fake)) >= 23


def _conv_case(k, stride, cin, cout, hw, seed):
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, (2, hw, hw, cin), dtype=np.int8)
    qp = {"wq": rng.integers(-127, 128, (k, k, cin, cout), dtype=np.int8),
          "sw": rng.uniform(1e-3, 2e-3, cout).astype(np.float32),
          "b": rng.normal(0, 0.1, cout).astype(np.float32)}
    g = load_graph(CFGS["small"])
    node = next(n for n in g.conv_nodes if n.index > 0)
    node = type(node)(**{**node.__dict__, "size": k, "stride": stride,
                         "pad": 1, "filters": cout, "out_channels": cout})
    return xq, qp, node


@pytest.mark.parametrize("k,stride,cin,cout,hw,zx", [
    (1, 1, 32, 24, 9, 0), (3, 1, 16, 40, 11, 0), (3, 2, 24, 16, 12, 0),
    (3, 2, 24, 16, 13, 0), (3, 1, 16, 40, 11, -37), (3, 2, 24, 16, 12, 21),
    (1, 1, 32, 27, 5, 5), (3, 1, 1024, 8, 6, 0)])
def test_conv_int8_core_matches_jax(k, stride, cin, cout, hw, zx):
    """The integer sums are exact (also where 9·1024 products pass float32's
    24 bits); the float32 epilogue is within 1 ulp of the JAX conv's."""
    from jax import lax

    xq, qp, node = _conv_case(k, stride, cin, cout, hw, seed=k * 100 + hw)
    pad = k // 2
    ints = int8_conv.conv_int8(torch.from_numpy(xq),
                               int8_conv.weight_operand(torch.from_numpy(qp["wq"])),
                               stride, pad)
    want_ints = lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(qp["wq"]), (stride, stride),
        [(pad, pad), (pad, pad)], dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    assert ints.dtype == torch.int32
    np.testing.assert_array_equal(ints.numpy(), np.asarray(want_ints))
    tqp = quant_state_from_jax({1: qp}, device="cpu")[1]
    got = tq._conv_int8_core(torch.from_numpy(xq), node, tqp, 0.031, True, zx)
    want = np.asarray(jq._conv_int8_core(
        jnp.asarray(xq), node, {n: jnp.asarray(v) for n, v in qp.items()},
        0.031, True, zx))
    ulp = np.spacing(np.maximum(np.abs(want), 1e-3).astype(np.float32))
    assert (np.abs(got.numpy() - want) <= ulp).all()
    # a float input quantizes at the site first
    x = (xq.astype(np.float32) - zx) * 0.031
    got_f = tq._conv_int8_core(torch.from_numpy(x), node, tqp, 0.031, False, zx)
    np.testing.assert_array_equal(got_f.numpy(), got.numpy())


@pytest.mark.parametrize("k,stride,hw", [(3, 1, 7), (3, 2, 8), (3, 2, 9),
                                         (1, 1, 5)])
def test_zp_border_deficit_matches_jax(k, stride, hw):
    _, qp, node = _conv_case(k, stride, 8, 6, hw, seed=9)
    w32 = qp["wq"].astype(np.float32)
    pad = k // 2
    out = (hw + 2 * pad - k) // stride + 1
    got = tq._zp_border_deficit(torch.from_numpy(w32), node, pad, out, out, hw, hw)
    want = np.asarray(jq._zp_border_deficit(jnp.asarray(w32), node, pad, out,
                                            out, hw, hw))
    np.testing.assert_array_equal(np.broadcast_to(got.numpy(), want.shape)
                                  if got.shape != want.shape else got.numpy(),
                                  want)
    if k == 1:
        assert not got.any()


def test_stem_exact_u8_algebra():
    """q = u8 − 128 with q = −128 padding and the +128 fold in the bias is
    the float conv of the dequantized weights on u8/255, and equals the JAX
    stem conv within 1 ulp."""
    import torch.nn.functional as F

    g, tparams, jparams = _both_params(CFGS["small"])
    jg = jload_graph(CFGS["small"])
    node = g.conv_nodes[0]
    qp = tq.quantize_weights(g, tparams, include_stem=True)[0]
    jqp = jq.quantize_weights(jg, jparams, include_stem=True)[0]
    u8 = np.random.default_rng(2).integers(0, 256, (2, 16, 16, 3))
    x = (u8 / 255.0).astype(np.float32)
    got = tq._conv_stem_int8(torch.from_numpy(x), node, qp)
    want = np.asarray(jq._conv_stem_int8(jnp.asarray(x), jg.conv_nodes[0], jqp))
    ulp = np.spacing(np.maximum(np.abs(want), 1e-2).astype(np.float32))
    assert (np.abs(got.numpy() - want) <= 2 * ulp).all()
    w_dq = (qp["wq"].float() * qp["sw"]).permute(3, 2, 0, 1).double()
    b0 = tparams[0]["b"].double()
    ref = F.conv2d(torch.from_numpy(u8 / 255.0).permute(0, 3, 1, 2), w_dq, b0,
                   stride=node.stride, padding=node.size // 2)
    np.testing.assert_allclose(got.permute(0, 3, 1, 2).numpy(), ref.numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("size,stride,padding", [(2, 2, 1), (2, 1, 1), (5, 1, 4)])
def test_maxpool_int8_matches_jax(size, stride, padding):
    g = load_graph(CFGS["tiny"])
    node = next(n for n in g.nodes if n.kind == "maxpool")
    node = type(node)(**{**node.__dict__, "size": size, "stride": stride,
                         "padding": padding})
    x = np.random.default_rng(4).integers(-127, 128, (2, 9, 9, 8), dtype=np.int8)
    got = tq._maxpool_int8(torch.from_numpy(x), node)
    want = np.asarray(jq._maxpool_int8(jnp.asarray(x), node))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


def test_upsample_keeps_int8():
    x = np.random.default_rng(5).integers(-127, 128, (2, 3, 4, 5), dtype=np.int8)
    got = tq._upsample_nearest(torch.from_numpy(x), 2)
    assert got.dtype == torch.int8 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), x.repeat(2, axis=1).repeat(2, axis=2))


def test_int8_conv_operand_validation():
    with pytest.raises(ValueError, match="HWIO int8"):
        int8_conv.weight_operand(torch.zeros(3, 3, 4, 4))
    op = int8_conv.weight_operand(torch.zeros(1, 1, 8, 4, dtype=torch.int8))
    with pytest.raises(ValueError, match="int8"):
        int8_conv.conv_int8(torch.zeros(1, 2, 2, 8), op, 1, 0)
    cols = int8_conv.im2col(torch.arange(2 * 4 * 4 * 2, dtype=torch.int8)
                            .reshape(2, 4, 4, 2), 3, 1)
    assert cols.shape == (2 * 2 * 2, 18)
