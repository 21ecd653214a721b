"""The port's calibrators, percentile statistic, input statistics and bias
correction against the JAX package's (CPU, seeded numpy inputs).

Scales come from float32 maxima / percentiles of activations that the two
frameworks compute with sums in different orders, so they are compared at
rtol 1e-5 at precision "highest"; zero-points are integers and must match.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu import quant as jq
from yolov3_tpu.graph import load_graph as jload_graph
from yolov3_tpu_torch import quant as tq
from yolov3_tpu_torch.graph import load_graph
from yolov3_tpu_torch.weights import fold_raw, params_from_jax, random_raw

torch.set_num_threads(1)

DATA = Path(__file__).parent / "data"
SMALL = DATA / "port_small.cfg"
BLOCK = DATA / "port_block.cfg"


@pytest.fixture(scope="module")
def nets():
    out = {}
    for name, cfg in (("small", SMALL), ("block", BLOCK)):
        g, jg = load_graph(cfg), jload_graph(cfg)
        params = fold_raw(random_raw(g, seed=7))
        rng = np.random.default_rng(8)
        batches = [rng.uniform(0, 1, (2, g.in_height, g.in_width, 3))
                   .astype(np.float32) for _ in range(2)]
        out[name] = (g, jg, params_from_jax(params, device="cpu"),
                     {i: {k: jnp.asarray(v) for k, v in p.items()}
                      for i, p in params.items()}, batches)
    return out


def _assert_scales(got, want, rtol=1e-5):
    assert set(got) == set(want)
    for i in want:
        assert got[i] == pytest.approx(want[i], rel=rtol), i


@pytest.mark.parametrize("method,pct", [("absmax", 99.9), ("percentile", 99.9),
                                        ("percentile", 90.0), ("percentile", 100.0)])
@pytest.mark.parametrize("heads", [False, True])
def test_calibrate_matches_jax(nets, method, pct, heads):
    g, jg, tp, jp, batches = nets["small"]
    got = tq.calibrate(g, tp, batches, "highest", heads, method, pct)
    want = jq.calibrate(jg, jp, batches, "highest", heads, method, pct)
    _assert_scales(got, want)
    assert all(isinstance(v, float) for v in got.values())


@pytest.mark.parametrize("net", ["small", "block"])
@pytest.mark.parametrize("method,pct", [("absmax", 99.9), ("percentile", 99.0)])
def test_calibrate_tensors_matches_jax(nets, net, method, pct):
    g, jg, tp, jp, batches = nets[net]
    got = tq.calibrate_tensors(g, tp, batches, "highest", method, pct)
    want = jq.calibrate_tensors(jg, jp, batches, "highest", method, pct)
    _assert_scales(got, want)
    assert set(got) == {n.index for n in g.nodes}


@pytest.mark.parametrize("net", ["small", "block"])
@pytest.mark.parametrize("method,pct", [("minmax", 99.9), ("percentile", 99.0)])
def test_calibrate_tensors_affine_matches_jax(nets, net, method, pct):
    g, jg, tp, jp, batches = nets[net]
    scales, zeros = tq.calibrate_tensors_affine(g, tp, batches, "highest",
                                                method, pct)
    jscales, jzeros = jq.calibrate_tensors_affine(jg, jp, batches, "highest",
                                                  method, pct)
    _assert_scales(scales, jscales)
    assert zeros == jzeros
    assert all(isinstance(z, int) and -127 <= z <= 127 for z in zeros.values())
    # leaky outputs are one-sided: their zero-points sit well below 0
    assert min(zeros.values()) < -60


def test_calibrate_bf16_scales_close(nets):
    """At "bf16" the float walk rounds at other places in the two
    frameworks: scales within two bf16 ulps."""
    g, jg, tp, jp, batches = nets["small"]
    got = tq.calibrate_tensors(g, tp, batches, "bf16")
    want = jq.calibrate_tensors(jg, jp, batches, "bf16")
    _assert_scales(got, want, rtol=2 ** -6)


def test_calibration_validation(nets):
    g, _, tp, _, batches = nets["small"]
    with pytest.raises(ValueError, match="unknown calibration method"):
        tq.calibrate(g, tp, batches, method="median")
    with pytest.raises(ValueError, match="percentile must be"):
        tq.calibrate_tensors(g, tp, batches, method="percentile", percentile=0.0)
    with pytest.raises(ValueError, match="unknown affine calibration method"):
        tq.calibrate_tensors_affine(g, tp, batches, method="absmax")
    with pytest.raises(ValueError, match="percentile must be"):
        tq.calibrate_tensors_affine(g, tp, batches, method="percentile",
                                    percentile=101.0)


@pytest.mark.parametrize("n,q", [(1000, 99.9), (1001, 50.0), (7, 100.0),
                                 (5000, 0.1), (1, 37.0)])
def test_percentile_matches_jnp(n, q):
    t = np.random.default_rng(n).normal(0, 3, n).astype(np.float32)
    got = float(tq._percentile(torch.from_numpy(t), q))
    want = float(jnp.percentile(jnp.asarray(t), q))
    # the fractional index is a float32 near n: one ulp of it, times the
    # gap between the two neighbours, is the most the forms may differ by
    st = np.sort(t)
    gap = float(np.diff(st).max()) if n > 1 else 0.0
    assert got == pytest.approx(want, rel=1e-6, abs=np.spacing(np.float32(n)) * gap)


def test_percentile_over_2_pow_24_elements():
    """``torch.quantile`` refuses this size; the statistic takes it, with
    the fractional index formed in float32 as ``jnp.percentile`` forms it."""
    n = 2 ** 24 + 4097
    t = np.random.default_rng(1).normal(0, 1, n).astype(np.float32)
    with pytest.raises(RuntimeError):
        torch.quantile(torch.from_numpy(t), 0.999)
    got = float(tq._percentile(torch.from_numpy(t), 99.9))
    want = float(jnp.percentile(jnp.asarray(t), 99.9))
    # the float32 index has a spacing of 2 here: both forms must land on the
    # same neighbours (the tail's gaps are about 1e-6 per element)
    assert got == pytest.approx(want, rel=1e-5)
    assert 3.0 < got < 3.2


@pytest.mark.parametrize("carrier,scheme", [("int8", "symmetric"),
                                            ("int8", "asymmetric"),
                                            ("bf16", "symmetric")])
def test_collect_input_stats_matches_jax(nets, carrier, scheme):
    g, jg, tp, jp, batches = nets["small"]
    zeros = None
    if scheme == "asymmetric":
        scales, zeros = jq.calibrate_tensors_affine(jg, jp, batches, "highest")
    elif carrier == "int8":
        scales = jq.calibrate_tensors(jg, jp, batches, "highest")
    else:
        scales = jq.calibrate(jg, jp, batches, "highest")
    idx = [n.index for n in g.conv_nodes if tq.eligible(g, n, include_stem=True)]
    got = tq.collect_input_stats(g, tp, scales, idx, batches, carrier,
                                 "highest", zeros)
    want = jq.collect_input_stats(jg, jp, scales, idx, batches, carrier,
                                  "highest", zeros)
    assert set(got) == set(want) == set(idx)
    for i in idx:
        mu, eps = got[i]
        jmu, jeps = want[i]
        assert mu.dtype == eps.dtype == np.float64
        np.testing.assert_allclose(mu, jmu, rtol=1e-5, atol=1e-6)
        # residual means cancel to near zero: absolute bar, a thousandth of
        # the rounding step
        step = (1 / 255 if g.nodes[i].inputs[0] < 0
                else tq._input_scale(g, g.nodes[i], scales, carrier))
        np.testing.assert_allclose(eps, jeps, atol=1e-3 * step)


@pytest.mark.parametrize("carrier,scheme,heads,stem", [
    ("int8", "symmetric", False, False), ("int8", "asymmetric", False, True),
    ("bf16", "symmetric", True, False)])
def test_bias_correct_matches_jax(nets, carrier, scheme, heads, stem):
    g, jg, tp, jp, batches = nets["small"]
    zeros = None
    if scheme == "asymmetric":
        scales, zeros = jq.calibrate_tensors_affine(jg, jp, batches, "highest")
    elif carrier == "int8":
        scales = jq.calibrate_tensors(jg, jp, batches, "highest")
    else:
        scales = jq.calibrate(jg, jp, batches, "highest", include_heads=heads)
    tqp = tq.quantize_weights(g, tp, heads, stem)
    jqp = jq.quantize_weights(jg, jp, heads, stem)
    got = tq.bias_correct(g, tp, tqp, scales, batches, carrier, "highest", zeros)
    want = jq.bias_correct(jg, jp, jqp, scales, batches, carrier, "highest", zeros)
    changed = 0
    for i, qp in want.items():
        assert set(got[i]) == set(qp)
        np.testing.assert_allclose(got[i]["b"].numpy(), np.asarray(qp["b"]),
                                   rtol=1e-5, atol=1e-6)
        if "wq" in qp:
            np.testing.assert_array_equal(got[i]["wq"].numpy(), np.asarray(qp["wq"]))
            changed += not np.array_equal(got[i]["b"].numpy(), tqp[i]["b"].numpy())
        else:  # float convs pass through untouched
            assert got[i] is tqp[i]
    assert changed > 0 and got is not tqp
