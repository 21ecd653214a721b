"""The port's int8 walks against the JAX package's on ONE quantization
state carried across (CPU, seeded numpy inputs).

At precision "highest" (float32 carrier) both packages run the same
float32 operations around exact integer sums, so the head maps agree
almost everywhere: ≥ 99% of elements equal to within float32 summation
noise of the float head conv (1e-5, a thousandth of a quantization step)
and none beyond a few quantization steps (a summation-order difference in a
float conv can flip one rounding upstream).
At "bf16" the float convs and the carrier round at other places in the two
frameworks, so the walks are held to the DESIGN int8 bars after the decode:
on the top-200 candidates the same class, |Δscore| ≤ 0.01, |Δbox| ≤ 0.5 px.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu import quant as jq
from yolov3_tpu.graph import load_graph as jload_graph
from yolov3_tpu.model import forward_compact as jforward_compact
from yolov3_tpu_torch import quant as tq
from yolov3_tpu_torch.graph import load_graph
from yolov3_tpu_torch.model import fused_heads_eligible
from yolov3_tpu_torch.weights import (fold_raw, params_from_jax,
                                      quant_state_from_jax, random_raw)

torch.set_num_threads(1)

DATA = Path(__file__).parent / "data"
MODELS = Path(__file__).parent.parent / "models"
CFGS = {"small": DATA / "port_small.cfg", "wide": DATA / "port_wide.cfg",
        "block": DATA / "port_block.cfg", "tiny": MODELS / "yolov3-tiny.cfg"}


class State:
    """One cfg's weights, input and a JAX-made quantization state, in both
    packages' forms."""

    def __init__(self, cfg, precision, scheme="symmetric", carrier="int8",
                 heads=False, stem=False, seed=3, hw=None):
        self.g, self.jg = load_graph(CFGS[cfg]), jload_graph(CFGS[cfg])
        params = fold_raw(random_raw(self.g, seed=seed))
        self.tparams = params_from_jax(params, device="cpu")
        self.jparams = {i: {k: jnp.asarray(v) for k, v in p.items()}
                        for i, p in params.items()}
        hw = hw or (self.g.in_height, self.g.in_width)
        self.x = np.random.default_rng(seed + 1).uniform(
            0, 1, (2, *hw, 3)).astype(np.float32)
        jx = [jnp.asarray(self.x)]
        self.zeros = None
        if scheme == "asymmetric":
            self.scales, self.zeros = jq.calibrate_tensors_affine(
                self.jg, self.jparams, jx, precision=precision)
        elif carrier == "int8":
            self.scales = jq.calibrate_tensors(self.jg, self.jparams, jx,
                                               precision=precision)
        else:
            self.scales = jq.calibrate(self.jg, self.jparams, jx,
                                       precision=precision, include_heads=heads)
        self.jqp = jq.quantize_weights(self.jg, self.jparams, heads, stem)
        self.tqp = quant_state_from_jax(
            {i: {k: np.asarray(v) for k, v in qp.items()}
             for i, qp in self.jqp.items()}, device="cpu")
        self.precision = precision


def _close_heads(got, want, smax, frac=0.99, steps=4):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = a.float().numpy(), np.asarray(b, np.float32)
        assert a.shape == b.shape
        d = np.abs(a - b)
        same = d <= 1e-5 * np.maximum(1.0, np.abs(b))
        assert same.mean() >= frac, f"{1 - same.mean():.3%} differ"
        assert d.max() <= steps * smax, f"max {d.max()} vs step {smax}"


@pytest.mark.parametrize("scheme", ["symmetric", "asymmetric"])
@pytest.mark.parametrize("cfg", ["block", "small", "wide"])
def test_int8_carrier_walk_highest(cfg, scheme):
    st = State(cfg, "highest", scheme)
    got = tq.forward_features_int8_carrier(
        st.g, st.tqp, st.scales, torch.from_numpy(st.x), "highest",
        tensor_zeros=st.zeros)
    want = jq.forward_features_int8_carrier(
        st.jg, st.jqp, st.scales, jnp.asarray(st.x), "highest",
        tensor_zeros=st.zeros)
    _close_heads(got, want, max(st.scales.values()))
    assert all(h.dtype == torch.float32 for h in got)


@pytest.mark.parametrize("heads,stem", [(True, False), (False, True), (True, True)])
def test_int8_carrier_walk_quantized_heads_and_stem(heads, stem):
    st = State("small", "highest", heads=heads, stem=stem)
    got = tq.forward_features_int8_carrier(
        st.g, st.tqp, st.scales, torch.from_numpy(st.x), "highest")
    want = jq.forward_features_int8_carrier(
        st.jg, st.jqp, st.scales, jnp.asarray(st.x), "highest")
    _close_heads(got, want, max(st.scales.values()))


@pytest.mark.parametrize("chain", [True, False])
@pytest.mark.parametrize("cfg", ["block", "small"])
def test_bf16_carrier_walk_highest(cfg, chain):
    st = State(cfg, "highest", carrier="bf16")
    got = tq.forward_features_int8(st.g, st.tqp, st.scales,
                                   torch.from_numpy(st.x), "highest", chain=chain)
    want = jq.forward_features_int8(st.jg, st.jqp, st.scales,
                                    jnp.asarray(st.x), "highest", chain=chain)
    _close_heads(got, want, max(st.scales.values()))


@pytest.mark.parametrize("upto", [1, 3, 5, 8])
def test_int8_carrier_walk_upto(upto):
    """``upto`` truncates the walk and appends the last live activation,
    dequantized; the decisions still come from the full graph."""
    st = State("block", "highest")
    got = tq.forward_features_int8_carrier(
        st.g, st.tqp, st.scales, torch.from_numpy(st.x), "highest", upto=upto)
    want = jq.forward_features_int8_carrier(
        st.jg, st.jqp, st.scales, jnp.asarray(st.x), "highest", upto=upto)
    assert len(got) == 1
    _close_heads(got, want, max(st.scales.values()))


@pytest.mark.parametrize("cfg", ["wide", "tiny"])
def test_int8_carrier_walk_stop_before_heads(cfg):
    """The pre-head activations (carrier type), head convs skipped."""
    st = State(cfg, "highest", hw=(96, 96) if cfg == "tiny" else None)
    assert fused_heads_eligible(st.g)
    got = tq.forward_features_int8_carrier(
        st.g, st.tqp, st.scales, torch.from_numpy(st.x), "highest",
        stop_before_heads=True)
    want = jq.forward_features_int8_carrier(
        st.jg, st.jqp, st.scales, jnp.asarray(st.x), "highest",
        stop_before_heads=True)
    _close_heads(got, want, max(st.scales.values()))
    cins = [st.g.nodes[st.g.nodes[yn.inputs[0]].inputs[0]].out_channels
            for yn in st.g.yolo_nodes]
    assert [h.shape[-1] for h in got] == cins


def _bars(got, want):
    """The DESIGN int8 bars on the reference's top-200 candidates."""
    (tb, ts, tc), (rb, rs, rc) = ([np.asarray(t, np.float32) for t in out]
                                  for out in (got, want))
    for i in range(rs.shape[0]):
        top = np.argsort(rs[i])[::-1][:200]
        assert np.abs(rs[i][top] - ts[i][top]).max() <= 0.01
        assert np.abs(rb[i][top] - tb[i][top]).max() <= 0.5
        assert (rc[i][top] == tc[i][top]).all()


def _np(out):
    return [t.float().numpy() for t in out]


@pytest.mark.parametrize("carrier,scheme", [("int8", "symmetric"),
                                            ("int8", "asymmetric"),
                                            ("bf16", "symmetric")])
def test_int8_walks_bf16_design_bars(carrier, scheme):
    """tiny@416 with the JAX tests' weights (seed 3) at precision "bf16":
    port against JAX on one state, and port against the float32 forward."""
    st = State("tiny", "bf16", scheme, carrier, seed=3, hw=(416, 416))
    got = tq.forward_compact_int8(st.g, st.tqp, st.scales, torch.from_numpy(st.x),
                                  "bf16", carrier=carrier, zeros=st.zeros)
    want = jq.forward_compact_int8(st.jg, st.jqp, st.scales, jnp.asarray(st.x),
                                   "bf16", carrier=carrier, zeros=st.zeros)
    _bars(_np(got), want)
    f32 = jforward_compact(st.jg, st.jparams, jnp.asarray(st.x))
    _bars(_np(got), f32)


def test_forward_packed_int8_matches_compact_and_fused():
    """The packed (K1) and head-fused (K4) int8 forwards carry the compact
    decode's candidates: same thresholded scores and classes."""
    st = State("wide", "highest")
    x = torch.from_numpy(st.x)
    boxes, scores, classes = tq.forward_compact_int8(
        st.g, st.tqp, st.scales, x, "highest", carrier="int8",
        decode_impl="pallas")
    payload, pscores = tq.forward_packed_int8(
        st.g, st.tqp, st.scales, x, 0.1, "highest", carrier="int8")
    keep = scores >= 0.1
    np.testing.assert_array_equal(pscores.numpy(),
                                  torch.where(keep, scores, 0.0).numpy())
    np.testing.assert_array_equal(payload[..., 5][keep].numpy(),
                                  classes[keep].float().numpy())
    np.testing.assert_allclose(payload[..., :4][keep].numpy(),
                               boxes[keep].numpy(), atol=1e-4)
    fpayload, fscores = tq.forward_packed_fused_int8(
        st.g, st.tqp, st.scales, x, 0.1, "highest", carrier="int8")
    np.testing.assert_allclose(fscores.numpy(), pscores.numpy(), atol=2e-4)
    # the bf16 carrier has no head-fused walk: it runs the packed one
    st2 = State("wide", "highest", carrier="bf16")
    a = tq.forward_packed_fused_int8(st2.g, st2.tqp, st2.scales, x, 0.1,
                                     "highest", carrier="bf16")
    b = tq.forward_packed_int8(st2.g, st2.tqp, st2.scales, x, 0.1, "highest",
                               carrier="bf16")
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())


def test_walk_validation():
    st = State("block", "highest")
    x = torch.from_numpy(st.x)
    with pytest.raises(ValueError, match="block_impl"):
        tq.forward_features_int8_carrier(st.g, st.tqp, st.scales, x, "highest",
                                         block_impl="triton")
    with pytest.raises(ValueError, match="precision"):
        tq.forward_features_int8_carrier(st.g, st.tqp, st.scales, x, "fp8")
    with pytest.raises(ValueError, match="decode_impl"):
        tq.forward_compact_int8(st.g, st.tqp, st.scales, x, decode_impl="cuda")
