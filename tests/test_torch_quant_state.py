"""The int8 quantization state: ``Darknet.quantize_int8`` against the JAX
package's, the npz round trip, and files written by either package loading
in the other."""
from pathlib import Path

import numpy as np
import pytest
import torch

from yolov3_tpu.model import Darknet as JDarknet
from yolov3_tpu_torch import Darknet, quant_state_from_jax
from yolov3_tpu_torch.weights import fold_raw, random_raw

torch.set_num_threads(1)

DATA = Path(__file__).parent / "data"
SMALL = str(DATA / "port_small.cfg")
WIDE = str(DATA / "port_wide.cfg")
BLOCK = str(DATA / "port_block.cfg")


def _nets(cfg, precision, seed=4):
    net = Darknet(cfg, precision=precision, device="cpu")
    params = fold_raw(random_raw(net.graph, seed=seed))
    net.set_params(params)
    jnet = JDarknet(cfg, precision=precision).set_params(params)
    frames = np.random.default_rng(seed).integers(0, 256, (3, 50, 70, 3),
                                                  dtype=np.uint8)
    return net, jnet, frames


def _assert_state_equal(net, jnet, b_rtol=1e-5, b_atol=1e-6):
    assert net.qcarrier == jnet.qcarrier
    assert set(net.act_scales) == set(jnet.act_scales)
    for i, s in jnet.act_scales.items():
        assert net.act_scales[i] == pytest.approx(s, rel=1e-5)
    assert net.act_zeros == jnet.act_zeros
    assert set(net.qparams) == set(jnet.qparams)
    for i, qp in jnet.qparams.items():
        assert set(net.qparams[i]) == set(qp)
        for name, a in qp.items():
            got = net.qparams[i][name].float().numpy()
            want = np.asarray(a, np.float32)
            if name == "b":
                np.testing.assert_allclose(got, want, rtol=b_rtol, atol=b_atol)
            else:
                np.testing.assert_array_equal(got, want, err_msg=f"{i}.{name}")


@pytest.mark.parametrize("kw", [
    {}, {"carrier": "bf16"}, {"act_scheme": "asymmetric"},
    {"quantize_heads": True, "quantize_stem": True},
    {"calib_method": "percentile", "calib_percentile": 99.0},
    {"bias_correct": False, "mode": "stretch"},
], ids=["default", "bf16-carrier", "asymmetric", "heads+stem", "percentile",
        "no-bias-correct-stretch"])
def test_quantize_int8_matches_jax(kw):
    net, jnet, frames = _nets(SMALL, "highest")
    assert not net.quantized
    assert net.quantize_int8(frames, **kw) is net and net.quantized
    jnet.quantize_int8(frames, **kw)
    # the affine dequantize folds z·s in float32 here and in double there
    # (1 ulp of z·s): the mean residual of the bias correction moves by that
    # ulp times the summed weights, 5e-5 at these widths
    asym = kw.get("act_scheme") == "asymmetric"
    _assert_state_equal(net, jnet, b_atol=5e-5 if asym else 1e-6)
    assert ("wq" in net.qparams[0]) == bool(kw.get("quantize_stem"))


def test_quantize_int8_list_of_frames_and_bf16():
    """Variable-size frames calibrate one by one; at "bf16" the scales are
    within two bf16 ulps of the JAX package's."""
    net, jnet, frames = _nets(SMALL, "bf16")
    extra = np.random.default_rng(9).integers(0, 256, (40, 30, 3), dtype=np.uint8)
    net.quantize_int8([frames[0], extra])
    jnet.quantize_int8([frames[0], extra])
    for i, s in jnet.act_scales.items():
        assert net.act_scales[i] == pytest.approx(s, rel=2 ** -6)
    assert net.qparams[0]["w"].dtype == torch.bfloat16  # the float stem


def test_quantize_int8_validation():
    net = Darknet(SMALL, device="cpu")
    frames = np.zeros((1, 32, 32, 3), np.uint8)
    with pytest.raises(RuntimeError, match="load_weights"):
        net.quantize_int8(frames)
    net.set_params(fold_raw(random_raw(net.graph, seed=1)))
    with pytest.raises(ValueError, match="at least one calibration"):
        net.quantize_int8(frames[:0])
    with pytest.raises(TypeError, match="uint8"):
        net.quantize_int8(frames.astype(np.float32))
    with pytest.raises(ValueError, match="act_scheme"):
        net.quantize_int8(frames, act_scheme="affine")
    with pytest.raises(ValueError, match="int8 activation carrier"):
        net.quantize_int8(frames, act_scheme="asymmetric", carrier="bf16")
    with pytest.raises(ValueError, match="calibration method"):
        net.quantize_int8(frames, calib_method="median")
    with pytest.raises(RuntimeError, match="quantize_int8"):
        net.save_quantized("unused.npz")


def _detect(net, frames, **kw):
    from yolov3_tpu_torch import Detector

    return Detector(net, prob_thresh=0.1, bgr=False, **kw).detect_batch(frames)


def _same(a, b):
    return all(np.array_equal(x.bbox_tlbr, y.bbox_tlbr)
               and np.array_equal(x.class_prob, y.class_prob)
               and np.array_equal(x.class_idx, y.class_idx) for x, y in zip(a, b))


@pytest.mark.parametrize("precision,kw", [
    ("bf16", {}), ("highest", {"act_scheme": "asymmetric"}),
    ("bf16", {"carrier": "bf16", "quantize_heads": True})],
    ids=["bf16", "asymmetric", "bf16-carrier-heads"])
def test_state_round_trip(tmp_path, precision, kw):
    net, _, frames = _nets(WIDE, precision)
    net.quantize_int8(frames, **kw)
    path = tmp_path / "state.npz"
    assert net.save_quantized(path) is net and path.is_file()
    assert not path.with_suffix(".npz.tmp").exists()
    fresh = Darknet(WIDE, precision=precision, device="cpu").set_params(
        fold_raw(random_raw(net.graph, seed=4)))
    assert fresh.load_quantized(path) is fresh
    assert fresh.qcarrier == net.qcarrier and fresh.act_zeros == net.act_zeros
    assert fresh.act_scales == net.act_scales
    for i, qp in net.qparams.items():
        for name, t in qp.items():
            assert fresh.qparams[i][name].dtype == t.dtype
            assert torch.equal(fresh.qparams[i][name], t)
    assert _same(_detect(fresh, frames), _detect(net, frames))


@pytest.mark.parametrize("precision", ["bf16", "highest"])
def test_jax_saved_state_loads_in_the_port(tmp_path, precision):
    net, jnet, frames = _nets(WIDE, precision)
    jnet.quantize_int8(frames, act_scheme="asymmetric")
    path = tmp_path / "jax_state.npz"
    jnet.save_quantized(path)
    net.load_quantized(path)
    _assert_state_equal(net, jnet, b_rtol=0, b_atol=0)
    if precision == "bf16":  # the tagged bf16 bits come back as bfloat16
        assert net.qparams[0]["w"].dtype == torch.bfloat16
    assert sum(len(d.class_idx) for d in _detect(net, frames)) > 0


@pytest.mark.parametrize("precision", ["bf16", "highest"])
def test_port_saved_state_loads_in_jax(tmp_path, precision):
    net, jnet, frames = _nets(WIDE, precision)
    net.quantize_int8(frames, quantize_heads=True)
    path = tmp_path / "port_state.npz"
    net.save_quantized(path)
    jnet.load_quantized(path)
    _assert_state_equal(net, jnet, b_rtol=0, b_atol=0)
    with np.load(path) as z:
        assert ("0.w:bf16" in z.files) == (precision == "bf16")
        assert z["1.wq"].dtype == np.int8 and z["1.wq"].ndim == 4  # HWIO
        assert z["1.wq"].shape[:2] == (net.graph.nodes[1].size,) * 2
    from yolov3_tpu.inference import Detector as JDetector

    out = JDetector(jnet, prob_thresh=0.1, bgr=False).detect_batch(frames)
    assert len(out) == len(frames)


def test_wrong_graph_raises(tmp_path):
    net, _, frames = _nets(SMALL, "highest")
    net.quantize_int8(frames)
    path = tmp_path / "small.npz"
    net.save_quantized(path)
    other = Darknet(WIDE, device="cpu").set_params(
        fold_raw(random_raw(Darknet(WIDE, device="cpu").graph, seed=1)))
    with pytest.raises(ValueError, match="was saved for graph"):
        other.load_quantized(path)
    assert not other.quantized


def test_quant_state_from_jax_keeps_layout_and_types():
    import ml_dtypes

    rng = np.random.default_rng(0)
    w = rng.normal(0, 1, (3, 3, 4, 8)).astype(np.float32)
    state = {
        0: {"w": w.astype(ml_dtypes.bfloat16), "b": np.zeros(8, np.float32)},
        1: {"wq": rng.integers(-127, 128, (1, 1, 8, 6), dtype=np.int8),
            "sw": np.ones(6, np.float32), "b": np.ones(6, np.float32)},
        2: {"w:bf16": w.astype(ml_dtypes.bfloat16).view(np.uint16),
            "b": np.zeros(8, np.float32)},
    }
    got = quant_state_from_jax(state, device="cpu")
    assert got[0]["w"].dtype == got[2]["w"].dtype == torch.bfloat16
    assert got[0]["w"].shape == (3, 3, 4, 8) and torch.equal(got[0]["w"], got[2]["w"])
    np.testing.assert_array_equal(got[0]["w"].float().numpy(),
                                  w.astype(ml_dtypes.bfloat16).astype(np.float32))
    assert got[1]["wq"].dtype == torch.int8 and got[1]["wq"].shape == (1, 1, 8, 6)
    net = Darknet(SMALL, device="cpu")
    net.set_quantized(state, {0: 0.1}, {0: 3}, "int8")
    assert net.quantized and net.act_zeros == {0: 3} and net.qoperands.qparams is net.qparams
