"""The Detector's int8 routes on the CPU against the JAX package's Detector
on one quantization state, the route gates with their warnings, and the
kernel launch counts (none on CPU tensors).

Both Detectors run the same quantized program on the same state; at
precision "highest" the candidates differ by float noise, so the survivors
are held to the DESIGN int8 bars: the same count and classes, |Δscore| ≤
0.01, |Δbox| ≤ 0.5 px.
"""
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

from yolov3_tpu.inference import Detector as JDetector
from yolov3_tpu.model import Darknet as JDarknet
from yolov3_tpu_torch import Darknet, Detector
from yolov3_tpu_torch.ops import (cuda_block, cuda_conv, cuda_decode,
                                  cuda_nms, cuda_requant)
from yolov3_tpu_torch.weights import fold_raw, random_raw

torch.set_num_threads(1)

DATA = Path(__file__).parent / "data"
WIDE = str(DATA / "port_wide.cfg")
BLOCK = str(DATA / "port_block.cfg")
KERNELS = (cuda_decode.decode_packed, cuda_decode.decode_compact,
           cuda_decode.decode_packed_head, cuda_decode.decode_compact_head,
           cuda_decode.decode_packed_fused_head, cuda_decode.decode_head,
           cuda_decode.decode_all, cuda_conv.conv3x3_fused,
           cuda_block.residual_block_int8, cuda_nms.suppress,
           cuda_requant.int8_requant)


def _pair(cfg, precision="highest", seed=6, native=False, **qkw):
    """The port's and the JAX package's nets on ONE quantization state,
    made by the JAX package and carried across as numpy arrays."""
    net = Darknet(cfg, precision=precision, device="cpu")
    params = fold_raw(random_raw(net.graph, seed=seed))
    net.set_params(params)
    jnet = JDarknet(cfg, precision=precision).set_params(params)
    # native: frames of the net's own size, so no resize rounds the input
    hw = (net.graph.in_height, net.graph.in_width) if native else (60, 80)
    frames = np.random.default_rng(seed).integers(0, 256, (2, *hw, 3),
                                                  dtype=np.uint8)
    jnet.quantize_int8(frames[..., ::-1], **qkw)
    net.set_quantized({i: {k: np.asarray(v) for k, v in qp.items()}
                       for i, qp in jnet.qparams.items()},
                      jnet.act_scales, jnet.act_zeros, jnet.qcarrier)
    return net, jnet, frames


def _assert_int8_bars(got, want):
    """Same survivor count per image, and a one-to-one match of every
    survivor to one of the same class within the bars (near-tied scores may
    come out in another order, so the match is not by position)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g.class_idx) == len(w.class_idx) > 0
        free = list(range(len(w.class_idx)))
        for box, score, cls in zip(g.bbox_tlbr, g.class_prob, g.class_idx):
            hit = next((j for j in free if w.class_idx[j] == cls
                        and abs(w.class_prob[j] - score) <= 0.01
                        and np.abs(w.bbox_tlbr[j] - box).max() <= 0.5), None)
            assert hit is not None, (box, score, cls)
            free.remove(hit)


@pytest.mark.parametrize("block_impl", ["xla", "pallas"])
@pytest.mark.parametrize("decode_impl", ["pallas", "pallas-fused", "xla"])
def test_int8_carrier_routes_match_jax(decode_impl, block_impl):
    net, jnet, frames = _pair(BLOCK)
    kw = dict(prob_thresh=0.1, iou_thresh=0.45, max_results=32,
              decode_impl=decode_impl, block_impl=block_impl)
    det = Detector(net, **kw)
    assert det.route == decode_impl and det.block_impl == block_impl
    _assert_int8_bars(det.detect_batch(frames),
                      JDetector(jnet, **kw).detect_batch(frames))


@pytest.mark.parametrize("qkw", [{"carrier": "bf16"},
                                 {"act_scheme": "asymmetric"},
                                 {"quantize_heads": True, "quantize_stem": True}],
                         ids=["bf16-carrier", "asymmetric", "heads+stem"])
def test_int8_variants_match_jax(qkw):
    # the quantized stem rounds 255·x: a resized input differs between the
    # frameworks by float noise, which would flip that rounding
    net, jnet, frames = _pair(WIDE, native="quantize_stem" in qkw, **qkw)
    kw = dict(prob_thresh=0.1, iou_thresh=0.45, max_results=32)
    _assert_int8_bars(Detector(net, **kw).detect_batch(frames),
                      JDetector(jnet, **kw).detect_batch(frames))


def test_block_impls_give_identical_detections_on_cpu():
    """K6's plain version is the unfused walk's operations: bit-identical."""
    net, _, frames = _pair(BLOCK, precision="bf16")
    a = Detector(net, prob_thresh=0.1, block_impl="pallas").detect_batch(frames)
    b = Detector(net, prob_thresh=0.1, block_impl="xla").detect_batch(frames)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.bbox_tlbr, y.bbox_tlbr)
        np.testing.assert_array_equal(x.class_prob, y.class_prob)
        np.testing.assert_array_equal(x.class_idx, y.class_idx)


def test_bf16_carrier_gates_the_fused_head(caplog):
    """The gate holds from construction; its warning fires where the
    reference gives it, when the program of a key is built."""
    net, _, frames = _pair(WIDE, carrier="bf16")
    with caplog.at_level(logging.WARNING, logger="yolov3_tpu_torch"):
        det = Detector(net, decode_impl="pallas-fused")
        assert det.route == "pallas"
        assert "bf16-carrier int8" not in caplog.text
        assert len(det.detect_batch(frames)) == 2
    assert det.route == "pallas"
    assert caplog.text.count("bf16-carrier int8") == 1


def test_route_follows_a_later_quantization(caplog):
    """The gates depend on the quantization state, which may change after
    the Detector was built: the route is resolved again, once per state."""
    net = Darknet(WIDE, precision="highest", device="cpu")
    net.set_params(fold_raw(random_raw(net.graph, seed=6)))
    frames = np.random.default_rng(1).integers(0, 256, (1, 40, 40, 3),
                                               dtype=np.uint8)
    det = Detector(net, decode_impl="pallas-fused", prob_thresh=0.1)
    assert det.route == "pallas-fused"
    float_out = det.detect_batch(frames)
    net.quantize_int8(frames, carrier="bf16")
    with caplog.at_level(logging.WARNING, logger="yolov3_tpu_torch"):
        det.detect_batch(frames)
        det.detect_batch(frames)
    assert det.route == "pallas"
    assert caplog.text.count("head-fused decode not applicable") == 1
    net.quantize_int8(frames)
    q_out = det.detect_batch(frames)
    assert det.route == "pallas-fused"
    assert len(float_out) == len(q_out) == 1


@pytest.mark.parametrize("scheme,warns", [("asymmetric", True),
                                          ("symmetric", False)])
def test_block_fallback_warning_follows_the_walks_condition(caplog, scheme, warns):
    """The walk leaves K6 only when a zero-point is nonzero
    (``any(act_zeros.values())``): the warning has the same condition, so a
    state whose zero-points are all 0 does not warn."""
    net, _, frames = _pair(BLOCK, act_scheme=scheme)
    if scheme == "symmetric":
        net.act_zeros = {i: 0 for i in net.act_scales}  # present, all zero
    with caplog.at_level(logging.WARNING, logger="yolov3_tpu_torch"):
        det = Detector(net, block_impl="pallas", prob_thresh=0.1)
        out = det.detect_batch(frames)
    assert ("symmetric quantization contract only" in caplog.text) == warns
    assert len(out) == 2
    ref = Detector(net, block_impl="xla", prob_thresh=0.1).detect_batch(frames)
    for x, y in zip(out, ref):
        np.testing.assert_array_equal(x.class_prob, y.class_prob)


def test_block_impl_validation():
    net = Darknet(BLOCK, device="cpu")
    with pytest.raises(ValueError, match="block_impl"):
        Detector(net, block_impl="nope")
    assert Detector(net, block_impl="pallas").block_impl == "pallas"


@pytest.mark.parametrize("decode_impl", ["pallas", "pallas-fused", "xla"])
@pytest.mark.parametrize("carrier", ["int8", "bf16"])
def test_cpu_int8_routes_launch_no_kernel(carrier, decode_impl):
    for k in KERNELS:
        k.launches = 0
    net, _, frames = _pair(BLOCK, precision="bf16", carrier=carrier)
    det = Detector(net, prob_thresh=0.1, decode_impl=decode_impl,
                   block_impl="pallas")
    assert len(det.detect_batch(frames)) == 2
    net(torch.zeros(1, 48, 48, 3))
    assert [k.launches for k in KERNELS] == [0] * len(KERNELS)


def test_quantized_detector_on_cuda_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Darknet(BLOCK, device="cuda")
