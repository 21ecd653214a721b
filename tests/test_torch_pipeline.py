"""The port's serving path end to end on the CPU: ``Detector.detect_batch``
against the JAX package's Detector, the frozen golden fixtures replayed
through the port, the kernel launch counts, and the kernel build's refusal
to fall back."""
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from yolov3_tpu.inference import Detector as JDetector
from yolov3_tpu.model import Darknet as JDarknet
from yolov3_tpu_torch import Darknet, Detector, forward_compact, inference
from yolov3_tpu_torch.ops import _build, cuda_conv, cuda_decode, cuda_nms
from yolov3_tpu_torch.weights import fold_raw, random_raw

torch.set_num_threads(1)

DATA = Path(__file__).parent / "data"
MODELS = Path(__file__).parent.parent / "models"
SMALL_CFG = str(DATA / "port_small.cfg")
WIDE_CFG = str(DATA / "port_wide.cfg")
KERNELS = (cuda_decode.decode_packed, cuda_decode.decode_compact,
           cuda_decode.decode_packed_head, cuda_decode.decode_compact_head,
           cuda_decode.decode_packed_fused_head, cuda_decode.decode_all,
           cuda_conv.conv3x3_fused, cuda_nms.suppress)


def _assert_same_detections(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g.class_idx) == len(w.class_idx)
        np.testing.assert_array_equal(g.class_idx, w.class_idx)
        np.testing.assert_allclose(g.class_prob, w.class_prob, atol=5e-5)
        np.testing.assert_allclose(g.bbox_tlbr, w.bbox_tlbr, atol=0.1)


@pytest.mark.parametrize("cfg,net_hw,src_hw,prob", [
    (SMALL_CFG, (64, 64), (90, 120), 0.05),
    (str(MODELS / "yolov3-tiny.cfg"), (416, 416), (240, 320), 0.3),
], ids=["small@64", "tiny@416"])
def test_detect_batch_matches_jax(cfg, net_hw, src_hw, prob):
    net = Darknet(cfg, precision="highest", device="cpu")
    params = fold_raw(random_raw(net.graph, seed=12))
    net.set_params(params)
    frames = np.random.default_rng(3).integers(0, 256, (2, *src_hw, 3),
                                               dtype=np.uint8)
    kw = dict(prob_thresh=prob, iou_thresh=0.45, net_hw=net_hw, max_results=64)
    got = Detector(net, **kw).detect_batch(frames)
    jnet = JDarknet(cfg, precision="highest").set_params(params)
    want = JDetector(jnet, **kw).detect_batch(frames)
    assert sum(len(d.class_idx) for d in want) > 0
    _assert_same_detections(got, want)


@pytest.mark.parametrize("fixture", ["golden_tiny.json", "golden_yolov3.json"])
def test_golden_replay(fixture):
    """The JAX package's frozen detections, replayed through the port's
    Detector at precision="highest" and compared in net-input pixels."""
    golden = json.loads((DATA / fixture).read_text())
    net = Darknet(MODELS / golden["cfg"], precision="highest", device="cpu")
    net.set_params(fold_raw(random_raw(net.graph, seed=golden["seed"],
                                       scale=golden.get("scale", 1.0))))
    size = golden["net_size"]
    det = Detector(net, prob_thresh=golden["prob_thresh"],
                   iou_thresh=golden["iou_thresh"], top_k=golden["top_k"],
                   net_hw=(size, size))
    frames = np.random.default_rng(golden["seed"]).integers(
        0, 256, (1, 480, 640, 3), dtype=np.uint8)
    (got,) = det._unpack(det._run(det._stage(frames)), None)  # net pixels
    assert len(got.class_prob) == len(golden["scores"])
    np.testing.assert_array_equal(got.class_idx, np.asarray(golden["classes"]))
    np.testing.assert_allclose(got.class_prob, np.asarray(golden["scores"]),
                               atol=5e-5)
    np.testing.assert_allclose(got.bbox_tlbr, np.asarray(golden["boxes"]),
                               atol=0.1)


def test_cpu_path_launches_no_kernel():
    cuda_decode.decode_packed.launches = 0
    cuda_decode.decode_packed_head.launches = 0
    cuda_nms.suppress.launches = 0
    net = Darknet(SMALL_CFG, precision="highest", device="cpu")
    net.set_params(fold_raw(random_raw(net.graph, seed=1)))
    frames = np.zeros((2, 64, 64, 3), np.uint8)
    out = inference(net, frames, prob_thresh=0.05)
    assert len(out) == 2 and all(len(t) == 3 for t in out)
    assert cuda_decode.decode_packed.launches == 0
    assert cuda_decode.decode_packed_head.launches == 0
    assert cuda_nms.suppress.launches == 0


@pytest.mark.parametrize("precision", ["highest", "bf16"])
@pytest.mark.parametrize("decode_impl", ["pallas", "pallas-fused", "xla"])
def test_cpu_routes_launch_no_kernel(decode_impl, precision):
    """Every route on CPU tensors runs the plain versions only: with the
    fused conv on, port_wide.cfg passes through every kernel's wrapper."""
    for k in KERNELS:
        k.launches = 0
    net = Darknet(WIDE_CFG, precision=precision, conv_impl="pallas", device="cpu")
    net.set_params(fold_raw(random_raw(net.graph, seed=1)))
    det = Detector(net, prob_thresh=0.2, decode_impl=decode_impl)
    assert det.route == decode_impl
    out = det.detect_batch(np.zeros((2, 40, 50, 3), np.uint8))
    forward_compact(net.graph, net.params, torch.zeros(1, 32, 32, 3),
                    precision=precision, conv_impl="pallas", decode_impl="pallas")
    assert len(out) == 2
    assert [k.launches for k in KERNELS] == [0] * len(KERNELS)


def test_build_hashes_every_source_and_header():
    """Each kernel source and the shared decode header is built and hashed:
    editing any of them names a new library."""
    assert set(_build.SOURCES) | set(_build.HEADERS) == {
        p.name for p in _build.CSRC.iterdir()}
    assert _build.library_path().parent == _build.BUILD_DIR


def test_detector_validation():
    net = Darknet(SMALL_CFG, device="cpu").set_params(
        fold_raw(random_raw(Darknet(SMALL_CFG, device="cpu").graph, seed=1)))
    for kw, match in [({"top_k": 0}, "top_k"), ({"select_group": 1}, "select_group"),
                      ({"net_hw": (60, 64)}, "multiples"),
                      ({"prob_thresh": 1.0}, "prob_thresh"),
                      ({"iou_thresh": 1.5}, "iou_thresh"),
                      ({"resize_mode": "crop"}, "mode"),
                      ({"decode_impl": "triton"}, "decode_impl")]:
        with pytest.raises(ValueError, match=match):
            Detector(net, **kw)
    det = Detector(net)
    assert det.top_k == 256  # auto_top_k: 3·(8² + 16²) candidates
    with pytest.raises(TypeError, match="uint8"):
        det.detect_batch(np.zeros((1, 64, 64, 3), np.float32))
    assert det.detect_batch(np.zeros((0, 64, 64, 3), np.uint8)) == []


def test_detector_device(monkeypatch):
    """The Detector runs where the net's weights are: a different device is
    an error (weights are not moved behind the caller's back), and CUDA
    without a card raises instead of running on the CPU."""
    net = Darknet(SMALL_CFG, device="cpu")
    assert Detector(net, device="cpu").device == torch.device("cpu")
    with pytest.raises(ValueError, match="live on cpu"):
        Detector(net, device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Detector(net, device="cuda")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc → a clear error, never a fall back to the plain versions."""
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_kernels(tmp_path / "build")
    assert not (tmp_path / "build").exists() or not any(
        (tmp_path / "build").iterdir())


def test_build_reports_compiler_output(monkeypatch, tmp_path):
    """A failing nvcc raises with the compiler's own output."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: fake compiler refuses' >&2\nexit 2\n")
    os.chmod(fake, 0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match="fake compiler refuses"):
        _build.build_kernels(tmp_path / "build")
