"""The heads' ``scale_x_y`` (YOLOv4) in every decode the Detector can
route to: the plain decode (``ops/decode.py``), K1 and K1c
(``ops/cuda_decode.py``; their plain versions on the CPU) and K3's, against
the formula centre = (sigmoid(t)·s − (s − 1)/2 + cell) × stride, and at
s = 1 bit for bit the decode without a scale. K4 takes no scale: a graph
with a scaled head is refused its route (``decode_route`` falls back to K1
with a warning; ``forward_packed_fused`` and the int8 K4 walk raise)."""
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

from yolov3_tpu_torch import model as tmodel
from yolov3_tpu_torch.graph import load_graph
from yolov3_tpu_torch.inference import decode_route
from yolov3_tpu_torch.ops import cuda_decode
from yolov3_tpu_torch.ops import decode as plain

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
ANCHORS = [((12.0, 16.0), (19.0, 36.0), (40.0, 28.0)),
           ((36.0, 75.0), (76.0, 55.0), (72.0, 146.0)),
           ((142.0, 110.0), (192.0, 243.0), (459.0, 401.0))]
STRIDES = [8, 16, 32]
GRIDS = [12, 6, 3]
SCALES = [1.2, 1.1, 1.05]
CLASSES = 4


def _heads(seed, dtype=torch.float32):
    """Head maps (B=2) with centre logits to +-9 and box sizes near their
    anchors, so that a box's corners give its centre back to 1e-4."""
    rng = np.random.default_rng(seed)
    per = 5 + CLASSES
    out = []
    for g in GRIDS:
        f = rng.normal(0, 3, (2, g, g, 3, per)).astype(np.float32)
        f[..., 2:4] *= 0.1
        out.append(torch.from_numpy(f.reshape(2, g, g, 3 * per)).to(dtype))
    return out


def _centres(feat, stride, scale):
    """(B, g, g, A, 2) centres by the formula, float32, in the decode's
    order of operations."""
    b, g, _, _ = feat.shape
    f = feat.float().reshape(b, g, g, 3, 5 + CLASSES)
    sig = torch.sigmoid(f[..., 0:2])
    cells = torch.stack(torch.meshgrid(torch.arange(g), torch.arange(g),
                                       indexing="xy"), -1).float()[:, :, None]
    return (sig * scale - (scale - 1.0) / 2.0 + cells) * stride


def _unscaled_centres(feat, stride):
    """The decode before scale_x_y: (sigmoid(t) + cell) × stride."""
    b, g, _, _ = feat.shape
    f = feat.float().reshape(b, g, g, 3, 5 + CLASSES)
    cells = torch.stack(torch.meshgrid(torch.arange(g), torch.arange(g),
                                       indexing="xy"), -1).float()[:, :, None]
    return (torch.sigmoid(f[..., 0:2]) + cells) * stride


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("scaled", [True, False], ids=["scaled", "ones"])
def test_plain_decode_centres(scaled):
    heads = _heads(1)
    scales = SCALES if scaled else None
    full = plain.decode_all(heads, ANCHORS, STRIDES, CLASSES, scales)
    boxes, _, _ = plain.decode_compact(heads, ANCHORS, STRIDES, CLASSES, scales)
    off = 0
    for f, s, sc in zip(heads, STRIDES, SCALES if scaled else [1.0] * 3):
        want = (_centres(f, s, sc) if scaled else _unscaled_centres(f, s)
                ).reshape(2, -1, 2)
        n = want.shape[1]
        got_full = full[:, off:off + n, 0:2]
        got_compact = (boxes[:, off:off + n, 0:2] + boxes[:, off:off + n, 2:4]) / 2
        assert torch.equal(_bits(got_full), _bits(want))
        torch.testing.assert_close(got_compact, want, rtol=0, atol=1e-4)
        off += n


@pytest.mark.parametrize("scaled", [True, False], ids=["scaled", "ones"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_k1_and_k1c_plain_versions(scaled, dtype):
    """K1's records and K1c's boxes (anchor-major) carry the formula's
    centres; at s = 1 (or no scales) bit for bit the unscaled decode."""
    heads = _heads(2, dtype)
    scales = SCALES if scaled else None
    payload, _ = cuda_decode.decode_packed(heads, ANCHORS, STRIDES, CLASSES,
                                           0.0, scales=scales)
    boxes, scores, classes = cuda_decode.decode_compact(
        heads, ANCHORS, STRIDES, CLASSES, 0.0, scales=scales)
    torch.testing.assert_close(boxes, payload[..., :4], rtol=0, atol=0)
    off = 0
    for f, s, sc in zip(heads, STRIDES, SCALES if scaled else [1.0] * 3):
        c = (_centres(f, s, sc) if scaled else _unscaled_centres(f, s))
        want = c.permute(0, 3, 1, 2, 4).reshape(2, -1, 2)  # anchor-major
        n = want.shape[1]
        rec = payload[:, off:off + n]
        half_w = (rec[..., 2] - rec[..., 0]) / 2
        torch.testing.assert_close((rec[..., 0] + rec[..., 2]) / 2,
                                   want[..., 0], rtol=0, atol=1e-4)
        torch.testing.assert_close((rec[..., 1] + rec[..., 3]) / 2,
                                   want[..., 1], rtol=0, atol=1e-4)
        assert (half_w >= 0).all()
        off += n


def test_ones_are_the_unscaled_decode_bit_for_bit():
    """Scales of 1 given explicitly, none given, and the decode as it was
    before the scale: the same bits on every route's plain version."""
    heads = _heads(3)
    ones = [1.0, 1.0, 1.0]
    for fn in (cuda_decode.decode_packed, cuda_decode.decode_compact,
               cuda_decode.decode_all, plain.decode_compact, plain.decode_all):
        a = fn(heads, ANCHORS, STRIDES, CLASSES)
        b = fn(heads, ANCHORS, STRIDES, CLASSES, scales=ones)
        for x, y in zip(a if isinstance(a, tuple) else [a],
                        b if isinstance(b, tuple) else [b]):
            assert torch.equal(x, y)
    for feat, anchors, stride in zip(heads, ANCHORS, STRIDES):
        rec = cuda_decode.decode_packed_head_reference(feat, anchors, stride,
                                                       CLASSES)
        assert torch.equal(_bits(rec[..., :4]),
                           _bits(_boxes_before(feat, anchors, stride)))


def _boxes_before(feat, anchors, stride):
    """K1's box lanes as its plain version computed them before the
    scale (anchor-major): cx = (sigmoid(tx) + col) * stride, corners
    cx -+ w * 0.5."""
    b, gy, gx, _ = feat.shape
    a, per = len(anchors), 5 + CLASSES
    f = feat.float().reshape(b, gy * gx, a, per)
    cell = torch.arange(gy * gx)
    col = (cell % gx).to(torch.float32)[:, None]
    row = (cell // gx).to(torch.float32)[:, None]
    anc = torch.tensor(anchors, dtype=torch.float32)
    cx = (torch.sigmoid(f[..., 0]) + col) * stride
    cy = (torch.sigmoid(f[..., 1]) + row) * stride
    w = torch.exp(torch.clamp(f[..., 2], max=60.0)) * anc[:, 0]
    h = torch.exp(torch.clamp(f[..., 3], max=60.0)) * anc[:, 1]
    box = torch.stack([cx - w * 0.5, cy - h * 0.5, cx + w * 0.5,
                       cy + h * 0.5], dim=-1)
    return box.permute(0, 2, 1, 3).reshape(b, a * gy * gx, 4)


def test_k3_plain_version_is_the_plain_decode():
    heads = _heads(4, torch.bfloat16)
    got = cuda_decode.decode_all(heads, ANCHORS, STRIDES, CLASSES, SCALES)
    want = plain.decode_all([h.float() for h in heads], ANCHORS, STRIDES,
                            CLASSES, SCALES)
    assert torch.equal(got, want)
    one = cuda_decode.decode_head(heads[0], ANCHORS[0], 8, CLASSES, 1.2)
    assert torch.equal(one, want[:, :one.shape[1]])


def test_k4_is_refused_a_scaled_graph(caplog):
    v4 = load_graph(ROOT / "models" / "yolov4.cfg")
    v3 = load_graph(ROOT / "models" / "yolov3.cfg")
    assert tmodel.fused_heads_eligible(v3)
    assert not tmodel.fused_heads_eligible(v4)
    with caplog.at_level(logging.WARNING):
        assert decode_route(v4, "pallas-fused") == "pallas"
    assert "scale_x_y" in caplog.text
    assert decode_route(v3, "pallas-fused", warn=False) == "pallas-fused"
    assert decode_route(v4, "pallas") == "pallas"
    with pytest.raises(ValueError, match="not eligible"):
        tmodel.forward_packed_fused(v4, {}, torch.zeros(1, 608, 608, 3), 0.05)


def test_int8_k4_walk_refuses_a_scaled_graph():
    from yolov3_tpu_torch.quant import forward_packed_fused_int8

    v4 = load_graph(ROOT / "models" / "yolov4.cfg")
    with pytest.raises(ValueError, match="scale_x_y"):
        forward_packed_fused_int8(v4, {}, {}, torch.zeros(1, 608, 608, 3), 0.05)
