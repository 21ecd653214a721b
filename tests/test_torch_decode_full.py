"""K3 (full decode) and the K1 layout variants on the CPU.

K3's plain version against ``decode_head_pallas`` (interpret mode) and the
JAX plain decode; K1n (``decode_packed_head_pallas_noT``) and K1r
(``decode_packed_head_pallas(out_rows=True)``) compute K1's records in
other TPU layouts, and map onto the port's one K1: their records (interpret
mode) against the port's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu.ops import decode as jdecode
from yolov3_tpu.ops.pallas_decode import (decode_all_pallas,
                                          decode_head_pallas,
                                          decode_packed_head_pallas,
                                          decode_packed_head_pallas_noT)
from yolov3_tpu_torch import Darknet
from yolov3_tpu_torch.ops import cuda_decode
from yolov3_tpu_torch.ops import decode as plain_decode
from yolov3_tpu_torch.weights import fold_raw, random_raw

torch.set_num_threads(1)

ANCHORS = [((10.0, 14.0), (23.0, 27.0), (37.0, 58.0)),
           ((81.0, 82.0), (135.0, 169.0), (344.0, 319.0))]
STRIDES = [32, 16]
GRIDS = [(5, 5), (10, 8)]


def _heads(num_classes, seed):
    """Two head maps (B=2), one of them not square, with tie-heavy class
    logits and box logits past the exp clamp at 60."""
    rng = np.random.default_rng(seed)
    per = 5 + num_classes
    heads = []
    for gy, gx in GRIDS:
        f = rng.normal(0, 2, (2, gy, gx, 3, per)).astype(np.float32)
        f[..., 5:] = np.round(f[..., 5:] * 8) / 8
        big = rng.uniform(0, 1, f[..., 2:4].shape) < 0.05
        f[..., 2:4] = np.where(big, rng.uniform(60, 90, big.shape), f[..., 2:4])
        heads.append(np.ascontiguousarray(f.reshape(2, gy, gx, 3 * per)))
    return heads


@pytest.mark.parametrize("num_classes", [3, 80])
def test_decode_head_matches_pallas_and_plain_jax(num_classes):
    """sigmoid / exp implementations differ in the last ulps between the
    frameworks: rtol 1e-6 (+ 1e-4 px near zero); shapes and order exact."""
    for h, a, s in zip(_heads(num_classes, seed=num_classes), ANCHORS, STRIDES):
        got = cuda_decode.decode_head(torch.from_numpy(h), a, s, num_classes)
        want = np.asarray(decode_head_pallas(jnp.asarray(h), a, s, num_classes,
                                             interpret=True))
        plain = np.asarray(jdecode.decode_head(jnp.asarray(h), a, s, num_classes))
        assert got.shape == want.shape == (2, h.shape[1] * h.shape[2] * 3,
                                           5 + num_classes)
        assert got.dtype == torch.float32 and np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)
        np.testing.assert_allclose(got.numpy(), plain, rtol=1e-6, atol=1e-4)


def test_decode_all_matches_pallas_and_is_the_plain_version_on_cpu():
    heads = _heads(4, seed=11)
    got = cuda_decode.decode_all([torch.from_numpy(h) for h in heads], ANCHORS,
                                 STRIDES, 4)
    want = np.asarray(decode_all_pallas([jnp.asarray(h) for h in heads], ANCHORS,
                                        STRIDES, 4, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)
    cuda_decode.decode_head.launches = 0
    same = plain_decode.decode_all([torch.from_numpy(h) for h in heads], ANCHORS,
                                   STRIDES, 4)
    assert torch.equal(got, same) and cuda_decode.decode_head.launches == 0


def test_decode_head_bf16_map_widens_exactly():
    h = torch.from_numpy(_heads(3, seed=5)[0]).bfloat16()
    got = cuda_decode.decode_head(h, ANCHORS[0], 32, 3)
    assert got.dtype == torch.float32
    assert torch.equal(got, plain_decode.decode_head(h.float(), ANCHORS[0], 32, 3))
    # a channel-padded map decodes its first A·(5+C) channels
    padded = torch.zeros(2, 5, 5, 128)
    padded[..., :24] = h.float()
    assert torch.equal(cuda_decode.decode_head(padded, ANCHORS[0], 32, 3), got)


def test_decode_head_validation():
    h = torch.zeros(1, 5, 5, 24)
    with pytest.raises(ValueError, match="channels"):
        cuda_decode.decode_head(h, ANCHORS[0], 32, 80)
    with pytest.raises(TypeError):
        cuda_decode.decode_head(h.double(), ANCHORS[0], 32, 3)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        cuda_decode.decode_head(h.to("meta"), ANCHORS[0], 32, 3)


def test_darknet_call_runs_the_full_decode_wrapper():
    """``Darknet(x)`` decodes through ``ops.cuda_decode.decode_all`` (K3 on
    the card, its plain version here)."""
    from pathlib import Path

    cfg = Path(__file__).parent / "data" / "port_small.cfg"
    net = Darknet(cfg, precision="highest", device="cpu")
    net.set_params(fold_raw(random_raw(net.graph, seed=2)))
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (2, 64, 64, 3)).astype(np.float32))
    out = net(x)
    assert out.shape == (2, 3 * (8 * 8 + 16 * 16), 5 + net.graph.yolo_nodes[0].classes)
    assert cuda_decode.decode_head.launches == 0


def _records(fn, h, a, s, num_classes, prob, off, **kw):
    payload, scores = fn(jnp.asarray(h), a, s, num_classes, prob_thresh=prob,
                         head_offset=off, interpret=True, **kw)
    return np.asarray(payload), np.asarray(scores)


@pytest.mark.parametrize("variant", ["noT", "out_rows"])
@pytest.mark.parametrize("num_classes,prob", [(3, 0.0), (80, 0.3)])
def test_k1_layout_variants_match_port_k1(variant, num_classes, prob):
    """K1n / K1r records against the port's K1: class, candidate and spare
    lanes exact, the threshold's zero pattern exact, float lanes to the
    frameworks' sigmoid/exp ulps."""
    fn = (decode_packed_head_pallas_noT if variant == "noT"
          else decode_packed_head_pallas)
    kw = {} if variant == "noT" else {"out_rows": True}
    off = 0
    for h, a, s in zip(_heads(num_classes, seed=20 + num_classes), ANCHORS,
                       STRIDES):
        if h.shape[1] != h.shape[2]:
            h = np.ascontiguousarray(h[:, :8])  # the TPU variants take square grids
        want_p, want_s = _records(fn, h, a, s, num_classes, prob, off, **kw)
        got = cuda_decode.decode_packed_head(torch.from_numpy(h), a, s,
                                             num_classes, prob_thresh=prob,
                                             head_offset=off).numpy()[:, off:]
        assert got.shape == want_p.shape
        np.testing.assert_array_equal(got[..., 5:], want_p[..., 5:])
        np.testing.assert_array_equal(got[..., 4] == 0, want_s == 0)
        np.testing.assert_allclose(got[..., :5], want_p[..., :5], rtol=1e-6,
                                   atol=1e-4)
        off += got.shape[1]
