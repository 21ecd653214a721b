"""K1 (packed decode): the port's ``decode_packed`` (plain path on the CPU)
against ``yolov3_tpu.ops.pallas_decode.decode_packed_pallas`` (the Pallas
kernel, which runs in interpret mode on the CPU backend by itself)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu.ops.pallas_decode import decode_packed_pallas
from yolov3_tpu_torch.ops import cuda_decode

torch.set_num_threads(1)

ANCHORS = [((10.0, 14.0), (23.0, 27.0), (37.0, 58.0)),
           ((81.0, 82.0), (135.0, 169.0), (344.0, 319.0))]
STRIDES = [32, 16]
GRIDS = [5, 10]


def _heads(num_classes, seed):
    """Two head maps (B=2) with tie-heavy class logits (1/8 grid) and box
    logits past the exp clamp at 60."""
    rng = np.random.default_rng(seed)
    per = 5 + num_classes
    heads = []
    for g in GRIDS:
        f = rng.normal(0, 2, (2, g, g, 3 * per)).astype(np.float32)
        f = f.reshape(2, g, g, 3, per)
        f[..., 5:] = np.round(f[..., 5:] * 8) / 8            # exact ties
        big = rng.uniform(0, 1, f[..., 2:4].shape) < 0.05
        f[..., 2:4] = np.where(big, rng.uniform(60, 90, big.shape), f[..., 2:4])
        heads.append(np.ascontiguousarray(f.reshape(2, g, g, 3 * per)))
    return heads


@pytest.mark.parametrize("num_classes", [3, 80])
@pytest.mark.parametrize("prob_thresh", [0.0, 0.3])
def test_decode_packed_matches_pallas(num_classes, prob_thresh):
    heads = _heads(num_classes, seed=num_classes)
    want_p, want_s = decode_packed_pallas(
        [jnp.asarray(h) for h in heads], ANCHORS, STRIDES, num_classes,
        prob_thresh=prob_thresh)
    want_p, want_s = np.asarray(want_p), np.asarray(want_s)
    got_p, got_s = cuda_decode.decode_packed(
        [torch.from_numpy(h) for h in heads], ANCHORS, STRIDES, num_classes,
        prob_thresh=prob_thresh)
    got_p, got_s = got_p.numpy(), got_s.numpy()
    assert got_p.shape == want_p.shape == (2, 3 * (25 + 100), 8)
    # class, candidate index and the spare lane: exact
    np.testing.assert_array_equal(got_p[..., 5:], want_p[..., 5:])
    # the threshold's zero pattern: exact
    np.testing.assert_array_equal(got_s == 0, want_s == 0)
    np.testing.assert_array_equal(got_s, got_p[..., 4])
    # float lanes: sigmoid/exp implementations differ in the last ulps
    np.testing.assert_allclose(got_p[..., :5], want_p[..., :5],
                               rtol=1e-6, atol=1e-4)
    assert np.isfinite(got_p).all()


def test_decode_head_takes_strided_channel_padded_map():
    """A channel-padded map (TPU lane padding, or any stride) decodes to the
    same records as the tight map — the wrapper reads channels 0..A·(5+C)."""
    h = _heads(3, seed=7)[0]
    padded = np.zeros((*h.shape[:3], 128), np.float32)
    padded[..., :h.shape[3]] = h
    a = cuda_decode.decode_packed_head(torch.from_numpy(h), ANCHORS[0], 32, 3,
                                       prob_thresh=0.2, head_offset=11)
    b = cuda_decode.decode_packed_head(torch.from_numpy(padded), ANCHORS[0],
                                       32, 3, prob_thresh=0.2, head_offset=11)
    assert a.shape == (2, 11 + 75, 8)  # rows < head_offset: other heads'
    assert torch.equal(a[:, 11:], b[:, 11:])
    np.testing.assert_array_equal(a[0, 11:, 6].numpy(), np.arange(11, 86))


def test_decode_wrapper_rejects_what_the_kernel_does_not_take():
    h = torch.zeros(1, 5, 5, 24)
    with pytest.raises(ValueError, match="channels"):
        cuda_decode.decode_packed_head(h, ANCHORS[0], 32, 80)
    with pytest.raises(TypeError):
        cuda_decode.decode_packed_head(h.double(), ANCHORS[0], 32, 3)
    with pytest.raises(ValueError, match="payload"):
        cuda_decode.decode_packed_head(h, ANCHORS[0], 32, 3,
                                       out=torch.empty(1, 10, 8))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        cuda_decode.decode_packed_head(h.to("meta"), ANCHORS[0], 32, 3)
