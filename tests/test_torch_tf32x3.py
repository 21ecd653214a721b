"""Split TF32 ("3xTF32"), the arithmetic of K5's and K4's float32 kernels
on the tensor cores, held against the JAX package before any card runs it.

The split itself (``ops/tf32.py``, bit for bit the kernels'
``wg_split_tf32``) on seeded and edge values, then a test-only emulation of
what the kernels compute: every operand split into hi = tf32(x) and lo =
tf32(x − hi), three TF32 products per product (hi·hi + hi·lo + lo·hi), each
K step of 32 channels summed on its own and the steps added in float32 in
the kernels' order. The emulation holds the float32 bars against the JAX
kernels up to Cin = 1,024; one TF32 pass (hi·hi) does not."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu.ops import pallas_conv
from yolov3_tpu.ops.pallas_decode import decode_packed_head_fused_pallas
from yolov3_tpu_torch.ops import cuda_decode
from yolov3_tpu_torch.ops.tf32 import split_tf32, tf32_operands, tf32_round

torch.set_num_threads(1)

STEP = 32  # channels of the kernels' K step (one 128-byte row of float32)
ANCHORS = ((10.0, 13.0), (33.0, 23.0), (116.0, 90.0))
# the float32 bars: K5's (the JAX package's conv-kernel tolerance) and K4's
# (its fused-vs-unfused test's), as chip_smoke.py holds the kernels
K5_ATOL, K5_RTOL = 5e-5, 1e-4
K4_SCORE_ATOL, K4_SCORE_RTOL, K4_BOX_ATOL, K4_MARGIN = 1e-5, 1e-4, 5e-3, 1e-4


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _f32(bits) -> torch.Tensor:
    return torch.tensor(np.asarray(bits, np.uint32).view(np.int32)).view(
        torch.float32)


def _edge_values() -> torch.Tensor:
    """Seeded normals over many scales, zeros, negatives, subnormals,
    powers of two, and the bit patterns around a rounding tie."""
    rng = np.random.default_rng(0)
    seeded = (rng.normal(0, 1, 4096) * 10.0 ** rng.integers(-30, 30, 4096))
    pows = [2.0 ** k for k in range(-126, 127, 7)]
    ties = []
    for base in (0x3F800000, 0x41200000, 0x00400000, 0x7E000000):
        for low in (0x0FFF, 0x1000, 0x1001, 0x1FFF, 0x2FFF, 0x3000):
            ties.append(base | low)
    tie_vals = _f32(ties)
    vals = torch.cat([
        torch.from_numpy(seeded.astype(np.float32)),
        torch.tensor([0.0, -0.0, 1.0, -1.0, 1e-40, -3e-42, 1.4e-45, -1e-45,
                      1e38, -1e38]),
        torch.tensor(pows, dtype=torch.float32),
        -torch.tensor(pows, dtype=torch.float32), tie_vals, -tie_vals])
    return vals


def test_split_tf32_is_exact_and_bounded():
    x = _edge_values()
    hi, lo = split_tf32(x)
    # hi keeps TF32's 10 mantissa bits: the low 13 are zero
    assert int((_bits(hi) & 0x1FFF).abs().max()) == 0
    # hi + lo is x exactly, in float32
    assert torch.equal(hi + lo, x)
    x64, lo64 = x.double().abs(), lo.double()
    # the relative bounds hold for normal x; a subnormal x has fewer
    # mantissa bits, and there the bound is TF32's subnormal step, 2^-136
    # (values some 30 orders of magnitude under the bars' atol)
    step = 2.0 ** -136
    # what the tensor cores would make of lo as it is (its low 13 bits
    # dropped) leaves at most 2^-21 |x|; the kernels round lo to TF32
    # first, which leaves at most 2^-22 |x|
    trunc = (_bits(lo) & -8192).view(torch.float32).double()
    assert bool(((trunc - lo64).abs()
                 <= torch.clamp(2.0 ** -21 * x64, min=step)).all())
    assert bool(((tf32_round(lo).double() - lo64).abs()
                 <= torch.clamp(2.0 ** -22 * x64, min=step / 2)).all())
    # hi is the nearest TF32 value: within half a TF32 ulp, 2^-11 |x|
    assert bool(((hi.double() - x.double()).abs()
                 <= torch.clamp(2.0 ** -11 * x64, min=step / 2)).all())
    normal = x64 >= 2.0 ** -126
    assert bool(((trunc - lo64).abs() <= 2.0 ** -21 * x64)[normal].all())


def test_tf32_round_is_rna():
    """Ties go away from zero, as ``cvt.rna.tf32.f32`` rounds; below a tie
    the value truncates, above it rounds up; the sign is kept."""
    cases = {0x3F800FFF: 0x3F800000, 0x3F801000: 0x3F802000,
             0x3F801001: 0x3F802000, 0x3F803000: 0x3F804000,
             0xBF801000: 0xBF802000, 0xBF800FFF: 0xBF800000,
             0x00001000: 0x00002000, 0x3F7FF000: 0x3F800000}
    got = _bits(tf32_round(_f32(list(cases)))).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, np.array(list(cases.values()),
                                                np.uint32))


def test_tf32_operands_split_once_per_weight():
    """The weight operands the float32 kernels read: (hi, tf32(lo)) in the
    view's logical order, made once and kept on the tensor the view reads
    (so K5's permuted view of a channels_last weight and K4's reshaped head
    weight hit the same pair call after call), made anew after an in-place
    change of the weights; an inference tensor is split at every call."""
    w = torch.randn(16, 8, 3, 3).contiguous(memory_format=torch.channels_last)
    view = w.permute(0, 2, 3, 1)  # K5's (Cout, 3, 3, Cin) view
    hi, lo = tf32_operands(view)
    want_hi, want_lo = split_tf32(view)
    assert hi.is_contiguous() and hi.shape == view.shape
    assert torch.equal(hi, want_hi) and torch.equal(lo, tf32_round(want_lo))
    again = tf32_operands(w.permute(0, 2, 3, 1))
    assert again[0] is hi and again[1] is lo
    w.mul_(3.0)
    fresh = tf32_operands(view)
    assert fresh[0] is not hi and torch.equal(fresh[0], tf32_round(view))
    head = torch.randn(255, 128, 1, 1).contiguous(
        memory_format=torch.channels_last)
    pair = tf32_operands(head.reshape(255, 128)[:200].contiguous())
    assert tf32_operands(head.reshape(255, 128)[:200].contiguous())[0] is pair[0]
    with torch.inference_mode():
        x = torch.randn(4, 32)
        first, second = tf32_operands(x), tf32_operands(x)
    assert first[0] is not second[0] and torch.equal(first[0], second[0])


def emulate_tf32x3(a: np.ndarray, b: np.ndarray, passes: int = 3
                   ) -> np.ndarray:
    """(M, K) x (N, K) → (M, N) float32 as the kernels sum it: K in steps of
    32 in the given order, each step's TF32 products summed on their own
    (exactly, in float64: the products of 11-bit mantissas are exact) and
    rounded to float32 once, the steps added in float32. ``passes`` 3:
    hi·hi + hi·lo + lo·hi; 1: hi·hi alone, one TF32 pass."""
    ahi, alo = (t.numpy().astype(np.float64) for t in split_tf32(
        torch.from_numpy(a)))
    bhi, blo = (t.numpy().astype(np.float64) for t in split_tf32(
        torch.from_numpy(b)))
    alo = tf32_round(torch.from_numpy(alo.astype(np.float32))).double().numpy()
    blo = tf32_round(torch.from_numpy(blo.astype(np.float32))).double().numpy()
    total = np.zeros((a.shape[0], b.shape[0]), np.float32)
    for k0 in range(0, a.shape[1], STEP):
        s = slice(k0, k0 + STEP)
        step = ahi[:, s] @ bhi[:, s].T
        if passes == 3:
            step += ahi[:, s] @ blo[:, s].T + alo[:, s] @ bhi[:, s].T
        total += step.astype(np.float32)
    return total


def emulate_conv3x3(x: np.ndarray, w_hwio: np.ndarray, b: np.ndarray,
                    activation: str, passes: int = 3) -> np.ndarray:
    """K5's float32 kernel in numpy: the implicit GEMM over (tap, channel)
    with K steps of 32 channels of one tap, 32-channel blocks outermost and
    the nine taps inside (``csrc/conv3x3.cu``), SAME padding, then bias and
    activation."""
    bsz, h, wd, cin = x.shape
    cout = w_hwio.shape[3]
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    taps = np.stack([xp[:, ky:ky + h, kx:kx + wd]
                     for ky in range(3) for kx in range(3)], axis=3)
    a = taps.reshape(-1, 9, cin // STEP, STEP).transpose(0, 2, 1, 3)
    wk = w_hwio.reshape(9, cin // STEP, STEP, cout).transpose(3, 1, 0, 2)
    y = emulate_tf32x3(np.ascontiguousarray(a.reshape(-1, 9 * cin)),
                       np.ascontiguousarray(wk.reshape(cout, 9 * cin)),
                       passes) + b
    if activation == "leaky":
        y = np.where(y > 0, y, np.float32(0.1) * y)
    return y.reshape(bsz, h, wd, cout)


def _within(got, want, atol, rtol) -> bool:
    return bool(np.all(np.abs(got - want) <= atol + rtol * np.abs(want)))


@pytest.mark.parametrize("cin", [128, 256, 512, 1024])
def test_k5_tf32x3_holds_the_float32_bar(cin):
    """The emulated kernel against the JAX ``conv3x3_fused_roll2`` (interpret
    mode, as the JAX package's tests run it on the CPU), at the chip phase's
    operand scales (x ~ N(0, 1), w ~ N(0, 0.1)): within atol 5e-5 / rtol
    1e-4 at every Cin, K = 9·Cin up to 9,216. One TF32 pass misses that bar
    at Cin = 1,024, which is why the kernel runs three."""
    rng = np.random.default_rng(cin)
    x = rng.normal(0, 1, (1, 6, 7, cin)).astype(np.float32)
    w = rng.normal(0, 0.1, (3, 3, cin, 64)).astype(np.float32)
    b = rng.normal(0, 0.1, 64).astype(np.float32)
    for activation in ("leaky", "linear"):
        want = np.asarray(pallas_conv.conv3x3_fused_roll2(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
            activation=activation, interpret=True))
        got = emulate_conv3x3(x, w, b, activation)
        np.testing.assert_allclose(got, want, atol=K5_ATOL, rtol=K5_RTOL)
    if cin == 1024:
        one_pass = emulate_conv3x3(x, w, b, "linear", passes=1)
        assert not _within(one_pass, want, K5_ATOL, K5_RTOL)
        # by an order of magnitude: its worst error against the bar's room
        room = K5_ATOL + K5_RTOL * np.abs(want)
        assert float(np.max(np.abs(one_pass - want) / room)) > 10


def emulate_fused_head(x: np.ndarray, w: np.ndarray, bias: np.ndarray,
                       passes: int = 3, **decode_kw) -> np.ndarray:
    """K4's float32 kernel in numpy and the port's plain decode: the head
    rows x·wᵀ by the emulated split-TF32 sums (K steps of 32 channels in
    order), plus the bias, decoded to K1's records."""
    bsz, gy, gx, cin = x.shape
    head = emulate_tf32x3(np.ascontiguousarray(x.reshape(-1, cin)), w,
                          passes) + bias
    return cuda_decode.decode_packed_head_reference(
        torch.from_numpy(head.reshape(bsz, gy, gx, -1)), ANCHORS, 32, 80,
        **decode_kw).numpy()


def _records_within_k4_bars(got, want, head) -> bool:
    """K4's bars: scores atol 1e-5 / rtol 1e-4, boxes 5e-3 px where both
    keep the candidate, candidates exact, classes exact wherever the top
    two class logits of the plain head are further apart than K4_MARGIN."""
    ok = _within(got[..., 4], want[..., 4], K4_SCORE_ATOL, K4_SCORE_RTOL)
    both = (got[..., 4] > 0) & (want[..., 4] > 0)
    ok &= bool(both.any()) and _within(got[both][:, :4], want[both][:, :4],
                                       K4_BOX_ATOL, K4_SCORE_RTOL)
    ok &= bool(np.array_equal(got[..., 6], want[..., 6]))
    cls = np.sort(head.reshape(-1, 3, 85)[..., 5:], axis=-1)
    near = (cls[..., -1] - cls[..., -2] <= K4_MARGIN)     # (cells, anchors)
    near = near.reshape(got.shape[0], -1, 3).transpose(0, 2, 1).reshape(
        got.shape[0], -1)
    ok &= bool(np.all((got[..., 5] == want[..., 5]) | near))
    return ok


@pytest.mark.parametrize("cin", [256, 512, 1024])
def test_k4_tf32x3_holds_the_float32_bars(cin):
    """The emulated kernel against the JAX ``decode_packed_head_fused_pallas``
    at precision "highest" (as the JAX package's tests run it on the CPU),
    within K4's bars at Cin = 256, 512 and 1,024."""
    rng = np.random.default_rng(cin + 1)
    x = rng.normal(0, 1, (2, 4, 4, cin)).astype(np.float32)
    w = rng.normal(0, 1 / np.sqrt(cin), (255, cin)).astype(np.float32)
    bias = rng.normal(0, 0.1, 255).astype(np.float32)
    w_pad = np.zeros((cin, 256), np.float32)
    w_pad[:, :255] = w.T
    b_pad = np.zeros(256, np.float32)
    b_pad[:255] = bias
    want, _ = decode_packed_head_fused_pallas(
        jnp.asarray(x), jnp.asarray(w_pad), jnp.asarray(b_pad), ANCHORS, 32,
        80, prob_thresh=0.2, head_offset=0, precision="highest")
    want = np.asarray(want)
    got = emulate_fused_head(x, w, bias, prob_thresh=0.2)
    head = x.reshape(-1, cin).astype(np.float64) @ w.T.astype(np.float64) + bias
    assert got.shape == want.shape == (2, 3 * 16, 8)
    assert _records_within_k4_bars(got, want, head)
    np.testing.assert_allclose(got[..., 4], want[..., 4], atol=K4_SCORE_ATOL,
                               rtol=K4_SCORE_RTOL)
