"""K5, the fused 3×3 conv: its plain version against the JAX package's three
Pallas conv kernels (interpret mode), the eligibility predicate, and the
port's ``conv_impl="pallas"`` walk against the JAX walk."""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu import model as jmodel
from yolov3_tpu.graph import load_graph as jload_graph
from yolov3_tpu.ops import pallas_conv
from yolov3_tpu_torch import model as tmodel
from yolov3_tpu_torch.graph import load_graph
from yolov3_tpu_torch.ops import cuda_conv
from yolov3_tpu_torch.weights import fold_raw, params_from_jax, random_raw

torch.set_num_threads(1)

WIDE_CFG = str(Path(__file__).parent / "data" / "port_wide.cfg")
# the JAX package's conv test shapes (B, H, W, Cin, Cout): a W that is not
# a multiple of 8, an odd grid, and a divisor row tile with Cout 64
SHAPES = [(2, 8, 10, 128, 256), (1, 19, 19, 256, 128), (1, 38, 38, 128, 64)]


def _operands(shape, seed):
    b, h, w, ci, co = shape
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, h, w, ci)).astype(np.float32),
            rng.normal(0, 0.1, (3, 3, ci, co)).astype(np.float32),
            rng.normal(0, 0.1, (co,)).astype(np.float32))


def _oihw(w_hwio):
    """HWIO numpy → the port's OIHW channels_last weight tensor."""
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1))
                            ).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("activation", ["leaky", "linear"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kernel", ["conv3x3_fused_roll2", "conv3x3_fused_roll",
                                    "conv3x3_fused"])
def test_k5_plain_matches_pallas(kernel, shape, activation):
    x, w, b = _operands(shape, seed=sum(shape))
    want = np.asarray(getattr(pallas_conv, kernel)(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), activation=activation,
        interpret=True))
    got = cuda_conv.conv3x3_fused(torch.from_numpy(x), _oihw(w),
                                  torch.from_numpy(b), activation=activation)
    assert got.is_contiguous() and got.dtype == torch.float32
    # float32 sums over 9·Cin products in different orders: the JAX
    # package's own conv-kernel tolerance
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=1e-4)


def test_k5_bf16_plain_rounds_once():
    """On bf16 operands the plain version is the float32 conv of the same
    bf16 values, rounded to bf16 once at the end."""
    x, w, b = _operands(SHAPES[0], seed=1)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = _oihw(w).to(torch.bfloat16)
    got = cuda_conv.conv3x3_fused(xb, wb, torch.from_numpy(b))
    want = cuda_conv.conv3x3_fused(xb.float(), wb.float(), torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))


@pytest.mark.parametrize("activation", ["leaky", "linear"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k5_bf16_plain_matches_pallas(shape, activation):
    """bf16 operands: the plain version against the JAX kernel on the same
    bf16 values. Both sum in float32 and round once to bf16, in different
    orders, so they agree to one bf16 ulp (rtol 2^-7); near zero, where an
    ulp is tiny, a float32 summation-order difference decides the rounding,
    hence the float32 bar's atol on top."""
    x, w, b = _operands(shape, seed=sum(shape) + 1)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = pallas_conv.conv3x3_fused_roll2(xb, wb, jnp.asarray(b),
                                           activation=activation, interpret=True)
    assert want.dtype == jnp.bfloat16
    got = cuda_conv.conv3x3_fused(
        torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16),
        _oihw(np.asarray(wb.astype(jnp.float32))).to(torch.bfloat16),
        torch.from_numpy(b), activation=activation)
    assert got.is_contiguous() and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=5e-5, rtol=2.0 ** -7)


def test_supported_matches_jax():
    cases = [(3, 1, 256, "leaky"), (1, 1, 256, "leaky"), (3, 2, 256, "leaky"),
             (3, 1, 3, "leaky"), (3, 1, 32, "leaky"), (3, 1, 256, "mish"),
             (3, 1, 384, "linear"), (3, 1, 128, "relu")]
    for case in cases:
        assert cuda_conv.supported(*case) == pallas_conv.supported(*case), case


@pytest.mark.parametrize("precision", ["highest", None])
def test_forward_features_fused_conv_matches_jax(precision):
    """port_wide.cfg: two of its convs take K5's path (Cin 128 leaky, Cin
    256 linear); the walk equals the JAX walk on XLA's convs (the JAX
    package cannot run its Pallas convs as a whole net on the CPU). On the
    CPU, precision None runs the same float32 math as "highest" (TF32
    exists only on the card)."""
    g = load_graph(WIDE_CFG)
    eligible = [n.index for n in g.conv_nodes if n.pad and cuda_conv.supported(
        n.size, n.stride, g.nodes[n.inputs[0]].out_channels if n.inputs[0] >= 0
        else g.in_channels, n.activation)]
    assert eligible == [1, 4]
    params_np = fold_raw(random_raw(g, seed=9))
    x = np.random.default_rng(2).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    jp = {k: {n: jnp.asarray(v) for n, v in p.items()} for k, p in params_np.items()}
    want = jmodel.forward_features(jload_graph(WIDE_CFG), jp, jnp.asarray(x),
                                   precision="highest", conv_impl="xla")
    got = tmodel.forward_features(g, params_from_jax(params_np, device="cpu"),
                                  torch.from_numpy(x), precision=precision,
                                  conv_impl="pallas")
    assert len(got) == len(want) == 2
    for gh, wh in zip(got, want):
        assert tuple(gh.shape) == wh.shape
        np.testing.assert_allclose(gh.numpy(), np.asarray(wh), rtol=1e-4,
                                   atol=1e-5)


# (B, H, W, Cin, Cout): yolov3@416's three eligible layer shapes at batch 8,
# the ragged test shapes, a yolov3@608 layer, and single images
PLAN_SHAPES = [(8, 52, 52, 128, 256), (8, 26, 26, 256, 512),
               (8, 13, 13, 512, 1024), (8, 76, 76, 128, 256), *SHAPES,
               (1, 13, 13, 512, 1024), (1, 52, 52, 128, 256),
               (1, 10, 10, 512, 1000)]
H100_SMS = 132


def _grid(m, cout, block_m):
    """The kernel's grid for ``block_m``-row tiles (csrc/conv3x3.cu)."""
    return -(-m // block_m), -(-cout // cuda_conv.BLOCK_N)


@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_tile_plan_covers_the_output_once_and_fits(shape):
    """The grid the kernel derives from ``block_m`` (ceil(M / block_m) x
    ceil(Cout / 128)) covers every output element once, with no empty
    block; that the ring fits a block's shared memory is the header's
    ``static_assert``."""
    bsz, h, w, _, cout = shape
    m = bsz * h * w
    block_m = cuda_conv.plan_tiles(m, cout, H100_SMS)
    assert block_m in (64, 128)
    grid = _grid(m, cout, block_m)
    count = np.zeros((m, cout), np.int32)
    for i in range(grid[0]):
        for j in range(grid[1]):
            rows = slice(i * block_m, min((i + 1) * block_m, m))
            cols = slice(j * cuda_conv.BLOCK_N,
                         min((j + 1) * cuda_conv.BLOCK_N, cout))
            assert rows.start < m and cols.start < cout  # no empty block
            count[rows, cols] += 1
    assert (count == 1).all()
    # 64-row tiles exactly while each gets a multiprocessor of its own
    tiles64 = -(-m // 64) * grid[1]
    assert (block_m == 64) == (tiles64 <= H100_SMS)
    if block_m == 64:
        assert grid[0] * grid[1] <= H100_SMS


def test_tile_plan_of_the_main_path():
    """yolov3@416, batch 8: 128-row tiles at all three layer shapes. At
    13 x 13 that is 88 blocks for 132 multiprocessors; 176 blocks of 64 rows
    were measured slower on the card (the busiest multiprocessor does the
    same work, and the weights are read twice as often)."""
    grids = {hw: _grid(8 * hw * hw, cout,
                       cuda_conv.plan_tiles(8 * hw * hw, cout, H100_SMS))
             for hw, cout in ((52, 256), (26, 512), (13, 1024))}
    assert grids == {52: (169, 2), 26: (43, 4), 13: (11, 8)}
    # a card with fewer multiprocessors never gets smaller tiles
    assert cuda_conv.plan_tiles(8 * 13 * 13, 1024, 64) == 128
    # a single image does: 22 x 8 tiles of 64 rows would not fit, 3 x 8 do
    assert _grid(13 * 13, 1024,
                 cuda_conv.plan_tiles(13 * 13, 1024, H100_SMS)) == (3, 8)


def test_k5_layout_check_by_type():
    """Rows are read in 16-byte pieces: strides in multiples of 4 float32 or
    8 bfloat16 elements. A pixel stride of 132 elements is fine for float32
    and refused for bfloat16."""
    w = torch.zeros(8, 3, 3, 128)
    wide = torch.zeros(1, 4, 4, 132)
    cuda_conv._check_layout(wide[..., :128], w)
    with pytest.raises(ValueError, match="multiples of 8 elements"):
        cuda_conv._check_layout(wide.to(torch.bfloat16)[..., :128],
                                w.to(torch.bfloat16))
    cuda_conv._check_layout(torch.zeros(1, 4, 4, 136, dtype=torch.bfloat16)
                            [..., :128], w.to(torch.bfloat16))
    with pytest.raises(ValueError, match="multiples of 4 elements"):
        cuda_conv._check_layout(torch.zeros(1, 4, 4, 130)[..., :128], w)
    with pytest.raises(ValueError, match="channels_last OIHW"):
        cuda_conv._check_layout(wide[..., :128], w.permute(0, 3, 1, 2))
    with pytest.raises(ValueError, match="channel stride 1"):
        cuda_conv._check_layout(torch.zeros(1, 128, 4, 4).permute(0, 2, 3, 1), w)


def test_k5_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(1, 4, 4, 128)
    w = torch.zeros(8, 128, 3, 3)
    b = torch.zeros(8)
    with pytest.raises(ValueError, match="OIHW"):
        cuda_conv.conv3x3_fused(x, torch.zeros(8, 64, 3, 3), b)
    with pytest.raises(ValueError, match="bias"):
        cuda_conv.conv3x3_fused(x, w, torch.zeros(4))
    with pytest.raises(ValueError, match="activation"):
        cuda_conv.conv3x3_fused(x, w, b, activation="relu")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cuda_conv.conv3x3_fused(x.double(), w, b)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        cuda_conv.conv3x3_fused(x.to("meta"), w.to("meta"), b.to("meta"))
