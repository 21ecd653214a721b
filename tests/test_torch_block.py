"""K6 on the CPU: the block plan against the JAX package's, and K6's plain
version against the port's unfused walk (exactly) and against the JAX
kernel ``residual_block_int8`` in interpret mode (its own tie contract).

The JAX kernel and the unfused walks differ only at requantization ties
flipped by float-contraction differences: at a block's output at most one
quantization step on a small share of elements
(``tests/test_pallas_block.py``); at the heads, where a flipped element
spreads through the following convs, most elements equal and none beyond a
few steps.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu import quant as jq
from yolov3_tpu.config import parse_config_text as jparse
from yolov3_tpu.graph import load_graph as jload_graph, lower as jlower
from yolov3_tpu.ops import pallas_block as jblock
from yolov3_tpu_torch import quant as tq
from yolov3_tpu_torch.config import parse_config_text
from yolov3_tpu_torch.graph import load_graph, lower
from yolov3_tpu_torch.ops import cuda_block
from yolov3_tpu_torch.weights import (fold_raw, quant_state_from_jax,
                                      random_raw)

torch.set_num_threads(1)

DATA = Path(__file__).parent / "data"
MODELS = Path(__file__).parent.parent / "models"
BLOCK_CFG = (DATA / "port_block.cfg").read_text()

HEAD = """
[convolutional]
size=1
stride=1
pad=1
filters=27
activation=linear

[yolo]
mask=0,1,2
anchors=10,13, 16,30, 33,23
classes=4
num=3
"""


def _variant(name: str) -> str:
    """port_block.cfg and the variants of ``tests/test_pallas_block.py``."""
    parts = BLOCK_CFG.split("[convolutional]")
    stem, blocks = parts[0] + "[convolutional]" + parts[1], parts[2:6]
    two_blocks = "".join("[convolutional]" + b for b in blocks)
    if name == "chain2":
        return BLOCK_CFG
    if name == "odd":  # 38 -> 19x19 blocks: ragged tiles on both edges
        return BLOCK_CFG.replace("width=48", "width=38").replace("height=48",
                                                                 "height=38")
    if name == "rect":
        return BLOCK_CFG.replace("width=48", "width=56").replace("height=48",
                                                                 "height=40")
    if name == "float_consumer":  # the block feeds the float head conv
        return stem + "".join("[convolutional]" + b for b in blocks[:2]) + HEAD
    if name == "route_tap":  # a later route reads the FIRST block's output
        down = ("\n[convolutional]\nbatch_normalize=1\nfilters=128\nsize=3\n"
                "stride=2\npad=1\nactivation=leaky\n\n[route]\nlayers=-1\n")
        return stem + two_blocks + down + HEAD + "\n[route]\nlayers=3\n" + HEAD
    raise ValueError(name)


class Case:
    def __init__(self, name: str, seed: int = 0):
        text = _variant(name)
        self.g, self.jg = lower(parse_config_text(text)), jlower(jparse(text))
        params = fold_raw(random_raw(self.g, seed=seed))
        self.jparams = {i: {k: jnp.asarray(v) for k, v in p.items()}
                        for i, p in params.items()}
        self.x = np.random.default_rng(seed + 1).uniform(
            0, 1, (2, self.g.in_height, self.g.in_width, 3)).astype(np.float32)
        self.scales = jq.calibrate_tensors(self.jg, self.jparams,
                                           [jnp.asarray(self.x)], precision="bf16")
        self.jqp = jq.quantize_weights(self.jg, self.jparams)
        self.tqp = quant_state_from_jax(
            {i: {k: np.asarray(v) for k, v in qp.items()}
             for i, qp in self.jqp.items()}, device="cpu")

    def walk(self, impl, precision="bf16", **kw):
        return tq.forward_features_int8_carrier(
            self.g, self.tqp, self.scales, torch.from_numpy(self.x), precision,
            block_impl=impl, **kw)

    def jwalk(self, impl, precision="bf16", **kw):
        return jq.forward_features_int8_carrier(
            self.jg, self.jqp, self.scales, jnp.asarray(self.x), precision,
            block_impl=impl, **kw)


@pytest.mark.parametrize("cfg", ["block", "yolov3", "tiny"])
def test_fused_block_plan_equals_jax_plan(cfg):
    path = {"block": DATA / "port_block.cfg", "yolov3": MODELS / "yolov3.cfg",
            "tiny": MODELS / "yolov3-tiny.cfg"}[cfg]
    g, jg = load_graph(path), jload_graph(path)
    fake = {n.index: ({"wq": 0} if tq.eligible(g, n) else {"w": 0})
            for n in g.conv_nodes}
    scales = {n.index: 1.0 for n in g.nodes}
    plan = cuda_block.fused_block_plan(g, fake, scales)
    assert plan == jblock.fused_block_plan(jg, fake, scales)
    assert len(plan) == {"block": 2, "yolov3": 10, "tiny": 0}[cfg]
    if cfg == "yolov3":  # 2 blocks of C=128, 8 of C=256; C=64 and C>=512 stay
        assert sorted(v["cin"] for v in plan.values()) == [128] * 2 + [256] * 8
        assert cuda_block.fused_block_plan(g, fake, scales, max_cin=128) == \
            jblock.fused_block_plan(jg, fake, scales, max_cin=128)
    assert cuda_block.DEFAULT_MAX_CIN == jblock.DEFAULT_MAX_CIN == 256
    del scales[1]  # a missing calibrated scale refuses the block
    assert 2 not in cuda_block.fused_block_plan(g, fake, scales)


@pytest.mark.parametrize("precision", ["bf16", "highest"])
@pytest.mark.parametrize("name", ["chain2", "odd", "rect", "float_consumer",
                                  "route_tap"])
def test_plain_block_equals_unfused_walk_exactly(name, precision):
    """K6's plain version runs the unfused walk's operations in its order:
    the head maps of ``block_impl="pallas"`` and ``"xla"`` are identical."""
    case = Case(name)
    plan = cuda_block.fused_block_plan(case.g, case.tqp, case.scales)
    assert len(plan) == (1 if name == "float_consumer" else 2)
    cuda_block.residual_block_int8.launches = 0
    fused, unfused = case.walk("pallas", precision), case.walk("xla", precision)
    assert len(fused) == len(unfused) == len(case.g.yolo_nodes)
    for a, b in zip(fused, unfused):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    assert cuda_block.residual_block_int8.launches == 0  # CPU: plain version


@pytest.mark.parametrize("upto", [2, 3, 4, 7])
def test_plain_block_upto(upto):
    """A cut inside a block fuses nothing; a cut after it returns the
    block's output tensor, identical to the unfused walk's."""
    case = Case("chain2")
    a = case.walk("pallas", upto=upto)
    b = case.walk("xla", upto=upto)
    assert len(a) == len(b) == 1 and torch.equal(a[0], b[0])


@pytest.mark.parametrize("name", ["chain2", "odd", "float_consumer"])
def test_block_output_within_jax_kernel_tie_contract(name):
    """The block OUTPUT (upto = first shortcut + 1) of the port against the
    JAX kernel in interpret mode: ≥ 99.5% of elements equal (a carrier
    output, computed with another float contraction, to 1e-6 relative),
    none further than one quantization step of the output scale."""
    case = Case(name)
    got = case.walk("pallas", "highest", upto=4)[-1].float().numpy()
    want = np.asarray(case.jwalk("pallas", "highest", upto=4)[-1], np.float32)
    d = np.abs(got - want)
    same = d <= (0.0 if name != "float_consumer"
                 else 1e-6 * np.maximum(1.0, np.abs(want)))
    assert same.mean() >= 0.995, f"{1 - same.mean():.4%} differ"
    assert d.max() <= 1.05 * case.scales[3]


@pytest.mark.parametrize("name", ["chain2", "route_tap", "rect"])
def test_heads_close_to_jax_kernel_walk(name):
    case = Case(name)
    smax = max(case.scales.values())
    for a, b in zip(case.walk("pallas", "highest"),
                    case.jwalk("pallas", "highest")):
        b = np.asarray(b, np.float32)
        d = np.abs(a.float().numpy() - b)
        # the float head conv sums in another order: 1e-5 is float noise
        same = d <= 1e-5 * np.maximum(1.0, np.abs(b))
        assert same.mean() >= 0.9, f"{1 - same.mean():.4%} differ"
        assert d.max() <= 10 * smax


def _block_operands(case, a=1):
    s = case.scales
    bp = cuda_block.prepare_block_params(case.tqp[a], case.tqp[a + 1], s[a - 1], s[a])
    kw = dict(s_in=s[a - 1], s_mid=s[a], s_mid2=s[a + 1], s_out=s[a + 2])
    return bp, kw


def test_residual_block_int8_direct_against_jax_kernel():
    """The wrapper on one int8 tensor against ``residual_block_int8``
    (interpret mode) on the same tensor in the chain layout."""
    case = Case("chain2")
    rng = np.random.default_rng(3)
    xq = rng.integers(-127, 128, (2, 24, 24, 128), dtype=np.int8)
    bp, kw = _block_operands(case)
    got = cuda_block.residual_block_int8(torch.from_numpy(xq), bp, emit_q=True, **kw)
    assert got.dtype == torch.int8 and got.shape == xq.shape
    geom = jblock.plan_geometry(24, 24, 128, 64, 128)
    ops = jblock.prepare_block_params(case.jqp[1], case.jqp[2], kw["s_in"],
                                      kw["s_mid"], geom.cp)
    want = jblock.residual_block_int8(
        jblock.pad_chain_input(jnp.asarray(xq), geom, 24, 24), *ops, h=24, w=24,
        emit_q=True, interpret=True, **kw)
    want = np.asarray(jblock.slice_chain_output(want, 24, 24))
    d = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d == 0).mean() >= 0.995
    for dtype in (torch.bfloat16, torch.float32):
        f = cuda_block.residual_block_int8(torch.from_numpy(xq), bp, emit_q=False,
                                           carrier_dtype=dtype, **kw)
        assert f.dtype == dtype
        # the int8 output is the carrier output quantized to s_out
        q = tq._quantize_to(cuda_block.residual_block_int8(
            torch.from_numpy(xq), bp, emit_q=False, carrier_dtype=torch.float32,
            **kw), kw["s_out"])
        assert torch.equal(q, got)


def _unpack_block_weights(w1k, w2k, cin, cmid):
    """The inverse of ``pack_block_weights``, written from the kernel's
    layout: w1k row n = the 1×1 weights of mid channel n; w2k row o at
    K = tap·cmid_p + j = the 3×3 weight of (tap, j) into output o."""
    cp = w1k.shape[0]
    wq1 = w1k[:cmid].t().reshape(1, 1, cin, cmid)
    wq2 = torch.empty((3, 3, cmid, cin), dtype=torch.int8)
    for tap in range(9):
        wq2[tap // 3, tap % 3] = w2k[:, tap * cp:tap * cp + cmid].t()
    return wq1, wq2


@pytest.mark.parametrize("cin,cmid", [(128, 64), (256, 128), (128, 32)])
def test_pack_block_weights_round_trip(cin, cmid):
    """K6's K-major operands hold the int8 weights and zeros elsewhere:
    w1k (cmid_p, C) and w2k (C, ksteps·128), cmid_p = cmid rounded up to
    64, ksteps = ceil(9·cmid_p / 128)."""
    rng = np.random.default_rng(cin + cmid)
    wq1 = torch.from_numpy(rng.integers(-127, 128, (1, 1, cin, cmid), dtype=np.int8))
    wq2 = torch.from_numpy(rng.integers(-127, 128, (3, 3, cmid, cin), dtype=np.int8))
    w1k, w2k = cuda_block.pack_block_weights(wq1, wq2)
    cp = -(-cmid // 64) * 64
    ksteps = -(-9 * cp // 128)
    assert w1k.shape == (cp, cin) and w1k.dtype == torch.int8
    assert w2k.shape == (cin, ksteps * 128) and w2k.dtype == torch.int8
    assert w1k.is_contiguous() and w2k.is_contiguous()
    back1, back2 = _unpack_block_weights(w1k, w2k, cin, cmid)
    assert torch.equal(back1, wq1) and torch.equal(back2, wq2)
    # every byte that is not a weight is zero: the padded mid channels and
    # the K tail past 9·cmid_p add nothing to the products
    assert int(w1k.abs().sum()) == int(wq1.abs().sum())
    assert int(w2k.abs().sum()) == int(wq2.abs().sum())
    # the 3x3's K = (tap, mid channel) in 32-byte products never straddles
    # a tap: K6 reads each product's A rows from one tap's shifted tile
    assert cp % 32 == 0


def test_pack4_and_block_validation():
    case = Case("chain2")
    bp, kw = _block_operands(case)
    x = torch.zeros((1, 4, 4, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="int8 NHWC"):
        cuda_block.residual_block_int8(x.float(), bp, emit_q=True, **kw)
    with pytest.raises(ValueError, match="s_out"):
        cuda_block.residual_block_int8(x, bp, emit_q=True, **{**kw, "s_out": None})
    with pytest.raises(ValueError, match="other scales"):
        cuda_block.residual_block_int8(x, bp, emit_q=True, **{**kw, "s_in": 0.5})
    with pytest.raises(ValueError, match="carrier_dtype"):
        cuda_block.residual_block_int8(x, bp, emit_q=False,
                                       carrier_dtype=torch.float16, **kw)
    with pytest.raises(ValueError, match="residual bottleneck"):
        cuda_block.prepare_block_params(case.tqp[2], case.tqp[1], 1.0, 1.0)
    cache = {}
    a = cuda_block.prepare_block_params(case.tqp[1], case.tqp[2], 0.1, 0.2,
                                        cache=cache, key=1)
    assert cuda_block.prepare_block_params(case.tqp[1], case.tqp[2], 0.1, 0.2,
                                           cache=cache, key=1) is a
    assert cuda_block.prepare_block_params(case.tqp[1], case.tqp[2], 0.3, 0.2,
                                           cache=cache, key=1) is not a


def _shipped_blocks():
    """(cfg, net size, block start, plan entry, grid) of every block
    ``fused_block_plan`` selects in the shipped cfgs at 320, 416 and 608."""
    out = []
    for path in sorted(MODELS.glob("*.cfg")):
        g = load_graph(path)
        fake = {n.index: ({"wq": 0} if tq.eligible(g, n) else {"w": 0})
                for n in g.conv_nodes}
        scales = {n.index: 1.0 for n in g.nodes}
        for a, v in cuda_block.fused_block_plan(g, fake, scales).items():
            for size in (320, 416, 608):
                out.append((path.name, size, a, v,
                            size // g.nodes[a].downsample))
    return out


def test_shipped_blocks_are_in_the_kernels_domain():
    """Every block ``fused_block_plan`` selects in ``models/`` passes K6's
    domain check (C ∈ {128, 256}, cmid a multiple of 16 up to 256), and the
    check refuses what the kernel does not take."""
    blocks = _shipped_blocks()
    assert {cfg for cfg, *_ in blocks} == {"yolov3.cfg", "yolov3-spp.cfg"}
    for cfg, size, a, v, grid in blocks:
        assert v["cout"] == v["cin"]
        cuda_block.check_block_domain(v["cin"], v["cmid"])
    for c, cmid in ((512, 256), (64, 32), (256, 40), (256, 272), (128, 0)):
        with pytest.raises(ValueError, match="K6 takes"):
            cuda_block.check_block_domain(c, cmid)


@pytest.mark.parametrize("batch", [1, 8])
def test_block_tile_plan_fits_and_covers(batch):
    """The tile plan: every shipped block at 320 / 416 / 608 gets a tile
    whose shared memory fits a block's 227 KB; 8-row tiles only while every
    8 × 8 tile has a multiprocessor to itself (132 on an H100); the grid
    covers every output pixel exactly once."""
    sms = 132
    for cfg, size, a, v, grid in _shipped_blocks():
        c, cmid = v["cin"], v["cmid"]
        th = cuda_block.plan_block_tiles(batch, grid, grid, c, cmid, sms)
        assert th in cuda_block.TILE_HEIGHTS
        assert cuda_block.block_smem_bytes(th, c, cmid) <= 227 * 1024
        small = batch * (-(-grid // 8)) ** 2 <= sms
        assert th == (8 if small else 16), (cfg, size, a)
    # yolov3@416 B=8: 104² C=128 and 52² C=256 take 16-row tiles
    assert cuda_block.block_smem_bytes(16, 256, 128) == 207360
    assert cuda_block.plan_block_tiles(8, 52, 52, 256, 128, sms) == 16
    # a wide mid tile falls back to 8 rows, and past that the plan refuses
    assert cuda_block.block_smem_bytes(16, 256, 256) > cuda_block.SMEM_LIMIT
    assert cuda_block.plan_block_tiles(8, 52, 52, 256, 256, sms) == 8
    for h, w, th in ((37, 53, 16), (5, 3, 8), (52, 52, 16), (19, 21, 8)):
        count = np.zeros((h, w), np.int32)
        for ty in range(-(-h // th)):
            for tx in range(-(-w // cuda_block.TILE_W)):
                count[ty * th:(ty + 1) * th,
                      tx * cuda_block.TILE_W:(tx + 1) * cuda_block.TILE_W] += 1
        assert (count == 1).all()


def test_ablations_apply_to_the_kernel_source():
    """``tools.ablate_block`` removes each part from the kernel as it is:
    every edit finds its code exactly once, and each ablated source differs
    from the kernel's."""
    from yolov3_tpu_torch.tools import ablate_block

    source = ablate_block.SOURCE.read_text()
    got = ablate_block.ablated_sources(source)
    assert set(got) == {"noload", "nomma3", "noepi", "skeleton"}
    assert all(text != source for text in got.values())
    assert "wg_mma_m64k32_s8<C>(acc2" not in got["skeleton"]
    with pytest.raises(ValueError, match="exactly once"):
        ablate_block.ablated_sources(source.replace("load_w2(st == 0", "x("))
