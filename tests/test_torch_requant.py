"""The int8 walk's requantize pass (``ops/cuda_requant.py``): its plain
version against the chain of the walk's own functions it replaces, bit for
bit, on seeded and edge int32 sums; the int8-carrier walk, which in the
symmetric scheme hands each quantized conv's sums (and the shortcut after
it) to the pass, against the same walk node by node, and raising on the
card where the kernel cannot take the sums; the gate ``supported``; the
grid ``plan_int8_requant``, replayed in numpy and pinned at yolov3@608. On
the card (``card``, skipped here) the kernel against the chain bit for bit
at every int8 conv shape of yolov3@608 outside K6. No JAX: the card's
machine runs this file with ``--noconftest``."""
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from yolov3_tpu_torch import quant as tq
from yolov3_tpu_torch.graph import Node, load_graph
from yolov3_tpu_torch.model import residual_convs
from yolov3_tpu_torch.ops import cuda_block
from yolov3_tpu_torch.ops import cuda_requant as cr
from yolov3_tpu_torch.weights import fold_raw, params_from_jax, random_raw

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
BLOCK_CFG = str(ROOT / "tests" / "data" / "port_block.cfg")
TINY_CFG = str(ROOT / "models" / "yolov3-tiny.cfg")
YOLOV3_CFG = str(ROOT / "models" / "yolov3.cfg")
OUT_DTYPES = [torch.int8, torch.bfloat16, torch.float32]
CHANNELS = [32, 64, 1024]
# (the conv's activation, the shortcut's activation or None: no shortcut)
CHAINS = [(a, r) for a in cr.ACTIVATIONS
          for r in (None, "linear", "leaky")]
# int32 sums at float32's integer edge, int32's ends, and zero
INT_EDGES = [0, 1, -1, 2 ** 24 - 1, 2 ** 24, 2 ** 24 + 1, -(2 ** 24 - 1),
             -(2 ** 24), -(2 ** 24 + 1), 2 ** 31 - 1, -(2 ** 31 - 1), -2 ** 31]


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    if t.dtype == torch.int8:
        return t
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _node(activation: str) -> Node:
    return Node(index=0, kind="convolutional", inputs=(-1,), out_channels=0,
                downsample=1, size=3, stride=1, pad=1, activation=activation)


def _conv_state(rng, c: int, sw_range=(1e-4, 1e-3)):
    """A quantized 1x1 conv's qparams (its weights zero: only ``sw`` and
    ``b`` reach the epilogue) and its Operands."""
    qp = {"wq": torch.zeros((1, 1, 16, c), dtype=torch.int8),
          "sw": torch.from_numpy(rng.uniform(*sw_range, c).astype(np.float32)),
          "b": torch.from_numpy(rng.normal(0, 1, c).astype(np.float32))}
    return qp, tq.Operands({0: qp})


def _chain(acc, qp, ops, sx, activation, out_dtype, s_out, shortcut):
    """What the walk runs on the CPU after the int8 product, through its own
    functions: the epilogue, the activation, ``emit``'s quantize (or the
    carrier cast) and, a node later, the shortcut's sum, activation and
    quantize."""
    node = _node(activation)
    y = tq._activate(tq._int8_conv_epilogue(acc, node, qp, sx, 0,
                                            acc.shape[1:3], ops), activation)
    if shortcut is not None:
        s3 = shortcut.conv_scale
        q3 = ("q", tq._quantize_affine(y, s3, 0), s3, 0)
        y = tq._activate(tq._shortcut_sum(
            q3, ("q", shortcut.q, shortcut.scale, 0)), shortcut.activation)
    if out_dtype == torch.int8:
        return tq._quantize_affine(y, s_out, 0)
    return y.to(out_dtype)


def _shortcut(rng, shape, res_act, conv_scale=1.7 / 127, scale=0.0231):
    if res_act is None:
        return None
    q = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
    return cr.Shortcut(q, scale, conv_scale, res_act)


def _chain_ids(chain):
    act, res = chain
    return f"{act}-{'none' if res is None else 'shortcut_' + res}"


@pytest.mark.parametrize("out_dtype", OUT_DTYPES, ids=str)
@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("chain", CHAINS, ids=_chain_ids)
def test_plain_version_is_the_chain_it_replaces(chain, c, out_dtype):
    activation, res_act = chain
    rng = np.random.default_rng(c)
    shape = (2, 3, 5, c)
    acc = torch.from_numpy(rng.integers(-200_000, 200_000, shape
                                        ).astype(np.int32))
    qp, ops = _conv_state(rng, c)
    sx, s_out = 0.0213, 2.0 / 127     # some outputs clamp at +-127
    sc = _shortcut(rng, shape, res_act)
    want = _chain(acc, qp, ops, sx, activation, out_dtype, s_out, sc)
    got = cr.int8_requant_reference(acc, ops.dequant_scale(0, sx), qp["b"],
                                    activation, out_dtype, s_out, sc)
    assert got.dtype == out_dtype and got.shape == shape
    assert torch.equal(_bits(got), _bits(want))
    if out_dtype == torch.int8:
        assert got.abs().max() == 127 and (got.abs() < 127).any()


def _edge_operands(c: int = 8):
    """Sums (1, 4, n, c) holding :data:`INT_EDGES`, odd numbers whose half
    is a .5 tie (1 to 257 and their negatives) and values around +-127.5;
    per-channel scales 1, 0.5, 0.25, ... and biases of 0 and +-0.5 that move
    some sums onto ties."""
    ties = list(range(1, 259, 2))
    rows = [INT_EDGES, ties, [-t for t in ties],
            [125, 126, 127, 128, 129, 254, 255, 256, -254, -255, -256, 2000]]
    n = max(len(r) for r in rows)
    acc = torch.zeros((1, len(rows), n, c), dtype=torch.int32)
    for i, r in enumerate(rows):
        acc[0, i, :len(r)] = torch.tensor(r, dtype=torch.int32)[:, None]
    scale = torch.tensor([1.0, 0.5, 0.25, 2.0 ** -10, 1.0, 0.5, 2.0 ** -20,
                          3.0][:c], dtype=torch.float32)
    b = torch.tensor([0.0, 0.0, 0.5, 0.0, -0.5, 0.25, 0.0, 0.0][:c],
                     dtype=torch.float32)
    return acc, scale, b


@pytest.mark.parametrize("out_dtype", OUT_DTYPES, ids=str)
@pytest.mark.parametrize("chain", CHAINS, ids=_chain_ids)
def test_plain_version_on_edge_sums(chain, out_dtype):
    """int32 sums at 0, +-(2^24 +- 1), +-(2^31 - 1), -2^31, on .5 ties and
    clamping at +-127.5 and beyond: the plain version's bits are the
    chain's. The chain's epilogue takes ``scale`` as ``sw · float32(1.0)``."""
    activation, res_act = chain
    acc, scale, b = _edge_operands()
    qp = {"wq": torch.zeros((1, 1, 16, 8), dtype=torch.int8), "sw": scale,
          "b": b}
    ops = tq.Operands({0: qp})
    rng = np.random.default_rng(11)
    sc = _shortcut(rng, acc.shape, res_act, conv_scale=1.0, scale=0.5)
    want = _chain(acc, qp, ops, 1.0, activation, out_dtype, 1.0, sc)
    got = cr.int8_requant_reference(acc, scale, b, activation, out_dtype, 1.0,
                                    sc)
    assert torch.equal(_bits(got), _bits(want))


def test_edge_sums_round_half_to_even_and_clip():
    """Linear, scale 1 and 0.5, no bias, s_out = 1: what the site must give,
    written out."""
    acc, scale, b = _edge_operands()
    got = cr.int8_requant_reference(acc, scale, torch.zeros_like(b), "linear",
                                    torch.int8, 1.0)
    edges, ties = got[0, 0, :len(INT_EDGES)], got[0, 1]
    assert edges[:, 0].tolist() == [0, 1, -1, 127, 127, 127, -127, -127, -127,
                                    127, -127, -127]
    # channel 1 halves: 1 -> 0.5 -> 0, 3 -> 1.5 -> 2, 5 -> 2.5 -> 2, ...,
    # 253 -> 126.5 -> 126, 255 -> 127.5 -> 128 -> 127
    want = [min(round(t / 2), 127) for t in range(1, 259, 2)]
    assert ties[:len(want), 1].tolist() == want
    assert got[0, 2, :len(want), 1].tolist() == [-w for w in want]
    assert got[0, 3, :11, 1].tolist() == [62, 63, 64, 64, 64, 127, 127, 127,
                                          -127, -127, -127]


# ----------------------------------------------------------------- the walk


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card: the gate's other checks
    read its layout, type and shape."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _on_card(t: torch.Tensor) -> torch.Tensor:
    return torch.Tensor._make_subclass(_OnCard, t)


def _spy(monkeypatch) -> list:
    """Record each call of the plain version by the walk: the shortcut's
    activation, or None where the pass took no shortcut."""
    calls, plain = [], cr.int8_requant_reference

    def run(acc, scale, b, activation, out_dtype, s_out=None, shortcut=None):
        calls.append(None if shortcut is None else shortcut.activation)
        return plain(acc, scale, b, activation, out_dtype, s_out, shortcut)

    monkeypatch.setattr(cr, "int8_requant_reference", run)
    return calls


def _node_by_node(monkeypatch) -> None:
    """The walk with no shortcut handed to a conv's pass: each shortcut runs
    as its own node, on the conv's int8 output."""
    monkeypatch.setattr(tq, "residual_convs", lambda graph, upto=None: {})


class Net:
    """A cfg's random weights, input, and its int8 state calibrated by the
    port on that input (symmetric, or asymmetric with zero-points)."""

    def __init__(self, cfg: str, hw: int, precision, scheme="symmetric",
                 heads: bool = False):
        self.graph = load_graph(cfg)
        self.params = params_from_jax(fold_raw(random_raw(self.graph, seed=3)),
                                      device="cpu")
        self.x = torch.from_numpy(np.random.default_rng(4).uniform(
            0, 1, (2, hw, hw, 3)).astype(np.float32))
        self.precision = precision
        self.qparams = tq.quantize_weights(self.graph, self.params, heads)
        self.zeros = None
        if scheme == "asymmetric":
            self.scales, self.zeros = tq.calibrate_tensors_affine(
                self.graph, self.params, [self.x], precision=precision)
        else:
            self.scales = tq.calibrate_tensors(self.graph, self.params,
                                               [self.x], precision=precision)

    def walk(self, **kw):
        return tq.forward_features_int8_carrier(
            self.graph, self.qparams, self.scales, self.x, self.precision,
            tensor_zeros=self.zeros, **kw)

    def int8_convs(self, block_impl: str):
        k6 = set()
        if block_impl == "pallas":
            k6 = {i for a in cuda_block.fused_block_plan(
                self.graph, self.qparams, self.scales) for i in (a, a + 1)}
        return [n.index for n in self.graph.conv_nodes
                if "wq" in self.qparams[n.index] and n.inputs[0] >= 0
                and n.index not in k6]


def _equal_heads(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("block_impl", ["xla", "pallas"])
@pytest.mark.parametrize("precision", [None, "bf16"])
@pytest.mark.parametrize("cfg", ["block", "tiny"])
def test_fused_walk_equals_the_walk_node_by_node(cfg, precision, block_impl,
                                                monkeypatch):
    """Each quantized conv but the stem (and K6's) hands its sums to the
    pass; port_block's two 3x3 convs take their shortcuts where K6 does not
    run the blocks. Bit for bit the walk that runs each shortcut as its own
    node, int8 and float outputs alike."""
    net = Net(BLOCK_CFG if cfg == "block" else TINY_CFG,
              48 if cfg == "block" else 64, precision)
    with monkeypatch.context() as m:
        _node_by_node(m)
        want = net.walk(block_impl=block_impl)
    with monkeypatch.context() as m:
        calls = _spy(m)
        got = net.walk(block_impl=block_impl)
    assert len(calls) == len(net.int8_convs(block_impl)) > 0
    residual = {("block", "xla"): 2}.get((cfg, block_impl), 0)
    assert calls.count("linear") == residual
    assert len(residual_convs(net.graph)) == (2 if cfg == "block" else 0)
    _equal_heads(got, want)


# a residual block whose input also feeds a float head conv through a route:
# that input stays float, so the conv before the shortcut takes the pass alone
FLOAT_RESIDUAL_CFG = """[net]
width=48
height=48
channels=3

[convolutional]
batch_normalize=1
filters=64
size=3
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=32
size=1
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=64
size=3
stride=1
pad=1
activation=leaky

[shortcut]
from=-3
activation=linear

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

[route]
layers=-6

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


def test_a_float_residual_leaves_the_conv_in_the_pass_alone(tmp_path,
                                                            monkeypatch):
    """Where the shortcut's other input is float the conv still takes the
    pass, alone, and the shortcut runs as its own node: the walk equals the
    walk node by node."""
    cfg = tmp_path / "float_residual.cfg"
    cfg.write_text(FLOAT_RESIDUAL_CFG)
    net = Net(str(cfg), 48, "bf16")
    assert set(residual_convs(net.graph)) == {2}
    with monkeypatch.context() as m:
        _node_by_node(m)
        want = net.walk()
    with monkeypatch.context() as m:
        calls = _spy(m)
        got = net.walk()
    assert calls == [None, None]
    _equal_heads(got, want)


def test_upto_at_a_fused_conv_returns_its_own_output(monkeypatch):
    """port_block's conv 2 feeds shortcut 3: a walk that stops at the conv
    returns the conv's own output, one that stops at the shortcut the sum."""
    net = Net(BLOCK_CFG, 48, None)
    with monkeypatch.context() as m:
        _node_by_node(m)
        want = [net.walk(upto=u)[-1] for u in (3, 4)]
    with monkeypatch.context() as m:
        calls = _spy(m)
        conv = net.walk(upto=3)[-1]
        assert calls == [None, None]
        shortcut = net.walk(upto=4)[-1]
        assert calls[2:] == [None, "linear"]
    assert torch.equal(conv, want[0]) and torch.equal(shortcut, want[1])
    assert not torch.equal(conv, shortcut)


def test_the_asymmetric_scheme_runs_the_chain(monkeypatch):
    net = Net(BLOCK_CFG, 48, "bf16", scheme="asymmetric")
    assert any(net.zeros.values())
    with monkeypatch.context() as m:
        calls = _spy(m)
        heads = net.walk()
    assert calls == [] and len(heads) == 1


def test_on_the_card_the_walk_raises_where_the_kernel_refuses(monkeypatch):
    """tiny with quantized heads: each head conv's 255 sums come as a slice
    of _int_mm's 256 columns, rows 256 apart, which the gate takes. Where it
    refused them the walk on the card would raise, never run the chain."""
    net = Net(TINY_CFG, 64, "bf16", heads=True)
    heads = [n.index for n in net.graph.conv_nodes if n.filters == 255]
    assert len(heads) == 2 and all("wq" in net.qparams[i] for i in heads)
    conv, gate, seen = tq.int8_conv.conv_int8, cr.supported, []

    def padded_n(xq, op, stride, pad, pad_value=0):
        y = conv(xq, op, stride, pad, pad_value)
        if y.shape[-1] != 255:
            return y
        y = _on_card(F.pad(y, (0, 1))[..., :255])  # _int_mm's N of 256
        seen.append((cr.row_stride(y), gate(y, "linear")))
        return y

    monkeypatch.setattr(tq.int8_conv, "conv_int8", padded_n)
    monkeypatch.setattr(cr, "supported", lambda *a, **k: False)
    with pytest.raises(ValueError, match="requantize kernel needs"):
        net.walk()
    assert seen == [(256, True)]


def _sums(shape=(2, 4, 5, 16), dtype=torch.int32) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype)


def _padded_n(shape=(2, 4, 5, 16), n=24) -> torch.Tensor:
    """``conv_int8``'s sums where ``_int_mm``'s N was padded to ``n``."""
    b, h, w, c = shape
    return torch.zeros(b * h * w, n, dtype=torch.int32)[:, :c].reshape(shape)


def _permuted(shape=(2, 4, 5, 16), dtype=torch.int32) -> torch.Tensor:
    """NHWC sums whose pixels do not lie at one stride (an NCHW tensor)."""
    b, h, w, c = shape
    return torch.zeros(b, c, h, w, dtype=dtype).permute(0, 2, 3, 1)


@pytest.mark.parametrize("t, want", [
    (_sums(), 16), (_padded_n(), 24), (_padded_n(n=16), 16),
    (_padded_n((1, 1, 1, 255), 256), 255), (_permuted(), None),
    (torch.zeros(2, 4, 6, 16, dtype=torch.int32)[:, :, ::2], 32),
    (torch.zeros(2, 4, 6, 16, dtype=torch.int32)[:, :, :3], None),
    (_sums((0, 4, 5, 16)), None)],
    ids=["dense", "padded_n", "unpadded", "one_row", "permuted",
         "every_other_pixel", "half_a_row", "empty"])
def test_row_stride(t, want):
    assert cr.row_stride(t) == want


@pytest.mark.parametrize("case, want", [
    ("dense", True), ("dense_shortcut", True), ("leaky_shortcut", True),
    ("padded_n", True), ("relu", True), ("mish", True),
    ("shortcut_mish", True), ("cpu", False), ("permuted", False),
    ("float32", False), ("empty", False), ("swish", False),
    ("shortcut_float", False), ("shortcut_shape", False),
    ("shortcut_strided", False), ("shortcut_swish", False)])
def test_supported(case, want):
    acc, act, sc = _on_card(_sums()), "leaky", None
    q = _on_card(_sums(dtype=torch.int8))
    if case == "dense_shortcut":
        sc = cr.Shortcut(q, 0.1, 0.2, "linear")
    elif case == "leaky_shortcut":
        act, sc = "linear", cr.Shortcut(q, 0.1, 0.2, "leaky")
    elif case == "padded_n":  # _int_mm's output sliced to a short Cout
        acc = _on_card(_padded_n())
    elif case in ("relu", "mish", "swish"):
        act = case
    elif case == "cpu":
        acc = _sums()
    elif case == "permuted":
        acc = _on_card(_permuted())
    elif case == "float32":
        acc = _on_card(_sums(dtype=torch.float32))
    elif case == "empty":
        acc = _on_card(_sums(shape=(0, 4, 5, 16)))
    elif case == "shortcut_float":
        sc = cr.Shortcut(_on_card(_sums(dtype=torch.bfloat16)), 0.1, 0.2,
                         "linear")
    elif case == "shortcut_shape":
        sc = cr.Shortcut(_on_card(_sums((2, 4, 5, 8), torch.int8)), 0.1, 0.2,
                         "linear")
    elif case == "shortcut_strided":
        sc = cr.Shortcut(_on_card(_permuted(dtype=torch.int8)), 0.1, 0.2,
                         "linear")
    elif case in ("shortcut_mish", "shortcut_swish"):
        sc = cr.Shortcut(q, 0.1, 0.2, case.split("_")[1])
    assert cr.supported(acc, act, sc) is want


@pytest.mark.parametrize("case", ["cpu", "permuted", "shortcut_float"])
def test_wrapper_raises_where_the_gate_refuses(case):
    """No plain fallback inside the wrapper: a CPU tensor or an operand the
    kernel cannot take raises (the walk runs the plain version on the CPU
    itself)."""
    acc, sc = _on_card(_sums()), None
    scale, b = _on_card(torch.ones(16)), _on_card(torch.zeros(16))
    if case == "cpu":
        acc, scale, b = _sums(), torch.ones(16), torch.zeros(16)
    elif case == "permuted":
        acc = _on_card(_permuted())
    else:
        sc = cr.Shortcut(_on_card(_sums(dtype=torch.float32)), 0.1, 0.2,
                         "linear")
    assert not cr.supported(acc, "leaky", sc)
    with pytest.raises(ValueError, match="requantize kernel needs"):
        cr.int8_requant(acc, scale, b, "leaky", torch.int8, 0.1, sc)


def test_wrapper_refuses_mismatched_operands():
    acc = _on_card(_sums())
    ones, zeros = _on_card(torch.ones(16)), _on_card(torch.zeros(16))
    for scale, b, out_dtype, s_out in [
            (_on_card(torch.ones(8)), zeros, torch.int8, 0.1),
            (ones, _on_card(torch.zeros(16, dtype=torch.bfloat16)), torch.int8,
             0.1),
            (ones, zeros, torch.float16, None),
            (ones, zeros, torch.int8, None), (ones, zeros, torch.int8, 0.0)]:
        with pytest.raises(ValueError):
            cr.int8_requant(acc, scale, b, "leaky", out_dtype, s_out)


# ----------------------------------------------------------------- the plan


def _replay(plan, rows: int, c: int) -> np.ndarray:
    """How often the kernel's walk (csrc/int8_requant.cu) writes each
    element of a (rows, c) tensor under ``plan``."""
    per = cr.VEC if plan.vec else 1
    (gx, gy), (tx, ty) = plan.grid, plan.threads
    hits = np.zeros(rows * c, np.int64)
    step = gy * ty
    for bx in range(gx):
        for lane in range(tx):
            c0 = (bx * tx + lane) * per
            if c0 >= c:
                continue
            for start in range(gy * ty):  # (block row, row thread) pairs
                for row in range(start, rows, step):
                    hits[row * c + c0:row * c + c0 + per] += 1
    return hits


@pytest.mark.parametrize("rows, c, aligned, grid_y_max", [
    (7, 32, True, 65535), (5, 255, True, 65535), (3, 1024, True, 65535),
    (9, 4096, True, 65535), (6, 48, False, 65535), (5, 24, True, 65535),
    (300, 32, True, 2), (40, 255, True, 1), (33, 96, True, 3)])
def test_plan_writes_every_element_once(rows, c, aligned, grid_y_max,
                                        monkeypatch):
    monkeypatch.setattr(cr, "GRID_Y_MAX", grid_y_max)
    plan = cr.plan_int8_requant(rows, c, aligned)
    assert plan.vec == (aligned and c % cr.VEC == 0)
    assert plan.threads[0] * plan.threads[1] <= cr.THREADS
    assert 1 <= plan.grid[1] <= grid_y_max
    assert (_replay(plan, rows, c) == 1).all()


def yolov3_sites(graph, size: int = 608):
    """yolov3's int8 convs outside K6 at ``size`` in walk order (the
    stem and the heads stay float): (H, Cout, activation, the activation of
    the shortcut the pass takes, or None)."""
    qp = {n.index: {"wq": None} for n in graph.conv_nodes
          if tq.eligible(graph, n)}
    k6 = {i for a in cuda_block.fused_block_plan(
        graph, qp, {n.index: 1.0 for n in graph.nodes}) for i in (a, a + 1)}
    plan = residual_convs(graph)
    return [(size // n.downsample, n.filters, n.activation,
             plan[n.index].activation if n.index in plan else None)
            for n in graph.conv_nodes
            if n.index in qp and n.inputs[0] >= 0 and n.index not in k6]


def test_yolov3_608_sites_and_plans():
    """51 int8 convs outside K6's 10 blocks, 13 of them with a shortcut;
    at B = 32 every one takes the 8-channel path, and the plans are pinned
    at three of them."""
    sites = yolov3_sites(load_graph(YOLOV3_CFG))
    assert len(sites) == 51
    assert sum(s[3] is not None for s in sites) == 13
    assert {s[2] for s in sites} == {"leaky"}
    for h, c, _, _ in sites:
        plan = cr.plan_int8_requant(32 * h * h, c)
        assert plan.vec and plan.grid[0] == 1
        assert plan.threads[0] * plan.threads[1] == cr.THREADS
    assert cr.plan_int8_requant(32 * 304 * 304, 64) == cr.RequantPlan(
        (1, 65535), (8, 32), True)
    assert cr.plan_int8_requant(32 * 304 * 304, 32) == cr.RequantPlan(
        (1, 46208), (4, 64), True)
    assert cr.plan_int8_requant(32 * 19 * 19, 1024) == cr.RequantPlan(
        (1, 5776), (128, 2), True)
    # a quantized head's 255 channels (include_heads) would go one by one
    assert cr.plan_int8_requant(32 * 76 * 76, 255) == cr.RequantPlan(
        (1, 65535), (255, 1), False)


@pytest.mark.parametrize("rows, c", [(0, 8), (4, 0), (2 ** 40, 2 ** 23)])
def test_plan_refuses(rows, c):
    with pytest.raises(ValueError):
        cr.plan_int8_requant(rows, c)


# ----------------------------------------------------------------- the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the requantize kernel runs on the card only")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("out_dtype", OUT_DTYPES, ids=str)
def test_kernel_is_the_chain_on_the_card(out_dtype, card):
    """Every int8 conv shape of yolov3@608 outside K6 at B = 32, without and
    with a linear shortcut, leaky and linear: the kernel against the chain
    (the walk's own functions, on the card's PyTorch kernels) and the plain
    version, 0 elements differing; a quantized head's 255 sums in rows 256
    apart, and every activation; then the edge sums. Runs with ``python
    -m pytest tests/test_torch_requant.py -m card --noconftest`` on the
    card's machine."""
    gen = torch.Generator(device=card).manual_seed(26)
    rng = np.random.default_rng(26)
    shapes = sorted({(h, c) for h, c, _, _ in
                     yolov3_sites(load_graph(YOLOV3_CFG))})
    for h, c in shapes:
        shape = (32, h, h, c)
        acc = torch.randint(-200_000, 200_000, shape, generator=gen,
                            device=card, dtype=torch.int32)
        qp, ops = _conv_state(rng, c)
        qp = {k: v.to(card) for k, v in qp.items()}
        ops = tq.Operands({0: qp})
        q = torch.randint(-127, 128, shape, generator=gen, device=card,
                          dtype=torch.int32).to(torch.int8)
        for act in ("leaky", "linear"):
            for sc in (None, cr.Shortcut(q, 0.0231, 1.7 / 127, "linear")):
                args = (acc, ops.dequant_scale(0, 0.0213), qp["b"], act,
                        out_dtype, 2.0 / 127, sc)
                before = (cr.int8_requant.launches,
                          cr.int8_requant.residual_launches)
                got = cr.int8_requant(*args)
                assert (cr.int8_requant.launches,
                        cr.int8_requant.residual_launches) == (
                            before[0] + 1, before[1] + (sc is not None))
                want = _chain(acc, qp, ops, 0.0213, act, out_dtype, 2.0 / 127,
                              sc)
                plain = cr.int8_requant_reference(*args)
                for ref in (want, plain):
                    differ = int((_bits(got) != _bits(ref)).sum())
                    assert differ == 0, (shape, act, sc is not None, differ)
    # a quantized head's 255 sums, rows 256 apart, and relu and mish
    wide = torch.randint(-200_000, 200_000, (32 * 76 * 76, 256),
                         generator=gen, device=card, dtype=torch.int32)
    q = torch.randint(-127, 128, (32, 76, 76, 255), generator=gen,
                      device=card, dtype=torch.int32).to(torch.int8)
    for c in (255, 256):
        acc = wide[:, :c].reshape(32, 76, 76, c)
        qp, ops = _conv_state(rng, c)
        qp = {k: v.to(card) for k, v in qp.items()}
        ops = tq.Operands({0: qp})
        for act in cr.ACTIVATIONS:
            for res_act in (None, "linear", "mish"):
                sc = None if res_act is None else cr.Shortcut(
                    torch.cat([q, q[..., :1]], -1)[..., :c].contiguous(),
                    0.0231, 1.7 / 127, res_act)
                args = (acc, ops.dequant_scale(0, 0.0213), qp["b"], act,
                        out_dtype, 2.0 / 127, sc)
                got = cr.int8_requant(*args)
                want = _chain(acc, qp, ops, 0.0213, act, out_dtype, 2.0 / 127,
                              sc)
                differ = int((_bits(got) != _bits(want)).sum())
                assert differ == 0, (c, act, res_act, differ)
    acc, scale, b = (t.to(card) for t in _edge_operands())
    for act, res_act in CHAINS:
        sc = _shortcut(rng, acc.shape, res_act, 1.0, 0.5)
        sc = None if sc is None else sc._replace(q=sc.q.to(card))
        got = cr.int8_requant(acc, scale, b, act, out_dtype, 1.0, sc)
        plain = cr.int8_requant_reference(acc, scale, b, act, out_dtype, 1.0,
                                          sc)
        assert torch.equal(_bits(got), _bits(plain)), (act, res_act)
