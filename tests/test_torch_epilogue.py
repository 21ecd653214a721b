"""The float walk's conv epilogue (``ops/cuda_epilogue.py``): its plain
version against the PyTorch chain it replaces, bit for bit; the walk that
hands a shortcut to the epilogue of the conv before it against the same walk
node by node; the fusion plan ``model.residual_convs``; the kernel's gate
``supported`` and its grid ``plan_conv_epilogue``, replayed in numpy. Mish
(YOLOv4) with and without a residual, on edge values too; on the card
(``card``, skipped here) the kernel against the chain bit for bit."""
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from yolov3_tpu_torch import model as tmodel
from yolov3_tpu_torch.graph import Node, load_graph
from yolov3_tpu_torch.ops import cuda_epilogue as ce
from yolov3_tpu_torch.weights import fold_raw, params_from_jax, random_raw

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
BLOCK_CFG = str(ROOT / "tests" / "data" / "port_block.cfg")
TINY_CFG = str(ROOT / "models" / "yolov3-tiny.cfg")
DTYPES = [torch.float32, torch.bfloat16]
CHANNELS = [32, 255, 1024]
# (the conv's activation, the shortcut's activation or None: no residual)
CHAINS = [(a, r) for a in ("leaky", "linear", "mish")
          for r in (None, "linear", "leaky")]
# -0, +-inf, NaN, large and tiny values, and Mish's turns: past 20 softplus
# is x, past 88.7 exp overflows, below -88 it underflows
EDGES = [-0.0, 0.0, float("inf"), float("-inf"), float("nan"), 3.0e38,
         -3.0e38, 1.0e-39, -1.0e-39, 20.0, 20.5, -20.0, 88.0, 89.0, -88.0,
         -104.0, 1.0e4, -1.0e4, 0.3, -0.3, -1.19]

# a conv whose output feeds both a shortcut right after it and a route
ROUTE_CFG = """
[net]
width=32
height=32
channels=3

[convolutional]
batch_normalize=1
filters=16
size=3
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=8
size=1
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky

[shortcut]
from=-3
activation=linear

[convolutional]
batch_normalize=1
filters=16
size=1
stride=1
pad=1
activation=leaky

[shortcut]
from=-2
activation=leaky

[route]
layers=-1,-4

[convolutional]
size=1
stride=1
pad=1
filters=18
activation=linear

[yolo]
mask=0,1,2
anchors=10,13, 16,30, 33,23
classes=1
num=3
"""


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _nchw(rng, shape, dtype, scale=2.0) -> torch.Tensor:
    """A channels_last NCHW tensor, as the walk's activations are."""
    return torch.from_numpy(rng.normal(0, scale, shape).astype(np.float32)
                            ).to(dtype).contiguous(
                                memory_format=torch.channels_last)


def _chain_ids(chain):
    act, res = chain
    return f"{act}-{'none' if res is None else 'shortcut_' + res}"


@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("chain", CHAINS, ids=_chain_ids)
def test_plain_version_is_the_chain_it_replaces(chain, dtype, c):
    """On the card PyTorch runs a biased conv as cuDNN's conv, then ``add_``
    of the (1, C, 1, 1) bias; the walk then runs the activation and, a node
    later, the shortcut's add and activation. The plain version gives that
    chain's bits, on NHWC views."""
    activation, res_act = chain
    rng = np.random.default_rng(c)
    y = _nchw(rng, (2, c, 5, 7), dtype)
    b = torch.from_numpy(rng.normal(0, 1, c).astype(np.float32)).to(dtype)
    r = None if res_act is None else _nchw(rng, (2, c, 5, 7), dtype)
    want = tmodel._activate(y.clone().add_(b.view(1, c, 1, 1)), activation)
    if r is not None:
        want = tmodel._activate(want + r, res_act)
    nhwc = None if r is None else r.permute(0, 2, 3, 1)
    got = ce.conv_epilogue_reference(y.permute(0, 2, 3, 1), b, activation,
                                     nhwc, res_act or "linear"
                                     ).permute(0, 3, 1, 2)
    assert got.dtype == dtype
    assert torch.equal(_bits(got), _bits(want))


def _edges(rng, dtype, c: int = 24, residual: bool = False):
    """NHWC y (2, 3, 4, c) whose first pixels hold :data:`EDGES`, its bias
    (zero in the channels the edges sit in, so they reach the activation
    as they are) and a residual when asked."""
    y = torch.from_numpy(rng.normal(0, 4, (2, 3, 4, c)).astype(np.float32))
    flat = y.view(-1, c)
    for k, v in enumerate(EDGES):
        flat[k // c, k % c] = v
    b = torch.from_numpy(rng.normal(0, 1, c).astype(np.float32))
    b[:] = torch.where(torch.arange(c) < len(EDGES), 0.0, b)
    r = (torch.from_numpy(rng.normal(0, 2, (2, 3, 4, c)).astype(np.float32))
         if residual else None)
    return (y.to(dtype), b.to(dtype), None if r is None else r.to(dtype))


def _mish_chain(y, b, r):
    """The walk's chain for a Mish conv: the bias add, ``F.mish``, then a
    linear shortcut's add, each rounded to y's type."""
    out = F.mish(y + b)
    return out if r is None else out + r


@pytest.mark.parametrize("residual", [False, True], ids=["alone", "shortcut"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_mish_plain_version_is_the_chain(dtype, residual):
    """Mish with and without a residual, on -0, +-inf, NaN and large and
    small values: the plain version's bits are the chain's."""
    y, b, r = _edges(np.random.default_rng(7), dtype, residual=residual)
    got = ce.conv_epilogue_reference(y, b, "mish", r, "linear")
    want = _mish_chain(y, b, r)
    assert got.dtype == dtype
    assert torch.equal(_bits(got), _bits(want))
    # F.mish's corner cases, which the kernel keeps: -inf gives NaN (-inf *
    # 0), +inf and large values stay, NaN stays NaN
    mid = ce.activate(y + b, "mish").float().view(-1)
    assert torch.isnan(mid[3]) and torch.isnan(mid[4]) and mid[2] == float("inf")
    assert mid[5] == y.float().view(-1)[5]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the epilogue kernel runs on the card only")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("c", [24, 64, 255])
@pytest.mark.parametrize("residual", [False, True], ids=["alone", "shortcut"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_mish_kernel_is_the_chain_on_the_card(dtype, residual, c, card):
    """The Mish kernel (``conv_epilogue_mish_kernel``) against the chain
    and the plain version on the card, bit for bit, with the edge values;
    C = 255 takes the one-element path. Runs with ``python -m pytest
    tests/test_torch_epilogue.py -m card --noconftest`` on the card's
    machine (no JAX there)."""
    y, b, r = (None if t is None else t.to(card)
               for t in _edges(np.random.default_rng(c), dtype, c, residual))
    want = _mish_chain(y, b, r)
    plain = ce.conv_epilogue_reference(y, b, "mish", r, "linear")
    before = ce.conv_epilogue.mish_launches
    got = ce.conv_epilogue(y.clone(), b, "mish", r, "linear")
    assert ce.conv_epilogue.mish_launches == before + 1
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(got), _bits(plain))


def _conv_node(activation: str) -> Node:
    return Node(index=0, kind="convolutional", inputs=(-1,), out_channels=0,
                downsample=1, size=3, stride=1, pad=1, activation=activation)


@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("chain", CHAINS, ids=_chain_ids)
def test_conv_on_the_cpu_is_todays_chain(chain, dtype, c):
    """``_conv`` on a CPU tensor: ``F.conv2d(x, w, b)`` (the CPU's convs
    take the bias inside their sum), the activation, then the residual's
    add and activation, bit for bit."""
    activation, res_act = chain
    rng = np.random.default_rng(c + 1)
    x = _nchw(rng, (2, 16, 6, 6), dtype, 1.0)
    w = _nchw(rng, (c, 16, 3, 3), torch.float32, 0.1)
    b = torch.from_numpy(rng.normal(0, 1, c).astype(np.float32))
    r = None if res_act is None else _nchw(rng, (2, c, 6, 6), dtype)
    node = _conv_node(activation)
    want = tmodel._activate(F.conv2d(x, w.to(dtype), b.to(dtype), padding=1),
                            activation)
    if r is None:
        got = tmodel._conv(x, w, b, node)
    else:
        want = tmodel._activate(want + r, res_act)
        got = tmodel._conv(x, w, b, node, residual=r,
                           residual_activation=res_act)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(_bits(got), _bits(want))


def _net(cfg: str, seed: int = 3):
    graph = load_graph(cfg)
    return graph, params_from_jax(fold_raw(random_raw(graph, seed=seed)),
                                  device="cpu")


def _unfused(monkeypatch):
    monkeypatch.setattr(tmodel, "residual_convs", lambda graph, upto=None: {})


def _count_residuals(monkeypatch) -> list:
    """Record each epilogue of the CPU walk that takes a residual."""
    calls = []
    plain = ce.conv_epilogue_reference

    def spy(y, b, activation="leaky", residual=None,
            residual_activation="linear"):
        if residual is not None:
            calls.append(residual_activation)
        return plain(y, b, activation, residual, residual_activation)

    monkeypatch.setattr(ce, "conv_epilogue_reference", spy)
    return calls


def _route_cfg(tmp_path) -> str:
    path = tmp_path / "route.cfg"
    path.write_text(ROUTE_CFG)
    return str(path)


@pytest.mark.parametrize("precision", [None, "bf16"])
@pytest.mark.parametrize("cfg", ["block", "tiny", "route"])
def test_fused_walk_equals_the_walk_node_by_node(cfg, precision, monkeypatch,
                                                tmp_path):
    path = {"block": BLOCK_CFG, "tiny": TINY_CFG,
            "route": _route_cfg(tmp_path) if cfg == "route" else None}[cfg]
    graph, params = _net(path)
    hw = 64 if cfg == "tiny" else 48 if cfg == "block" else 32
    x = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 1, (2, hw, hw, 3)).astype(np.float32))
    with monkeypatch.context() as m:
        calls = _count_residuals(m)
        got = tmodel.forward_features(graph, params, x, precision)
    assert len(calls) == len(tmodel.residual_convs(graph))
    assert len(calls) == {"block": 2, "tiny": 0, "route": 1}[cfg]
    _unfused(monkeypatch)
    want = tmodel.forward_features(graph, params, x, precision)
    assert len(got) == len(want) == len(graph.yolo_nodes)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))


def test_upto_at_a_conv_before_a_shortcut_returns_its_own_output(monkeypatch):
    """port_block's conv 2 feeds shortcut 3: a walk that stops at the conv
    returns the conv's own output, one that stops at the shortcut the sum."""
    graph, params = _net(BLOCK_CFG)
    assert graph.nodes[3].kind == "shortcut" and 2 in tmodel.residual_convs(graph)
    x = torch.from_numpy(np.random.default_rng(6).uniform(
        0, 1, (2, 48, 48, 3)).astype(np.float32))
    with monkeypatch.context() as m:
        calls = _count_residuals(m)
        conv = tmodel.forward_features(graph, params, x, upto=3)[-1]
        assert calls == []  # conv 2 takes no shortcut the walk never reaches
        shortcut = tmodel.forward_features(graph, params, x, upto=4)[-1]
        assert calls == ["linear"]
    _unfused(monkeypatch)
    want_conv, want_shortcut = (
        tmodel.forward_features(graph, params, x, upto=u)[-1] for u in (3, 4))
    assert torch.equal(conv, want_conv) and torch.equal(shortcut, want_shortcut)
    assert not torch.equal(conv, shortcut)


@pytest.mark.parametrize("cfg, want", [("yolov3.cfg", 23), ("yolov3-spp.cfg", 23),
                                       ("yolov3-tiny.cfg", 0)])
def test_fusion_plan_takes_a_residual_at(cfg, want):
    graph = load_graph(str(ROOT / "models" / cfg))
    plan = tmodel.residual_convs(graph)
    assert len(plan) == want
    for i, sc in plan.items():
        assert graph.nodes[i].kind == "convolutional" and sc.index == i + 1
        assert sc.kind == "shortcut" and sc.inputs == (i, sc.inputs[1])


def test_a_conv_that_feeds_a_route_stays_unfused(tmp_path):
    graph = load_graph(_route_cfg(tmp_path))
    assert 2 in graph.needed_outputs and graph.nodes[3].kind == "shortcut"
    assert sorted(tmodel.residual_convs(graph)) == [4]


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card: the gate's other checks
    read its layout, type and shape."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _on_card(t: torch.Tensor) -> torch.Tensor:
    return torch.Tensor._make_subclass(_OnCard, t)


def _dense(dtype=torch.bfloat16, shape=(2, 4, 5, 16)) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("case, want", [
    ("dense", True), ("dense_residual", True), ("dense_float32", True),
    ("cpu", False), ("nchw_dense", False), ("float16", False),
    ("empty", False), ("residual_shape", False), ("residual_strided", False),
    ("residual_dtype", False)])
def test_supported(case, want):
    y, r = _on_card(_dense()), None
    if case == "dense_residual":
        r = _on_card(_dense())
    elif case == "dense_float32":
        y = _on_card(_dense(torch.float32))
    elif case == "cpu":
        y = _dense()
    elif case == "nchw_dense":  # an NCHW-contiguous conv output, viewed NHWC
        y = _on_card(torch.zeros(2, 16, 4, 5, dtype=torch.bfloat16
                                 ).permute(0, 2, 3, 1))
    elif case == "float16":
        y = _on_card(_dense(torch.float16))
    elif case == "empty":
        y = _on_card(_dense(shape=(0, 4, 5, 16)))
    elif case == "residual_shape":
        r = _on_card(_dense(shape=(2, 4, 5, 8)))
    elif case == "residual_strided":
        r = _on_card(torch.zeros(2, 16, 4, 5, dtype=torch.bfloat16
                                 ).permute(0, 2, 3, 1))
    elif case == "residual_dtype":
        r = _on_card(_dense(torch.float32))
    assert ce.supported(y, r) is want


def _replay(plan, rows: int, c: int, elem_size: int) -> np.ndarray:
    """How often the kernel's walk (csrc/conv_epilogue.cu) writes each
    element of a (rows, c) tensor under ``plan``."""
    per = 16 // elem_size if plan.vec else 1
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


@pytest.mark.parametrize("rows, c, elem_size, aligned, grid_y_max", [
    (7, 32, 2, True, 65535), (5, 255, 2, True, 65535),
    (3, 1024, 2, True, 65535), (9, 1024, 4, True, 65535),
    (4, 2048, 4, True, 65535), (6, 24, 4, False, 65535),
    (300, 32, 2, True, 2), (40, 255, 4, True, 1), (33, 96, 2, True, 3)])
def test_plan_writes_every_element_once(rows, c, elem_size, aligned,
                                        grid_y_max, monkeypatch):
    monkeypatch.setattr(ce, "GRID_Y_MAX", grid_y_max)
    plan = ce.plan_conv_epilogue(rows, c, elem_size, aligned)
    assert plan.vec == (aligned and c % (16 // elem_size) == 0)
    assert plan.threads[0] * plan.threads[1] <= ce.THREADS
    assert 1 <= plan.grid[1] <= grid_y_max
    assert (_replay(plan, rows, c, elem_size) == 1).all()


def test_plan_at_yolov3_608():
    """B = 32 at 608: the stem's 32 bf16 channels are four 16-byte pieces
    a pixel, 64 pixels a block, up to the grid's limit; the heads' 255
    channels one element a thread; 1,024 channels 128 pieces."""
    stem = ce.plan_conv_epilogue(32 * 608 * 608, 32, 2)
    assert stem == ce.ConvEpiloguePlan((1, 65535), (4, 64), True)
    head = ce.plan_conv_epilogue(32 * 76 * 76, 255, 2)
    assert head == ce.ConvEpiloguePlan((1, 65535), (255, 1), False)
    deep = ce.plan_conv_epilogue(32 * 19 * 19, 1024, 2)
    assert deep == ce.ConvEpiloguePlan((1, 5776), (128, 2), True)


@pytest.mark.parametrize("rows, c", [(0, 8), (4, 0), (2 ** 40, 2 ** 23)])
def test_plan_refuses(rows, c):
    with pytest.raises(ValueError):
        ce.plan_conv_epilogue(rows, c, 2)


def test_wrapper_refuses_mismatched_operands():
    y = _on_card(torch.zeros(1, 2, 2, 8))
    for b, kw in [(torch.zeros(4), {}), (torch.zeros(8, dtype=torch.bfloat16), {}),
                  (torch.zeros(8), {"activation": "swish"}),
                  (torch.zeros(8), {"residual_activation": "swish"}),
                  (torch.zeros(8), {"residual": torch.zeros(1, 2, 2, 4)})]:
        with pytest.raises(ValueError):
            ce.conv_epilogue(y, _on_card(b), **{
                k: _on_card(v) if isinstance(v, torch.Tensor) else v
                for k, v in kw.items()})


@pytest.mark.parametrize("case", ["cpu", "nchw_dense", "residual_strided"])
def test_wrapper_raises_where_the_gate_refuses(case):
    """No plain fallback inside the wrapper: a CPU tensor or a layout the
    kernel cannot take raises (``model._conv`` runs the plain version on the
    CPU itself)."""
    y, b, r = _on_card(_dense()), _on_card(torch.zeros(16, dtype=torch.bfloat16)), None
    if case == "cpu":
        y, b = _dense(), torch.zeros(16, dtype=torch.bfloat16)
    elif case == "nchw_dense":
        y = _on_card(torch.zeros(2, 16, 4, 5, dtype=torch.bfloat16
                                 ).permute(0, 2, 3, 1))
    else:
        r = _on_card(torch.zeros(2, 16, 4, 5, dtype=torch.bfloat16
                                 ).permute(0, 2, 3, 1))
    assert not ce.supported(y, r)
    with pytest.raises(ValueError, match="dense NHWC CUDA"):
        ce.conv_epilogue(y, b, "leaky", r)
