"""The plain versions in ``ops/cuda_probe.py`` (what the wrappers run on the
CPU, and what the card's kernels are held to) against the JAX package's tool
kernels, run on the CPU under ``pltpu.force_tpu_interpret_mode()``. The
tools' own code runs unmodified: ``pl.pallas_call`` is wrapped to record
each call's inputs and output."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tools import bench_int8_dot as jbench_int8
from tools import bench_pallas_dot as jbench_dot
from tools import probe_block as jprobe
from yolov3_tpu_torch.ops import cuda_probe as cp
from yolov3_tpu_torch.tools import (ablate_block, bench_dot, bench_int8_dot,
                                   probe_block)

torch.set_num_threads(1)

# out = bf16(p1 . bf16(acc)) . p2: two bf16 roundings of sums taken in another
# order, one bf16 ulp each, relative to the largest output
DOT_RTOL = 2.0 ** -7


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@pytest.fixture
def calls(monkeypatch):
    """Every ``pl.pallas_call`` made while the fixture lives, as
    (inputs, output) numpy pairs, each run in TPU interpret mode."""
    seen = []
    real = pl.pallas_call

    def wrapped(*a, **k):
        def run(*args):
            with pltpu.force_tpu_interpret_mode():
                out = real(*a, **k)(*args)
            seen.append((tuple(np.asarray(x) for x in args), np.asarray(out)))
            return out

        return run

    monkeypatch.setattr(pl, "pallas_call", wrapped)
    return seen


def _close(got: torch.Tensor, want: np.ndarray):
    want = torch.from_numpy(want.astype(np.float32))
    bar = DOT_RTOL * float(want.abs().max()) + 1e-12
    assert float((got.float() - want).abs().max()) <= bar


@pytest.mark.parametrize("dtype,carry", [("int8", 0.0), ("int8", 3.7),
                                         ("int8", -130.2), ("bfloat16", 0.0),
                                         ("bfloat16", 0.25)])
@pytest.mark.parametrize("shape", [(100, 128, 64), (64, 192, 128)])
def test_t1_dot_step_against_make_dot(calls, shape, dtype, carry):
    jdtype = getattr(jnp, dtype)
    args = list(jbench_int8.operands(*shape, jdtype, np.random.default_rng(3)))
    args[0] = args[0].at[0, 0].set(carry)
    want = np.asarray(jbench_int8.make_dot(*shape, jdtype)(*args))
    assert want.shape == (8, 128) and len(calls) == 1
    targs = [_t(a) for a in args]
    got = cp.dot_step(*targs)                      # CPU tensors: the plain version
    assert got.dtype == torch.float32 and got.shape == (8, 128)
    _close(got, want)
    assert float(np.abs(want).max()) > 0
    if dtype == "int8":
        # the int8 product itself is exact, whatever the carry wraps
        shifted = (np.asarray(args[2], np.int32) + int(carry)).astype(np.int8)
        exact = np.asarray(args[1], np.int64) @ shifted.astype(np.int64)
        acc = cp.dot_reference(targs[1], cp.shift_rhs(targs[2], carry))
        np.testing.assert_array_equal(acc.numpy(), exact)
    cores = ("wgmma_s8", "mma_s8", "dp4a_s8") if dtype == "int8" else (
        "wgmma_bf16",)
    for core in cores:
        assert torch.equal(cp.dot_step(*targs, core=core), got)
    # the dependent chain moves the carry by 1e-24 of each result: no change
    assert torch.equal(cp.dot_step(*targs, steps=3), got)


def test_t2_dot_grid_against_timed_grid(calls):
    m, k, n, grid = 32, 72, 128, 2
    with jax.disable_jit():
        jbench_dot.timed_grid(m, k, n, grid)
    (lhs, rhs, p1, p2), want = calls[0]
    assert want.shape == (grid, 8, 128) and want.dtype.name == "bfloat16"
    got = cp.dot_grid(_t(lhs), _t(rhs), _t(p1), _t(p2), grid)
    assert got.dtype == torch.bfloat16 and got.shape == (grid, 8, 128)
    # + one ulp of the bf16 store
    want32 = want.astype(np.float32)
    bar = 2 * DOT_RTOL * float(np.abs(want32).max())
    assert float((got.float() - torch.from_numpy(want32)).abs().max()) <= bar
    assert torch.equal(got[0], got[1])


def test_t3a_int8_dot_exact(calls, capsys):
    jprobe.probe_int8_dot()
    assert "ndiff 0/" in capsys.readouterr().out
    assert [tuple(a[0].shape) + (a[1].shape[1],) for a, _ in calls] == \
        list(probe_block.INT8_DOT_SHAPES[:4])
    for (lhs, rhs), want in calls:
        got = cp.probe_int8_dot(_t(lhs), _t(rhs))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_t3b_round_exact(calls):
    jprobe.probe_round()
    (x,), want = calls[0]
    np.testing.assert_array_equal(x, probe_block.round_inputs())
    np.testing.assert_array_equal(cp.probe_round(_t(x)).numpy(), want)
    # half to even, never half away from zero
    halves = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.5, -300.0])
    assert cp.probe_round(halves).tolist() == [0, 2, 2, -0, -2, -2, 126, 127, -127]


def test_t3c_roll_exact(calls):
    jprobe.probe_roll()
    (x,), want = calls[0]
    got = cp.probe_roll(_t(x))
    assert got.dtype == torch.int8 and tuple(got.shape) == (2, 10, 48, 128)
    np.testing.assert_array_equal(got.numpy(), want)


def test_t3d_mask_exact(calls):
    jprobe.probe_mask()
    assert len(calls) == 3
    for hi, (args, want) in zip((0, 3, 6), calls):
        assert args == ()
        got = cp.probe_mask(6, 48, 128, 40, 40, hi, device="cpu")
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            want, probe_block.mask_reference(6, 48, 128, 40, 40, hi))
    assert 0 < int(got.sum()) < got.numel()


# T3c at the tool's shape, a plane above 227 KB as float32 (a block's most
# shared memory),
# lanes no multiple of 16 (the byte walk), several 512-byte lane chunks with a
# short last row chunk, one row
ROLL_SHAPES = ((10, 48, 128), (2, 512, 128), (3, 37, 100), (2, 9, 1040),
               (3, 1, 64))


@pytest.mark.parametrize("shape", ROLL_SHAPES)
def test_t3c_roll_reference_at_any_plane(shape):
    """The plain version (what the card is held to) equals ``np.roll`` at
    every shape the kernel takes, the plane size unbounded."""
    x = np.random.default_rng(11).integers(-128, 128, shape).astype(np.int8)
    want = np.stack([np.roll(x, 1, axis=1), np.roll(x, -1, axis=1)])
    np.testing.assert_array_equal(cp.probe_roll_reference(_t(x)).numpy(), want)
    np.testing.assert_array_equal(cp.probe_roll(_t(x)).numpy(), want)


def _roll_by_blocks(x: np.ndarray, plan) -> np.ndarray:
    """T3c's kernel walked block by block as ``probe_roll_kernel`` walks it:
    a block stages its rows and the wrap-around rows beside them, then
    writes its rows of both outputs, each element exactly once."""
    planes, rows, lanes = x.shape
    nrows, chunk = 1 << plan.rows_lg, cp.ROLL_PIECE << plan.pieces_lg
    row_chunks = -(-rows // nrows)
    assert plan.grid == (planes * row_chunks, -(-lanes // chunk))
    out = np.zeros((2,) + x.shape, np.int8)
    written = np.zeros(out.shape, np.int64)
    for bx in range(plan.grid[0]):
        plane, rc = divmod(bx, row_chunks)
        r0 = rc * nrows
        here = min(nrows, rows - r0)
        staged = []
        for s in range(here + 2):
            r = r0 - 1 + s
            staged.append(r + rows if r < 0 else (r - rows if r >= rows else r))
        assert len(staged) * chunk <= plan.smem <= cp.ROLL_SMEM
        for by in range(plan.grid[1]):
            lo, hi = by * chunk, min(lanes, (by + 1) * chunk)
            tile = x[plane, staged, lo:hi]
            for j in range(here):
                out[0, plane, r0 + j, lo:hi] = tile[j]
                out[1, plane, r0 + j, lo:hi] = tile[j + 2]
                written[:, plane, r0 + j, lo:hi] += 1
    assert (written == 1).all()
    return out


@pytest.mark.parametrize("shape", ROLL_SHAPES + ((1, 3, 16), (2, 5, 8200)))
def test_t3c_block_plan_covers_the_planes(shape):
    """T3c's blocks (:func:`plan_roll`): 64 to 256 threads, shared memory
    bounded by the block whatever the plane, and the block walk equal to the
    plain version; at the tool's shape 60 blocks (one a plane would be 10),
    8 rows of 8 pieces each, 16-byte pieces."""
    plan = cp.plan_roll(*shape)
    assert 64 <= plan.threads <= 256 and plan.smem <= cp.ROLL_SMEM
    assert plan.vec == (shape[2] % 16 == 0)
    x = np.random.default_rng(12).integers(-128, 128, shape).astype(np.int8)
    np.testing.assert_array_equal(_roll_by_blocks(x, plan),
                                  cp.probe_roll_reference(_t(x)).numpy())
    if shape == (10, 48, 128):
        assert plan.grid == (60, 1) and plan.threads == 64 and plan.vec
        assert (plan.rows_lg, plan.pieces_lg) == (3, 3)
    assert not cp.plan_roll(*shape, vec=False).vec
    with pytest.raises(ValueError, match="non-empty"):
        cp.plan_roll(0, 4, 16)


def test_t3d_masks_one_launch_against_the_jax_probe(calls):
    """``probe_masks`` (every tile in one launch on the card) equals the JAX
    probe's three outputs stacked in ``hi`` order, and three
    ``probe_mask`` calls."""
    jprobe.probe_mask()
    assert len(calls) == 3
    want = np.stack([out for _, out in calls])
    got = cp.probe_masks(6, 48, 128, 40, 40, (0, 3, 6), device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 384, 128)
    np.testing.assert_array_equal(got.numpy(), want)
    one_by_one = torch.stack([cp.probe_mask(6, 48, 128, 40, 40, hi, "cpu")
                              for hi in (0, 3, 6)])
    assert torch.equal(got, one_by_one)
    assert torch.equal(got, cp.probe_masks_reference(6, 48, 128, 40, 40,
                                                     [0, 3, 6]))
    # any list of tiles, in its own order; a cp no multiple of 4
    odd = cp.probe_masks(5, 12, 6, 11, 9, (2, 0, 1), device="cpu")
    for k, hi in enumerate((2, 0, 1)):
        np.testing.assert_array_equal(
            odd[k].numpy(), probe_block.mask_reference(5, 12, 6, 11, 9, hi))
    for his in ((), tuple(range(cp.MASK_MAX_TILES + 1))):
        with pytest.raises(ValueError, match="row tiles"):
            cp.probe_masks(6, 48, 128, 40, 40, his, device="cpu")


def test_t3d_signatures_keep_their_positional_order():
    import inspect

    names = lambda fn: list(inspect.signature(fn).parameters)  # noqa: E731
    assert names(cp.probe_mask) == ["th", "ws", "cp", "h", "w", "hi", "device"]
    assert names(cp.probe_masks) == ["th", "ws", "cp", "h", "w", "his",
                                     "device"]
    for fn in (cp.probe_mask, cp.probe_masks):
        assert inspect.signature(fn).parameters["device"].default is None
    assert names(cp.probe_roll) == ["x"]
    assert names(cp.probe_roll_reference) == ["x"]


def test_t3e_epilogue_exact(calls):
    jprobe.probe_epilogue()
    (acc, deq, b), want = calls[0]
    tacc, tdeq, tb, inv = probe_block.epilogue_inputs()
    np.testing.assert_array_equal(acc, tacc)
    np.testing.assert_array_equal(deq[0], tdeq)
    np.testing.assert_array_equal(b[0], tb)
    got = cp.probe_epilogue(_t(tacc), _t(tdeq), _t(tb), inv).numpy()
    np.testing.assert_array_equal(got, probe_block.epilogue_reference(
        tacc, tdeq, tb, inv))
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 100   # the quantized range is exercised


# T3b at the tool's 1,152 floats, ragged counts (the tail alone, pieces plus
# one), and K6's epilogue at yolov3@416 B=8 (8 x 104 x 104 x 128)
K6_EPILOGUE = (8 * 104 * 104, 128)
ROUND_COUNTS = (1152, 1, 3, 1153, K6_EPILOGUE[0] * K6_EPILOGUE[1])
# T3e at the tool's (256, 128), cols 100 and 6 (6: the scalar walk), K6's
EPILOGUE_SHAPES = ((256, 128), (1000, 100), (37, 6), K6_EPILOGUE)


def _round_writes(n: int, plan) -> np.ndarray:
    """Writes per element of ``probe_round_clip_kernel``'s grid-stride walk
    from ``plan``: thread t takes pieces t, t + stride, ... (four floats
    each), then the floats after the pieces one at a time."""
    counts = np.zeros(n, np.int64)
    stride = plan.blocks * plan.threads
    t = np.arange(stride)
    for k in range(-(-plan.pieces // stride)):
        p = t + k * stride
        p = p[p < plan.pieces]
        for e in range(4):
            counts[4 * p + e] += 1
    for k in range(-(-plan.tail // stride)):
        i = 4 * plan.pieces + t + k * stride
        counts[i[i < n]] += 1
    return counts


@pytest.mark.parametrize("grid_limit", [None, 1])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("n", ROUND_COUNTS)
def test_t3b_plan_covers_every_element_once(n, aligned, grid_limit,
                                            monkeypatch):
    """T3b's grid (:func:`plan_elementwise`): 16-byte pieces plus a tail of
    n % 4 floats (every float one by one off the 16-byte grid) cover the
    tensor, each element written once: one piece a thread up to the grid's
    limit, a stride walking the rest (``grid_limit`` 1 stands in for the
    card's 2^31 - 1 blocks); the tool's 1,152 floats take one block."""
    if grid_limit:
        monkeypatch.setattr(cp, "GRID_X_MAX", grid_limit)
    plan = cp.plan_elementwise(n, aligned)
    assert plan.vec == aligned and plan.threads == cp.EW_THREADS
    assert 4 * plan.pieces + plan.tail == n
    assert plan.tail == (n % 4 if aligned else n)
    units = max(plan.pieces, plan.tail)
    assert plan.blocks == min(-(-units // plan.threads), cp.GRID_X_MAX)
    assert (_round_writes(n, plan) == 1).all()
    if n == 1152 and aligned:
        assert plan.blocks == 1 and plan.pieces == 288
    if n == ROUND_COUNTS[-1] and aligned:   # K6's size
        assert plan.blocks == (grid_limit or 5408)
    with pytest.raises(ValueError, match="at least one"):
        cp.plan_elementwise(0)


def _epilogue_writes(rows: int, cols: int, plan):
    """Writes per row and per column of ``probe_epilogue_kernel``'s walk
    from ``plan``: lane (bx, tx) owns columns 4 (32 bx + tx) .. + 3 (fewer
    at the edge), row thread (by, ty) rows by * 8 + ty stepping by grid y
    x 8. An element is written once a (lane, row thread) pair, so once in
    all where every row and every column is taken once."""
    (gx, gy), (lanes, nrows) = plan.grid, plan.threads
    col_hits = np.zeros(cols, np.int64)
    for bx in range(gx):
        for tx in range(lanes):
            c0 = (bx * lanes + tx) * 4
            if c0 < cols:
                col_hits[c0:min(c0 + 4, cols)] += 1
    row_hits = np.zeros(rows, np.int64)
    step = gy * nrows
    for by in range(gy):
        for ty in range(nrows):
            row_hits[by * nrows + ty::step] += 1
    return row_hits, col_hits


@pytest.mark.parametrize("grid_limit", [None, 1])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("shape", EPILOGUE_SHAPES)
def test_t3e_plan_covers_every_element_once(shape, aligned, grid_limit,
                                            monkeypatch):
    """T3e's grid (:func:`plan_epilogue`): x covers the columns in chunks of
    128, y runs of 8 rows, one row a thread up to the grid's y limit, a
    stride walking the rest (``grid_limit`` 1 stands in for the card's
    65,535); 16-byte pieces only where cols % 4 == 0 and the operands are
    aligned."""
    if grid_limit:
        monkeypatch.setattr(cp, "GRID_Y_MAX", grid_limit)
    rows, cols = shape
    plan = cp.plan_epilogue(rows, cols, aligned)
    assert plan.threads == (cp.EPI_LANES, cp.EPI_ROWS)
    assert plan.vec == (aligned and cols % 4 == 0)
    assert plan.grid[0] == -(-cols // 128)
    assert plan.grid[1] == min(-(-rows // 8), cp.GRID_Y_MAX)
    row_hits, col_hits = _epilogue_writes(rows, cols, plan)
    assert (row_hits == 1).all() and (col_hits == 1).all()
    if shape == (256, 128):
        assert plan.grid == (1, grid_limit or 32) and plan.vec == aligned
    if shape == K6_EPILOGUE:
        assert plan.grid == (1, grid_limit or 10816)
    with pytest.raises(ValueError, match="non-empty"):
        cp.plan_epilogue(0, 128)


def test_t3b_t3e_refuse_shapes_their_indexes_cannot_reach():
    """Past 2^60 elements (a 64-bit byte offset) or 2^31 - 1 column chunks
    (the grid's x) both wrappers raise before any launch, whatever the
    device; tried with meta tensors, which hold no memory."""
    big = cp.EW_MAX_ELEMENTS
    with pytest.raises(ValueError, match="2\\^60"):
        cp.probe_round(torch.empty(big + 4, device="meta"))
    with pytest.raises(ValueError, match="2\\^60"):
        cp.plan_elementwise(big + 1)
    assert cp.plan_elementwise(big).blocks == cp.GRID_X_MAX   # a grid stride

    def epilogue(rows, cols):
        return cp.probe_epilogue(
            torch.empty((rows, cols), dtype=torch.int32, device="meta"),
            torch.empty(cols, device="meta"), torch.empty(cols, device="meta"),
            1.0)

    with pytest.raises(ValueError, match="2\\^60"):
        epilogue(2 ** 30, 2 ** 30 + 4)
    with pytest.raises(ValueError, match="column chunks"):
        epilogue(1, 2 ** 38)
    with pytest.raises(ValueError, match="2\\^60"):
        cp.plan_epilogue(2 ** 31, 2 ** 29 + 1)
    # at the limits the meta tensors reach the device check
    with pytest.raises(ValueError, match="CUDA or CPU"):
        epilogue(1, 128 * (2 ** 31 - 1))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        cp.probe_round(torch.empty(big, device="meta"))


@pytest.mark.parametrize("n", [1, 3, 1153])
def test_t3b_reference_at_ragged_counts(n):
    """The plain version (the card's kernel is held to it) at counts that
    leave a tail: numpy's half-to-even rounding, clipped."""
    x = probe_block.round_inputs().reshape(-1)
    x = np.resize(x, n).astype(np.float32)
    want = np.clip(np.round(x), -127, 127)
    np.testing.assert_array_equal(cp.probe_round(_t(x)).numpy(), want)


def test_t3e_reference_against_the_numpy_chain_at_100_columns():
    """``probe_epilogue_reference`` at a seeded (1,000, 100) equals the JAX
    tool's numpy float32 chain (``epilogue_reference``) bit for bit."""
    rng = np.random.default_rng(18)
    acc = rng.integers(-2_000_000, 2_000_000, (1000, 100)).astype(np.int32)
    deq = rng.uniform(1e-6, 1e-4, 100).astype(np.float32)
    b = rng.normal(0, 0.05, 100).astype(np.float32)
    inv = 1.0 / 0.017
    want = probe_block.epilogue_reference(acc, deq, b, inv)
    got = cp.probe_epilogue_reference(_t(acc), _t(deq), _t(b), inv)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        cp.probe_epilogue(_t(acc), _t(deq), _t(b), inv).numpy(), want)
    assert len(np.unique(want)) > 100


def test_bench_requant_inputs_at_k6s_size():
    """``tools/bench_requant``'s inputs: K6's epilogue at yolov3@416 B=8,
    seeded, with ties and values past +-127 for T3b and the tool's ranges
    for T3e; 88.6 MB moved by each kernel; it refuses to run without a
    card."""
    from yolov3_tpu_torch.tools import bench_requant as br

    assert (br.K6_ROWS, br.K6_COLS) == K6_EPILOGUE
    assert br.K6_ELEMENTS == ROUND_COUNTS[-1] == 11_075_584
    x = br.k6_round_input()
    assert x.dtype == np.float32 and x.shape == (br.K6_ELEMENTS,)
    np.testing.assert_array_equal(x, br.k6_round_input())
    assert (np.abs(x) > 127).mean() > 0.1
    assert ((x - np.floor(x)) == 0.5).sum() > br.K6_ELEMENTS // 6
    acc, deq, b, inv = br.k6_epilogue_inputs()
    assert acc.dtype == np.int32 and acc.shape == K6_EPILOGUE
    assert deq.shape == b.shape == (128,) and inv == 1.0 / 0.017
    assert 8 * br.K6_ELEMENTS == 88_604_672
    with pytest.raises(RuntimeError, match="cuda"):
        br.main()


def test_port_tool_probes_read_zero_on_cpu(capsys):
    """The port's tool functions on the CPU (plain versions against the
    tool's exact host values): 0 differences, the reference's wording."""
    bad = (probe_block.probe_int8_dot("cpu") + probe_block.probe_round("cpu")
           + probe_block.probe_roll("cpu") + probe_block.probe_mask("cpu")
           + probe_block.probe_epilogue("cpu")
           + probe_block.probe_full_tiny(2, 19, 19, device="cpu"))
    out = capsys.readouterr().out
    assert bad == 0
    assert "round/clip: ndiff 0/1152" in out and "roll +1: ndiff 0" in out
    for hi in (0, 3, 6):
        assert f"mask hi={hi}: ndiff 0/49152" in out
    assert "epilogue chain: ndiff 0/32768 max 0.0" in out
    assert "full block B=2 H=19 W=19: ndiff 0/" in out


def test_tool_shape_lists_keep_the_reference_and_add_the_ports_own():
    import inspect

    src = inspect.getsource(jbench_int8.main)
    for shape in bench_int8_dot.SHAPES[:10]:
        assert f"({shape[0]}, {shape[1]}, {shape[2]})" in src
    src = inspect.getsource(jbench_dot.main)
    for shape in bench_dot.SHAPES[:8]:
        assert f"({shape[0]}, {shape[1]}, {shape[2]})" in src
    assert {(100, 128, 64), (64, 576, 128), (100, 256, 128), (64, 1152, 256)} \
        <= set(bench_int8_dot.SHAPES) & set(probe_block.INT8_DOT_SHAPES)
    assert all(m == 128 and n == 128 and k % 9 == 0
               for m, k, n in bench_dot.SHAPES[8:])
    args = cp.dot_operands(64, 72, 64, torch.bfloat16,
                           np.random.default_rng(0), "cpu")
    assert bench_int8_dot.check_shape(args, "wgmma_bf16") == 0.0
    assert bench_dot.check_shape(args[1:]) == 0.0


def test_cuda_requests_raise_without_a_card():
    """No wrapper takes its plain version for anything but a CPU tensor."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="cuda"):
        cp.probe_mask(6, 48, 128, 40, 40, 0)             # default: the card
    with pytest.raises(RuntimeError, match="cuda"):
        cp.probe_masks(6, 48, 128, 40, 40, (0, 3, 6))
    with pytest.raises(RuntimeError, match="cuda"):
        cp.probe_masks(6, 48, 128, 40, 40, (0, 3, 6), device=None)
    with pytest.raises(RuntimeError, match="cuda"):
        cp.dot_operands(64, 64, 64, torch.int8, np.random.default_rng(0))
    for tool in (probe_block, bench_int8_dot, bench_dot, ablate_block):
        with pytest.raises(RuntimeError, match="cuda"):
            tool.main()
    meta8 = torch.empty((64, 64), dtype=torch.int8, device="meta")
    metab = torch.empty((64, 64), dtype=torch.bfloat16, device="meta")
    p1 = torch.empty((8, 64), dtype=torch.bfloat16, device="meta")
    p2 = torch.empty((64, 128), dtype=torch.bfloat16, device="meta")
    carry = torch.zeros(8, 128)
    for call in (lambda: cp.probe_int8_dot(meta8, meta8),
                 lambda: cp.dot_step(carry, meta8, meta8, p1, p2),
                 lambda: cp.dot_grid(metab, metab, p1, p2, 2),
                 lambda: cp.probe_round(torch.empty(4, device="meta")),
                 lambda: cp.probe_roll(torch.empty((1, 2, 2), dtype=torch.int8,
                                                   device="meta")),
                 lambda: cp.probe_mask(6, 48, 128, 40, 40, 0, "meta"),
                 lambda: cp.probe_masks(6, 48, 128, 40, 40, (0, 3), "meta"),
                 lambda: cp.probe_epilogue(
                     torch.empty((2, 2), dtype=torch.int32, device="meta"),
                     torch.empty(2, device="meta"), torch.empty(2, device="meta"),
                     1.0)):
        with pytest.raises(ValueError, match="CUDA or CPU"):
            call()
    with pytest.raises(ValueError, match="core"):
        cp.probe_int8_dot(torch.zeros((4, 4), dtype=torch.int8),
                          torch.zeros((4, 4), dtype=torch.int8), core="wgmma")
    with pytest.raises(ValueError, match="does not take"):
        cp.dot_step(carry, torch.zeros((4, 4), dtype=torch.int8),
                    torch.zeros((4, 4), dtype=torch.int8),
                    torch.zeros((8, 4), dtype=torch.bfloat16),
                    torch.zeros((4, 128), dtype=torch.bfloat16),
                    core="wgmma_bf16")
    with pytest.raises(ValueError, match="core"):   # T2's core is not T1's
        cp.dot_product(torch.zeros((4, 4), dtype=torch.bfloat16),
                       torch.zeros((4, 4), dtype=torch.bfloat16),
                       core="mma_bf16")
    for call in (lambda: cp.dot_product(meta8, meta8),
                 lambda: cp.dot_product(metab, metab, "wgmma_bf16")):
        with pytest.raises(ValueError, match="CUDA or CPU"):
            call()


@pytest.mark.parametrize("dtype,core", [("int8", "wgmma_s8"), ("int8", "mma_s8"),
                                        ("int8", "dp4a_s8"),
                                        ("bfloat16", "wgmma_bf16")])
def test_dot_product_store_mode_is_the_bare_product(dtype, core):
    """T1's kernel in store mode (the timing split's bare product): on the
    CPU the plain product, int8 exact against int64 numpy, bf16 to float32
    sums; every core of T1 takes it, the default being the wgmma core of
    the operands' type."""
    rng = np.random.default_rng(5)
    a = rng.integers(-127, 128, (100, 128))
    b = rng.integers(-127, 128, (128, 64))
    if dtype == "int8":
        lhs, rhs = (torch.from_numpy(t.astype(np.int8)) for t in (a, b))
        got = cp.dot_product(lhs, rhs, core)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), a @ b)
        assert torch.equal(cp.dot_product(lhs, rhs), got)
        assert torch.equal(cp.probe_int8_dot(lhs, rhs, core), got)
    else:
        lhs = torch.from_numpy(a.astype(np.float32) / 64).to(torch.bfloat16)
        rhs = torch.from_numpy(b.astype(np.float32) / 64).to(torch.bfloat16)
        got = cp.dot_product(lhs, rhs, core)
        assert got.dtype == torch.float32 and got.shape == (100, 64)
        # multiples of 1/64 below 2: the products and sums are exact
        np.testing.assert_array_equal(got.numpy(), (a @ b) / 4096.0)
        assert torch.equal(cp.dot_product(lhs, rhs), got)
    assert cp.dot_product.launches == 0   # CPU: the plain version


# ------------------------------------------------------------- T2's tiles

def test_t2_tile_plan_over_the_tools_shapes():
    """T2's planner at every shape of the tool: 128-row tiles (two
    warpgroups) above M = 64, else 64 rows and 256 columns where N > 128;
    two blocks fit a multiprocessor's shared memory; the issued product pads
    M = 32 to 64 rows, K = 72 to 80 and N = 2944 to the 256-column tile."""
    want = {64: (64, 256, 2), 128: (128, 128, 3), 256: (128, 128, 3)}
    for m, k, n in bench_dot.SHAPES:
        t = cp.plan_grid_tiles(m, n)
        bm = 64 if m <= 64 else 128
        assert (t.block_m, t.block_n, t.stages) == (
            want[max(m, 64)] if n > 128 else (bm, 128, 3))
        assert t.resident >= 2
        assert 2 * (t.smem + cp.SMEM_RESERVED) <= cp.SMEM_PER_SM
        # the ring holds the stages, the acc tile and p2's rows
        stage = t.block_m * 128 + 64 * t.block_n * 2
        ring = t.smem - 1024 - (t.block_m + t.block_n) // 64 * 1024
        assert ring >= max(t.stages * stage, t.block_m * t.block_n * 2,
                           t.block_n * 256)
        mp, kp, np_ = cp.grid_issued(m, k, n)
        assert mp % t.block_m == 0 and np_ % t.block_n == 0 and kp % 16 == 0
        assert 0 <= mp - m < t.block_m and 0 <= kp - k < 16
        assert 0 <= np_ - n < t.block_n
    assert cp.grid_issued(32, 72, 2944) == (64, 80, 3072)
    assert cp.grid_issued(256, 384, 2560) == (256, 384, 2560)
    assert cp.plan_grid_tiles(64, 128).block_n == 128


def _grid_by_tiles(lhs, rhs, p1, p2):
    """T2's arithmetic walked tile by tile as the kernel walks it (numpy,
    float32 sums): each N tile's d1 summed over the M tiles of bf16(acc),
    zero-padded; bf16(d1) times that tile's rows of p2 added into o."""
    m, n = lhs.shape[0], rhs.shape[1]
    t = cp.plan_grid_tiles(m, n)
    f32 = lambda a: a.float().numpy()                      # noqa: E731
    bf = lambda a: torch.from_numpy(a).bfloat16().float().numpy()  # noqa: E731
    a, b, q1, q2 = f32(lhs), f32(rhs), f32(p1), f32(p2)
    o = np.zeros((8, 128), np.float32)
    for n0 in range(0, n, t.block_n):
        d1 = np.zeros((8, t.block_n), np.float32)
        for m0 in range(0, m, t.block_m):
            tile_a = np.zeros((t.block_m, a.shape[1]), np.float32)
            rows = a[m0:m0 + t.block_m]
            tile_a[:len(rows)] = rows
            tile_b = np.zeros((b.shape[0], t.block_n), np.float32)
            cols = b[:, n0:n0 + t.block_n]
            tile_b[:, :cols.shape[1]] = cols
            tile_p1 = np.zeros((8, t.block_m), np.float32)
            tile_p1[:, :len(rows)] = q1[:, m0:m0 + t.block_m]
            d1 += tile_p1 @ bf(tile_a @ tile_b)
        tile_p2 = np.zeros((t.block_n, 128), np.float32)
        p2_rows = q2[n0:n0 + t.block_n]
        tile_p2[:len(p2_rows)] = p2_rows
        o += bf(d1) @ tile_p2
    return bf(o)


@pytest.mark.parametrize("m,k,n", [(96, 136, 200), (50, 24, 264),
                                   (130, 200, 136)])
def test_t2_ragged_against_timed_grid(calls, m, k, n):
    """T2 at ragged M, K and N (an M tile part zero, a last K step of 8, an
    N tile of 8 columns) against the JAX tool's kernel in interpret mode;
    its tile walk (the plan's zero padding, the sums per tile) within the
    same bar of the plain version."""
    grid = 2
    with jax.disable_jit():
        jbench_dot.timed_grid(m, k, n, grid)
    (lhs, rhs, p1, p2), want = calls[0]
    targs = [_t(x) for x in (lhs, rhs, p1, p2)]
    got = cp.dot_grid(*targs, grid)
    assert got.dtype == torch.bfloat16 and got.shape == (grid, 8, 128)
    want32 = want.astype(np.float32)
    bar = 2 * DOT_RTOL * float(np.abs(want32).max())
    assert float((got.float() - torch.from_numpy(want32)).abs().max()) <= bar
    assert torch.equal(got[0], got[1])
    walked = _grid_by_tiles(*targs)
    plain = got[0].float().numpy()
    assert float(np.abs(walked - plain).max()) <= 2 * DOT_RTOL * float(
        np.abs(plain).max())


def test_ablation_macros_guard_code_in_their_sources():
    """Every ablated build of ``tools/ablate_phases.py`` names a macro its
    source tests, so no build times the whole kernel by mistake."""
    from yolov3_tpu_torch.tools import ablate_phases

    for kernel in ablate_phases.VARIANTS:
        source, entry, macros = ablate_phases.variants(kernel)
        text = source.read_text()
        assert f'extern "C" int {entry}(' in text
        for macro in macros.values():
            assert f"#ifdef {macro}" in text or f"#ifndef {macro}" in text
