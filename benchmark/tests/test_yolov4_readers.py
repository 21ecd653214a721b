"""YOLOv4's configuration and its per-layer readers on hand-made traces:
the counts its metrics divide by (Darknet's published conv work, the
Mish epilogue's bytes), the kernels each reader takes, and None where a
run has no trace, as the parent's runs of other cells have."""
import importlib.util
from types import SimpleNamespace

import pytest

import counts
import harness
from conftest import BENCH
from devtrace import Trace
from reference import yolov4

CELL = "yolov4-608-bf16.stream32"
MISH = "void conv_epilogue_mish_kernel<__nv_bfloat16, true, false>(...)"
POOL = "void at::native::max_pool_forward_nhwc<c10::BFloat16, int>(...)"
CONV = "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwc"
PREPROCESS = "void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn>"


def _net():
    return yolov4.read_cfg(BENCH / "configs" / "yolov4.cfg")


def _run(kernel_s, batches=10, window_s=20.0):
    cell = harness.load_cell(CELL, trace=True)
    trace = Trace(window_s, {0: window_s}, kernel_s, [])
    served = SimpleNamespace(returned=batches * 32)
    return harness.Run(cell, _net(), 10.0, window_s, served, trace=trace)


def test_the_configuration_is_the_published_one():
    net = _net()
    assert len(net.layers) == 162 and len(net.convs) == 110
    assert net.heads == [139, 150, 161]
    assert counts.image_ops(net, 608) == 128_389_482_496
    assert [yolov4.head_scale(net, h) for h in net.heads] == [1.2, 1.1, 1.05]
    cell = harness.load_cell(CELL)
    assert cell.reference is yolov4 and set(cell.metrics) == {
        "images_per_s", "setup_s"}
    assert set(harness.load_cell(CELL, trace=True).metrics) == {
        "mfu_pct.yolov4", "conv_roofline_pct.yolov4",
        "mish_epilogue_roofline_pct"}


def test_mish_bytes():
    """72 Mish outputs read and written once, 23 residuals read once, bf16:
    13.32 GB a batch of 32 at 608, 3.98 ms at HBM's rate."""
    spec = importlib.util.spec_from_file_location(
        "mish_reader", BENCH / "metrics" / "mish_epilogue_roofline_pct.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.mish_bytes(_net(), 608, 32) == 13_319_733_248


def test_readers_take_their_kernels():
    run = _run({MISH: 0.1, POOL: 0.05, CONV: 0.2, PREPROCESS: 0.03})
    mish = harness.read_metric("mish_epilogue_roofline_pct", run)
    # 10 batches of 13.32 GB at 3.35 TB/s over 0.1 s of the Mish kernel
    assert mish == pytest.approx(100 * 10 * 13_319_733_248 / 3.35e12 / 0.1)
    need = 10 * sum(counts.conv_bound_s(c, 32, "bf16")
                    for c in counts.convs(_net(), 608))
    conv = harness.read_metric("conv_roofline_pct.yolov4", run)
    # the convs, the pools and the epilogue; not the preprocess's products
    assert conv == pytest.approx(100 * need / 0.35)
    mfu = harness.read_metric("mfu_pct.yolov4", run)
    assert mfu == pytest.approx(100 * 320 * 128_389_482_496 / 989e12 / 20.0)


@pytest.mark.parametrize("name", ["mfu_pct.yolov4", "conv_roofline_pct.yolov4",
                                  "mish_epilogue_roofline_pct"])
def test_nothing_to_read(name):
    run = _run({CONV: 0.2})
    if name != "mfu_pct.yolov4":  # a parent's trace: no Mish kernel, no pool
        run.trace.kernel_s = {}
        assert harness.read_metric(name, run) is None
    run.trace = None
    assert harness.read_metric(name, run) is None
