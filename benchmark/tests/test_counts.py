"""The yardstick's operation and byte counts against the shapes of
``models/yolov3.cfg``: the published totals (65.86 and 140.69 billion
operations at 416 and 608, the Darknet / YOLOv3 site's figures) and each
conv's MACs as the port's own traffic model counts them."""
from types import SimpleNamespace

import pytest

import counts
import harness
from conftest import BENCH, ROOT
from reference import yolo


@pytest.mark.parametrize("size,gflop", [(416, 65.86), (608, 140.69)])
def test_published_totals(size, gflop):
    net = yolo.read_cfg(ROOT / "models" / "yolov3.cfg")
    assert counts.image_ops(net, size) / 1e9 == pytest.approx(gflop, abs=0.005)


@pytest.mark.parametrize("size", [416, 608])
def test_conv_shapes_match_the_port(size):
    from yolov3_tpu_torch.graph import load_graph
    from yolov3_tpu_torch.tools.traffic_model import node_rows

    graph = load_graph(ROOT / "models" / "yolov3.cfg")
    rows = {r["index"]: r for r in node_rows(graph, size, 1, "bf16")}
    net = yolo.read_cfg(BENCH / "configs" / "yolov3.cfg")
    convs = counts.convs(net, size)
    assert [c.index for c in convs] == [n.index for n in graph.conv_nodes]
    for c, n in zip(convs, graph.conv_nodes):
        assert c.macs == rows[c.index]["macs"]
        assert (c.cin, c.cout, c.size) == (rows[c.index]["macs"] // (
            c.out_hw[0] * c.out_hw[1] * c.cout * c.size ** 2), n.filters, n.size)


def test_int8_split_and_blocks():
    net = yolo.read_cfg(BENCH / "configs" / "yolov3.cfg")
    convs = counts.convs(net, 608)
    bf16 = [c.index for c in convs if not counts.int8_quantized(c)]
    # the stem and the three linear head projections stay bf16
    assert bf16 == [0, 81, 93, 105]
    blocks = counts.residual_blocks(net)
    assert len(blocks) == 10  # Darknet-53's blocks of width 128 (2) and 256 (8)
    assert counts.block_bound_s(net, 608, 32) > 0


def test_bounds_follow_batch():
    net = yolo.read_cfg(BENCH / "configs" / "yolov3.cfg")
    c = counts.convs(net, 608)[10]
    ops_s = 2 * c.macs * 64 / counts.PEAK_OPS_PER_S["bf16"]
    assert counts.conv_bound_s(c, 64, "bf16") >= ops_s
    assert counts.image_peak_s(net, 608, "int8") < counts.image_peak_s(net, 608, "bf16")


@pytest.mark.parametrize("name,tier", [("yolov3-608-bf16.stream32", "bf16"),
                                       ("yolov3-608-int8.stream32", "int8")])
def test_mfu_counts_each_conv_at_its_tier_peak(name, tier):
    """``mfu_pct`` as a run reads it: the int8 cell's convs at the int8 peak
    but the stem and the heads, the bf16 cell's at the bf16 peak."""
    cell = harness.load_cell(name, trace=True)
    assert cell.config["tier"] == tier
    net = yolo.read_cfg(cell.cfg_path)
    run = SimpleNamespace(cell=cell, net=net,
                          served=SimpleNamespace(returned=4000),
                          trace=SimpleNamespace(window_s=10.0))
    got = harness.read_metric("mfu_pct", run)
    assert got == pytest.approx(100 * 4000 * counts.image_peak_s(net, 608, tier) / 10)
    # 140.69 GFLOP an image: at the bf16 peak 5.69%; at int8 but the stem and
    # the three head projections about half that
    assert got == pytest.approx(5.69 if tier == "bf16" else 2.88, abs=0.01)
