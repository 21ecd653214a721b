"""The bf16 tier: bfloat16 weights and walk, float32 decode. Held against
the JAX package's bf16 walk within bf16 rounding, and to the DESIGN parity
bar against the port's own float32 tier."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu import model as jmodel
from yolov3_tpu.graph import load_graph as jload_graph
from yolov3_tpu_torch import model as tmodel
from yolov3_tpu_torch.graph import load_graph
from yolov3_tpu_torch.ops import cuda_decode
from yolov3_tpu_torch.ops.nms import batched_nms_compact
from yolov3_tpu_torch.weights import fold_raw, random_raw

torch.set_num_threads(1)

DATA = Path(__file__).parent / "data"
ANCHORS = ((10.0, 13.0), (33.0, 23.0), (116.0, 90.0))


def test_darknet_bf16_holds_bf16_buffers():
    net = tmodel.Darknet(DATA / "port_wide.cfg", precision="bf16", device="cpu")
    assert net.param_dtype == torch.bfloat16
    net.set_params(fold_raw(random_raw(net.graph, seed=1)))
    for p in net.params.values():
        assert p["w"].dtype == p["b"].dtype == torch.bfloat16
        assert p["w"].is_contiguous(memory_format=torch.channels_last)
    f32 = tmodel.Darknet(DATA / "port_wide.cfg", precision="bf16",
                         param_dtype=torch.float32, device="cpu")
    f32.set_params(fold_raw(random_raw(net.graph, seed=1)))
    assert all(p["w"].dtype == torch.float32 for p in f32.params.values())
    out = net(torch.rand(1, 32, 32, 3))
    assert out.dtype == torch.float32  # heads decode in float32


@pytest.mark.parametrize("cfg,hw", [("port_small.cfg", (64, 64)),
                                    ("port_wide.cfg", (32, 32))])
def test_forward_features_bf16_matches_jax(cfg, hw):
    """Both walks run convs, bias, shortcut and route in bf16, but round at
    different places (F.conv2d adds the bias before its one bf16 rounding,
    the JAX walk adds a bf16 bias to a bf16 conv output), so the maps
    differ by a few bf16 ulps (2^-8 relative) after the layers compound:
    the bar is 4 ulps at unit scale, absolute and relative."""
    path = str(DATA / cfg)
    params_np = fold_raw(random_raw(load_graph(path), seed=4))
    x = np.random.default_rng(0).uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params_np)
    want = jmodel.forward_features(jload_graph(path), jp, jnp.asarray(x),
                                   precision="bf16")
    net = tmodel.Darknet(path, precision="bf16", device="cpu").set_params(params_np)
    got = tmodel.forward_features(net.graph, net.params, torch.from_numpy(x),
                                  precision="bf16")
    for gh, wh in zip(got, want):
        assert gh.dtype == torch.bfloat16 and tuple(gh.shape) == wh.shape
        np.testing.assert_allclose(gh.float().numpy(),
                                   np.asarray(wh).astype(np.float32),
                                   atol=2 ** -6, rtol=2 ** -6)


def _iou(a, b):
    tl = np.maximum(a[:2], b[:2])
    br = np.minimum(a[2:], b[2:])
    wh = np.maximum(br - tl, 0)
    inter = wh[0] * wh[1]
    ua = (a[2] - a[0]) * (a[3] - a[1])
    ub = (b[2] - b[0]) * (b[3] - b[1])
    return inter / max(ua + ub - inter, 1e-9)


def test_bf16_box_parity_with_fp32(cfg_paths):
    """The DESIGN bf16 bar on the port (tests/test_compact_path.py's test
    run against the port): surviving boxes match float32 ("highest") at
    IoU > 0.99 on ≥ 90% of the float32 detections scoring ≥ 0.45."""
    params_np = fold_raw(random_raw(load_graph(cfg_paths["yolov3-tiny"]), seed=3))
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (2, 416, 416, 3)).astype(np.float32))
    res = {}
    for prec in ("highest", "bf16"):
        net = tmodel.Darknet(cfg_paths["yolov3-tiny"], precision=prec, device="cpu")
        net.set_params(params_np)
        out = tmodel.forward_compact(net.graph, net.params, x, precision=prec)
        res[prec] = batched_nms_compact(*out, prob_thresh=0.35, top_k=64)
    r32, rbf = res["highest"], res["bf16"]
    matched, total = 0, 0
    for i in range(x.shape[0]):
        for j in np.where(r32.valid[i].numpy())[0]:
            if float(r32.scores[i, j]) < 0.45:
                continue
            total += 1
            cls32 = int(r32.classes[i, j])
            best = max((_iou(r32.boxes[i, j].numpy(), rbf.boxes[i, k].numpy())
                        for k in np.where(rbf.valid[i].numpy())[0]
                        if int(rbf.classes[i, k]) == cls32), default=0.0)
            matched += best > 0.99
    assert total > 0
    assert matched / total >= 0.9, f"bf16 parity {matched}/{total}"


def _bf16_map(shape, seed):
    rng = np.random.default_rng(seed)
    f = rng.normal(0, 2, shape).astype(np.float32)
    return torch.from_numpy(f).to(torch.bfloat16)


@pytest.mark.parametrize("kernel", ["K1", "K1c", "K4"])
def test_plain_versions_on_bf16_equal_widened_f32(kernel):
    """The decode kernels read bf16 maps with float32 math after the load;
    the widening is exact, so on the same maps widened to float32 their
    plain versions give identical records."""
    if kernel == "K4":
        x = _bf16_map((2, 4, 4, 128), seed=1)
        w = _bf16_map((255, 128), seed=2) / 16
        b = torch.from_numpy(np.random.default_rng(3).normal(0, 0.1, 255)
                             .astype(np.float32))
        run = lambda xx, ww: cuda_decode.decode_packed_fused_head(  # noqa: E731
            xx, ww, b, ANCHORS, 32, 80, prob_thresh=0.2)
        got, want = run(x, w), run(x.float(), w.float())
    else:
        feat = _bf16_map((2, 5, 6, 255), seed=4)
        fn = (cuda_decode.decode_packed_head if kernel == "K1"
              else cuda_decode.decode_compact_head)
        got, want = fn(feat, ANCHORS, 32, 80, 0.2), fn(feat.float(), ANCHORS,
                                                       32, 80, 0.2)
    for g, w_ in zip(got if kernel == "K1c" else [got],
                     want if kernel == "K1c" else [want]):
        assert torch.equal(g, w_)
