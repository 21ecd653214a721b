"""The port's public functions bind their arguments as the JAX package's do:
every function and method that both modules define takes the original's
parameters in the original's positions, with the deviations listed below.
Also the few definitions of the reference that the port had lost
(``Darknet.num_classes``, ``ops.nms.iou_matrix``, the box-format helpers)
and the NMS functions' ``impl`` / ``interpret`` positions."""
import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu import inference as _jinference  # noqa: F401  (module import)
from yolov3_tpu.model import Darknet as JDarknet
from yolov3_tpu.ops import nms as jnms
from yolov3_tpu.utils import boxes as jboxes
from yolov3_tpu_torch import Darknet, Detector
from yolov3_tpu_torch.ops import cuda_nms
from yolov3_tpu_torch.ops import nms as tnms
from yolov3_tpu_torch.parallel import make_mesh
from yolov3_tpu_torch.utils import boxes as tboxes
from yolov3_tpu_torch.weights import fold_raw, random_raw

torch.set_num_threads(1)

MODULES = ("inference", "model", "ops.nms", "utils.boxes", "ops.preprocess",
           "ops.decode", "quant", "weights", "graph", "config", "native",
           "serve", "parallel.sharding", "parallel.spatial")

# (module, qualified name) -> (parameters the port drops, parameters it
# appends after the original's). Each appended parameter is the port's own:
# the device a net or Detector lives on, the cached resize
# matrices, the int8 operands cached on the card, the float walk's ``upto``
# (the per-layer profile's prefixes, as the int8 carrier walk has), the
# shortcut that _conv's epilogue takes over (its residual and activation). The
# port's _conv and _conv_bf16 take no precision: the weights' type says it;
# nor do the spatial walk's convs, under the walk's one precision scope.
DEVIATIONS = {
    ("inference", "Detector.__init__"): ((), ("device",)),
    ("model", "Darknet.__init__"): ((), ("device",)),
    ("model", "_conv"): (("precision",), ("residual", "residual_activation")),
    ("model", "forward_features"): ((), ("upto",)),
    ("ops.preprocess", "preprocess"): ((), ("interp",)),
    ("ops.preprocess", "resize_bilinear"): ((), ("interp",)),
    ("quant", "_conv_bf16"): (("precision",), ("operands",)),
    ("quant", "_conv_int8_core"): ((), ("operands",)),
    ("quant", "_conv_stem_int8"): ((), ("operands",)),
    ("quant", "forward_compact_int8"): ((), ("operands",)),
    ("quant", "forward_features_int8"): ((), ("operands",)),
    ("quant", "forward_features_int8_carrier"): ((), ("operands",)),
    ("quant", "forward_packed_fused_int8"): ((), ("operands",)),
    ("quant", "forward_packed_int8"): ((), ("operands",)),
    ("parallel.spatial", "_conv_sharded"): (("precision",), ()),
    ("parallel.spatial", "_conv_col"): (("precision",), ()),
    ("parallel.spatial", "_conv_row"): (("precision",), ()),
}


def _functions(mod):
    """Functions and methods defined in ``mod``, by qualified name (jitted
    JAX functions keep their Python signature)."""
    out = {}
    for name, obj in vars(mod).items():
        if getattr(obj, "__module__", None) != mod.__name__:
            continue
        if inspect.isclass(obj):
            out.update({f"{name}.{m}": f for m, f in vars(obj).items()
                        if inspect.isfunction(f)})
        elif callable(obj):
            out[name] = obj
    return out


def _params(fn):
    return list(inspect.signature(fn).parameters)


# the port's bench against the JAX package's (the repository's bench.py):
# port name -> (reference name, parameters appended after the reference's)
BENCH = {
    "device_reachable": ("device_reachable", ("device",)),
    "_probe_with_retry": ("_probe_with_retry", ()),
    "measure_gpu": ("measure_tpu", ("device",)),
    "measure_gpu_int8": ("measure_tpu_int8", ("device",)),
    "latency_row": ("latency_row", ()),
    "measure_latency": ("measure_latency", ("device",)),
    "measure_torch_cpu": ("measure_torch_cpu", ()),
    "torch_baseline": ("torch_baseline", ()),
    "main": ("main", ("argv",)),
    "_fail_row": ("_fail_row", ()),
    "_run": ("_run", ()),
    "auto_top_k": ("auto_top_k", ()),
}


@pytest.mark.parametrize("name", sorted(BENCH))
def test_bench_positional_order_matches_the_reference(name):
    import bench as jbench
    from yolov3_tpu_torch import bench as tbench

    ref_name, appended = BENCH[name]
    assert _params(getattr(tbench, name)) == \
        _params(getattr(jbench, ref_name)) + list(appended)


@pytest.mark.parametrize("module", MODULES)
def test_positional_order_matches_the_reference(module):
    port = _functions(importlib.import_module(f"yolov3_tpu_torch.{module}"))
    ref = _functions(importlib.import_module(f"yolov3_tpu.{module}"))
    common = sorted(set(port) & set(ref))
    assert common
    for name in common:
        dropped, appended = DEVIATIONS.get((module, name), ((), ()))
        want = [p for p in _params(ref[name]) if p not in dropped]
        assert _params(port[name]) == want + list(appended), name
    listed = {name for mod, name in DEVIATIONS if mod == module}
    assert listed <= set(common), "a listed deviation names no shared function"


def test_detector_binds_positionally_like_the_reference(cfg_paths):
    net = Darknet(cfg_paths["yolov3-tiny"], precision="highest", device="cpu")
    net.set_params(fold_raw(random_raw(net.graph, seed=0)))
    args = (0.5, 0.45, "letterbox", None, True, None, None, "xla", "pallas")
    det = Detector(net, *args)
    jsig = inspect.signature(_jinference.Detector.__init__)
    bound = jsig.bind(None, None, *args).arguments
    for name in ("prob_thresh", "iou_thresh", "resize_mode", "bgr",
                 "nms_impl", "decode_impl"):
        assert getattr(det, name) == bound[name], name
    assert (det.top_k, det.net_hw, det.route) == (256, (416, 416), "pallas")
    mesh = make_mesh(2, devices=[torch.device("cpu")] * 2)
    det = Detector(net, 0.5, 0.45, "letterbox", None, True, None, mesh)
    assert (det.mesh, det.partition) == (mesh, "data")
    det = Detector(net, 0.5, 0.45, "letterbox", 64, True, None, None, "pallas",
                   "xla", 32, 2, "data", 4, "pallas", "cpu")
    assert (det.top_k, det.nms_impl, det.decode_impl, det.max_results,
            det.scan, det.select_group, det.block_impl, det.device) == (
        64, "pallas", "xla", 32, 2, 4, "pallas", torch.device("cpu"))


@pytest.mark.parametrize("name", ["yolov3-tiny", "yolov3"])
def test_darknet_num_classes(cfg_paths, name):
    assert Darknet(cfg_paths[name], device="cpu").num_classes == \
        JDarknet(cfg_paths[name]).num_classes == 80


def _seeded_boxes(rng, k):
    """tlbr boxes with shared edges, duplicates, and some degenerate ones
    (x1 < x0) that the clamp to zero must meet."""
    xy = np.round(rng.uniform(0, 100, (k, 2)) * 2) / 2
    wh = np.round(rng.uniform(-5, 40, (k, 2)) * 2) / 2
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[k // 2:k // 2 + 3] = boxes[:3]
    return boxes


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_iou_matrix_equals_jax(seed):
    boxes = _seeded_boxes(np.random.default_rng(seed), 48)
    got = tnms.iou_matrix(torch.from_numpy(boxes)).numpy()
    want = np.asarray(jnms.iou_matrix(jnp.asarray(boxes)))
    assert got.shape == (48, 48)
    np.testing.assert_array_equal(got, want)


def test_conflict_matrix_is_iou_matrix_over_a_batch():
    rng = np.random.default_rng(3)
    boxes = np.stack([_seeded_boxes(rng, 32) for _ in range(2)])
    classes = rng.integers(0, 3, (2, 32)).astype(np.int32)
    got = cuda_nms.conflict_matrix(torch.from_numpy(boxes),
                                   torch.from_numpy(classes), 0.3).numpy()
    for i in range(2):
        iou = np.asarray(jnms.iou_matrix(jnp.asarray(boxes[i])))
        same = classes[i][:, None] == classes[i][None, :]
        np.testing.assert_array_equal(got[i], (iou > 0.3) & same)


def test_box_helpers_equal_jax():
    rng = np.random.default_rng(4)
    cxywh = rng.uniform(0, 400, (3, 16, 4)).astype(np.float32)
    tlbr = tboxes.cxywh_to_tlbr(cxywh)
    np.testing.assert_array_equal(tlbr, jboxes.cxywh_to_tlbr(cxywh))
    np.testing.assert_array_equal(tboxes.tlbr_to_cxywh(tlbr),
                                  jboxes.tlbr_to_cxywh(tlbr))
    assert tlbr.dtype == np.float32
    for fn in ("cxywh_to_tlbr", "tlbr_to_cxywh"):
        assert inspect.getsource(getattr(tboxes, fn)) == \
            inspect.getsource(getattr(jboxes, fn))


def _nms_inputs():
    rng = np.random.default_rng(5)
    boxes = torch.from_numpy(_seeded_boxes(rng, 40)[None])
    scores = torch.from_numpy(rng.uniform(0, 1, (1, 40)).astype(np.float32))
    classes = torch.from_numpy(rng.integers(0, 2, (1, 40)).astype(np.int32))
    payload = torch.cat([boxes, scores[..., None], classes.float()[..., None],
                         torch.arange(40.0)[None, :, None],
                         torch.zeros(1, 40, 1)], -1)
    det = torch.cat([(boxes[..., :2] + boxes[..., 2:]) / 2,
                     boxes[..., 2:] - boxes[..., :2], torch.ones(1, 40, 1),
                     torch.nn.functional.one_hot(classes.long(), 3).float()
                     * scores[..., None]], -1)
    return {"batched_nms": (det,),
            "batched_nms_compact": (boxes, scores, classes),
            "batched_nms_packed": (payload, scores)}


@pytest.mark.parametrize("fn", ["batched_nms", "batched_nms_compact",
                                "batched_nms_packed"])
def test_nms_impl_and_interpret(fn):
    """``impl`` and ``interpret`` sit where the reference has them; "xla"
    and "pallas" give one result (both run K2), anything else raises, and
    so does interpret=True."""
    f, inputs = getattr(tnms, fn), _nms_inputs()[fn]
    ref = list(inspect.signature(getattr(jnms, fn)).parameters)
    assert list(inspect.signature(f).parameters) == ref
    # positionally, up to and including impl: thresholds, top_k, impl
    lead = (0.05, 0.3, 16) if fn != "batched_nms_packed" else (0.3, 16)
    a = f(*inputs, *lead, "xla")
    b = f(*inputs, *lead, "pallas")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a.scores.shape == (1, 16) and bool(a.valid.any())
    with pytest.raises(ValueError, match="unknown NMS impl 'bogus'"):
        f(*inputs, *lead, "bogus")
    with pytest.raises(ValueError, match="no interpret mode"):
        f(*inputs, *lead, "xla", True)
