"""The port's profiling tools against the reference's (CPU).

* ``tools/profile_layers.py``: ``partial_forward`` at full depth gives
  ``forward_features``' head maps to the bit (it IS the served walk,
  truncated), and each prefix's last activation sums as the JAX walk's
  prefix (``tools/profile_layers.py``'s ``partial_forward``) does; the
  default marks are the reference's downsample boundaries plus full depth.
* ``tools/profile_int8.py``: each stage on a JAX-made quantization state
  against the reference's stage functions at precision "highest": the
  walk's prefixes within the int8 walks' bar (``test_torch_quant_walk.py``),
  the packed decode, the pair-max selection and the suppression within the
  DESIGN int8 bars (the same class, |Δscore| ≤ 0.01, |Δbox| ≤ 0.5 px).
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools import profile_layers as jprofile
from yolov3_tpu import quant as jq
from yolov3_tpu.graph import load_graph as jload_graph
from yolov3_tpu.ops import nms as jnms
from yolov3_tpu_torch.graph import load_graph
from yolov3_tpu_torch.model import forward_features
from yolov3_tpu_torch.tools import profile_int8
from yolov3_tpu_torch.tools import profile_layers as pl
from yolov3_tpu_torch.weights import (fold_raw, params_from_jax,
                                      quant_state_from_jax, random_raw)

torch.set_num_threads(1)

MODELS = Path(__file__).parent.parent / "models"
DATA = Path(__file__).parent / "data"


def _walk_inputs(cfg, hw, seed=0):
    g, jg = load_graph(cfg), jload_graph(cfg)
    params = fold_raw(random_raw(g, seed=seed))
    x = np.random.default_rng(seed).uniform(0, 1, (1, *hw, 3)).astype(np.float32)
    return g, jg, params, x


@pytest.mark.parametrize("conv_impl", ["xla", "pallas"])
@pytest.mark.parametrize("cfg", ["yolov3-tiny", "port_small"])
def test_partial_forward_at_full_depth_is_forward_features(cfg, conv_impl):
    path = MODELS / f"{cfg}.cfg" if cfg.startswith("yolov3") else DATA / f"{cfg}.cfg"
    g, _, params, x = _walk_inputs(path, (64, 64))
    tp = params_from_jax(params, device="cpu")
    got = pl.partial_forward(g, tp, torch.from_numpy(x), len(g.nodes),
                             "highest", conv_impl)
    want = forward_features(g, tp, torch.from_numpy(x), "highest", conv_impl)
    assert len(got) == len(want) + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(got[-1], want[-1])   # the last node is the last head


def test_prefixes_sum_as_the_jax_walk(cfg_paths):
    """Every 7th prefix of yolov3-tiny at 96x96, and full depth: the last
    activation's float32 sum against the reference tool's ``partial_forward``
    (which returns that sum), to float32 summation noise."""
    g, jg, params, x = _walk_inputs(cfg_paths["yolov3-tiny"], (96, 96), seed=3)
    tp = params_from_jax(params, device="cpu")
    jp = {i: {k: jnp.asarray(v) for k, v in p.items()}
          for i, p in params.items()}
    for upto in list(range(1, len(g.nodes), 7)) + [len(g.nodes)]:
        got = pl.partial_forward(g, tp, torch.from_numpy(x), upto, "highest")
        want = float(jprofile.partial_forward(jg, jp, jnp.asarray(x), upto))
        s = float(got[-1].double().sum())
        assert abs(s - want) <= 1e-4 * max(1.0, abs(want)), (upto, s, want)


@pytest.mark.parametrize("cfg", ["yolov3", "yolov3-tiny", "yolov3-spp"])
def test_default_marks_are_the_references(cfg_paths, cfg):
    """The reference's loop (``tools/profile_layers.py`` main) on the JAX
    graph: the first stride-2 conv of each new resolution, plus full
    depth."""
    jg = jload_graph(cfg_paths[cfg])
    marks, seen = [], set()
    for n in jg.nodes:
        if n.kind == "convolutional" and n.stride > 1 and n.downsample not in seen:
            seen.add(n.downsample)
            marks.append(n.index + 1)
    marks.append(len(jg.nodes))
    assert pl.default_marks(load_graph(cfg_paths[cfg])) == marks


def test_describe_names_the_layer():
    g = load_graph(MODELS / "yolov3-tiny.cfg")
    assert pl.describe(g.nodes[0], torch.zeros(1, 8, 8, 16)) == \
        "conv 3x3/1 -> 8x8x16"
    assert pl.describe(g.nodes[1], torch.zeros(1, 4, 4, 16)) == \
        "maxpool -> 4x4x16"


class JState:
    """One JAX-made int8-carrier state (tiny@96 or the block cfg at 48),
    in both packages' forms."""

    def __init__(self, cfg, hw, scheme):
        self.g, self.jg, params, _ = _walk_inputs(cfg, hw, seed=4)
        jp = {i: {k: jnp.asarray(v) for k, v in p.items()}
              for i, p in params.items()}
        self.x = np.random.default_rng(5).uniform(
            0, 1, (2, *hw, 3)).astype(np.float32)
        calib = [jnp.asarray(self.x)]
        self.zeros = None
        if scheme == "asymmetric":
            self.scales, self.zeros = jq.calibrate_tensors_affine(
                self.jg, jp, calib, precision="highest")
        else:
            self.scales = jq.calibrate_tensors(self.jg, jp, calib,
                                               precision="highest")
        self.jqp = jq.quantize_weights(self.jg, jp, False)
        tqp = quant_state_from_jax({i: {k: np.asarray(v) for k, v in q.items()}
                                    for i, q in self.jqp.items()}, device="cpu")
        self.state = profile_int8.State(self.g, tqp, self.scales, self.zeros,
                                        hw, device="cpu")


def _close_maps(got, want, smax):
    """The int8 walks' bar at "highest": >= 99% of elements equal to float32
    noise, none beyond 4 quantization steps."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = a.float().numpy(), np.asarray(b, np.float32)
        d = np.abs(a - b)
        assert (d <= 1e-5 * np.maximum(1.0, np.abs(b))).mean() >= 0.99
        assert d.max() <= 4 * smax


def _matched(got, want, n=None):
    """Each of ``want``'s (boxes, scores, classes) rows (the top ``n`` by
    score) has its own row of ``got`` of the same class within the DESIGN
    bars; near-tied scores may come out in another order."""
    (gb, gs, gc), (wb, ws, wc) = got, want
    order = np.argsort(-ws, kind="stable")[:n]
    free = list(range(len(gs)))
    for j in order:
        hit = next((i for i in free if gc[i] == wc[j]
                    and abs(gs[i] - ws[j]) <= 0.01
                    and np.abs(gb[i] - wb[j]).max() <= 0.5), None)
        assert hit is not None, (wb[j], ws[j], wc[j])
        free.remove(hit)


def _records(payload, image):
    p = np.asarray(payload[image], np.float32)
    keep = p[:, 4] > 0
    return p[keep, :4], p[keep, 4], p[keep, 5]


@pytest.mark.parametrize("cfg,hw,scheme,block_impl", [
    ("yolov3-tiny", (96, 96), "symmetric", "xla"),
    ("port_block", (48, 48), "asymmetric", "xla"),
    ("port_block", (48, 48), "symmetric", "pallas")])
def test_int8_stages_match_the_references(cfg, hw, scheme, block_impl):
    path = MODELS / f"{cfg}.cfg" if cfg.startswith("yolov3") else DATA / f"{cfg}.cfg"
    js = JState(path, hw, scheme)
    marks = pl.default_marks(js.g)
    prob, top_k = 0.05, 64
    stages = profile_int8.stages(js.state, marks, prob_thresh=prob,
                                 top_k=top_k, block_impl=block_impl,
                                 precision="highest")
    assert [s[0] for s in stages] == (
        [f"conv walk [0:{u})" for u in marks]
        + ["+ packed decode", "+ pair-max selection",
           "+ suppression (full step)"])
    x, jx = torch.from_numpy(js.x), jnp.asarray(js.x)
    smax = max(js.scales.values())
    for (label, fn), upto in zip(stages, marks):
        want = jq.forward_features_int8_carrier(
            js.jg, js.jqp, js.scales, jx, "highest", upto=upto,
            tensor_zeros=js.zeros)
        _close_maps(fn(x), want, smax)
    payload, scores = jq.forward_packed_int8(
        js.jg, js.jqp, js.scales, jx, prob_thresh=prob, precision="highest",
        carrier="int8", zeros=js.zeros)
    got_payload, got_scores = stages[-3][1](x)
    assert torch.equal(got_payload[..., 4], got_scores)
    sel = stages[-2][1](x)
    want_sel = jnms._select_pairmax_payload(payload, scores, top_k)
    res = stages[-1][1](x)
    want_res = jnms.batched_nms_packed(payload, scores, top_k=top_k)
    for i in range(js.x.shape[0]):
        _matched(_records(got_payload, i), _records(payload, i), n=50)
        valid = np.asarray(want_sel[3][i])
        assert int(sel[3][i].sum()) == int(valid.sum())
        _matched([t[i].numpy() for t in sel[:3]],
                 [np.asarray(t[i])[valid] for t in want_sel[:3]], n=50)
        keep = np.asarray(want_res.valid[i])
        assert int(res.valid[i].sum()) == int(keep.sum()) > 0
        _matched([t[i][res.valid[i]].numpy()
                  for t in (res.boxes, res.scores, res.classes)],
                 [np.asarray(t[i])[keep]
                  for t in (want_res.boxes, want_res.scores,
                            want_res.classes)])
