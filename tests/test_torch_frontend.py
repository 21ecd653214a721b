"""The port's frontend copies (config, graph, weights, boxes) against the
JAX package's originals, and the port's import boundary (no jax)."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from yolov3_tpu import config as jconfig
from yolov3_tpu import graph as jgraph
from yolov3_tpu import weights as jweights
from yolov3_tpu.utils import boxes as jboxes
from yolov3_tpu_torch import config as tconfig
from yolov3_tpu_torch import graph as tgraph
from yolov3_tpu_torch import weights as tweights
from yolov3_tpu_torch.utils import boxes as tboxes

torch.set_num_threads(1)

CFGS = ("yolov3", "yolov3-tiny", "yolov3-spp")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", CFGS)
def test_lower_matches_jax_field_by_field(cfg_paths, name):
    text = open(cfg_paths[name]).read()
    assert tconfig.parse_config_text(text) == jconfig.parse_config_text(text)
    tg = tgraph.load_graph(cfg_paths[name])
    jg = jgraph.load_graph(cfg_paths[name])
    assert len(tg.nodes) == len(jg.nodes)
    for tn, jn in zip(tg.nodes, jg.nodes):
        assert dataclasses.asdict(tn) == dataclasses.asdict(jn)
    assert (tg.in_width, tg.in_height, tg.in_channels, tg.name) == \
        (jg.in_width, jg.in_height, jg.in_channels, jg.name)
    assert tg.needed_outputs == jg.needed_outputs
    assert tg.head_strides() == jg.head_strides()
    assert tg.num_detections(416, 416) == jg.num_detections(416, 416)


@pytest.mark.parametrize("name", CFGS)
def test_random_raw_and_fold_bit_equal(cfg_paths, name):
    tg = tgraph.load_graph(cfg_paths[name])
    jg = jgraph.load_graph(cfg_paths[name])
    traw = tweights.random_raw(tg, seed=3, scale=0.9)
    jraw = jweights.random_raw(jg, seed=3, scale=0.9)
    assert traw.keys() == jraw.keys()
    for idx in traw:
        assert traw[idx].keys() == jraw[idx].keys()
        for key in traw[idx]:
            np.testing.assert_array_equal(traw[idx][key], jraw[idx][key])
    tfold, jfold = tweights.fold_raw(traw), jweights.fold_raw(jraw)
    for idx in tfold:
        for key in ("w", "b"):
            np.testing.assert_array_equal(tfold[idx][key], jfold[idx][key])
    assert tweights.param_count(tg) == jweights.param_count(jg)


def test_write_read_roundtrip_bit_exact(cfg_paths, tmp_path):
    g = tgraph.load_graph(cfg_paths["yolov3-tiny"])
    raw = tweights.random_raw(g, seed=5)
    path = tmp_path / "tiny.weights"
    tweights.write_weights(path, g, raw)
    assert path.stat().st_size == 20 + 4 * tweights.param_count(g)
    back, header = tweights.read_raw(path, g)
    jback, jheader = jweights.read_raw(path, jgraph.load_graph(cfg_paths["yolov3-tiny"]))
    assert header == jheader == {"major": 0, "minor": 2, "revision": 0, "seen": 0}
    for idx in raw:
        for key in raw[idx]:
            np.testing.assert_array_equal(back[idx][key], raw[idx][key])
            np.testing.assert_array_equal(back[idx][key], jback[idx][key])


def test_weights_errors_kept(cfg_paths, tmp_path):
    g = tgraph.load_graph(cfg_paths["yolov3-tiny"])
    path = tmp_path / "tiny.weights"
    tweights.write_weights(path, g, tweights.random_raw(g, seed=1))
    data = path.read_bytes()
    with pytest.raises(ValueError, match="exhausted"):
        tweights.read_raw(data[:-4], g)
    with pytest.raises(ValueError, match="size mismatch"):
        tweights.read_raw(data + b"\0\0\0\0", g)


def test_params_from_jax_layout(cfg_paths):
    g = tgraph.load_graph(cfg_paths["yolov3-tiny"])
    folded = tweights.fold_raw(tweights.random_raw(g, seed=2))
    tp = tweights.params_from_jax(folded, device="cpu")
    for idx, p in folded.items():
        w = tp[idx]["w"]
        assert w.dtype == torch.float32 and w.is_contiguous(
            memory_format=torch.channels_last)
        np.testing.assert_array_equal(w.numpy(), p["w"].transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(tp[idx]["b"].numpy(), p["b"])


def test_letterbox_geometry_and_unletterbox_match():
    rng = np.random.default_rng(0)
    boxes = rng.uniform(-50, 700, (16, 4)).astype(np.float32)
    for sh in (1, 240, 480, 501, 720, 1080):
        for sw in (1, 320, 640, 832, 1920):
            for net in ((416, 416), (320, 608)):
                src = (sh, sw)
                assert tboxes.letterbox_geometry(src, net) == \
                    jboxes.letterbox_geometry(src, net)
                for clip in (True, False):
                    np.testing.assert_array_equal(
                        tboxes.unletterbox_tlbr(boxes, src, net, clip),
                        jboxes.unletterbox_tlbr(boxes, src, net, clip))
                    np.testing.assert_array_equal(
                        tboxes.unstretch_tlbr(boxes, src, net, clip),
                        jboxes.unstretch_tlbr(boxes, src, net, clip))


UTILS_COPIES = ("drawing", "export", "profiling", "video")


@pytest.mark.parametrize("name", UTILS_COPIES)
def test_utils_copies_equal_their_originals(name):
    """``utils/{drawing,export,profiling,video}.py`` are copies (numpy, cv2
    and threads only): every public function and class has the original's
    source, line for line."""
    import importlib
    import inspect

    t = importlib.import_module(f"yolov3_tpu_torch.utils.{name}")
    j = importlib.import_module(f"yolov3_tpu.utils.{name}")

    def public(mod):
        return {n: inspect.getsource(o) for n, o in vars(mod).items()
                if not n.startswith("_") and getattr(o, "__module__", None)
                == mod.__name__}

    got, want = public(t), public(j)
    assert got.keys() == want.keys() and got
    for n in want:
        assert got[n] == want[n], n


def test_utils_copies_behave_alike(tmp_path):
    from yolov3_tpu.inference import Detection as JDetection
    from yolov3_tpu.utils import drawing as jdrawing
    from yolov3_tpu.utils import export as jexport
    from yolov3_tpu_torch.inference import Detection
    from yolov3_tpu_torch.utils import drawing, export, profiling

    fields = dict(bbox_tlbr=np.array([[3.0, 4.0, 40.5, 30.25],
                                      [10.0, 12.0, 60.0, 50.0]], np.float32),
                  class_prob=np.array([0.912345, 0.5], np.float32),
                  class_idx=np.array([2, 0], np.int32))
    names = ["a", "b", "c"]
    assert export.to_coco_dicts({"x.png": Detection(**fields)}, names) == \
        jexport.to_coco_dicts({"x.png": JDetection(**fields)}, names)
    assert export.save_detections_json(tmp_path / "d.json",
                                       {"x.png": Detection(**fields)}) == 2
    frame = np.full((64, 80, 3), 90, np.uint8)
    other = frame.copy()
    drawing.draw_boxes(frame, Detection(**fields), class_names=names)
    jdrawing.draw_boxes(other, JDetection(**fields), class_names=names)
    np.testing.assert_array_equal(frame, other)
    assert (frame != 90).any()
    (tmp_path / "n.names").write_text("cat\ndog\n")
    assert drawing.load_class_names(tmp_path / "n.names") == \
        jdrawing.load_class_names(tmp_path / "n.names") == ["cat", "dog"]
    timers = profiling.StageTimers()
    with timers.stage("a"):
        pass
    assert "a" in timers.totals and "a" in timers.report()


def test_preprocess_host_equals_jax(cfg_paths):
    from yolov3_tpu.ops.preprocess import preprocess_host as jhost
    from yolov3_tpu_torch.ops.preprocess import preprocess, preprocess_host

    frames = np.random.default_rng(4).integers(0, 256, (2, 90, 120, 3),
                                               dtype=np.uint8)
    for mode in ("letterbox", "stretch"):
        got = preprocess_host(frames, (64, 96), mode=mode)
        np.testing.assert_array_equal(got, jhost(frames, (64, 96), mode=mode))
        dev = preprocess(torch.from_numpy(frames), (64, 96), mode=mode).numpy()
        # the host oracle against the device path: cv2's fixed-point
        # bilinear weights against float32 ones, under one uint8 step
        assert np.abs(got - dev).max() <= 1.0 / 255.0
    with pytest.raises(ValueError, match="unknown preprocess mode"):
        preprocess_host(frames, (64, 96), mode="crop")
    assert preprocess_host(frames[0], (64, 96)).shape == (1, 64, 96, 3)


def test_import_leaves_jax_out():
    """``import yolov3_tpu_torch`` (and every module of the port: the CLI,
    the server, the native binding, the tools, ``parallel/``) pulls in no
    jax, nothing of the JAX package or the repository's ``tools/``, and no
    cv2 — checked in a fresh interpreter, since this process has them."""
    code = ("import sys, pkgutil, importlib, yolov3_tpu_torch as p\n"
            "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
            "p.__name__ + '.')]\n"
            "for n in names:\n"
            "    importlib.import_module(n)\n"
            "want = ['__main__', 'bench', 'serve', 'native', "
            "'ops.cuda_probe', 'tools.probe_block', 'tools.bench_int8_dot', "
            "'tools.bench_dot', "
            "'tools.clock', 'tools.eval_coco', 'tools.gen_eval_golden', "
            "'tools.profile_layers', 'tools.profile_int8', "
            "'utils.drawing', 'utils.export', "
            "'utils.profiling', 'utils.video', 'parallel.sharding', "
            "'parallel.spatial', 'parallel.collectives', 'parallel.dryrun']\n"
            "missing = [w for w in want if p.__name__ + '.' + w not in names]\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'yolov3_tpu', 'tools', 'cv2', 'PIL'))\n"
            "print(bad, missing)\n"
            "bad += missing\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
