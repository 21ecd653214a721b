"""The port's command line (``python -m yolov3_tpu_torch``) in process on the
CPU: every source, the int8 flags, the one-line errors, and the same printed
detections and COCO JSON as ``python -m yolov3_tpu`` on the same files
(precision "highest", the golden bars). The parser is held to the
reference's flag by flag."""
import contextlib
import io
import json
import logging
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from yolov3_tpu.__main__ import build_parser as jbuild_parser
from yolov3_tpu.__main__ import main as jmain
from yolov3_tpu_torch import native as tnative
from yolov3_tpu_torch.__main__ import build_parser, main
from yolov3_tpu_torch.graph import load_graph
from yolov3_tpu_torch.weights import random_raw, write_weights

torch.set_num_threads(1)

MODELS = Path(__file__).parent.parent / "models"
TINY = str(MODELS / "yolov3-tiny.cfg")
NAMES = str(MODELS / "coco.names")
LINE = re.compile(r"^(.{20}) (\d\.\d{3})  tlbr=\((-?\d+),(-?\d+),(-?\d+),(-?\d+)\)$")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("cli")
    weights = root / "tiny.weights"
    g = load_graph(TINY)
    write_weights(weights, g, random_raw(g, seed=42))
    rng = np.random.default_rng(0)
    img_dir = root / "imgs"
    img_dir.mkdir()
    images = []
    for i, (h, w) in enumerate([(120, 160), (120, 160), (120, 160), (180, 101)]):
        p = img_dir / f"img{i}.png"   # lossless: both packages read the same pixels
        assert cv2.imwrite(str(p), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        images.append(str(p))
    video = root / "in.avi"
    vw = cv2.VideoWriter(str(video), cv2.VideoWriter_fourcc(*"MJPG"), 10.0,
                         (160, 120))
    for _ in range(6):
        vw.write(rng.integers(0, 256, (120, 160, 3), dtype=np.uint8))
    vw.release()
    return {"root": root, "weights": str(weights), "dir": str(img_dir),
            "images": images, "video": str(video)}


def _base(files):
    return ["--config", TINY, "--weights", files["weights"], "--class-names",
            NAMES, "--no-show", "--precision", "highest", "--net-size", "160",
            "--prob-thresh", "0.3", "--no-compile-cache"]


def _run(entry, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = entry(argv)
    return rc, out.getvalue()


def _detection_lines(text):
    rows = []
    for line in text.splitlines():
        m = LINE.match(line)
        if m:
            rows.append((m.group(1).strip(), float(m.group(2)),
                         [int(v) for v in m.groups()[2:]]))
    return rows


def _same_json(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g["image_id"], g["category_id"], g["category_name"]) == \
            (w["image_id"], w["category_id"], w["category_name"])
        assert abs(g["score"] - w["score"]) <= 5e-5 + 1e-5   # + the 5-digit rounding
        np.testing.assert_allclose(g["bbox"], w["bbox"], atol=0.1 + 0.01)


@pytest.fixture(scope="module")
def jax_cli(files):
    """The JAX CLI's answers, once: --image and --image-dir with --save-json."""
    root = files["root"]
    rc1, img_out = _run(jmain, _base(files) + [
        "--image", files["images"][0], "--save-json", str(root / "j_img.json")])
    rc2, dir_out = _run(jmain, _base(files) + [
        "--image-dir", files["dir"], "--batch-size", "2", "--scan", "2",
        "--save-json", str(root / "j_dir.json")])
    assert rc1 == rc2 == 0
    return {"img_out": img_out, "dir_out": dir_out,
            "img_json": json.loads((root / "j_img.json").read_text()),
            "dir_json": json.loads((root / "j_dir.json").read_text())}


def test_parser_has_the_reference_flags_and_defaults():
    def table(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices,
                         a.nargs, a.const, a.metavar, a.required,
                         type(a).__name__)
                for a in parser._actions}

    got, want = table(build_parser()), table(jbuild_parser())
    assert got.keys() == want.keys()
    for dest in want:
        assert got[dest] == want[dest], dest
    assert build_parser().prog == "yolov3_tpu_torch"
    groups = [sorted(a.dest for a in g._group_actions)
              for g in build_parser()._mutually_exclusive_groups]
    assert groups == [sorted(a.dest for a in g._group_actions)
                      for g in jbuild_parser()._mutually_exclusive_groups]


def test_image_prints_the_jax_cli_detections(files, jax_cli, tmp_path):
    out_img = tmp_path / "out.png"
    rc, text = _run(main, _base(files) + [
        "--device", "cpu", "--image", files["images"][0], "--verbose",
        "--output", str(out_img), "--save-json", str(tmp_path / "t.json")])
    assert rc == 0 and out_img.stat().st_size > 1000
    assert "detections in" in text and "wrote" in text
    got, want = _detection_lines(text), _detection_lines(jax_cli["img_out"])
    assert len(got) == len(want) > 0
    for (gn, gp, gb), (wn, wp, wb) in zip(got, want):
        assert gn == wn
        assert abs(gp - wp) <= 0.001 + 1e-9      # the 3-digit print of a 5e-5 bar
        assert max(abs(a - b) for a, b in zip(gb, wb)) <= 1  # integer print of 0.1 px
    _same_json(json.loads((tmp_path / "t.json").read_text()), jax_cli["img_json"])


def test_image_dir_json_equals_the_jax_cli(files, jax_cli, tmp_path):
    assert tnative.available()
    out_dir = tmp_path / "annotated"
    rc, text = _run(main, _base(files) + [
        "--device", "cpu", "--image-dir", files["dir"], "--batch-size", "2",
        "--scan", "2", "--output", str(out_dir),
        "--save-json", str(tmp_path / "t.json")])
    assert rc == 0
    assert "4 images" in text and "4 images" in jax_cli["dir_out"]
    assert len(list(out_dir.iterdir())) == 4
    _same_json(json.loads((tmp_path / "t.json").read_text()), jax_cli["dir_json"])


def test_image_dir_per_shape_route_without_the_loader(files, tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(tnative, "available", lambda: False)
    rc, text = _run(main, _base(files) + [
        "--device", "cpu", "--image-dir", files["dir"], "--batch-size", "2",
        "--save-json", str(tmp_path / "t.json")])
    assert rc == 0 and "4 images" in text
    ids = {d["image_id"] for d in json.loads((tmp_path / "t.json").read_text())}
    assert ids <= {f"img{i}.png" for i in range(4)} and ids


@pytest.mark.parametrize("depth", ["0", "2"])
def test_video_every_frame_in_order(files, tmp_path, depth):
    import cv2

    out = tmp_path / "out.avi"
    rc, text = _run(main, _base(files) + [
        "--device", "cpu", "--video", files["video"], "--output", str(out),
        "--show-fps", "--frame-batch", "2", "--pipeline-depth", depth])
    assert rc == 0
    assert "processed 6 frames" in text and "per-batch stages" in text
    cap = cv2.VideoCapture(str(out))
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 6
    cap.release()


@pytest.mark.parametrize("depth", [0, 2])
def test_cam_loop_on_a_file_source(files, tmp_path, depth):
    from yolov3_tpu_torch import Darknet, Detector
    from yolov3_tpu_torch.inference import detect_in_cam

    net = Darknet(TINY, precision="highest", device="cpu").load_weights(
        files["weights"])
    det = Detector(net, prob_thresh=0.3, net_hw=(160, 160))
    out = tmp_path / "cam.avi"
    n = detect_in_cam(det, files["video"], show=False, max_frames=3,
                      pipeline_depth=depth, output_path=str(out),
                      show_fps=True)
    # latest-frame-wins: a file "camera" may run out before max_frames
    assert 1 <= n <= 3 and out.stat().st_size > 0


def test_cam_flag_reaches_detect_in_cam(files, monkeypatch):
    import importlib

    seen = {}
    mod = importlib.import_module("yolov3_tpu_torch.inference")
    monkeypatch.setattr(mod, "detect_in_cam",
                        lambda det, cam, **kw: seen.update(cam=cam, **kw))
    assert main(_base(files) + ["--device", "cpu", "--cam", "--output-fps", "12",
                                "--pipeline-depth", "2", "--nms-impl", "pallas"]) == 0
    assert seen["cam"] == 0 and seen["pipeline_depth"] == 2
    assert seen["output_fps"] == 12.0 and seen["show"] is False
    assert main(_base(files) + ["--device", "cpu", "--cam", files["video"]]) == 0
    assert seen["cam"] == files["video"] and seen["pipeline_depth"] == 0


def test_quantize_then_quant_state_round_trip(files, tmp_path, caplog):
    state = tmp_path / "tiny_int8.npz"
    argv = [a for a in _base(files) if a not in ("--precision", "highest")] + [
        "--device", "cpu", "--image", files["images"][0],
        "--quant-state", str(state)]
    rc, first = _run(main, argv + ["--quantize-int8", files["dir"], "--verbose"])
    assert rc == 0 and state.is_file()
    assert "int8-quantized with 4 calibration images" in first
    assert "saved int8 quantization state" in first
    with caplog.at_level(logging.WARNING, logger="yolov3_tpu_torch"):
        rc, second = _run(main, argv)            # loads, no calibration dir
    assert rc == 0 and not caplog.records
    assert _detection_lines(second) == _detection_lines(first)
    # quant flags beside an existing state file are ignored, and say so
    with caplog.at_level(logging.WARNING, logger="yolov3_tpu_torch"):
        rc, third = _run(main, argv + ["--quantize-int8", files["dir"],
                                       "--act-scheme", "asymmetric"])
    assert rc == 0 and _detection_lines(third) == _detection_lines(first)
    warned = [r.getMessage() for r in caplog.records]
    assert any("--quantize-int8" in m and "--act-scheme" in m and "ignored" in m
               for m in warned), warned


def test_profile_flag_writes_a_trace(files, tmp_path):
    trace = tmp_path / "trace"
    rc, text = _run(main, _base(files) + ["--device", "cpu", "--image",
                                          files["images"][0], "--profile",
                                          str(trace)])
    assert rc == 0 and "profiler trace written" in text
    assert [p for p in trace.rglob("*") if p.is_file() and p.stat().st_size]


def test_summary_and_cache_params(files, tmp_path):
    rc, text = _run(main, _base(files) + ["--device", "cpu", "--image",
                                          files["images"][0], "--summary",
                                          "--cache-params"])
    assert rc == 0 and "conv" in text.lower()
    assert list((Path(files["weights"]).parent / ".param_cache").glob("*.npz"))


ONE_LINE_ERRORS = [
    (["--image", "a.png", "--video", "b.mp4"], SystemExit, None),
    (["--image", "IMG", "--device", "nosuch:0"], SystemExit, "--device"),
    (["--image", "IMG", "--device", "cuda"], SystemExit, "--device cuda"),
    (["--image", "IMG", "--device", "cpu", "--net-size", "100"], SystemExit,
     "max stride"),
    (["--image", "IMG", "--device", "cpu", "--top-k", "0"], SystemExit, "top_k"),
    (["--image", "IMG", "--device", "cpu", "--weights", "/nonexistent/w.weights"],
     FileNotFoundError, None),
    (["--image", "/nonexistent/img.png", "--device", "cpu"], FileNotFoundError,
     "could not read image"),
    (["--image", "IMG", "--device", "cpu", "--config",
      str(MODELS / "yolov3.cfg")], ValueError, "exhausted|mismatch"),
    (["--image", "IMG", "--device", "cpu", "--spatial", "2"], SystemExit,
     "ROADMAP.md"),
    (["--image", "IMG", "--device", "cpu", "--quant-state", "/nonexistent/q.npz"],
     SystemExit, "file not found"),
    (["--image", "IMG", "--device", "cpu", "--quantize-int8", "EMPTY"],
     SystemExit, "no readable calibration images"),
    # --save-json on a stream source fails BEFORE any weights are read
    (["--video", "VIDEO", "--device", "cpu", "--save-json", "x.json",
      "--weights", "/nonexistent/w.weights"], SystemExit, "--save-json"),
    (["--cam", "--device", "cpu", "--save-json", "x.json",
      "--weights", "/nonexistent/w.weights"], SystemExit, "--save-json"),
]


@pytest.mark.parametrize("argv,exc,match", ONE_LINE_ERRORS,
                         ids=[" ".join(a[0][:6]).replace("/", "_")
                              for a in ONE_LINE_ERRORS])
def test_user_errors(files, tmp_path, argv, exc, match):
    empty = tmp_path / "empty"
    empty.mkdir()
    sub = {"IMG": files["images"][0], "VIDEO": files["video"],
           "EMPTY": str(empty)}
    argv = [sub.get(a, a) for a in argv]
    base = _base(files)
    for flag in ("--weights", "--config"):      # the case's value wins
        if flag in argv:
            i = base.index(flag)
            del base[i:i + 2]
    with pytest.raises(exc, match=match):
        with contextlib.redirect_stderr(io.StringIO()):
            main(base + argv)
