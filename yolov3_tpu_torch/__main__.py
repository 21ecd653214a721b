"""CLI entry point: the JAX package's surface (``python -m yolov3_tpu``), flag
for flag: mutually exclusive ``--image | --image-dir | --video | --cam``
sources; ``--config/--weights/--class-names/--prob-thresh/--iou-thresh/
--output/--show-fps/--verbose``; plus ``--batch-size``, ``--net-size``,
``--resize-mode``, ``--precision`` and the kernel-route switches.

    python -m yolov3_tpu_torch --image dog.jpg \
        --config models/yolov3.cfg --weights yolov3.weights \
        --class-names models/coco.names

Runs on the card (``--device cuda``, the default) unless ``--device cpu`` is
asked for; without a card it exits with one line, never on the CPU instead.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="yolov3_tpu_torch",
        description="YOLOv3 object detection in PyTorch + CUDA")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--image", "-i", metavar="PATH", help="path to an image file")
    src.add_argument("--image-dir", "-I", metavar="DIR",
                     help="directory of images (batched inference)")
    src.add_argument("--video", "-v", metavar="PATH", help="path to a video file")
    src.add_argument("--cam", "-c", metavar="ID", nargs="?", const="0",
                     help="webcam device id (default 0)")

    p.add_argument("--config", "-C", default="models/yolov3.cfg",
                   help="darknet .cfg path")
    p.add_argument("--weights", "-W", default="models/yolov3.weights",
                   help="darknet .weights path")
    p.add_argument("--class-names", "-N", default="models/coco.names",
                   help=".names file with one class per line")
    p.add_argument("--device", default=None,
                   help="torch device: cuda, cuda:N or cpu; default = the "
                        "card (exits when there is none)")
    p.add_argument("--prob-thresh", "-p", type=float, default=0.05,
                   help="detection probability threshold (obj × class prob)")
    p.add_argument("--iou-thresh", type=float, default=0.3,
                   help="NMS IoU suppression threshold")
    p.add_argument("--output", "-o", default=None,
                   help="output image/video path, or directory for --image-dir")
    p.add_argument("--show-fps", action="store_true",
                   help="overlay rolling FPS on video/cam output")
    p.add_argument("--no-show", action="store_true",
                   help="do not open display windows (headless)")
    p.add_argument("--verbose", "-V", action="store_true")
    p.add_argument("--batch-size", "-b", type=int, default=32,
                   help="device batch for --image-dir / video batching")
    p.add_argument("--frame-batch", type=int, default=1,
                   help="frames per device step for --video")
    p.add_argument("--scan", type=int, default=1,
                   help="sub-batches per detect call, enqueued back to back "
                        "with one result copy for all of them (throughput "
                        "batch work, --image-dir); raises per-call latency "
                        "to scan x the step time. Results equal those of "
                        "the same sub-batches run one by one; on the card "
                        "they can differ in the last bits from --scan 1, "
                        "whose convs see one larger batch")
    p.add_argument("--pipeline-depth", type=int, default=None,
                   help="batches kept in flight on the device for --cam / "
                        "--video (overlaps device work with draw/show/encode; "
                        "output lags by this many batches; 0 = synchronous; "
                        "default: 0 for --cam, 1 for --video)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="capture a torch.profiler trace of the run into DIR "
                        "(Chrome trace format) and print host-side "
                        "per-stage timings where the entry point records "
                        "them")
    p.add_argument("--output-fps", type=float, default=None,
                   help="container FPS for --cam --output recordings "
                        "(default: the measured loop rate over a short "
                        "warmup)")
    p.add_argument("--net-size", type=int, default=None,
                   help="override net input resolution (e.g. 320/416/608)")
    p.add_argument("--resize-mode", choices=("letterbox", "stretch"),
                   default="letterbox", help="preprocessing geometry")
    p.add_argument("--precision", choices=("default", "highest", "bf16"),
                   default="default",
                   help="conv precision: 'highest' pins fp32 (parity), "
                        "'default' allows TF32 in the convs, 'bf16' runs "
                        "convs fully in bfloat16 (fastest; decode stays fp32)")
    p.add_argument("--top-k", type=int, default=None,
                   help="static NMS candidate cap per image (default: auto "
                        "preset: 512, or 256 for tiny-class graphs whose "
                        "candidate space is <=4096)")
    p.add_argument("--max-results", type=int, default=128,
                   help="max returned detections per image (0 = all top-k "
                        "slots; smaller = less device->host transfer)")
    p.add_argument("--cache-params", action="store_true",
                   help="cache converted/folded params on disk for fast reload")
    p.add_argument("--quantize-int8", metavar="CALIB_DIR", default=None,
                   help="post-training int8 quantization, calibrated on the "
                        "images in CALIB_DIR (on an H100 the int8 routes are "
                        "slower than bf16 at batch 8: PERF.md)")
    p.add_argument("--calib-method", choices=("absmax", "percentile"),
                   default="absmax",
                   help="activation-scale statistic for --quantize-int8: "
                        "absmax (never clips) or percentile (clips rare "
                        "outliers for finer int8 resolution elsewhere)")
    p.add_argument("--calib-percentile", type=float, default=99.9,
                   help="percentile q for --calib-method percentile")
    p.add_argument("--save-json", metavar="PATH", default=None,
                   help="write detections as COCO-results JSON "
                        "(--image / --image-dir sources; contiguous "
                        "category ids + names, see utils/export.py)")
    p.add_argument("--quant-state", metavar="PATH", default=None,
                   help="int8 quantization-state cache (npz): load it if "
                        "PATH exists (skips calibration entirely; other "
                        "quantization flags are then ignored, with a "
                        "warning); otherwise calibrate via --quantize-int8 "
                        "and save the result to PATH")
    p.add_argument("--no-bias-correct", action="store_true",
                   help="skip the bias correction applied after "
                        "--quantize-int8 by default (folds the measured "
                        "per-channel quantization shift into conv biases; "
                        "zero runtime cost)")
    p.add_argument("--act-scheme", choices=("symmetric", "asymmetric"),
                   default="symmetric",
                   help="activation quantization scheme for --quantize-int8: "
                        "asymmetric adds per-tensor zero-points (one-sided "
                        "LeakyReLU activations nearly double their int8 "
                        "resolution; zero-point terms fold into conv "
                        "epilogues)")
    p.add_argument("--conv-impl", choices=("xla", "pallas"), default="xla",
                   help="conv backend for eligible 3x3 layers (xla = cuDNN, "
                        "pallas = the hand-written fused kernel)")
    p.add_argument("--nms-impl", choices=("xla", "pallas"), default="xla",
                   help="NMS suppression backend (on the card both names "
                        "run the suppression kernel)")
    p.add_argument("--decode-impl",
                   choices=("xla", "pallas", "pallas-fused"),
                   default="pallas",
                   help="head decode backend (pallas = the packed decode "
                        "kernel, the serving default; pallas-fused "
                        "additionally runs the 1x1 head convs inside the "
                        "kernel; xla = plain tensor decode)")
    p.add_argument("--block-impl", choices=("xla", "pallas"),
                   default="xla",
                   help="residual-block backend on the int8 path (pallas = "
                        "the fused 1x1->3x3->shortcut kernel, "
                        "ops/cuda_block.py)")
    p.add_argument("--select-group", type=int, default=2,
                   help="group-max selection width G (exact top-k for any "
                        "G; trades the top-k term against the final G*k "
                        "sort)")
    p.add_argument("--spatial", type=int, default=None, metavar="N",
                   help="shard EACH image's rows over N cards (latency "
                        "mode: halo-exchange convs + channel-pair tail, "
                        "parallel/spatial.py); needs N visible cards (N "
                        "CPU shards with --device cpu) and float precision")
    p.add_argument("--summary", action="store_true",
                   help="print the darknet-style layer table before running")
    p.add_argument("--no-compile-cache", action="store_true",
                   help="accepted for compatibility with the JAX package's "
                        "CLI and does nothing: a Detector captures one CUDA "
                        "graph per (batch, source shape) key, taking "
                        "0.04-15 s, and a captured graph cannot outlive its "
                        "process")
    return p


QUANT_FLAGS = (("quantize_int8", "--quantize-int8"),
               ("calib_method", "--calib-method"),
               ("calib_percentile", "--calib-percentile"),
               ("no_bias_correct", "--no-bias-correct"),
               ("act_scheme", "--act-scheme"))


def _resolve_device(arg):
    """``--device`` → torch.device, or a one-line SystemExit."""
    import torch

    name = arg or "cuda"
    try:
        dev = torch.device(name)
    except RuntimeError as e:
        raise SystemExit(f"--device {name}: {str(e).splitlines()[0]}")
    if dev.type not in ("cuda", "cpu"):
        raise SystemExit(f"--device {name}: expected cuda, cuda:N or cpu")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(
                f"--device {name}: torch.cuda.is_available() is False (this "
                f"package runs on the card; ask for the CPU with --device cpu)")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise SystemExit(f"--device {name}: only "
                             f"{torch.cuda.device_count()} CUDA device(s)")
    return dev


def _profiler(trace_dir):
    """A ``torch.profiler`` context that writes one Chrome trace into
    ``trace_dir`` (host and, on the card, device activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)

    def save(prof):
        prof.export_chrome_trace(str(out / "trace.json"))

    return profile(activities=activities, on_trace_ready=save)


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)

    import logging

    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    log = logging.getLogger("yolov3_tpu_torch")

    # user errors that need no model come first: one line, before any
    # weights are read
    if args.save_json and not (args.image or args.image_dir):
        raise SystemExit("--save-json needs an --image or --image-dir "
                         "source (video/cam streams have no image ids)")
    device = _resolve_device(args.device)

    from .inference import (Detector, detect_directory, detect_image,
                            detect_in_cam, detect_in_video)
    from .model import Darknet
    from .utils.drawing import load_class_names

    precision = None if args.precision == "default" else args.precision
    net = Darknet(args.config, precision=precision, conv_impl=args.conv_impl,
                  device=device)
    if args.summary:
        print(net.graph.summary(args.net_size, args.net_size))
    if args.verbose:
        print(f"loaded {net.graph.name}: {len(net.graph.nodes)} layers, "
              f"net {net.net_size[1]}x{net.net_size[0]}, "
              f"{len(net.graph.yolo_nodes)} heads")
    net.load_weights(args.weights, cache=args.cache_params)

    if args.quant_state and Path(args.quant_state).exists():
        given = [flag for dest, flag in QUANT_FLAGS
                 if getattr(args, dest) != parser.get_default(dest)]
        if given:
            log.warning("--quant-state %s exists and is loaded as it is: %s "
                        "ignored (delete the file to calibrate anew)",
                        args.quant_state, ", ".join(given))
        try:
            net.load_quantized(args.quant_state)
        except ValueError as e:
            raise SystemExit(str(e))
        if args.verbose:
            print(f"loaded int8 quantization state from {args.quant_state}")
    elif args.quantize_int8:
        from .quant import load_calibration_dir

        calib = load_calibration_dir(args.quantize_int8)
        size = (args.net_size, args.net_size) if args.net_size else None
        # calibration must use the SAME preprocessing as serving
        net.quantize_int8(calib, net_hw=size, mode=args.resize_mode,
                          calib_method=args.calib_method,
                          calib_percentile=args.calib_percentile,
                          bias_correct=not args.no_bias_correct,
                          act_scheme=args.act_scheme)
        if args.verbose:
            print(f"int8-quantized with {len(calib)} calibration images")
        if args.quant_state:
            net.save_quantized(args.quant_state)
            if args.verbose:
                print(f"saved int8 quantization state to {args.quant_state}")
    elif args.quant_state:
        raise SystemExit(f"--quant-state {args.quant_state}: file not found "
                         "(pass --quantize-int8 CALIB_DIR to create it)")

    net_hw = (args.net_size, args.net_size) if args.net_size else None
    mesh, partition = None, "data"
    if args.spatial:
        from .parallel.spatial import make_spatial_mesh

        if args.spatial < 2:
            raise SystemExit(f"--spatial {args.spatial}: needs >= 2 devices")
        try:  # --device cpu: N CPU shards; else N visible cards
            mesh = make_spatial_mesh(args.spatial, devices=(
                [device] * args.spatial if device.type == "cpu" else None))
        except ValueError as e:
            raise SystemExit(f"--spatial {args.spatial}: {e}")
        partition = "spatial"
    try:
        detector = Detector(net, prob_thresh=args.prob_thresh,
                            iou_thresh=args.iou_thresh,
                            resize_mode=args.resize_mode, top_k=args.top_k,
                            net_hw=net_hw, nms_impl=args.nms_impl,
                            decode_impl=args.decode_impl,
                            max_results=args.max_results, scan=args.scan,
                            mesh=mesh, partition=partition,
                            select_group=args.select_group,
                            block_impl=args.block_impl)
    except ValueError as e:
        # bad knob values (net size not a stride multiple, thresholds out
        # of range, ...) are user errors: one line, not a traceback
        raise SystemExit(f"error: {e}")
    class_names = (load_class_names(args.class_names)
                   if Path(args.class_names).exists() else None)

    import contextlib

    prof = _profiler(args.profile) if args.profile else contextlib.nullcontext()
    with prof:
        if args.image:
            result = detect_image(detector, args.image,
                                  class_names=class_names,
                                  output_path=args.output,
                                  show=not args.no_show,
                                  verbose=args.verbose)
            for box, prob, cls in zip(result.bbox_tlbr, result.class_prob,
                                      result.class_idx):
                name = (class_names[int(cls)] if class_names
                        else str(int(cls)))
                print(f"{name:20s} {prob:.3f}  tlbr=({box[0]:.0f},"
                      f"{box[1]:.0f},{box[2]:.0f},{box[3]:.0f})")
            if args.save_json:
                from .utils.export import save_detections_json

                n = save_detections_json(
                    args.save_json, {Path(args.image).name: result},
                    class_names)
                if args.verbose:
                    print(f"wrote {n} detections to {args.save_json}")
        elif args.image_dir:
            if args.output:
                Path(args.output).mkdir(parents=True, exist_ok=True)
            results = detect_directory(detector, args.image_dir,
                                       batch_size=args.batch_size,
                                       class_names=class_names,
                                       output_dir=args.output, verbose=True)
            total = sum(len(r.bbox_tlbr) for r in results.values())
            print(f"{len(results)} images, {total} detections")
            if args.save_json:
                from .utils.export import save_detections_json

                n = save_detections_json(args.save_json, results,
                                         class_names)
                print(f"wrote {n} detections to {args.save_json}")
        elif args.video:
            detect_in_video(detector, args.video, class_names=class_names,
                            output_path=args.output, show=not args.no_show,
                            show_fps=args.show_fps,
                            frame_batch=args.frame_batch,
                            pipeline_depth=(1 if args.pipeline_depth is None
                                            else args.pipeline_depth),
                            verbose=True)
        else:
            cam = int(args.cam) if str(args.cam).isdigit() else args.cam
            detect_in_cam(detector, cam, class_names=class_names,
                          show_fps=args.show_fps, output_path=args.output,
                          show=not args.no_show,
                          pipeline_depth=args.pipeline_depth or 0,
                          output_fps=args.output_fps)
    if args.profile:
        print(f"profiler trace written to {args.profile}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
