"""Self-contained demo of the PyTorch + CUDA port: build a model, synthesize
weights, detect, draw.

The twin of ``examples/demo.py`` on ``yolov3_tpu_torch``. No downloads:
random weights and a random image, through the same code paths real
weights use. Runs on the card unless ``--device cpu``:

    python examples/demo_torch.py [--precision bf16] [--cfg yolov3-tiny.cfg] \
        [--device cuda|cuda:N|cpu]
"""
import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", default="yolov3-tiny.cfg")
    ap.add_argument("--precision", default=None,
                    choices=(None, "default", "highest", "bf16"))
    ap.add_argument("--out", default="demo_out.jpg")
    ap.add_argument("--device", default=None,
                    help="cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)

    import cv2

    from yolov3_tpu_torch.__main__ import _resolve_device
    from yolov3_tpu_torch.graph import load_graph
    from yolov3_tpu_torch.inference import Detector
    from yolov3_tpu_torch.model import Darknet
    from yolov3_tpu_torch.utils.drawing import draw_boxes, load_class_names
    from yolov3_tpu_torch.weights import random_raw, write_weights

    device = _resolve_device(args.device)
    cfg = REPO / "models" / args.cfg
    graph = load_graph(cfg)
    print(graph.summary())

    precision = None if args.precision == "default" else args.precision
    with tempfile.TemporaryDirectory() as tmp:
        print("\nsynthesizing random weights (real ones: models/get_weights.sh)")
        wpath = Path(tmp) / "demo.weights"
        write_weights(wpath, graph, random_raw(graph, seed=0))
        net = Darknet(cfg, precision=precision,
                      device=device).load_weights(wpath)

    detector = Detector(net, prob_thresh=0.35)
    frame = np.random.default_rng(0).integers(0, 256, (480, 640, 3),
                                              dtype=np.uint8)
    (result,) = detector.detect_batch(frame[None])
    names = load_class_names(REPO / "models" / "coco.names")
    print(f"\n{len(result.bbox_tlbr)} detections on {device} "
          f"(random weights → random boxes):")
    for box, prob, cls in list(zip(result.bbox_tlbr, result.class_prob,
                                   result.class_idx))[:10]:
        print(f"  {names[int(cls)]:20s} {prob:.3f} "
              f"({box[0]:.0f},{box[1]:.0f},{box[2]:.0f},{box[3]:.0f})")

    draw_boxes(frame, result, class_names=names)
    cv2.imwrite(args.out, frame)
    print(f"\nannotated image written to {args.out}")
    return result


if __name__ == "__main__":
    main()
