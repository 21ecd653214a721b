"""Generate the standard Darknet .cfg model assets (yolov3, yolov3-tiny,
yolov3-spp) and coco.names.

A copy of ``tools/gen_cfgs.py`` inside the port, which imports nothing of
the JAX package or of ``tools/``: the published Darknet-53 architecture
(YOLOv3 paper, arXiv 1804.02767) written out as the ``.cfg`` files any
``yolov3.weights`` file is keyed to. Its output is byte-equal to
``models/*.cfg`` and ``models/coco.names``
(``tests/test_torch_tools.py``).

Run:  python -m yolov3_tpu_torch.tools.gen_cfgs [outdir]   (default: models)
"""
import sys
from pathlib import Path

NET_HEADER = """\
[net]
# Testing
batch=1
subdivisions=1
# Training
# batch=64
# subdivisions=16
width={width}
height={height}
channels=3
momentum=0.9
decay=0.0005
angle=0
saturation = 1.5
exposure = 1.5
hue=.1

learning_rate=0.001
burn_in=1000
max_batches = 500200
policy=steps
steps=400000,450000
scales=.1,.1
"""

YOLOV3_ANCHORS = "10,13,  16,30,  33,23,  30,61,  62,45,  59,119,  116,90,  156,198,  373,326"
TINY_ANCHORS = "10,14,  23,27,  37,58,  81,82,  135,169,  344,319"


def conv(filters, size, stride=1, bn=True, activation="leaky"):
    lines = ["[convolutional]"]
    if bn:
        lines.append("batch_normalize=1")
    lines.append(f"filters={filters}")
    lines.append(f"size={size}")
    lines.append(f"stride={stride}")
    lines.append("pad=1")
    lines.append(f"activation={activation}")
    return "\n".join(lines) + "\n"


def shortcut(frm=-3):
    return f"[shortcut]\nfrom={frm}\nactivation=linear\n"


def route(layers):
    return f"[route]\nlayers = {layers}\n"


def upsample():
    return "[upsample]\nstride=2\n"


def maxpool(size, stride):
    return f"[maxpool]\nsize={size}\nstride={stride}\n"


def yolo(mask, anchors, classes=80, num=9):
    return (
        "[yolo]\n"
        f"mask = {mask}\n"
        f"anchors = {anchors}\n"
        f"classes={classes}\n"
        f"num={num}\n"
        "jitter=.3\n"
        "ignore_thresh = .7\n"
        "truth_thresh = 1\n"
        "random=1\n"
    )


def residual(inner, outer):
    """One Darknet-53 residual: 1x1 bottleneck -> 3x3 -> shortcut(-3)."""
    return [conv(inner, 1), conv(outer, 3), shortcut(-3)]


def darknet53_backbone():
    blocks = [conv(32, 3)]
    # (downsample filters, n residual blocks)
    for filters, n_res in [(64, 1), (128, 2), (256, 8), (512, 8), (1024, 4)]:
        blocks.append("# Downsample\n\n" + conv(filters, 3, stride=2))
        for _ in range(n_res):
            blocks.extend(residual(filters // 2, filters))
    return blocks


def head_convs(c, n_pairs=3, out_filters=255):
    """Detection head: alternating 1x1(c)/3x3(2c) convs then a linear 1x1."""
    blocks = []
    for _ in range(n_pairs):
        blocks.append(conv(c, 1))
        blocks.append(conv(2 * c, 3))
    # final head conv: no BN, linear activation
    blocks.append(conv(out_filters, 1, bn=False, activation="linear"))
    return blocks


def gen_yolov3(width=416, height=416):
    blocks = [NET_HEADER.format(width=width, height=height)]
    blocks += darknet53_backbone()  # layers 0..74
    # Head 1 (13x13 @416): layers 75..81, yolo 82
    blocks += head_convs(512)
    blocks.append(yolo("6,7,8", YOLOV3_ANCHORS))
    # layers 83..85
    blocks.append(route("-4"))
    blocks.append(conv(256, 1))
    blocks.append(upsample())
    blocks.append(route("-1, 61"))
    # Head 2: 87..93, yolo 94
    blocks += head_convs(256)
    blocks.append(yolo("3,4,5", YOLOV3_ANCHORS))
    blocks.append(route("-4"))
    blocks.append(conv(128, 1))
    blocks.append(upsample())
    blocks.append(route("-1, 36"))
    # Head 3: 99..105, yolo 106
    blocks += head_convs(128)
    blocks.append(yolo("0,1,2", YOLOV3_ANCHORS))
    return "\n".join(blocks)


def gen_yolov3_spp(width=608, height=608):
    blocks = [NET_HEADER.format(width=width, height=height)]
    blocks += darknet53_backbone()  # 0..74
    # Pre-SPP convs 75..77
    blocks += [conv(512, 1), conv(1024, 3), conv(512, 1)]
    # SPP block: maxpools 5/9/13 stride 1 + 4-way route (layers 78..83)
    blocks.append("### SPP ###\n\n" + maxpool(5, 1))
    blocks.append(route("-2"))
    blocks.append(maxpool(9, 1))
    blocks.append(route("-4"))
    blocks.append(maxpool(13, 1))
    blocks.append(route("-1,-3,-5,-6"))
    blocks.append("### End SPP ###\n\n" + conv(512, 1))
    # remaining head-1 convs 85..88, yolo 89
    blocks += [conv(1024, 3), conv(512, 1), conv(1024, 3),
               conv(255, 1, bn=False, activation="linear")]
    blocks.append(yolo("6,7,8", YOLOV3_ANCHORS))
    blocks.append(route("-4"))
    blocks.append(conv(256, 1))
    blocks.append(upsample())
    blocks.append(route("-1, 61"))
    blocks += head_convs(256)
    blocks.append(yolo("3,4,5", YOLOV3_ANCHORS))
    blocks.append(route("-4"))
    blocks.append(conv(128, 1))
    blocks.append(upsample())
    blocks.append(route("-1, 36"))
    blocks += head_convs(128)
    blocks.append(yolo("0,1,2", YOLOV3_ANCHORS))
    return "\n".join(blocks)


def gen_yolov3_tiny(width=416, height=416):
    blocks = [NET_HEADER.format(width=width, height=height)]
    # Backbone: conv/maxpool chain. Layers 0..12
    for filters in [16, 32, 64, 128, 256]:
        blocks.append(conv(filters, 3))
        blocks.append(maxpool(2, 2))
    blocks.append(conv(512, 3))
    blocks.append(maxpool(2, 1))  # the size-preserving stride-1 maxpool
    blocks.append(conv(1024, 3))
    # Head 1: layers 13..15, yolo 16
    blocks.append(conv(256, 1))
    blocks.append(conv(512, 3))
    blocks.append(conv(255, 1, bn=False, activation="linear"))
    blocks.append(yolo("3,4,5", TINY_ANCHORS, num=6))
    # Head 2: route to layer 13 output
    blocks.append(route("-4"))
    blocks.append(conv(128, 1))
    blocks.append(upsample())
    blocks.append(route("-1, 8"))
    blocks.append(conv(256, 3))
    blocks.append(conv(255, 1, bn=False, activation="linear"))
    blocks.append(yolo("0,1,2", TINY_ANCHORS, num=6))
    return "\n".join(blocks)


COCO_NAMES = """person bicycle car motorbike aeroplane bus train truck boat \
traffic_light fire_hydrant stop_sign parking_meter bench bird cat dog horse sheep cow \
elephant bear zebra giraffe backpack umbrella handbag tie suitcase frisbee skis \
snowboard sports_ball kite baseball_bat baseball_glove skateboard surfboard \
tennis_racket bottle wine_glass cup fork knife spoon bowl banana apple sandwich orange \
broccoli carrot hot_dog pizza donut cake chair sofa pottedplant bed diningtable toilet \
tvmonitor laptop mouse remote keyboard cell_phone microwave oven toaster sink \
refrigerator book clock vase scissors teddy_bear hair_drier toothbrush"""


def coco_names():
    # The published coco.names uses spaces inside names; restore them.
    return "\n".join(n.replace("_", " ") for n in COCO_NAMES.split()) + "\n"


def main(outdir="models"):
    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "yolov3.cfg").write_text(gen_yolov3())
    (out / "yolov3-spp.cfg").write_text(gen_yolov3_spp())
    (out / "yolov3-tiny.cfg").write_text(gen_yolov3_tiny())
    (out / "coco.names").write_text(coco_names())
    print(f"wrote yolov3.cfg / yolov3-spp.cfg / yolov3-tiny.cfg / coco.names to {out}")


if __name__ == "__main__":
    main(*sys.argv[1:])
