"""The int8 walk outside K6 against its roofline: the least time the card
needs for the int8 convolutions that K6's residual blocks do not take (per
conv the larger of its operations at the int8 peak and its int8 bytes at
HBM's rate, ``counts.conv_bound_s``) over the device time of every kernel of
the walk but K6's, the bf16 stem and head convolutions, the preprocess,
the decode and the selection and suppression: the int8 products, im2col,
the quantize and requantize element-wise kernels, pools and routes."""
import counts

EXCLUDE = (r"block_int8_kernel", r"fprop", r"cudnn", r"gemm_bf16", r"nvjet",
           r"f32f32", r"sgemm", r"decode_heads_kernel", r"nms_", r"[Ss]ort",
           r"scatter_gather", r"reduce_kernel", r"flip_kernel", r"Memcpy",
           r"Memset", r"memset", r"memcpy", r"where_kernel")


def read(run):
    if run.trace is None or not run.batches:
        return None
    t = run.trace.time_matching((r".",), EXCLUDE)
    if t <= 0:
        return None
    size = run.cell.config["width"]
    fused = {i for blk in counts.residual_blocks(run.net)
             for i in blk[:2]}
    batch = int(run.cell.traffic["batch"]) // run.cell.chips
    need = run.batches * sum(counts.conv_bound_s(c, batch, "int8")
                             for c in counts.convs(run.net, size)
                             if counts.int8_quantized(c) and c.index not in fused)
    return 100.0 * need / t
