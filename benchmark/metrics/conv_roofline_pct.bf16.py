"""The bf16 backbone against its roofline: the least time the card needs
for every conv of the batches served in the traced window (per conv the
larger of its operations at the bf16 peak and its bytes at HBM's rate,
``counts.conv_bound_s``; a bias, activation, shortcut, route or upsample
needs no bytes of its own where a kernel fuses it) over the device time of
the kernels the walk runs: cuDNN's and cuBLAS's convolutions, the port's K5,
and the bf16 element-wise, concatenation and upsampling kernels. The count
follows the cfg's shapes, whatever kernels run them."""
import counts

KERNELS = (r"fprop", r"cudnn", r"nvjet", r"gemm_bf16", r"conv3x3",
           r"BFloat16", r"nv_bfloat16", r"leaky_relu", r"OpaqueType<2u>")
# the preprocess's float32 products and the input's cast to bf16
EXCLUDE = (r"f32f32", r"sgemm", r"bfloat16_copy")


def read(run):
    if run.trace is None or not run.batches:
        return None
    t = run.trace.time_matching(KERNELS, EXCLUDE)
    if t <= 0:
        return None
    batch = int(run.cell.traffic["batch"]) // run.cell.chips
    need = run.batches * sum(counts.conv_bound_s(c, batch, "bf16")
                             for c in counts.convs(run.net, run.cell.config["width"]))
    return 100.0 * need / t
