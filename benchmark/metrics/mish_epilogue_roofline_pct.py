"""The conv epilogue's Mish kernel against its roofline: the least time the
card needs to read and write once, in bf16, the output of every Mish conv
of the batches served in the traced window, and to read once the residual
of each of them that a shortcut right after it adds (YOLOv4@608: 72 Mish
convs, 23 residuals; 13.3 GB a batch of 32, 3.98 ms at HBM's rate), over
the device time of ``conv_epilogue_mish_kernel`` in the window. The bytes
follow the cfg's shapes; the kernel's biases, a few KB, are left out."""
import counts

KERNELS = (r"conv_epilogue_mish_kernel",)
BF16_BYTES = 2


def mish_bytes(net, size: int, batch: int) -> int:
    """bf16 bytes of the Mish epilogues of one batch: each Mish conv's
    output read and written, plus the residual a shortcut right after the
    conv adds, read."""
    total = 0
    for l in net.convs:
        if l.opts.get("activation") != "mish":
            continue
        hw = size // l.stride
        elems = batch * hw * hw * l.channels
        nxt = net.layers[l.index + 1] if l.index + 1 < len(net.layers) else None
        residual = (nxt is not None and nxt.kind == "shortcut"
                    and nxt.inputs[0] == l.index)
        total += (3 if residual else 2) * elems * BF16_BYTES
    return total


def read(run):
    if run.trace is None or not run.batches:
        return None
    t = run.trace.time_matching(KERNELS)
    if t <= 0:
        return None
    batch = int(run.cell.traffic["batch"]) // run.cell.chips
    need = run.batches * mish_bytes(run.net, run.cell.config["width"],
                                    batch) / counts.HBM_BYTES_PER_S
    return 100.0 * need / t
