"""K6, the fused int8 residual block, against its roofline: the least time
the card needs for the blocks it takes (each reads its int8 input and both
weights once and writes its int8 output once; both convolutions' operations
at the int8 peak; ``counts.block_bound_s``) over the device time of K6's
kernel in the traced window."""
import counts

KERNELS = (r"block_int8_kernel",)


def read(run):
    if run.trace is None or not run.batches:
        return None
    t = run.trace.time_matching(KERNELS)
    if t <= 0:
        return None
    batch = int(run.cell.traffic["batch"]) // run.cell.chips
    need = run.batches * counts.block_bound_s(run.net, run.cell.config["width"],
                                              batch)
    return 100.0 * need / t
