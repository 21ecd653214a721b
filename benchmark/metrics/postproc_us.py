"""Device microseconds a batch of the decode (K1), the candidate selection
(the sorts and gathers of ``ops/nms.py``) and the suppression (K2) kernels
take in the traced window."""

KERNELS = (r"decode_heads_kernel", r"nms_bits_kernel", r"nms_walk_kernel",
           r"[Ss]ort", r"scatter_gather", r"reduce_kernel", r"where_kernel")


def read(run):
    if run.trace is None or not run.batches:
        return None
    t = run.trace.time_matching(KERNELS)
    return 1e6 * t / run.batches if t > 0 else None
