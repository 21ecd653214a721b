"""Process start to the first timed call: imports, frames and weights made
from the seed, (int8) calibration and quantization, the program's kernels
built and its CUDA graph captured, the warm-up batches."""


def read(run):
    return run.setup_s
