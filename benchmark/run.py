"""One run of one benchmark cell, from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result (``harness.measure``); the
numbers compared with the reference, each beside its limit, are the last
lines of standard error. Exits 1 without a result when the card (or the
cards the cell asks for) is missing, or when the program under test is not
beside this directory.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

if __name__ == "__main__":
    import harness

    sys.exit(harness.main(t_start=T_START))
