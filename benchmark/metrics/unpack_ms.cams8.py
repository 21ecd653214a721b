"""Median over the window's calls of the program's ``unpack`` span: the
host turning a call's packed results into ``Detection``s in source pixels
(``Detector._unpack``), after the device wait and the copy."""
import spans


def read(run):
    calls = spans.by_call()
    if calls is None:
        return None
    return spans.median_ms(c["unpack"] for c in calls.values() if "unpack" in c)
