"""Median over the window's calls of the program's ``lookup`` and
``launch`` spans of one call: the program cache's lookup
(``Detector._pipeline``) and the graph's replay queued
(``_CapturedProgram.__call__``)."""
import spans


def read(run):
    calls = spans.by_call()
    if calls is None:
        return None
    return spans.median_ms(c["lookup"] + c["launch"] for c in calls.values()
                           if "lookup" in c and "launch" in c)
