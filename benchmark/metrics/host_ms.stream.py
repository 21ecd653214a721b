"""Median over the window's batches of the host's own work on a batch in
``PipelinedDetector``: the sum of its spans that do not wait for the
device (``pad``, ``pin``, ``lookup``, ``stage``, ``launch``, ``d2h`` at
``submit``, ``unpack`` where it is handed back), over the batches both
submitted and handed back inside the window."""
import spans

HOST = ("pad", "pin", "lookup", "stage", "launch", "d2h", "unpack")


def read(run):
    calls = spans.by_call()
    if calls is None:
        return None
    return spans.median_ms(sum(c.get(n, 0.0) for n in HOST)
                           for c in calls.values()
                           if "launch" in c and "unpack" in c)
