"""The select kernel's share of its roofline, in %: the least time the card
could take for its launches (harness/bounds.py select_bound, from the
launch's shape) over their time in the profiler's trace of the traced
library call. Nothing when the trace holds no launch of it."""

from harness.trace import SELECT, kernel_seconds


def read(run):
    ds = kernel_seconds(run.kernels or {}, SELECT)
    if not ds:
        return None
    return 100 * len(ds) * run.select_bound_ms / (1e3 * sum(ds))
