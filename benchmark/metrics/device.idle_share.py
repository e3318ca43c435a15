"""The device's idle share of the traced sub-window, in %: 1 - (the union
of its kernel, copy and set intervals) / the sub-window's wall time, from
the profiler's trace of the traced library call. Nothing without a trace."""


def read(run):
    if not run.window_s:
        return None
    return 100 * (1 - run.busy_s / run.window_s)
