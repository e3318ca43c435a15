"""The process's host CPU time (user and system, every thread) per read
streamed in the window, in microseconds: the window's CPU seconds over the
reads of the library calls that ran in it. Beside reads_per_s it tells
less work a read from more of the work overlapped, and a slower host from
a slower program. Nothing when the window ran no call."""


def read(run):
    if not run.window_reads:
        return None
    return 1e6 * run.window_cpu_s / run.window_reads
