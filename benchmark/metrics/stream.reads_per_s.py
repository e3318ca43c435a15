"""The traced run's rate, in reads/s: the reads of every batch that
streaming_align committed in the window, over the window's length, as
reads_per_s is taken in an untraced run (with the stage timers on).
For the cells whose host-bound rate spreads too widely between runs to
hold a bound as an end-to-end metric. Nothing when no batch committed."""


def read(run):
    if not run.window_committed:
        return None
    return run.window_committed / run.seconds
