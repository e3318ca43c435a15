"""The traced run's rate of the two-pass cell, in reads/s: the library's
reads through both passes per second. Every read is committed once by each
pass (streaming_align's align.batch after each batch's commit), so it is
the reads committed in the window over two, over the window's length.
Nothing when no batch committed."""


def read(run):
    if not run.window_committed:
        return None
    return run.window_committed / 2 / run.seconds
