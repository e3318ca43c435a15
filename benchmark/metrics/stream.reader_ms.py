"""Reader-thread time in iter_fastq_batches (FASTQ -> ReadBatch), per
batch.

Reads the traced run's stage timers (harness/probe.py):
reader.next_batch's seconds over the window's library calls, in
milliseconds per batch dispatched (0 when the stage was never entered).
Nothing when the engine has no such stage."""


def read(run):
    t = (run.timers or {}).get("reader.next_batch")
    if t is None or not run.batches:
        return None
    return 1e3 * t["seconds"] / run.batches
