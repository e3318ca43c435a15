"""Writer-thread time in the engine's emit_sam (native SAM formatting and
the writes), per batch.

Reads the traced run's stage timers (harness/probe.py): writer.emit's
seconds over the window's library calls, in milliseconds per batch
dispatched (0 when the stage was never entered). Nothing when the engine
has no such stage."""


def read(run):
    t = (run.timers or {}).get("writer.emit")
    if t is None or not run.batches:
        return None
    return 1e3 * t["seconds"] / run.batches
