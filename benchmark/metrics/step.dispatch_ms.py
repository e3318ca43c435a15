"""Main-thread time in the engine's step (host packing, upload, graph
replay enqueue), per batch.

Reads the traced run's stage timers (harness/probe.py): main.dispatch's
seconds over the window's library calls, in milliseconds per batch
dispatched (0 when the stage was never entered). Nothing when the engine
has no such stage."""


def read(run):
    t = (run.timers or {}).get("main.dispatch")
    if t is None or not run.batches:
        return None
    return 1e3 * t["seconds"] / run.batches
