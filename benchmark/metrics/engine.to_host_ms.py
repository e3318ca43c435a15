"""Main-thread time in the engine's to_host (the fetch, tracebacks and host
finishing), inclusive, per batch.

Reads the traced run's stage timers (harness/probe.py): main.to_host's
seconds over the window's library calls, in milliseconds per batch
dispatched (0 when the stage was never entered). Nothing when the engine
has no such stage."""


def read(run):
    t = (run.timers or {}).get("main.to_host")
    if t is None or not run.batches:
        return None
    return 1e3 * t["seconds"] / run.batches
