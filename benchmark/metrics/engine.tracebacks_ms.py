"""Self time of host_tracebacks_batch (the batched gapped DP and its
walks), per batch.

Reads the traced run's stage timers (harness/probe.py):
main.to_host.host_tracebacks_batch's self_seconds over the window's
library calls, in milliseconds per batch dispatched (0 when the stage
was never entered). Nothing when the engine has no such stage."""


def read(run):
    t = (run.timers or {}).get("main.to_host.host_tracebacks_batch")
    if t is None or not run.batches:
        return None
    return 1e3 * t["self_seconds"] / run.batches
