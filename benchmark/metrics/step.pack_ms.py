"""Main-thread time packing a batch's reads into the wire's 2-bit codes and
N mask on the host (pack_codes_host), per batch dispatched.

Reads the program's own spans of the traced window (parasuite_tpu_torch/
utils/runlog.py): the inclusive seconds of every `step.pack` span over the
number of `step.dispatch` spans, in milliseconds. Nothing when no batch
was dispatched or the step packs no wire (the unpacked step)."""


def read(run):
    pack = run.spans.get("step.pack")
    n = run.spans.get("step.dispatch", {}).get("calls", 0)
    if pack is None or not n:
        return None
    return 1e3 * pack["seconds"] / n
