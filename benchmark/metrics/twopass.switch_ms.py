"""Main-thread time between the two passes of a two-pass call, per call:
the error profile made and saved, the learned score tensor computed and set
on the engine.

Reads the program's own spans of the traced window (parasuite_tpu_torch/
utils/runlog.py): the inclusive seconds of the `twopass.switch` spans over
their number, in milliseconds. Nothing where no two-pass call ran."""


def read(run):
    s = run.spans.get("twopass.switch")
    if not s or not s["calls"]:
        return None
    return 1e3 * s["seconds"] / s["calls"]
