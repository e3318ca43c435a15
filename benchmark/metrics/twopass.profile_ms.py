"""Main-thread time of pass 1's profile accounting, per pass-1 batch: the
device counts' copy to the host and the host's counting of the gapped
rows' CIGARs (or, in combined mode, of every emitted record).

Reads the program's own spans of the traced window (parasuite_tpu_torch/
utils/runlog.py): the inclusive seconds of the `engine.profile` spans over
their number, in milliseconds. Nothing where no pass counted a profile."""


def read(run):
    s = run.spans.get("engine.profile")
    if not s or not s["calls"]:
        return None
    return 1e3 * s["seconds"] / s["calls"]
