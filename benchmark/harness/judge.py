"""The comparison that decides `correct`: a sample of the SAM records the
timed path wrote in its last library call (as the engine handed them to its
writer: harness/system.py::SamTap), drawn from the seed, each held to the
plain reference's line for the same read, byte for byte.

Numbers compared, each with its limit:
  records_differ  sampled records whose line is not the reference's (0)
  calls_short     library calls, the warm-up's and the window's, whose
                  record count is not the library's size, and the judged
                  call if the records it wrote are not as many (0)
"""

from __future__ import annotations

import numpy as np

from harness import world

LIMITS = {"records_differ": 0, "calls_short": 0}


def sample(n_reads: int, k: int, seed: int) -> np.ndarray:
    """k distinct read indices, ascending, from the seed's own stream."""
    rng = world.rng_for(seed, world.SAMPLE)
    return np.sort(rng.choice(n_reads, min(k, n_reads), replace=False))


def judge(recs: list, lines: list, idx: np.ndarray) -> tuple:
    """-> (records_differ, [(read index, got, want)] of the first few)."""
    bad = []
    for i, want in zip(idx, lines):
        got = recs[i] if i < len(recs) else b"<missing>"
        if got != want:
            bad.append((int(i), got, want))
    return len(bad), bad[:3]


def checks(records_differ: int, calls_short: int) -> dict:
    vals = {"records_differ": records_differ, "calls_short": calls_short}
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in vals.items()}


def passed(chk: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in chk.values())
