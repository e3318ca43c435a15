"""Structured per-stage stats -> JSONL (SURVEY.md §5 metrics/observability).

The reference prints progress to stderr; here every pipeline stage appends a
JSON line (reads in/aligned/unaligned, conversion counts, reads/s, scaling
numbers) so the BASELINE config-5 scaling report is a jq query away.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path


class RunLog:
    """Append-only JSONL event log; also mirrors to stderr when verbose."""

    def __init__(self, path=None, verbose: bool = False, run_id: str = ""):
        self._fh = open(path, "a") if path else None
        self.verbose = verbose
        self.run_id = run_id
        self._t0 = time.time()

    def event(self, stage: str, **fields) -> dict:
        rec = {"ts": round(time.time() - self._t0, 3), "stage": stage,
               **({"run": self.run_id} if self.run_id else {}), **fields}
        line = json.dumps(rec)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self.verbose:
            print(line, file=sys.stderr)
        return rec

    def close(self) -> None:
        if self._fh:
            self._fh.close()


NULL_LOG = RunLog()
