"""Seed-geometry sweep of the port: sensitivity against device reads/s for
each (max_seeds, seed_stride) candidate on the bench world (counterpart of
tools/sweep_seeds.py; same JSON keys, plus `gpu`).

    python tools/torch_sweep_seeds.py [--device cuda|cpu]

PARASUITE_BENCH_BATCH shrinks the batch (reads = 8 batches a line).
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import _torch_bench as tb

# (max_seeds, seed_stride): 4/12 = the non-overlapping layout
GRID = [(4, 12), (5, 9), (6, 7), (7, 6)]


def sweep_line(base, max_seeds: int, stride: int, n_reads: int, ref_len: int,
               device: str) -> dict:
    cfg = dataclasses.replace(base, max_seeds=max_seeds, seed_stride=stride)
    state = tb.build_state(cfg, ref_len, device=device)
    rps, extras, _rounds = tb.run_throughput(
        cfg, n_reads, cfg.batch_size, ref_len, check_accuracy=True,
        state=state, device=device)
    return {"max_seeds": max_seeds, "stride": stride,
            "reads_per_s": round(rps, 0), **extras}


def main(argv=None) -> int:
    device, _ = tb.device_arg(argv, __doc__)
    base = tb.make_cfg()
    gpu = tb.gpu_line(device)
    for ms, stride in GRID:
        print(json.dumps({**sweep_line(base, ms, stride, 8 * base.batch_size,
                                       tb.REF_LEN, device), "gpu": gpu}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
