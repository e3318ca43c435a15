"""Read-length sweep of the port: sensitivity / precision across the spec
range 36-100 bp on the bench world, for the default adaptive per-read seed
placement and, where the geometry validates, the fixed stride-6 placement
(counterpart of tools/sweep_lengths.py; same JSON keys, plus `gpu`).

    python tools/torch_sweep_lengths.py [--device cuda|cpu]

PARASUITE_BENCH_BATCH shrinks the batch (reads = 4 batches a line).
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import _torch_bench as tb

LENGTHS = [36, 50, 75, 100]


def sweep_line(base, placement: str, L: int, n_reads: int, ref_len: int,
               device: str) -> dict:
    """One line of the sweep: the record of (placement, L), or the fixed
    placement's refusal as {"error": message}."""
    try:
        cfg = dataclasses.replace(base, max_read_len=L,
                                  seed_placement=placement)
    except ValueError as e:
        return {"placement": placement, "read_len": L, "error": str(e)}
    state = tb.build_state(cfg, ref_len, device=device)
    rps, extras, _rounds = tb.run_throughput(
        cfg, n_reads, cfg.batch_size, ref_len, check_accuracy=True,
        state=state, read_len=L, device=device)
    return {"placement": placement, "read_len": L,
            "stride_eff": cfg.seed_stride_for(L),
            "reads_per_s": round(rps, 0), **extras}


def main(argv=None) -> int:
    device, _ = tb.device_arg(argv, __doc__)
    base = tb.make_cfg()
    n_reads = 4 * base.batch_size
    gpu = tb.gpu_line(device)
    for placement in ("adaptive", "fixed"):
        for L in LENGTHS:
            print(json.dumps({**sweep_line(base, placement, L, n_reads,
                                           tb.REF_LEN, device),
                              "gpu": gpu}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
