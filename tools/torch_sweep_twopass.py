"""Production-flow sensitivity of the port: flat pass 1 against the
profile-aware pass 2 on the same simulated truth, over seed geometries that
include a k = 11 full-coverage layout (counterpart of tools/sweep_twopass.py;
same JSON keys, plus `gpu`). The device step is align_batch with the profile
counts beside it, and the results come to the host through fetch_host.

    python tools/torch_sweep_twopass.py [--device cuda|cpu]

PARASUITE_BENCH_BATCH shrinks the batch (reads = 8 batches a line).
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

import _torch_bench as tb

# (kmer_size, max_seeds, seed_stride); (12, 4, 12) = the speed layout.
# k=11 @ stride 13: seeds at 0/13/26/39 cover bases 0..49 — every base of a
# 50bp read sits in exactly one seed, and a shorter k survives more errors.
GRID = [(12, 4, 12), (11, 4, 13), (12, 7, 6)]


def sweep_line(base, k: int, max_seeds: int, stride: int, n_reads: int,
               ref_len: int, device: str) -> dict:
    from parasuite_tpu_torch.benchkit import evaluate_against_truth
    from parasuite_tpu_torch.errormodel.infer import (ErrorProfile,
                                                      counts_to_profile)
    from parasuite_tpu_torch.pipeline.align import fetch_host
    from parasuite_tpu_torch.sim.generate import simulate_reads

    cfg = dataclasses.replace(base, kmer_size=k, max_seeds=max_seeds,
                              seed_stride=stride)
    ref, _index, engine = tb.build_state(cfg, ref_len, device=device)
    codes, lengths, truth = simulate_reads(ref, n_reads, tb.READ_LEN, cfg,
                                           seed=2, tc_rate=0.12)
    codes, lengths = np.asarray(codes), np.asarray(lengths)

    def run_pass(with_counts):
        outs, csum = [], None
        for i in range(0, n_reads, cfg.batch_size):
            c, ln = codes[i:i + cfg.batch_size], lengths[i:i + cfg.batch_size]
            res = engine.align_device(c, ln)
            if with_counts:
                cnt = engine.profile_counts_device(c, ln, res)
                csum = cnt if csum is None else csum + cnt
            outs.append(fetch_host(res)[0])
        cat = lambda f: np.concatenate([getattr(r, f) for r in outs])
        rep = evaluate_against_truth(truth, cat("mapped"), cat("strand"),
                                     cat("pos"))
        counts = csum.cpu().numpy() if csum is not None else None
        return rep, counts, int(cat("mapped").sum())

    rep1, counts, n_prof = run_pass(True)
    profile = ErrorProfile(counts=counts.astype(np.int64), n_reads=n_prof)
    engine.set_profile(counts_to_profile(profile, cfg))
    rep2, _c, _n = run_pass(False)
    return {"kmer_size": k, "max_seeds": max_seeds, "stride": stride,
            "pass1_sensitivity": round(rep1.sensitivity, 4),
            "pass1_unmapped": rep1.n_reads - rep1.n_mapped,
            "pass1_mismapped": rep1.n_mapped - rep1.n_correct,
            "pass2_sensitivity": round(rep2.sensitivity, 4),
            "pass2_unmapped": rep2.n_reads - rep2.n_mapped,
            "pass2_mismapped": rep2.n_mapped - rep2.n_correct,
            "precision2": round(rep2.precision, 4)}


def main(argv=None) -> int:
    device, _ = tb.device_arg(argv, __doc__)
    base = tb.make_cfg()
    gpu = tb.gpu_line(device)
    for k, ms, stride in GRID:
        print(json.dumps({**sweep_line(base, k, ms, stride,
                                       8 * base.batch_size, tb.REF_LEN,
                                       device), "gpu": gpu}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
