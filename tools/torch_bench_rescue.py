"""Two-tier seeding rescue of the port at 36 bp: sensitivity, precision and
mapped fraction with config.rescue_kmer off and on, and what the rescue pass
costs end to end (counterpart of tools/bench_rescue.py; same JSON keys, plus
`gpu`; `seeding_ceiling_r04` is that file's constant, a count of reads
without an error-free 12-mer that depends on no hardware).

    python tools/torch_bench_rescue.py [--device cuda|cpu]

PARASUITE_RESCUE_K (default 10), PARASUITE_RESCUE_READS and
PARASUITE_BENCH_BATCH shrink or move the run.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

import _torch_bench as tb

READ_LEN = 36
RESCUE_K = int(os.environ.get("PARASUITE_RESCUE_K", 10))


def engine_accuracy(engine, codes, lengths, truth):
    """Sensitivity, precision and mapped fraction of engine.to_host over
    whole batches of the reads -> (fractions, reads counted). The plain
    engine has no wire-packed step: every batch goes through align_device."""
    from parasuite_tpu_torch.io.batch import ReadBatch

    B = engine.cfg.batch_size
    n = codes.shape[0] - codes.shape[0] % B
    mapped, strand, pos = [], [], []
    for i in range(0, n, B):
        b = ReadBatch(codes=codes[i:i + B], lengths=lengths[i:i + B])
        host = engine.to_host(b, engine.align_device(b.codes, b.lengths))
        mapped.append(host.mapped)
        strand.append(host.strand)
        pos.append(host.pos)
    mapped = np.concatenate(mapped)[:n]
    strand = np.concatenate(strand)[:n]
    pos = np.concatenate(pos)[:n].astype(np.int64)
    ok = (mapped & (strand == truth.strand[:n])
          & (pos == truth.packed_pos[:n]))
    return {"sensitivity": round(float(ok.sum() / n), 4),
            "precision": round(float(ok.sum() / max(mapped.sum(), 1)), 4),
            "mapped_frac": round(float(mapped.mean()), 4)}, n


def main(argv=None) -> int:
    from parasuite_tpu_torch.io.fastq import write_fastq
    from parasuite_tpu_torch.pipeline.align import AlignerEngine
    from parasuite_tpu_torch.sim.generate import simulate_reads

    device, _ = tb.device_arg(argv, __doc__)
    base = tb.make_cfg()
    cfg_off = base.replace(max_read_len=READ_LEN)
    cfg_on = cfg_off.replace(rescue_kmer=RESCUE_K)
    n_reads = int(os.environ.get("PARASUITE_RESCUE_READS",
                                 8 * base.batch_size))

    ref, index, eng_off = tb.build_state(cfg_off, tb.REF_LEN, device=device)
    # the sweep's iid stress model: every T converts i.i.d. at 12%
    codes, lengths, truth = simulate_reads(ref, n_reads, READ_LEN, cfg_off,
                                           seed=2, tc_rate=0.12)
    codes, lengths = np.asarray(codes), np.asarray(lengths)
    eng_on = AlignerEngine(ref, index, cfg_on, device=device)

    acc_off, n = engine_accuracy(eng_off, codes, lengths, truth)
    acc_on, _ = engine_accuracy(eng_on, codes, lengths, truth)
    rescued_acc_pass = eng_on.rescue_mapped  # before the streaming rounds
    overflow_acc_pass = eng_on.rescue_overflow

    with tempfile.TemporaryDirectory(prefix="parasuite_rescue_") as td:
        fq = Path(td) / "rescue.fastq"
        write_fastq(fq, [f"r{i}" for i in range(codes.shape[0])], codes,
                    lengths)
        e2e_off, r_off = tb.stream_rate(eng_off, fq, codes.shape[0], td,
                                        name="rescue_out.sam")
        e2e_on, r_on = tb.stream_rate(eng_on, fq, codes.shape[0], td,
                                      name="rescue_out.sam")

    cost = 1.0 - e2e_on / e2e_off
    print(json.dumps({
        "read_len": READ_LEN, "rescue_kmer": RESCUE_K, "n_reads": n,
        "model": "iid conversions tc=0.12 (stress model)",
        "seeding_ceiling_r04": 0.9898,
        "off": acc_off, "on": acc_on,
        "rescued_reads": rescued_acc_pass,
        "rescue_overflow": overflow_acc_pass,
        "e2e_off_reads_per_s": round(e2e_off, 0),
        "e2e_on_reads_per_s": round(e2e_on, 0),
        "e2e_rounds_off": [round(x, 0) for x in r_off],
        "e2e_rounds_on": [round(x, 0) for x in r_on],
        "e2e_cost_frac": round(cost, 4),
        "meets_bar": bool(acc_on["sensitivity"] >= 0.985 and cost < 0.10),
        "gpu": tb.gpu_line(device),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
