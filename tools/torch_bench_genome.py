"""Genome-scale operating points of the port (counterpart of
tools/bench_genome.py; one JSON line of the same shape, plus `gpu`):

  (a) chr22-class: the 51 Mbp repeat-structured chromosome of sim/genome.py
      — index build seconds, bucket-occupancy / max_occ census, seed-drop
      accounting against the repeat policy, sensitivity and precision
      overall and on the unique (X0 == 1) subset, device and FASTQ -> SAM
      reads/s, resident bytes of the index;
  (b) the 200 Mbp five-chromosome genome on one card: the same, FASTQ -> SAM
      only with PARASUITE_GENOME_E2E=1.

With no PARASUITE_GENOME_K the script runs every operating point: (a) at
k = 12 and 13; (b) at k = 12, 13, 13 with max_occ 32, and k = 14 (a 1.07 GB
bucket array, which an 80 GB card holds with room to spare). max_occ 64 at
batch 65,536 is a row of 448 diagonals for the select kernel and simply
runs; PARASUITE_GENOME_MAXOCC=64 takes it.

    python tools/torch_bench_genome.py [--device cuda|cpu]
    PARASUITE_GENOME_PART=a|b            one world
    PARASUITE_GENOME_K / _MAXOCC         one operating point
    PARASUITE_GENOME_SCALE=0.02          shrink the worlds
    PARASUITE_GENOME_READS, PARASUITE_BENCH_BATCH
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

import _torch_bench as tb

READ_LEN = 50
N_READS = int(os.environ.get("PARASUITE_GENOME_READS", 16 * 65536))
SCALE = float(os.environ.get("PARASUITE_GENOME_SCALE", 1.0))
# (kmer_size, max_occ) per world when PARASUITE_GENOME_K is not given
POINTS = {"a": [(12, 16), (13, 16)],
          "b": [(12, 16), (13, 16), (13, 32), (14, 16)]}


def make_cfg(batch, k: int = 12, max_occ: int = 16):
    from parasuite_tpu_torch.config import AlignConfig

    return AlignConfig(max_read_len=READ_LEN, kmer_size=k, batch_size=batch,
                       max_candidates=8, max_occ=max_occ)


def index_census(index, cfg) -> dict:
    """Bucket-occupancy stats: how much k-mer mass the max_occ repeat
    policy actually drops on this reference."""
    occ = np.diff(index.bucket_starts.astype(np.int64))
    nz = occ[occ > 0]
    over = occ > cfg.max_occ
    return {
        "kmers_total": int(occ.sum()),
        "buckets_nonzero": int(nz.shape[0]),
        "bucket_p99": int(np.percentile(nz, 99)) if nz.size else 0,
        "bucket_max": int(occ.max()) if occ.size else 0,
        "buckets_over_max_occ": int(over.sum()),
        "kmer_mass_over_max_occ_frac": round(
            float(occ[over].sum()) / max(int(occ.sum()), 1), 5),
    }


def seed_drop_census(ref, index, truth, lengths, cfg) -> dict:
    """Repeat-policy seed accounting on the CLEAN reference windows of the
    simulated reads: a seed is dropped when its (error-free) k-mer bucket
    holds > max_occ positions or spans an N. Reads with ALL seeds dropped
    are seeding-blind — the structural sensitivity ceiling the repeat
    policy imposes (errors/conversions only lower it further)."""
    k, S, M = cfg.kmer_size, cfg.max_seeds, cfg.max_occ
    n = truth.packed_pos.shape[0]
    L = int(lengths.max())
    win_idx = truth.packed_pos[:, None] + np.arange(L)[None, :]
    win = ref.seq[np.clip(win_idx, 0, ref.seq.shape[0] - 1)].astype(np.int64)
    stride = np.maximum(1, (lengths.astype(np.int64) - k) // max(S - 1, 1))
    pow4 = 4 ** np.arange(k - 1, -1, -1)
    starts = index.bucket_starts.astype(np.int64)
    dropped = np.zeros((n, S), dtype=bool)
    for s in range(S):
        off = np.minimum(s * stride, lengths.astype(np.int64) - k)
        sl = win[np.arange(n)[:, None], off[:, None] + np.arange(k)[None, :]]
        has_n = (sl == 4).any(axis=1)
        code = np.where(has_n[:, None], 0, sl).dot(pow4)
        cnt = starts[code + 1] - starts[code]
        dropped[:, s] = has_n | (cnt > M)
    all_dropped = dropped.all(axis=1)
    return {
        "seeds_per_read": S,
        "seed_dropped_frac": round(float(dropped.mean()), 5),
        "reads_all_seeds_dropped": int(all_dropped.sum()),
        "reads_all_seeds_dropped_frac": round(float(all_dropped.mean()), 5),
    }


def device_pass(engine, codes, lengths, rounds=3):
    """Best-of-N device throughput over whole batches + the per-read
    outputs (mapq / x0 kept for the unique-subset accuracy split)."""
    B = engine.cfg.batch_size
    n = codes.shape[0] - codes.shape[0] % B
    rates, res = tb.device_loop(engine, codes[:n], lengths[:n], B, rounds)
    cat = lambda f: np.concatenate([getattr(r, f) for r in res])
    return max(rates), rates, {f: cat(f) for f in
                               ("mapped", "strand", "pos", "mapq", "x0")}, n


def accuracy_split(truth, out, n) -> dict:
    """Overall + unique-subset accuracy. On a repeat-rich reference a read
    from a near-perfect repeat copy legitimately maps to a twin (X0>1,
    MAPQ 0, placement arbitrary per BWA convention) — so the honest
    precision claim is on the X0==1 subset, with the multi-mapped mass
    reported separately, not hidden in 'mismapped'."""
    mapped = out["mapped"][:n]
    ok = (mapped & (out["strand"][:n] == truth.strand[:n])
          & (out["pos"][:n].astype(np.int64) == truth.packed_pos[:n]))
    uniq = mapped & (out["x0"][:n] == 1)
    multi = mapped & ~uniq
    return {
        "sensitivity": round(float(ok.sum() / n), 4),
        "precision": round(float(ok.sum() / max(mapped.sum(), 1)), 4),
        "mapped_frac": round(float(mapped.mean()), 4),
        "multi_mapped_frac": round(float(multi.mean()), 4),
        "unique_frac": round(float(uniq.mean()), 4),
        "sensitivity_unique": round(
            float((ok & uniq).sum() / max(uniq.sum(), 1)), 4),
        "mapq0_frac": round(float((mapped & (out["mapq"][:n] == 0)).mean()),
                            4),
    }


def resident_footprint(engine) -> dict:
    """Bytes the index and score tables hold on the device, from the
    tensors' own sizes, and the allocator's peak beside them on a card."""
    import torch

    didx, sprof = engine.didx, engine.sprof
    tensors = [getattr(o, f) for o in (didx, sprof)
               for f in o.__dataclass_fields__
               if isinstance(getattr(o, f), torch.Tensor)]
    nbytes = lambda t: int(t.numel() * t.element_size())
    entry = {
        "resident_index_bytes": sum(nbytes(t) for t in tensors),
        "ref_seq_bytes": nbytes(didx.ref_seq),
        "positions_bytes": nbytes(didx.positions),
        "bucket_starts_bytes": nbytes(didx.bucket_starts),
    }
    if engine.device.type == "cuda":
        entry["device_bytes_in_use"] = int(torch.cuda.memory_allocated())
        entry["device_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    return entry


def e2e_stream(engine, codes, lengths, tmpdir, rounds=3):
    from parasuite_tpu_torch.io.fastq import write_fastq

    n = codes.shape[0]
    fq = Path(tmpdir) / "genome_bench.fastq"
    write_fastq(fq, [f"g{i}" for i in range(n)], codes, lengths)
    return tb.stream_rate(engine, fq, n, tmpdir, rounds,
                          name="genome_bench.sam")


def run_world(name, ref, stats, cfg, n_reads, with_e2e, device,
              index=None) -> dict:
    """One operating point on one packed reference -> the record. `index`
    hands in an index that is built already (its build seconds are then
    null)."""
    import torch

    from parasuite_tpu_torch.index import KmerIndex
    from parasuite_tpu_torch.pipeline.align import AlignerEngine
    from parasuite_tpu_torch.sim.generate import simulate_reads

    build_s = None
    if index is None:
        t0 = time.perf_counter()
        index = KmerIndex.build(ref.seq, cfg.kmer_size)
        build_s = time.perf_counter() - t0
    codes, lengths, truth = simulate_reads(ref, n_reads, READ_LEN, cfg,
                                           seed=5, tc_rate=0.12)
    codes, lengths = np.asarray(codes), np.asarray(lengths)
    if str(device).startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()
    engine = AlignerEngine(ref, index, cfg, device=device)
    best, rates, out_cols, n_timed = device_pass(engine, codes, lengths)
    entry = {
        "world": name,
        "kmer_size": cfg.kmer_size, "max_occ": cfg.max_occ,
        "select_row_width": cfg.max_seeds * cfg.max_occ,
        "ref_len": int(ref.total_len),
        "n_chroms": len(ref.names),
        "repeat_fraction": round(stats.repeat_fraction, 4),
        "n_gap_bases": int(stats.n_bases),
        "index_build_seconds": (None if build_s is None
                                else round(build_s, 2)),
        "n_reads": int(n_timed),
        "device_reads_per_s": round(best, 0),
        "device_rounds": [round(r, 0) for r in rates],
        **index_census(index, cfg),
        **seed_drop_census(ref, index, truth, lengths, cfg),
        **accuracy_split(truth, out_cols, n_timed),
        **resident_footprint(engine),
    }
    if with_e2e:
        with tempfile.TemporaryDirectory(prefix="parasuite_genome_") as td:
            med, e2e_rounds = e2e_stream(engine, codes, lengths, td)
        entry["e2e_reads_per_s"] = round(med, 0)
        entry["e2e_rounds"] = [round(r, 0) for r in e2e_rounds]
    return entry


def main(argv=None) -> int:
    from parasuite_tpu_torch.index import PackedReference
    from parasuite_tpu_torch.sim.genome import chr22_like, multi_chrom

    device, _ = tb.device_arg(argv, __doc__)
    part = os.environ.get("PARASUITE_GENOME_PART", "ab")
    batch = int(os.environ.get("PARASUITE_BENCH_BATCH", 65536))
    n_reads = max(batch, int(N_READS * min(SCALE * 4, 1.0)))
    one = os.environ.get("PARASUITE_GENOME_K")
    worlds = []
    for p, name, make in (
            ("a", "chr22_class_51Mbp", lambda: chr22_like(scale=SCALE)),
            ("b", "multi_chrom_200Mbp",
             lambda: multi_chrom(int(200_000_000 * SCALE), 5))):
        if p not in part:
            continue
        seqs, stats = make()
        with_e2e = p == "a" or os.environ.get("PARASUITE_GENOME_E2E") == "1"
        points = ([(int(one),
                    int(os.environ.get("PARASUITE_GENOME_MAXOCC", 16)))]
                  if one else POINTS[p])
        ref = None
        for k, max_occ in points:
            cfg = make_cfg(batch, k, max_occ)
            if ref is None:
                ref = PackedReference.from_dict(seqs,
                                                spacer=cfg.chrom_spacer)
            worlds.append(run_world(name, ref, stats, cfg, n_reads, with_e2e,
                                    device))
            print(json.dumps({"progress": worlds[-1]["world"],
                              "kmer_size": k, "max_occ": max_occ}),
                  file=sys.stderr, flush=True)
    print(json.dumps({"read_len": READ_LEN, "batch": batch, "scale": SCALE,
                      "worlds": worlds, "gpu": tb.gpu_line(device)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
