"""The 2-D chromosome-sharded step of the port at a non-toy index size: the
port's counterpart of tools/bench_shards_scale.py.

Builds the original's 200 Mbp repeat-structured genome of 2 chromosomes
(sim/genome.py multi_chrom, seed 9; PARASUITE_SHARDS_LEN), shards it two
ways over the index axis of a 2 x 2 data x index mesh
(parallel/mesh.py make_mesh2), runs the sharded step on 2,048 reads
(PARASUITE_SHARDS_READS; simulate_reads seed 6) at k = 13, C = 8, max_occ
16, and holds it to the replicated single-index step by the original's
contract. On a repeat-crowded reference the replicated candidate list
saturates and top-C selection evicts true diagonals, while each shard
keeps its own top C, so the contract is dominance, not equality:
  (a) every read the replicated step maps, the sharded step maps, with a
      score >= (reads_lost_vs_replicated, scores_worse: 0);
  (b) where the scores are equal the winners are identical: strand, chrom,
      local position, NM (equal_score_winner_mismatches: 0), and X0 only
      grows (x0_shrunk: 0);
  (c) extra mapped reads exist only on the sharded side
      (reads_rescued_by_sharding).
Equality where nothing saturates is pinned by tests/test_torch_shards.py
and chip_smoke.py's shards_k15 phase.

The mesh: --device cpu gives four CPU devices; --device cuda four cards
where the machine has them, else its one card given four times (the two
index columns then run in turn on it). At the full size every count that
depends on no hardware is pinned to the JAX tool's record
(BENCH_SHARDS_SCALE_r05.json; PINNED below) and the script fails on a
difference. The line has the original's keys (synth / build / step seconds,
per-shard slab bytes, the 3 Gbp / 8-shard projection), the card's
nvidia-smi line, and `graphs`: the sharded step's compiled steps (a cell's
alignment and a row's merge each, ops/compiled.py), keys, CUDA graphs and
capture ms.

    python tools/torch_bench_shards_scale.py [--device cuda|cpu]
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

TOOLS = Path(__file__).resolve().parent
sys.path.insert(0, str(TOOLS))

import numpy as np                                  # noqa: E402

import _torch_bench as tb                           # noqa: E402

FULL_LEN = 200_000_000
FULL_READS = 2048
TOTAL_LEN = int(os.environ.get("PARASUITE_SHARDS_LEN", FULL_LEN))
N_READS = int(os.environ.get("PARASUITE_SHARDS_READS", FULL_READS))
READ_LEN = 50
N_DATA = 2
N_INDEX = 2
# the JAX tool's counts at FULL_LEN and FULL_READS (BENCH_SHARDS_SCALE_r05
# .json, confirmed on the CPU with tools/bench_shards_scale.py); none of
# them depends on the hardware
PINNED = {"reads_lost_vs_replicated": 0, "reads_rescued_by_sharding": 20,
          "scores_worse": 0, "scores_better": 1,
          "equal_score_reads_checked": 1959,
          "equal_score_winner_mismatches": 0, "x0_shrunk": 0, "x0_grew": 1,
          "replicated_candidate_saturated": 2032,
          "sensitivity_vs_truth": 0.9595}


def mesh_devices(device: str) -> list:
    """The four devices of the 2 x 2 mesh, row-major (module docstring)."""
    import torch

    if device.startswith("cpu"):
        return [torch.device("cpu")] * (N_DATA * N_INDEX)
    if not torch.cuda.is_available():
        raise SystemExit("torch_bench_shards_scale: --device cuda, but "
                         "torch.cuda.is_available() is false")
    n = torch.cuda.device_count()
    if n >= N_DATA * N_INDEX:
        return [torch.device("cuda", i) for i in range(N_DATA * N_INDEX)]
    return [torch.device("cuda", 0)] * (N_DATA * N_INDEX)


def dominance(rep: dict, out: dict, chrom_starts: np.ndarray,
              max_candidates: int) -> dict:
    """The original's contract counts: replicated results (AlignResult
    fields, packed positions) against the sharded step's (original
    coordinates), all numpy."""
    ci_rep = np.searchsorted(chrom_starts, rep["pos"], side="right") - 1
    local_rep = rep["pos"] - chrom_starts[ci_rep]
    rm, sm = rep["mapped"], out["mapped"]
    rs, ss = rep["score"], out["score"]
    both = rm & sm
    eqs = both & (ss == rs)
    mism = 0
    for f_rep, f_sh in ((rep["strand"], out["strand"]),
                        (ci_rep, out["chrom"]),
                        (local_rep, out["local_pos"]),
                        (rep["nm"], out["nm"])):
        mism += int((f_rep[eqs] != f_sh[eqs]).sum())
    x0r, x0s = rep["x0"], out["x0"]
    got = {"reads_lost_vs_replicated": int((rm & ~sm).sum()),
           "reads_rescued_by_sharding": int((sm & ~rm).sum()),
           "scores_worse": int((ss[both] < rs[both]).sum()),
           "scores_better": int((ss[both] > rs[both]).sum()),
           "equal_score_reads_checked": int(eqs.sum()),
           "equal_score_winner_mismatches": mism,
           "x0_shrunk": int((x0s[eqs] < x0r[eqs]).sum()),
           "x0_grew": int((x0s[eqs] > x0r[eqs]).sum()),
           "replicated_candidate_saturated": int(
               (rep["n_candidates"] >= 2 * max_candidates).sum())}
    got["dominance_ok"] = (got["reads_lost_vs_replicated"] == 0
                           and got["scores_worse"] == 0 and mism == 0
                           and got["x0_shrunk"] == 0)
    return got


def measure(device: str, total_len: int = TOTAL_LEN,
            n_reads: int = N_READS) -> dict:
    """The sharded step against the replicated one -> the JSON line."""
    import torch

    from parasuite_tpu_torch.config import AlignConfig
    from parasuite_tpu_torch.errormodel.scoring import flat_score_tensor
    from parasuite_tpu_torch.index import KmerIndex
    from parasuite_tpu_torch.ops.aligner import align_batch
    from parasuite_tpu_torch.ops.device_index import (DeviceIndex,
                                                      ScoreParams,
                                                      min_scores_host)
    from parasuite_tpu_torch.parallel.dist_align import graph_stats
    from parasuite_tpu_torch.parallel.mesh import make_mesh2
    from parasuite_tpu_torch.parallel.shards import (build_sharded_index,
                                                     make_sharded_step)
    from parasuite_tpu_torch.sim.generate import simulate_reads
    from parasuite_tpu_torch.sim.genome import multi_chrom

    devices = mesh_devices(device)
    home = devices[0]
    # k = 13 per the genome-scale rule (BASELINE.md: G / 4^k <~ 3 at
    # 100 Mbp a shard)
    cfg = AlignConfig(max_read_len=READ_LEN, kmer_size=13,
                      batch_size=n_reads, max_candidates=8, max_occ=16)

    t0 = time.perf_counter()
    seqs, stats = multi_chrom(total_len, N_INDEX, seed=9)
    synth_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sharded, full = build_sharded_index(seqs, N_INDEX, cfg)
    build_s = time.perf_counter() - t0
    del seqs

    codes, lengths, truth = simulate_reads(full, n_reads, READ_LEN, cfg,
                                           seed=6, tc_rate=0.12)
    codes, lengths = np.asarray(codes), np.asarray(lengths)
    ms = min_scores_host(lengths, cfg)
    sprof = ScoreParams.from_tensor(flat_score_tensor(cfg, READ_LEN), cfg,
                                    home)

    # the replicated single-index step (the semantics oracle)
    index_full = KmerIndex.build(full.seq, cfg.kmer_size)
    didx = DeviceIndex.from_host(full, index_full, home)
    del index_full
    tb.sync(home)
    rep = align_batch(didx, sprof, *(torch.from_numpy(x).to(home)
                                     for x in (codes, lengths, ms)), cfg)
    rep = {f: getattr(rep, f).cpu().numpy() for f in rep._fields}
    del didx
    if home.type == "cuda":
        torch.cuda.empty_cache()

    # the 2-D sharded step
    step = make_sharded_step(cfg, make_mesh2(N_DATA, N_INDEX,
                                             devices=devices))
    slabs = sharded.slabs(cfg)
    orig = sharded.orig_chrom
    times = []
    for _ in range(2):        # the first uploads the slabs and captures
        tb.sync(home)
        t0 = time.perf_counter()
        out = step(slabs, orig, sprof, codes, lengths, ms)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        tb.sync(home)
        times.append(time.perf_counter() - t0)

    got = dominance(rep, out, np.asarray(full.starts), cfg.max_candidates)
    sens = float((out["mapped"] & (out["strand"] == truth.strand)
                  & (out["chrom"] == truth.chrom_idx)
                  & (out["local_pos"] == truth.local_pos)).sum() / n_reads)
    slab_bytes = {f: int(getattr(sharded, f)[0].nbytes)
                  for f in ("ref_seq", "positions", "bucket_starts")}
    # 3 Gbp on 8 shards: 375 Mbp a shard in the same dtypes (the JAX tool
    # adds the TPU's 3-bit packed-words temporary, which the port has not)
    g8 = 3_000_000_000 // 8
    proj = {"ref_seq": g8, "positions_upper_bound": 4 * g8,
            "bucket_starts": slab_bytes["bucket_starts"]}
    return {
        "total_ref_len": int(full.total_len),
        "n_chroms": len(full.names),
        "repeat_fraction": round(stats.repeat_fraction, 4),
        "mesh": f"{N_DATA}x{N_INDEX} data x index",
        "n_reads": n_reads,
        "synth_seconds": round(synth_s, 1),
        "sharded_build_seconds": round(build_s, 1),
        "step_first_seconds": round(times[0], 3),
        "step_steady_seconds": round(times[1], 3),
        "graphs": graph_stats(step),
        **got,
        "sensitivity_vs_truth": round(sens, 4),
        "per_shard_slab_bytes": slab_bytes,
        "per_shard_total_bytes": sum(slab_bytes.values()),
        "projected_3gbp_8chip_per_chip_bytes": proj,
        "projected_3gbp_8chip_total_per_chip": sum(proj.values()),
        "note": ("port; step seconds are one call each (the first uploads "
                 "the slabs and captures the graphs), host arrays in and "
                 "results fetched"
                 + ("; one card given four times, so the four cells of "
                    "the mesh run in turn on it"
                    if len(set(devices)) == 1 and home.type == "cuda"
                    else "")),
        "device": device, "mesh_devices": [str(d) for d in devices],
        "gpu": tb.gpu_line(device),
    }


def pin_check(line: dict) -> dict:
    """Differences from PINNED, {} when they agree (only at the full
    size)."""
    if (line["total_ref_len"] < FULL_LEN or line["n_reads"] != FULL_READS):
        return {}
    return {k: {"got": line[k], "jax": v} for k, v in PINNED.items()
            if line[k] != v}


def main(argv=None) -> int:
    device, _rest = tb.device_arg(argv, __doc__.splitlines()[0])
    line = measure(device)
    bad = pin_check(line)
    line["pinned"] = not bad and line["n_reads"] == FULL_READS \
        and line["total_ref_len"] >= FULL_LEN
    print(json.dumps(line))
    if bad:
        sys.stderr.write(f"torch_bench_shards_scale: differs from the JAX "
                         f"tool's record: {bad}\n")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
