"""Combined genome+transcriptome throughput of the port against plain mode:
FASTQ -> SAM reads/s through streaming_align on the 400-transcript world
(an exon-dense synthetic genome, reads drawn half from genomic loci and half
from spliced transcripts, many spanning a junction), median of 5 runs after
a warm-up (counterpart of tools/bench_combined.py; same JSON keys, plus
`gpu`).

    python tools/torch_bench_combined.py [n_reads] [--device cuda|cpu]

PARASUITE_COMBINED_GENOME, PARASUITE_COMBINED_NTX and PARASUITE_BENCH_BATCH
(default 16384 here, as in the original) shrink the world.
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

READ_LEN = 50
GENOME_LEN = int(os.environ.get("PARASUITE_COMBINED_GENOME", 8_000_000))
N_TX = int(os.environ.get("PARASUITE_COMBINED_NTX", 400))


def build_world(cfg, genome_len: int = GENOME_LEN, n_tx: int = N_TX):
    from parasuite_tpu_torch.pipeline.combined import (CombinedReference,
                                                       Transcript)

    rng = np.random.default_rng(11)
    genome = {"chr1": rng.integers(0, 4, genome_len).astype(np.int8)}
    txs = []
    for t in range(n_tx):
        # 3-exon transcripts, exons 120-400bp, introns 200-2000bp
        start = int(rng.integers(0, genome_len - 10_000))
        starts, ends, p = [], [], start
        for _ in range(3):
            e = int(rng.integers(120, 400))
            starts.append(p)
            ends.append(p + e)
            p += e + int(rng.integers(200, 2000))
        txs.append(Transcript(f"t{t}", "chr1", "+" if t % 2 else "-",
                              np.asarray(starts, dtype=np.int64),
                              np.asarray(ends, dtype=np.int64)))
    combined = CombinedReference.build(genome, txs, cfg.chrom_spacer)
    return genome, txs, combined


def make_reads(combined, txs, n_reads):
    """Half genomic reads, half spliced-transcript reads (many junction-
    spanning), all sampled from the combined packing so both engines see the
    identical read set; T->C at 12% of T; reads that straddle a spacer
    dropped; shuffled so every batch sees the mixed workload."""
    rng = np.random.default_rng(12)
    ref = combined.ref
    g_lo, g_hi = int(ref.starts[0]), int(ref.ends[0]) - READ_LEN
    n_g = n_reads // 2
    gpos = rng.integers(g_lo, g_hi, n_g)
    n_t = n_reads - n_g
    ti = rng.integers(0, len(txs), n_t)
    name_to_ci = {nm: i for i, nm in enumerate(ref.names)}
    tstart = np.asarray([ref.starts[name_to_ci[f"tx::{t.tx_id}"]]
                         for t in txs])
    tlen = np.asarray([t.spliced_len for t in txs])
    toff = (rng.random(n_t) * np.maximum(tlen[ti] - READ_LEN, 1)).astype(int)
    pos = np.concatenate([gpos, tstart[ti] + toff])
    codes = ref.seq[pos[:, None] + np.arange(READ_LEN)[None, :]]
    conv = (codes == 3) & (rng.random(codes.shape) < 0.12)
    codes = np.where(conv, 1, codes).astype(np.int8)
    codes = codes[~np.any(codes == 4, axis=1)]
    codes = codes[rng.permutation(codes.shape[0])]
    return codes, np.full(codes.shape[0], READ_LEN, dtype=np.int32)


def main(argv=None) -> int:
    from parasuite_tpu_torch.config import AlignConfig
    from parasuite_tpu_torch.index.kmer import KmerIndex
    from parasuite_tpu_torch.io.fastq import write_fastq
    from parasuite_tpu_torch.pipeline.align import AlignerEngine, fetch_host
    from parasuite_tpu_torch.pipeline.combined import CombinedEngine

    device, rest = tb.device_arg(argv, __doc__)
    n_reads = int(rest[0]) if rest else 131072
    batch = int(os.environ.get("PARASUITE_BENCH_BATCH", 16384))
    cfg = AlignConfig(max_read_len=READ_LEN, kmer_size=12, batch_size=batch,
                      max_candidates=8, max_occ=16)
    _genome, txs, combined = build_world(cfg)
    codes, lengths = make_reads(combined, txs, n_reads)
    n_reads = int(codes.shape[0])

    cidx = KmerIndex.build(combined.ref.seq, cfg.kmer_size)
    ceng = CombinedEngine(combined, cidx, cfg, device=device)
    gref = ceng.genome_ref
    geng = AlignerEngine(gref, KmerIndex.build(gref.seq, cfg.kmer_size), cfg,
                         device=device)

    with tempfile.TemporaryDirectory() as td:
        fq = Path(td) / "bench_reads.fastq"
        write_fastq(fq, [f"b{i}" for i in range(n_reads)], codes, lengths)
        # how full is the PackedCandidates cap?
        (pc,) = fetch_host(ceng.align_device_packed(codes[:batch],
                                                    lengths[:batch])[1])
        entries_per_read = int(pc.n_sel) / batch
        plain_s, plain_all = tb.stream_rate(geng, fq, n_reads, td, rounds=5)
        comb_s, comb_all = tb.stream_rate(ceng, fq, n_reads, td, rounds=5)

    spread = max(abs(a - b) / min(a, b)
                 for a, b in zip(comb_all, comb_all[1:]))
    print(json.dumps({
        "n_reads": n_reads, "batch": batch,
        "plain_stream_reads_per_s": round(plain_s, 0),
        "combined_stream_reads_per_s": round(comb_s, 0),
        "combined_stream_frac_of_plain": round(comb_s / plain_s, 3),
        "wire_entries_per_read": round(entries_per_read, 3),
        "wire_cap_per_read": cfg.combined_wire_cap,
        "plain_stream_rounds": [round(r, 0) for r in plain_all],
        "stream_rounds": [round(r, 0) for r in comb_all],
        "max_consecutive_spread": round(spread, 3),
        "n_transcripts": N_TX,
        "gpu": tb.gpu_line(device),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
