"""The inputs of a run, made from --seed alone: the genome, the annotation
and the read library. Pure numpy; the program and the plain reference are
handed the same arrays.

The genome generator is a frozen copy of parasuite_tpu_torch/sim/genome.py
(synth_chromosome, chr22_like), with its sizes read from the configuration
file instead of keyword defaults. The read model is a frozen copy of
tools/_torch_bench.py::draw_reads, generalised to draw origins from several
sources (genome, spliced transcripts, introns) in fixed shares.

Random streams: every part has its own stream of one SeedSequence over
(seed, part), so a seed changes every input and two parts never share
draws.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

A, C, G, T, N = 0, 1, 2, 3, 4
COMP = np.array([T, G, C, A, N], dtype=np.int8)
CODE_TO_BASE = np.frombuffer(b"ACGTN", dtype=np.uint8)

GENOME, ANNOTATION, READS, SAMPLE = 1, 2, 3, 4


def rng_for(seed: int, part: int) -> np.random.Generator:
    """The random stream of one part of a run's inputs."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) & (2**64 - 1), part]))


def revcomp(codes: np.ndarray) -> np.ndarray:
    return COMP[np.asarray(codes, dtype=np.int64)][..., ::-1]


# ---------------------------------------------------------------------------
# genome (frozen copy of sim/genome.py)
# ---------------------------------------------------------------------------

def _mutate(rng, seq: np.ndarray, divergence: float) -> np.ndarray:
    m = rng.random(seq.shape[0]) < divergence
    if not m.any():
        return seq
    out = seq.copy()
    out[m] = (out[m] + rng.integers(1, 4, int(m.sum()))) % 4
    return out.astype(np.int8)


def synth_chromosome(rng, length: int, families, n_gap_lead: int,
                     n_gap_internal: int, satellite_bases: int,
                     segdup_blocks: int) -> np.ndarray:
    """int8 codes [length]: uniform background, interspersed repeat
    families (name, consensus_len, copies, div_lo, div_hi) pasted as
    diverged 5'-truncated copies, a satellite array after the leading N
    block, segmental duplications, then the N gaps."""
    seq = rng.integers(0, 4, length).astype(np.int8)
    lo = n_gap_lead
    for _name, cons_len, copies, div_lo, div_hi in families:
        cons = rng.integers(0, 4, cons_len).astype(np.int8)
        for _ in range(copies):
            ln = int(rng.integers(60, cons_len + 1))
            pos = int(rng.integers(lo, length - ln))
            div = float(rng.uniform(div_lo, div_hi))
            seq[pos:pos + ln] = _mutate(rng, cons[-ln:], div)
    if satellite_bases > 0:
        mono = rng.integers(0, 4, 171).astype(np.int8)
        p = lo
        while p + 171 <= lo + satellite_bases:
            seq[p:p + 171] = _mutate(rng, mono, 0.05)
            p += 171
    for _ in range(segdup_blocks):
        ln = int(rng.integers(50_000, 200_000))
        src = int(rng.integers(lo, length - ln))
        dst = int(rng.integers(lo, length - ln))
        seq[dst:dst + ln] = _mutate(rng, seq[src:src + ln].copy(),
                                    float(rng.uniform(0.02, 0.05)))
    if n_gap_lead > 0:
        seq[:n_gap_lead] = N
    for _ in range(n_gap_internal):
        ln = int(rng.integers(20_000, 100_000))
        pos = int(rng.integers(lo, length - ln))
        seq[pos:pos + ln] = N
    return seq


def make_genome(spec: dict, seed: int) -> dict:
    """{chrom name: int8 codes} from the configuration's "genome" entry."""
    rng = rng_for(seed, GENOME)
    return {spec["name"]: synth_chromosome(
        rng, int(spec["length"]), [tuple(f) for f in spec["families"]],
        int(spec["n_gap_lead"]), int(spec["n_gap_internal"]),
        int(spec["satellite_bases"]), int(spec["segdup_blocks"]))}


# ---------------------------------------------------------------------------
# annotation
# ---------------------------------------------------------------------------

@dataclass
class Tx:
    tx_id: str
    chrom: str
    strand: str               # '+' or '-'
    exon_starts: np.ndarray   # int64, 0-based, ascending
    exon_ends: np.ndarray     # int64, exclusive


def make_annotation(spec: dict, genome: dict, seed: int) -> list:
    """Genes on the genome's first chromosome, outside its leading N block:
    each gene a chain of exons and introns, each isoform the gene's first
    and last exon and every inner exon kept with probability keep_inner.
    Lengths are drawn uniformly (exons) and log-uniformly (introns) from
    the configuration's ranges."""
    rng = rng_for(seed, ANNOTATION)
    chrom = next(iter(genome))
    seq = genome[chrom]
    lo = int(np.argmax(seq != N))
    txs = []
    for g in range(int(spec["genes"])):
        n_ex = int(rng.integers(spec["exons"][0], spec["exons"][1] + 1))
        ex_len = rng.integers(spec["exon_len"][0], spec["exon_len"][1] + 1,
                              n_ex)
        intr = np.round(10.0 ** rng.uniform(spec["intron_log10"][0],
                                            spec["intron_log10"][1],
                                            n_ex - 1)).astype(np.int64)
        span = int(ex_len.sum() + intr.sum())
        start = int(rng.integers(lo, seq.shape[0] - span))
        starts = start + np.concatenate(
            [[0], np.cumsum(ex_len[:-1] + intr)]).astype(np.int64)
        ends = starts + ex_len
        strand = "+" if rng.random() < 0.5 else "-"
        n_iso = int(rng.integers(spec["isoforms"][0],
                                 spec["isoforms"][1] + 1))
        seen = set()
        for _ in range(n_iso):
            keep = rng.random(n_ex) < spec["keep_inner"]
            keep[0] = keep[-1] = True
            key = keep.tobytes()
            if key in seen:
                continue
            seen.add(key)
            txs.append(Tx(f"g{g}.t{len(seen)}", chrom, strand,
                          starts[keep].copy(), ends[keep].copy()))
    return txs


def splice(genome: dict, tx: Tx) -> np.ndarray:
    chrom = genome[tx.chrom]
    s = np.concatenate([chrom[int(a):int(b)]
                        for a, b in zip(tx.exon_starts, tx.exon_ends)])
    return revcomp(s) if tx.strand == "-" else s


# ---------------------------------------------------------------------------
# reads
# ---------------------------------------------------------------------------

def _source(kind: str, genome: dict, txs: list, L: int) -> np.ndarray:
    """One int8 array with N where no read may start or run: a read is an
    (L + 1)-base window free of N (the extra base feeds a deletion)."""
    chrom = genome[next(iter(genome))]
    if kind == "genome":
        return chrom
    gap = np.full(L + 1, N, dtype=np.int8)
    if kind == "transcripts":
        parts = []
        for tx in txs:
            parts += [splice(genome, tx), gap]
        return np.concatenate(parts)
    if kind == "introns":
        # inside a gene's span and outside every exon of every transcript
        span = np.zeros(chrom.shape[0] + 1, dtype=np.int32)
        exon = np.zeros(chrom.shape[0] + 1, dtype=np.int32)
        for tx in txs:
            span[tx.exon_starts[0]] += 1
            span[tx.exon_ends[-1]] -= 1
            np.add.at(exon, tx.exon_starts, 1)
            np.add.at(exon, tx.exon_ends, -1)
        keep = (np.cumsum(span)[:-1] > 0) & (np.cumsum(exon)[:-1] == 0)
        return np.where(keep, chrom, np.int8(N)).astype(np.int8)
    raise ValueError(f"unknown read source {kind!r}")


def _draw_starts(rng, src: np.ndarray, n: int, L: int) -> np.ndarray:
    last = src.shape[0] - L - 1
    n_before = np.concatenate([[0], np.cumsum(src == N, dtype=np.int64)])
    clean = np.flatnonzero(n_before[L + 1:last + L + 1] == n_before[:last])
    if clean.shape[0] == 0:
        raise ValueError("read source has no window free of N")
    return clean[rng.integers(0, clean.shape[0], n)]


@dataclass
class Library:
    codes: np.ndarray     # int8 [n, L], machine orientation
    lengths: np.ndarray   # int32 [n]
    qual: bytes           # one quality character, every base


def make_library(mix: dict, n: int, genome: dict, txs: list,
                 seed: int) -> Library:
    """The read model of tools/_torch_bench.py::draw_reads over the mix's
    sources: origins drawn per source in its share, then over all reads
    a single-base deletion in deletion_rate of them (at a cut 5..L-6),
    substitutions at sub_rate, half reversed, T->C at tc_rate of the
    read's T (machine frame), all_n reads set to N; the read order is a
    permutation, so every batch holds the mix."""
    rng = rng_for(seed, READS)
    L = int(mix["read_len"])
    shares = [float(s["share"]) for s in mix["sources"]]
    counts = [int(round(n * s / sum(shares))) for s in shares]
    counts[-1] = n - sum(counts[:-1])
    wins = []
    for s, k in zip(mix["sources"], counts):
        src = _source(s["kind"], genome, txs, L)
        start = _draw_starts(rng, src, k, L)
        wins.append(np.lib.stride_tricks.sliding_window_view(
            src, L + 1)[start])
    win = np.concatenate(wins)                      # int8 [n, L + 1]
    deletion = rng.random(n, dtype=np.float32) < float(mix["deletion_rate"])
    cut = rng.integers(5, L - 5, n)
    col = np.arange(L)
    skip = deletion[:, None] & (col[None, :] >= cut[:, None])
    frag = np.where(skip, win[:, 1:], win[:, :L])
    sub = np.flatnonzero(rng.random((n, L), dtype=np.float32)
                         < float(mix["sub_rate"]))
    flat = frag.reshape(-1)
    flat[sub] = (flat[sub] + rng.integers(1, 4, sub.shape[0])) % 4
    reverse = np.zeros(n, dtype=bool)
    reverse[rng.permutation(n)[: int(round(n * mix["reverse_share"]))]] = True
    reads = np.where(reverse[:, None], 3 - frag[:, ::-1], frag)
    conv = (reads == T) & (rng.random((n, L), dtype=np.float32)
                           < float(mix["tc_rate"]))
    reads[conv] = C
    n_all_n = int(round(n * float(mix["all_n_share"])))
    reads[rng.choice(n, n_all_n, replace=False)] = N
    order = rng.permutation(n)
    return Library(codes=np.ascontiguousarray(reads[order]),
                   lengths=np.full(n, L, dtype=np.int32),
                   qual=str(mix["qual"]).encode("ascii"))


def read_name(i: int) -> str:
    return f"r{i}"


def write_fastq(path, lib: Library) -> int:
    """The library as FASTQ (names r0, r1, ...) -> bytes written."""
    seqs = CODE_TO_BASE[lib.codes.astype(np.int64)]
    L = lib.codes.shape[1]
    q = lib.qual * L
    with open(path, "wb") as fh:
        step = 65536
        for b in range(0, lib.codes.shape[0], step):
            block = seqs[b:b + step]
            fh.write(b"".join(
                b"@r%d\n%s\n+\n%s\n" % (b + i, block[i].tobytes(), q)
                for i in range(block.shape[0])))
        return fh.tell()
