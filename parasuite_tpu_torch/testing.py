"""Inputs that the port's tests and chip_smoke.py share (numpy only).

The cases the select and extend kernels are held to on a card are the cases
their plain versions are held to the JAX package on a CPU, so both draw
them from here.
"""

from __future__ import annotations

import numpy as np

I32MAX = 2 ** 31 - 1
# (diagonals per row, max_candidates): every row width the select kernel is
# built for (n_pad 32 .. 1,024 in registers, 2,048 and 4,096 in shared
# memory), ragged and full, and results past one warp
SELECT_CASES = [(8, 8), (32, 8), (33, 8), (64, 16), (100, 8), (112, 8),
                (128, 8), (200, 8), (208, 8), (256, 40), (400, 8), (512, 8),
                (777, 8), (1024, 8), (1088, 16), (2048, 8), (3000, 40),
                (4096, 8)]


def select_case_rows(n: int, seed: int = 0) -> np.ndarray:
    """int32 [102, n] rows of diagonals that stress candidate selection:
    heavy ties in a narrow range, ties with a third of the seeds missing
    (I32MAX), values over the whole int32 range with half missing, two or
    three distinct diagonals, and one row each of all I32MAX, one repeated
    diagonal, and one repeated diagonal with a single I32MAX."""
    rng = np.random.default_rng([seed, n])
    ties = rng.integers(-40, 40, (32, n))
    gaps = rng.integers(-6, 6, (32, n))
    gaps[rng.random((32, n)) < 0.33] = I32MAX
    wide = rng.integers(-2 ** 31, I32MAX, (16, n))
    wide[rng.random((16, n)) < 0.5] = I32MAX
    few = rng.integers(0, 3, (19, n)) * 1_000_003 - 7
    one = np.full((1, n), 17)
    one_gap = one.copy()
    one_gap[0, n // 2] = I32MAX
    return np.concatenate([ties, gaps, wide, few, np.full((1, n), I32MAX),
                           one, one_gap]).astype(np.int32)


# (band_width, max_read_len): every band width the extend kernel is built
# for, at the rescue pass's and the bench read length
EXTEND_CASES = [(w, L) for w in range(8) for L in (36, 50)]
EXTEND_C = 4          # candidates per oriented read
EXTEND_READS = 8      # reads per case: 64 pairs


def extend_case(W: int, L: int, seed: int = 0) -> dict:
    """One extension call that stresses the kernel's edges -> numpy inputs:
    ref int8 [G], oriented int32 [B, 2, L], lengths int32 [B], cand int32
    [2B, C], s_fwd / s_comp int32 [L, 5, 5], go, ge.

    Learned-looking score tables, different for the two strands; gaps as
    cheap as a mismatch, with go == ge at even W. Reads: exact, with a
    deletion, with an insertion, a homopolymer on a homopolymer run (ties
    for the best j), length 0, shorter than L (N after it), all N, random.
    Candidates: the true diagonal and its neighbours, diagonals that leave
    the reference at either end, and ones clamped there (far below 0, at
    and past G)."""
    rng = np.random.default_rng([seed, W, L])
    G = 6 * L + 200
    ref = rng.integers(0, 4, G).astype(np.int8)
    ref[L + 60:3 * L + 60] = 0              # homopolymer run
    ref[5 * L:5 * L + 8] = 4                # an N run
    B, C = EXTEND_READS, EXTEND_C
    fwd = np.full((B, L), 4, dtype=np.int32)
    lengths = np.full(B, L, dtype=np.int32)
    starts = np.asarray([30, 4 * L, 10, 2 * L, 40, 3 * L, 50, 5 * L - 20])
    for b in range(B):
        fwd[b] = ref[starts[b]:starts[b] + L]
    cut = L // 2
    fwd[1] = np.r_[ref[starts[1]:starts[1] + cut],
                   ref[starts[1] + cut + 2:starts[1] + L + 2]]   # deletion
    fwd[2] = np.r_[fwd[2, :cut], [1, 2], fwd[2, cut:L - 2]]     # insertion
    fwd[3] = 0                                                  # homopolymer
    lengths[4] = 0
    lengths[5] = L - 13
    fwd[5, L - 13:] = 4
    fwd[6] = 4                                                  # all N
    fwd[7] = rng.integers(0, 4, L)
    mut = [0, 1, 2, 7]                      # 5% substitutions
    fwd[mut] = np.where(rng.random((4, L)) < 0.05, (fwd[mut] + 1) % 4,
                        fwd[mut])
    rev = np.where(fwd == 4, 4, 3 - fwd)[:, ::-1]
    oriented = np.stack([fwd, rev], axis=1).astype(np.int32)
    win = L + 2 * W
    special = [-(win + 40), -(win + 1), -win + 3, -3, G - L + 2, G - 2, G,
               G + 50]
    cand = np.empty((2 * B, C), dtype=np.int32)
    for r in range(2 * B):
        true = int(starts[r // 2])
        cand[r] = [true, true + int(rng.integers(-W - 1, W + 2)),
                   special[r % len(special)],
                   int(rng.integers(-win - 10, G + 10))]

    def table():
        s = rng.integers(-40, -6, (L, 5, 5))
        for b in range(4):
            s[:, b, b] = rng.integers(2, 12, L)
        s[:, 4, :] = rng.integers(-8, -2, (L, 1))
        s[:, :, 4] = rng.integers(-8, -2, (L, 1))
        return s.astype(np.int32)

    go, ge = (6, 6) if W % 2 == 0 else (14, 4)
    return {"ref": ref, "oriented": oriented, "lengths": lengths,
            "cand": cand, "s_fwd": table(), "s_comp": table(), "go": go,
            "ge": ge}


# (entries a read n = 2C, the combined step's src / nm_pos / nm_strand):
# every register width of the finalize kernel (E = 1, 2, 4, 8 a lane),
# ragged and full, both tiers
FINALIZE_CASES = [(2, False), (16, False), (16, True), (32, False),
                  (40, True), (64, True), (254, False), (254, True)]
FINALIZE_READS = 96
FINALIZE_L = 50
FINALIZE_NEG = -(1 << 28)   # ops/cuda_extend.py NEG


def finalize_case(n: int, combined: bool, seed: int = 0) -> dict:
    """One finalize_core call that stresses the selection and its window ->
    numpy inputs: ref_seq int8 [G]; chrom_starts / chrom_ends int32 [3];
    oriented int32 [B, 2, L]; lengths int32 [B]; valid / ug_eq bool [B, n];
    strand int32 ([n], the plain step's row every read shares, or [B, n]
    with combined); pos_key / dps / diag int32 [B, n]; n_candidates int32
    [B]; mapq_sub int32 [256]; with combined src / nm_pos / nm_strand int32
    [B, n] and a learned-looking mapq_sub.

    Tie-heavy: keys from three positions a read on both strands, scores
    from three values, so twins and equal bests abound (with src, on both
    sources). The reads are the reference at their first key, with
    substitutions and T->C / A->G, so NM and T->C count. The first and last
    chromosomes reach past the reference's ends, so mapped windows read off
    them. Rows: all invalid; length 0; all N; keys below 0 and past G;
    spans across each chromosome boundary; every entry valid and below
    NEG (the best is NEG, no entry at it); the rest at random lengths."""
    rng = np.random.default_rng([seed, n, int(combined)])
    B, L = FINALIZE_READS, FINALIZE_L
    G = 3800
    ref = rng.integers(0, 4, G).astype(np.int8)
    ref[rng.random(G) < 0.02] = 4
    ref[1000:1200] = 4                       # spacers
    ref[2400:2600] = 4
    chrom_starts = np.asarray([-40, 1200, 2600], np.int32)
    chrom_ends = np.asarray([1000, 2400, G + 40], np.int32)
    lengths = rng.integers(L - 12, L + 1, B).astype(np.int32)
    anchors = rng.integers(-60, G + 60, B)
    anchors[5:8] = (-L // 2, G - L // 2, G + 5)          # off either end
    anchors[8:14] = np.repeat(chrom_ends[:2], 3) - L // 2  # across a boundary
    anchors[14:17] = chrom_starts[1:].repeat(2)[:3] - 3
    keys = anchors[:, None] + rng.integers(-1, 2, (B, 3)) * \
        np.asarray([0, 1, 7])
    keys[:, 1] = anchors + rng.integers(-2, 3, B)
    kidx = rng.integers(0, 3, (B, n))
    pos_key = np.take_along_axis(keys, kidx, axis=1)
    strand = (np.broadcast_to(np.arange(n) >= n // 2, (B, n)) if not combined
              else rng.random((B, n)) < 0.5).astype(np.int32)

    def window(a):
        i = a + np.arange(L)
        return np.where((i >= 0) & (i < G), ref[np.clip(i, 0, G - 1)], 4)

    oriented = np.empty((B, 2, L), np.int32)
    for b in range(B):
        w = window(int(anchors[b]))
        sub = rng.random(L) < 0.06
        oriented[b, 0] = np.where(sub, (w + 1) % 4, np.where(
            (w == 3) & (rng.random(L) < 0.3), 1, w))     # T -> C
        oriented[b, 1] = np.where(sub, (w + 2) % 4, np.where(
            (w == 0) & (rng.random(L) < 0.3), 2, w))     # A -> G
        oriented[b, :, lengths[b]:] = 4
    oriented[rng.random((B, 2, L)) < 0.01] = 4
    oriented[2] = 4                                      # all N
    lengths[1] = 0

    valid = rng.random((B, n)) < 0.7
    valid[0] = False                                     # all invalid
    dps = rng.choice(np.asarray([20, 25, 30, 30]), (B, n)).astype(np.int64)
    # half the rows: one (strand, key) above the rest, so X0 = 1 and MAPQ
    # reads mapq_sub
    one = rng.random(B) < 0.5
    top = (kidx == 0) & (strand == rng.integers(0, 2, B)[:, None])
    dps[one] = np.where(top[one], 30, rng.choice(np.asarray([20, 25]),
                                                  (int(one.sum()), n)))
    dps[~valid & (rng.random((B, n)) < 0.5)] = FINALIZE_NEG
    valid[4] = True
    dps[4] = FINALIZE_NEG - rng.integers(1, 3, n)        # below NEG
    pos_key[4] = anchors[4] + np.arange(n)
    out = {"ref_seq": ref, "chrom_starts": chrom_starts,
           "chrom_ends": chrom_ends, "oriented": oriented,
           "lengths": lengths, "valid": valid,
           "pos_key": pos_key.astype(np.int32), "dps": dps.astype(np.int32),
           "ug_eq": rng.random((B, n)) < 0.8,
           "diag": (pos_key + rng.integers(-5, 6, (B, n))).astype(np.int32),
           "n_candidates": rng.integers(0, n + 1, B).astype(np.int32)}
    if not combined:
        out["strand"] = strand[0].copy()
        out["mapq_sub"] = np.minimum(np.arange(256) * 4, 23).astype(np.int32)
        return out
    out["strand"] = strand
    out["src"] = rng.integers(0, 2, (B, n)).astype(np.int32)
    shift = rng.choice(np.asarray([0, 0, 3, -L - 5, G]), (B, n))
    out["nm_pos"] = (pos_key + shift).astype(np.int32)
    out["nm_strand"] = np.where(rng.random((B, n)) < 0.7, out["strand"],
                                1 - out["strand"]).astype(np.int32)
    out["mapq_sub"] = rng.integers(0, 30, 256).astype(np.int32)
    return out
