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
