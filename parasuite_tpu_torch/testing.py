"""Inputs that the port's tests and chip_smoke.py share (numpy only).

The cases the select kernel is held to on a card are the cases its plain
version is held to the JAX package on a CPU, so both draw them from here.
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
