"""chip_smoke.py's bound of the extend kernel, pinned on the CPU.

extend_bound is what the card run holds the kernel to (a kernel faster than
its bound fails the run), so its counts are pinned here for shapes small
enough to count by hand, and a change to the count shows up on the CPU.
"""

import numpy as np
import pytest

import chip_smoke

# (lengths, C, L, W, G) -> (cells, bytes, bound_by). Cells: 2 strands x C
# candidates x (2W + 1) diagonals x the rows each read runs (its length, at
# most L). Bytes: reads 2B * L * 4, lengths B * 4, candidates 2BC * 4, the
# windows min(G, 2BC (L + 2W)), two score tables 2 * L * 25 * 4, four
# outputs 4 * 2BC * 4.
CASES = [
    # 2 * 2 * 3 * (50 + 20 + 0) = 840 cells;
    # 1,200 + 12 + 48 + 624 + 10,000 + 192 = 12,076 bytes
    (([50, 20, 0], 2, 50, 1, 1000), (840, 12_076, "bytes")),
    # the window term capped by G: 12 pairs x 52 > 100
    (([50, 20, 0], 2, 50, 1, 100), (840, 11_552, "bytes")),
    # 1,024 reads of 50 bp at the bench config: 2 * 8 * 11 * 51,200 =
    # 9,011,200 cells; 409,600 + 4,096 + 65,536 + 983,040 + 10,000
    # + 262,144 = 1,734,416 bytes
    (([50] * 1024, 8, 50, 5, 10 ** 6), (9_011_200, 1_734_416,
                                        "operations")),
    # reads longer than L run L rows
    (([80, 36], 8, 50, 7, 10 ** 6), (2 * 8 * 15 * 86, 2 * 2 * 50 * 4 + 8
                                     + 32 * 4 + 32 * 64 + 10_000
                                     + 4 * 32 * 4, "bytes")),
]


@pytest.mark.parametrize("args,want", CASES)
def test_extend_bound_counts(args, want):
    lengths, C, L, W, G = args
    cells, n_bytes, by = want
    b = chip_smoke.extend_bound(np.asarray(lengths), C, L, W, G)
    assert chip_smoke.EXTEND_OPS_PER_CELL == 6
    assert b["bound_ops_per_cell"] == 6 and b["bound_cells"] == cells
    assert b["bound_ops"] == 6 * cells and b["bound_bytes"] == n_bytes
    assert b["bound_by"] == by
    by_ops = 1e3 * 6 * cells / chip_smoke.INSTR_OPS_PER_S
    by_bytes = 1e3 * n_bytes / chip_smoke.HBM_BYTES_PER_S
    assert b["bound_ms"] == max(by_ops, by_bytes)
    # the earlier count (10 a cell) and 6 at the int32 rate, which is half
    # the instruction rate
    assert chip_smoke.INSTR_OPS_PER_S == 2 * chip_smoke.INT32_OPS_PER_S
    assert b["bound_ms_int32_pipe"] == max(2 * by_ops, by_bytes)
    assert b["bound_ms_10_ops"] == pytest.approx(
        max(1e3 * 10 * cells / chip_smoke.INT32_OPS_PER_S, by_bytes))


def test_a_kernel_under_its_bound_fails():
    """_against_bound: the share is bound / ms, and a time under the bound
    is a miscount that fails the run."""
    b = chip_smoke.extend_bound(np.full(1024, 50), 8, 50, 5, 10 ** 6)
    ok = chip_smoke._against_bound("extend", 2 * b["bound_ms"], b)
    assert ok["share_of_bound"] == pytest.approx(0.5)
    with pytest.raises(AssertionError, match="under its bound"):
        chip_smoke._against_bound("extend", 0.9 * b["bound_ms"], b)
