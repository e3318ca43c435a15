"""The least time an NVIDIA H100 (SXM, 80 GB HBM3) could take for each hand
kernel of the main path, from the call's shapes alone: the larger of the
bytes over the memory rate and the operations over their rate. Frozen here
from chip_smoke.py's select_bound / extend_bound, so that a later change to
the program cannot move the yardstick.

The card's rates, from its published figures (the data sheet's SXM part at
its 700 W power limit; a card set below it runs slower, so every run prints
its limit beside these):
  * HBM3: 3.35e12 bytes/s;
  * int32 operations: 132 SMs x 64 INT32 lanes x 1.98e9 cycles/s
    (the boost clock) = 1.6727e13 ops/s (the select kernel's compares);
  * instruction issue: 132 SMs x 4 schedulers x 32 lanes x 1.98e9 =
    3.3454e13 lane-operations/s. The extension's six operations a DP cell
    are three adds, which the compiler may issue as IMAD on the FMA pipe,
    and three DPX max operations; the issue rate bounds any kernel that
    does them, whichever pipe each takes.

Counts are of the work these inputs need, whatever the code: each input
byte read once, each output byte written once; the extension counts the DP
cells of the candidate slots that hold a candidate (`filled`, the share of
the 2 x C slots a read has, measured on the run's reads), since a kernel
may skip an empty slot.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
SMS, INT32_LANES, SCHEDULERS, WARP, CLOCK_HZ = 132, 64, 4, 32, 1.98e9
INT32_OPS_PER_S = SMS * INT32_LANES * CLOCK_HZ
INSTR_OPS_PER_S = SMS * SCHEDULERS * WARP * CLOCK_HZ
EXTEND_OPS_PER_CELL = 6


def _bound(n_bytes: float, n_ops: float, ops_per_s: float) -> dict:
    by_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    by_ops = 1e3 * n_ops / ops_per_s
    return {"ms": max(by_bytes, by_ops),
            "by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": n_bytes, "ops": n_ops}


def select_bound(rows: int, n: int, C: int) -> dict:
    """One launch over `rows` rows of n int32 diagonals (two rows a read):
    the diagonals in, C int32 candidates and C validity bytes out; per row
    a comparison sort of n entries (n * ceil(log2 n) compares), two
    operations an entry for run starts and votes, one pick per result."""
    compares = n * max(1, int(n - 1).bit_length())
    return _bound(rows * (4 * n + 5 * C), rows * (compares + 2 * n + C),
                  INT32_OPS_PER_S)


def extend_bound(reads: int, C: int, L: int, W: int, G: int,
                 filled: float = 1.0) -> dict:
    """One launch over `reads` reads of length L: the oriented reads as
    int32 [2 reads, L], the lengths, the candidates int32 [2 reads, C], the
    reference windows (L + 2W bytes a filled slot, at most the whole
    reference), both score tables [L, 5, 5] int32, four int32 outputs a
    slot; EXTEND_OPS_PER_CELL operations a cell of the (2W + 1)-cell band
    over L rows, for the filled share of the slots."""
    slots = 2 * reads * C
    used = slots * filled
    cells = used * (2 * W + 1) * L
    n_bytes = (2 * reads * L * 4 + reads * 4 + slots * 4
               + min(G, used * (L + 2 * W)) + 2 * L * 25 * 4 + 4 * slots * 4)
    return _bound(n_bytes, EXTEND_OPS_PER_CELL * cells, INSTR_OPS_PER_S)
