"""DNA 2-bit+N code utilities (host-side, numpy).

Encoding: A=0, C=1, G=2, T=3, N(and any other IUPAC)=4 — the same nt4 table
BWA uses for its packed reference (upstream bntseq.c nst_nt4_table), chosen so
complement(code) = 3 - code for real bases.
"""

from __future__ import annotations

import numpy as np

A, C, G, T, N = 0, 1, 2, 3, 4

CODE_TO_BASE = np.frombuffer(b"ACGTN", dtype=np.uint8)

# 256-entry lookup: ASCII byte -> code (case-insensitive, everything else -> N)
BASE_TO_CODE = np.full(256, N, dtype=np.int8)
for _i, _b in enumerate(b"ACGT"):
    BASE_TO_CODE[_b] = _i
    BASE_TO_CODE[_b + 32] = _i  # lowercase

# complement: A<->T, C<->G, N->N
COMP = np.array([T, G, C, A, N], dtype=np.int8)


def encode_seq(seq: bytes | str) -> np.ndarray:
    """ASCII sequence -> int8 codes (0..4)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return BASE_TO_CODE[np.frombuffer(seq, dtype=np.uint8)]


def decode_seq(codes: np.ndarray) -> str:
    """int8 codes -> ASCII string."""
    return CODE_TO_BASE[np.asarray(codes, dtype=np.int64)].tobytes().decode("ascii")


def complement_codes(codes: np.ndarray) -> np.ndarray:
    return COMP[np.asarray(codes, dtype=np.int64)]


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement along the last axis."""
    return complement_codes(np.asarray(codes))[..., ::-1]
