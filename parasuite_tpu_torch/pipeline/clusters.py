"""Host helper copied from parasuite_tpu/pipeline/clusters.py (that package
imports jax when it is imported). tests/test_torch_pipeline.py pins the copy
to the original."""

from __future__ import annotations

import numpy as np


def tc_count_from_cigar(ref_seq: np.ndarray, packed_pos: int,
                        oriented_codes: np.ndarray, strand: int,
                        cigar: list[tuple[str, int]]) -> int:
    """Machine-frame T->C conversions over the M segments of one alignment.

    oriented_codes are genome-frame (reverse hits already revcomp'd, i.e.
    SAM SEQ order). A machine-frame T->C appears on the genome strand as
    (ref T, read C) forward and (ref A, read G) reverse. I ops consume read
    only; D and N (junction skips) consume reference only — so gapped and
    junction-spanning records stay in frame (SURVEY.md §3.5 cluster
    statistics; the flat `ref[p:p+len]` comparison the CLI used before was
    wrong for any CIGAR with I/D/N)."""
    tc = 0
    ri, qi = int(packed_pos), 0
    for op, ln in cigar:
        if op == "M":
            rb = ref_seq[ri : ri + ln]
            cb = oriented_codes[qi : qi + ln]
            if strand == 0:
                tc += int(np.sum((rb == 3) & (cb == 1)))
            else:
                tc += int(np.sum((rb == 0) & (cb == 2)))
            ri += ln
            qi += ln
        elif op == "I":
            qi += ln
        elif op in ("D", "N"):
            ri += ln
    return tc
