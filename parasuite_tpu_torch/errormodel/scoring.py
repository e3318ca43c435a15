"""Substitution score tensors S[read_pos, ref_base, read_base].

This tensor IS the PARA-suite feature (BASELINE.json:north_star): where BWA
scores every mismatch with one constant (upstream bwtaln.c flat penalty), the
profile-aware pass scores substitution (ref r -> observed c) at read position
i with an integer log-odds value learned from a first-pass alignment, making
expected PAR-CLIP T->C conversions cheap exactly where the data says they are
likely (reference: the PARA-suite aligner's patched penalty in bwtgap.c
bwt_match_gap, per SURVEY.md §3.2 — to be re-verified on mount, SURVEY.md §8).

Both passes use the same tensor form (SURVEY.md §7 "Two-pass": one code path,
two matrices). All values are int32; DP math never sees a float.

Shape convention: [L, 5, 5] indexed by (read position, ref code, read code),
codes 0..4 with 4 = N; any comparison involving N scores cfg.n_score.
"""

from __future__ import annotations

import numpy as np

from parasuite_tpu_torch.config import AlignConfig
from parasuite_tpu_torch.utils.dna import COMP


def flat_score_tensor(cfg: AlignConfig, length: int | None = None) -> np.ndarray:
    """Pass-1 tensor: position-independent match/mismatch (BWA-equivalent)."""
    L = length if length is not None else cfg.max_read_len
    s = np.full((L, 5, 5), cfg.mismatch_score, dtype=np.int32)
    for b in range(4):
        s[:, b, b] = cfg.match_score
    s[:, 4, :] = cfg.n_score
    s[:, :, 4] = cfg.n_score
    return s


def profile_score_tensor(probs: np.ndarray, cfg: AlignConfig) -> np.ndarray:
    """Learned tensor from conditional probabilities.

    probs: float64 [L, 4, 4], probs[i, r, c] = P(observe read base c | ref base
    r, read position i), rows normalized. Score = clip(round(scale * log2(p /
    0.25))) — log-odds against the uniform background, integerized so the DP
    stays exact (SURVEY.md §7 "Exactness discipline").
    """
    L = probs.shape[0]
    with np.errstate(divide="ignore"):
        logodds = cfg.profile_scale * np.log2(np.maximum(probs, 1e-12) / 0.25)
    s4 = np.clip(np.rint(logodds), cfg.profile_min_score, cfg.profile_max_score)
    s = np.full((L, 5, 5), cfg.n_score, dtype=np.int32)
    s[:, :4, :4] = s4.astype(np.int32)
    return s


def complement_score_tensor(s: np.ndarray) -> np.ndarray:
    """S_comp[i, r, c] = S[i, comp(r), comp(c)].

    Aligning the reverse-complemented read forward against the reference and
    scoring position i with S_comp[Lr-1-i] is exactly scoring the original
    machine-cycle/base pair with S — this is how strand handling stays a data
    transform instead of a second code path.
    """
    comp = COMP.astype(np.int64)
    return np.ascontiguousarray(s[:, comp][:, :, comp])
