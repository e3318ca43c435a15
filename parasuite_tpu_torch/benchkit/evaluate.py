"""Mapping sensitivity/precision vs simulation ground truth (SURVEY.md §2
component 10; BASELINE.json config 4).

A copy of parasuite_tpu/benchkit/evaluate.py:13-47 (its package imports
jax) that takes the port's SimTruth; tests/test_torch_cli.py pins it to
the original."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from parasuite_tpu_torch.sim.generate import SimTruth


@dataclass
class EvalReport:
    n_reads: int
    n_mapped: int
    n_correct: int
    tolerance: int

    @property
    def sensitivity(self) -> float:
        return self.n_correct / max(self.n_reads, 1)

    @property
    def precision(self) -> float:
        return self.n_correct / max(self.n_mapped, 1)

    def to_dict(self) -> dict:
        return {"n_reads": self.n_reads, "n_mapped": self.n_mapped,
                "n_correct": self.n_correct,
                "sensitivity": round(self.sensitivity, 6),
                "precision": round(self.precision, 6),
                "tolerance": self.tolerance}


def evaluate_against_truth(truth: SimTruth, mapped: np.ndarray,
                           strand: np.ndarray, packed_pos: np.ndarray,
                           tolerance: int = 0) -> EvalReport:
    """A read is correct if mapped to the true (strand, position) within
    +-tolerance bases (tolerance>0 forgives indel-shifted starts)."""
    n = truth.packed_pos.shape[0]
    m = np.asarray(mapped[:n], dtype=bool)
    ok = (m & (np.asarray(strand[:n]) == truth.strand)
          & (np.abs(np.asarray(packed_pos[:n]).astype(np.int64)
                    - truth.packed_pos) <= tolerance))
    return EvalReport(n_reads=n, n_mapped=int(m.sum()),
                      n_correct=int(ok.sum()), tolerance=tolerance)
