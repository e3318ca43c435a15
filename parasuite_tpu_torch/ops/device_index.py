"""Device-resident index and scoring parameters (dataclasses of tensors).

Counterpart of parasuite_tpu/ops/device_index.py. Every tensor lives on one
explicit device; the packed reference and k-mer tables are uploaded once per
engine, the score tensors once per pass.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from parasuite_tpu_torch.config import AlignConfig
from parasuite_tpu_torch.errormodel.scoring import complement_score_tensor
from parasuite_tpu_torch.index.kmer import KmerIndex
from parasuite_tpu_torch.index.reference import PackedReference


def _to(x: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    x = np.require(x, requirements=["C", "W"])  # from_numpy shares memory
    return torch.from_numpy(x).to(device=device, dtype=dtype)


@dataclass
class DeviceIndex:
    """Alignment-time reference state."""

    ref_seq: torch.Tensor        # int8  [G]
    bucket_starts: torch.Tensor  # int32 [4^k + 1]
    positions: torch.Tensor      # int32 [n_kmers]
    chrom_starts: torch.Tensor   # int32 [n_chroms]
    chrom_ends: torch.Tensor     # int32 [n_chroms]

    @classmethod
    def from_numpy(cls, ref_seq, bucket_starts, positions, chrom_starts,
                   chrom_ends, device) -> "DeviceIndex":
        return cls(ref_seq=_to(ref_seq, torch.int8, device),
                   bucket_starts=_to(bucket_starts, torch.int32, device),
                   positions=_to(positions, torch.int32, device),
                   chrom_starts=_to(chrom_starts, torch.int32, device),
                   chrom_ends=_to(chrom_ends, torch.int32, device))

    @classmethod
    def from_host(cls, ref: PackedReference, index: KmerIndex,
                  device) -> "DeviceIndex":
        if ref.total_len > np.iinfo(np.int32).max:
            raise ValueError("packed reference exceeds int32; partition it "
                             "by chromosome with parallel.shards."
                             "build_sharded_index")
        return cls.from_numpy(ref.seq, index.bucket_starts, index.positions,
                              ref.starts, ref.ends, device)


# host-side MAPQ subtraction table so device math is integer-only and matches
# oracle._mapq bit-for-bit (the 4.343*log is evaluated once here in float64)
def _mapq_table(n: int = 256) -> np.ndarray:
    t = np.zeros(n, dtype=np.int32)
    for x1 in range(1, n):
        t[x1] = int(4.343 * np.log(x1))
    return t


@dataclass
class ScoreParams:
    """Per-pass scoring state."""

    s_fwd: torch.Tensor      # int32 [L, 5, 5]
    s_comp: torch.Tensor     # int32 [L, 5, 5]  (complement-transformed)
    mapq_sub: torch.Tensor   # int32 [256]

    @classmethod
    def from_numpy(cls, s_fwd, s_comp, mapq_sub, device) -> "ScoreParams":
        return cls(s_fwd=_to(s_fwd, torch.int32, device),
                   s_comp=_to(s_comp, torch.int32, device),
                   mapq_sub=_to(mapq_sub, torch.int32, device))

    @classmethod
    def from_tensor(cls, s_tensor: np.ndarray, cfg: AlignConfig,
                    device) -> "ScoreParams":
        """Keeps exactly L = max_read_len rows: the extension indexes the
        stacked (s_fwd, s_comp) table as if each had L rows."""
        L = cfg.max_read_len
        if s_tensor.shape[0] < L:
            raise ValueError("score tensor shorter than max_read_len")
        s = np.asarray(s_tensor)[:L]
        return cls.from_numpy(s, complement_score_tensor(s), _mapq_table(),
                              device)


def min_scores_host(lengths: np.ndarray, cfg: AlignConfig) -> np.ndarray:
    """Per-read mapping threshold, computed host-side in float64 so device
    integer math never re-derives it (exactness discipline, SURVEY.md §7)."""
    return np.asarray(
        [int(cfg.min_score_frac * int(l) * cfg.match_score) for l in lengths],
        dtype=np.int32)


def min_score_table(cfg: AlignConfig) -> np.ndarray:
    """int32 [L+1] lookup so per-batch min_scores need no host loop."""
    return min_scores_host(np.arange(cfg.max_read_len + 1), cfg)
