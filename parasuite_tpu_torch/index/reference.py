"""Packed multi-chromosome reference.

A copy of parasuite_tpu/index/reference.py (same on-disk format). The
device-side equivalent of BWA's packed 2-bit reference (upstream bntseq.c .pac
/ .ann files; SURVEY.md §2 component 5). Differences by design:

- codes stay one-byte int8 (0..4 incl. N) rather than 2-bit-packed: the
  alignment kernels gather windows directly from this array in device
  memory, and int8
  gathers are cheap while unpack logic is not;
- chromosomes are concatenated with an N spacer of cfg.chrom_spacer bases
  (> L + 2W) so no alignment window can straddle two chromosomes — boundary
  handling becomes a property of the data layout instead of per-candidate
  branching.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from parasuite_tpu_torch.utils.dna import N


@dataclass
class PackedReference:
    """Concatenated reference with chromosome directory.

    seq:    int8 [G]  concatenated codes with leading/trailing/inter-chrom N spacers
    names:  list[str] chromosome names in order
    starts: int64 [n] offset of each chromosome's first base in `seq`
    ends:   int64 [n] offset one past each chromosome's last base
    """

    seq: np.ndarray
    names: list
    starts: np.ndarray
    ends: np.ndarray

    @classmethod
    def from_dict(cls, seqs: dict[str, np.ndarray], spacer: int = 256) -> "PackedReference":
        names = list(seqs.keys())
        parts = []
        starts = np.zeros(len(names), dtype=np.int64)
        ends = np.zeros(len(names), dtype=np.int64)
        pad = np.full(spacer, N, dtype=np.int8)
        pos = 0
        for i, name in enumerate(names):
            parts.append(pad)
            pos += spacer
            starts[i] = pos
            s = np.asarray(seqs[name], dtype=np.int8)
            parts.append(s)
            pos += len(s)
            ends[i] = pos
        parts.append(pad)
        seq = np.concatenate(parts)
        return cls(seq=seq, names=names, starts=starts, ends=ends)

    @property
    def total_len(self) -> int:
        return int(self.seq.shape[0])

    def chrom_len(self, i: int) -> int:
        return int(self.ends[i] - self.starts[i])

    def locate(self, packed_pos: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Packed coordinates -> (chrom_index, 0-based local position).

        Positions inside a spacer get chrom_index -1.
        """
        packed_pos = np.asarray(packed_pos, dtype=np.int64)
        ci = np.searchsorted(self.starts, packed_pos, side="right") - 1
        ci = np.clip(ci, 0, len(self.names) - 1)
        local = packed_pos - self.starts[ci]
        in_chrom = (packed_pos >= self.starts[ci]) & (packed_pos < self.ends[ci])
        return np.where(in_chrom, ci, -1), local

    # --- serialization ---
    def save(self, prefix) -> None:
        prefix = Path(prefix)
        np.save(str(prefix) + ".seq.npy", self.seq)
        meta = {
            "names": self.names,
            "starts": self.starts.tolist(),
            "ends": self.ends.tolist(),
        }
        Path(str(prefix) + ".ref.json").write_text(json.dumps(meta))

    @classmethod
    def load(cls, prefix) -> "PackedReference":
        seq = np.load(str(prefix) + ".seq.npy")
        meta = json.loads(Path(str(prefix) + ".ref.json").read_text())
        return cls(
            seq=seq,
            names=meta["names"],
            starts=np.asarray(meta["starts"], dtype=np.int64),
            ends=np.asarray(meta["ends"], dtype=np.int64),
        )
