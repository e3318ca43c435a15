"""Error-profile inference (SURVEY.md §2 component 3, §3.3 call stack).

From a set of aligned reads, accumulate counts[read_pos][ref_base][read_base]
over the M segments of each alignment (the reference's htsjdk record loop over
MD-tag/reference comparison, re-expressed as a vectorized scatter-add).

Conventions:
  * counts are in MACHINE-READ orientation: for reverse-strand alignments the
    reference base is complemented and the position index reversed, so cycle i
    always means "i-th sequenced base" — this is what makes T->C conversions
    (and not A->G shadows) accumulate in one cell, the property the PARA-suite
    profile relies on;
  * counts are int64 and the accumulation order never matters (pure adds), so
    profiles are bit-identical at any shard count; multi-host runs psum the
    count matrices (BASELINE.json:north_star; parallel/).

The numpy implementation here is the oracle; the device path lives in
ops/profile_update.py and must match it exactly.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from parasuite_tpu_torch.config import AlignConfig
from parasuite_tpu_torch.index.reference import PackedReference
from parasuite_tpu_torch.utils.dna import COMP, N


@dataclass
class ErrorProfile:
    """Substitution count matrix + indel counts + derived frequencies.

    counts: int64 [L, 4, 4]  (read_pos, ref_base, read_base), ACGT only —
            positions where either side is N are not counted.
    ins_counts / del_counts: int64 [L] per-machine-cycle indel events from
            the gapped alignments (SURVEY.md §2 component 3 "plus indel
            rates"). Gapped reads are <<1% of PAR-CLIP data, so these are
            counted on the host from traceback CIGARs, not on device.
    """

    counts: np.ndarray
    n_reads: int = 0
    ins_counts: np.ndarray | None = None
    del_counts: np.ndarray | None = None
    n_gapped: int = 0

    def __post_init__(self) -> None:
        L = self.counts.shape[0]
        if self.ins_counts is None:
            self.ins_counts = np.zeros(L, dtype=np.int64)
        if self.del_counts is None:
            self.del_counts = np.zeros(L, dtype=np.int64)

    @property
    def read_len(self) -> int:
        return int(self.counts.shape[0])

    def probs(self, pseudocount: float = 0.5) -> np.ndarray:
        """P(read base c | ref base r, position i) with additive smoothing."""
        c = self.counts.astype(np.float64) + pseudocount
        return c / c.sum(axis=2, keepdims=True)

    def conversion_rate(self, ref_base: int, read_base: int) -> np.ndarray:
        """Per-position conditional rate, e.g. (T, C) for PAR-CLIP T->C."""
        row = self.counts[:, ref_base, :].astype(np.float64)
        tot = row.sum(axis=1)
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(tot > 0, row[:, read_base] / np.maximum(tot, 1), 0.0)

    def indel_rates(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-machine-cycle (insertion, deletion) event rates.

        Denominator = reads contributing at that cycle. Gapped reads feed
        the substitution counts through their M segments (SURVEY.md §3.3:
        the reference's record loop counts every aligned read), so the only
        read bases missing from counts are the inserted ones — adding
        ins_counts back makes the denominator exactly the aligned-read count
        per cycle."""
        per_cycle = (self.counts.sum(axis=(1, 2)) +
                     self.ins_counts).astype(np.float64)
        denom = np.maximum(per_cycle, 1.0)
        return (self.ins_counts / denom, self.del_counts / denom)

    def gap_penalties(self, cfg) -> tuple[int, int]:
        """Learned (gap_open, gap_extend) on the integer log-odds scale.

        Mirrors the substitution-score derivation (errormodel/scoring.py):
        penalty = -profile_scale * log2(rate / 0.25), with additive smoothing
        and clipped to the aligner's int8 kernel feed. Opt-in — the pipeline
        keeps cfg's penalties unless the caller swaps them in explicitly."""
        total_bases = float(self.counts.sum() + self.ins_counts.sum())
        gap_bases = float(self.ins_counts.sum() + self.del_counts.sum())
        p_gap = (gap_bases + cfg.profile_pseudocount) / max(total_bases, 1.0)
        go = int(np.clip(round(-cfg.profile_scale
                               * np.log2(max(p_gap, 1e-12) / 0.25)), 1, 127))
        ge = max(1, go // 3)  # extension ~1/3 of open, BWA-like ratio
        return go, ge

    # --- .errorprofile text format (ours; reference format to be matched on
    #     mount, SURVEY.md §8.2) ---
    def save(self, path) -> None:
        lines = ["#parasuite_tpu errorprofile v2",
                 f"#read_len\t{self.read_len}",
                 f"#n_reads\t{self.n_reads}",
                 f"#n_gapped\t{self.n_gapped}",
                 "#pos\tref\tread\tcount"]
        bases = "ACGT"
        for i in range(self.read_len):
            for r in range(4):
                for c in range(4):
                    lines.append(f"{i}\t{bases[r]}\t{bases[c]}\t{int(self.counts[i, r, c])}")
        lines.append("#indels\tpos\tins\tdel")
        for i in range(self.read_len):
            lines.append(f"IND\t{i}\t{int(self.ins_counts[i])}"
                         f"\t{int(self.del_counts[i])}")
        Path(path).write_text("\n".join(lines) + "\n")

    @classmethod
    def load(cls, path) -> "ErrorProfile":
        base_idx = {"A": 0, "C": 1, "G": 2, "T": 3}
        read_len = 0
        n_reads = 0
        n_gapped = 0
        rows = []
        ind_rows = []
        for line in Path(path).read_text().splitlines():
            if line.startswith("#read_len"):
                read_len = int(line.split("\t")[1])
            elif line.startswith("#n_reads"):
                n_reads = int(line.split("\t")[1])
            elif line.startswith("#n_gapped"):
                n_gapped = int(line.split("\t")[1])
            elif line.startswith("#"):
                continue
            elif line.startswith("IND\t"):
                _, p, ni, nd = line.split("\t")
                ind_rows.append((int(p), int(ni), int(nd)))
            elif line:
                p, r, c, n = line.split("\t")
                rows.append((int(p), base_idx[r], base_idx[c], int(n)))
        counts = np.zeros((read_len, 4, 4), dtype=np.int64)
        for p, r, c, n in rows:
            counts[p, r, c] = n
        ins = np.zeros(read_len, dtype=np.int64)
        dels = np.zeros(read_len, dtype=np.int64)
        for p, ni, nd in ind_rows:
            ins[p], dels[p] = ni, nd
        return cls(counts=counts, n_reads=n_reads, ins_counts=ins,
                   del_counts=dels, n_gapped=n_gapped)


def infer_counts_numpy(read_codes: np.ndarray, lengths: np.ndarray,
                       mapped: np.ndarray, strand: np.ndarray,
                       packed_pos: np.ndarray, ref: PackedReference,
                       max_read_len: int,
                       ungapped_only: np.ndarray | None = None) -> ErrorProfile:
    """Oracle count accumulation over ungapped (single-M) alignments.

    read_codes [B, L] machine orientation; packed_pos is the alignment start.
    Gapped alignments (ungapped_only False) are skipped HERE — this is the
    oracle for the device scatter-add, which covers ungapped rows only; the
    streaming pipelines feed gapped reads' M segments host-side via
    count_substitutions_from_cigar so the full profile covers every aligned
    read (SURVEY.md §3.3).
    """
    counts = np.zeros((max_read_len, 4, 4), dtype=np.int64)
    n_used = 0
    B = read_codes.shape[0]
    for b in range(B):
        if not mapped[b] or (ungapped_only is not None and not ungapped_only[b]):
            continue
        ln = int(lengths[b])
        if ln == 0:
            continue
        pos = int(packed_pos[b])
        rb = ref.seq[pos : pos + ln].astype(np.int64)
        cycle = np.arange(ln)
        read_b = read_codes[b, :ln].astype(np.int64)  # machine frame already
        if strand[b] == 0:
            ref_b = rb
        else:
            # machine cycle i sits at aligned offset ln-1-i on the opposite
            # strand: complement-reverse the reference side into machine frame
            ref_b = COMP[rb[::-1]].astype(np.int64)
        ok = (ref_b < 4) & (read_b < 4)
        np.add.at(counts, (cycle[ok], ref_b[ok], read_b[ok]), 1)
        n_used += 1
    return ErrorProfile(counts=counts, n_reads=n_used)


def count_substitutions_from_cigar(ref_seq: np.ndarray, packed_pos: int,
                                   oriented_read: np.ndarray, read_len: int,
                                   strand: int, cigar: list,
                                   counts: np.ndarray) -> None:
    """Accumulate machine-frame substitution counts over the M segments of
    one gapped/junction alignment (the <<1% of reads the device's
    ungapped-only scatter-add skips — SURVEY.md §3.3: the reference's htsjdk
    loop counts every aligned read's M segments; VERDICT r2 missing #6).

    oriented_read is genome-frame (SAM SEQ order); machine cycle of oriented
    offset q is q forward / read_len-1-q reverse, with both bases
    complemented back to machine frame on the reverse strand — identical
    conventions to infer_counts_numpy. I consumes read only, D/N reference
    only; positions where either base is N are not counted."""
    L = counts.shape[0]
    ri, qi = int(packed_pos), 0
    for op, oln in cigar:
        if op == "M":
            rb = ref_seq[ri : ri + oln].astype(np.int64)
            cb = oriented_read[qi : qi + oln].astype(np.int64)
            q = np.arange(qi, qi + oln)
            if strand == 0:
                cyc = q
            else:
                cyc = read_len - 1 - q
                rb = COMP[rb].astype(np.int64)
                cb = COMP[cb].astype(np.int64)
            ok = (rb < 4) & (cb < 4) & (cyc >= 0) & (cyc < L)
            np.add.at(counts, (cyc[ok], rb[ok], cb[ok]), 1)
            ri += oln
            qi += oln
        elif op == "I":
            qi += oln
        elif op in ("D", "N"):
            ri += oln


def count_indels_from_cigar(cigar: list, read_len: int, strand: int,
                            ins_counts: np.ndarray,
                            del_counts: np.ndarray) -> None:
    """Accumulate per-machine-cycle indel events from one traceback CIGAR.

    The CIGAR walks the ORIENTED (genome-frame) read; machine cycle of
    oriented offset q is q forward / read_len-1-q reverse (same frame
    convention as the substitution counts). Insertions count one event per
    inserted base at that base's cycle; a deletion of n ref bases counts n
    events at the cycle of the read base following the gap.
    """
    L = ins_counts.shape[0]
    qi = 0
    for op, oln in cigar:
        if op == "M":
            qi += oln
        elif op == "I":
            for q in range(qi, qi + oln):
                c = q if strand == 0 else read_len - 1 - q
                if 0 <= c < L:
                    ins_counts[c] += 1
            qi += oln
        elif op == "D":
            q = min(qi, read_len - 1)
            c = q if strand == 0 else read_len - 1 - q
            if 0 <= c < L:
                del_counts[c] += oln
        # N (junction skips, combined mode) carries no indel signal


def counts_to_profile(profile: ErrorProfile, cfg: AlignConfig) -> np.ndarray:
    """ErrorProfile -> learned score tensor S [L, 5, 5] (int32)."""
    from parasuite_tpu_torch.errormodel.scoring import profile_score_tensor

    return profile_score_tensor(profile.probs(cfg.profile_pseudocount), cfg)
