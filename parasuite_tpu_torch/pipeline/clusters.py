"""Binding-site cluster calling (SURVEY.md §2 component 11, §3.5) in the
port: copies of parasuite_tpu/pipeline/clusters.py (that package imports jax
when it is imported) — Cluster, TSV_HEADER, call_clusters and
write_clusters (clusters.py:27-130) beside tc_count_from_cigar (:43-71).
tests/test_torch_pipeline.py and tests/test_torch_cli.py pin the copies to
the originals.

Reference mechanism: coordinate-sorted BAM sweep maintaining an open
interval; overlapping reads extend the current cluster, a gap closes it;
clusters report read count and T->C conversion statistics and low-support
clusters are filtered. Here the same sweep is vectorized numpy over the
merged alignment table (sort + run-boundary detection + segmented sums).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from parasuite_tpu_torch.config import AlignConfig
from parasuite_tpu_torch.index.reference import PackedReference


@dataclass
class Cluster:
    chrom: str
    start: int        # 0-based inclusive, local coords
    end: int          # 0-based exclusive
    n_reads: int
    n_tc: int         # total machine-frame T->C conversions in cluster
    conversion_specificity: float  # fraction of reads with >=1 conversion

    def to_tsv(self) -> str:
        return (f"{self.chrom}\t{self.start}\t{self.end}\t{self.n_reads}\t"
                f"{self.n_tc}\t{self.conversion_specificity:.4f}")


TSV_HEADER = "#chrom\tstart\tend\tn_reads\tn_tc\tconversion_specificity"


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


def call_clusters(ref: PackedReference, packed_pos: np.ndarray,
                  ref_span: np.ndarray, tc_count: np.ndarray,
                  cfg: AlignConfig) -> list[Cluster]:
    """Group overlapping alignments into clusters.

    packed_pos: int64 [N] packed start coordinates of mapped reads
    ref_span:   int32 [N] reference bases consumed (sum of M+D in CIGAR)
    tc_count:   int32 [N] per-read T->C conversions

    Because chromosomes are separated by N spacers longer than any read, the
    sweep never needs explicit chromosome-boundary logic: clusters cannot
    bridge a spacer (layout-as-invariant, like the aligner).
    """
    if packed_pos.shape[0] == 0:
        return []
    order = np.argsort(packed_pos, kind="stable")
    pos = packed_pos[order].astype(np.int64)
    ends = pos + ref_span[order].astype(np.int64)
    tc = tc_count[order].astype(np.int64)

    # sweep: running max of interval ends; a new cluster starts where the
    # current read begins after everything seen so far has ended
    run_end = np.maximum.accumulate(ends)
    new_cluster = np.ones(pos.shape[0], dtype=bool)
    new_cluster[1:] = pos[1:] >= run_end[:-1]
    cid = np.cumsum(new_cluster) - 1
    n_clusters = int(cid[-1]) + 1

    c_start = np.full(n_clusters, np.iinfo(np.int64).max)
    np.minimum.at(c_start, cid, pos)
    c_end = np.zeros(n_clusters, dtype=np.int64)
    np.maximum.at(c_end, cid, ends)
    c_reads = np.bincount(cid, minlength=n_clusters)
    c_tc = np.bincount(cid, weights=tc, minlength=n_clusters).astype(np.int64)
    c_conv_reads = np.bincount(cid, weights=(tc > 0), minlength=n_clusters)

    keep = (c_reads >= cfg.cluster_min_reads) & (c_tc >= cfg.cluster_min_tc)
    out: list[Cluster] = []
    ci_all, local_start = ref.locate(c_start)
    _, local_end = ref.locate(c_end - 1)
    for c in np.nonzero(keep)[0]:
        out.append(Cluster(
            chrom=ref.names[int(ci_all[c])],
            start=int(local_start[c]),
            end=int(local_end[c]) + 1,
            n_reads=int(c_reads[c]),
            n_tc=int(c_tc[c]),
            conversion_specificity=float(c_conv_reads[c] / c_reads[c]),
        ))
    return out


def write_clusters(path, clusters: list[Cluster]) -> None:
    with open(path, "w") as fh:
        fh.write(TSV_HEADER + "\n")
        for c in clusters:
            fh.write(c.to_tsv() + "\n")
