"""Combined genome+transcriptome reference (SURVEY.md §2 component 7;
BASELINE.json config 3) in the port.

A copy of parasuite_tpu/pipeline/combined.py (that package imports jax when
it is imported), pinned to it by tests/test_torch_combined.py. The host half
(Transcript, annotation parsers, splice_transcript, CombinedReference,
project_to_genome, build_combined_index) is numpy and unchanged, so either
package loads the other's index files. CombinedEngine runs the device step
on the engine's device through align_batch_with_candidates and keeps the
reference's unpacked to_host branch: the compacted PackedCandidates wire
and the device projection exist for the remote-TPU tunnel and are not
ported (the reference pins both branches equal, test_packed_wire_parity).

Transcripts are packed as extra "chromosomes" (name prefix "tx::") into ONE
PackedReference, so a single index and a single device pass cover both
spaces. Projection back to genome is a host-side exon-table walk, emitting
spliced CIGARs with N (intron skip) ops for junction-spanning reads.

Annotation input: TSV with columns
    tx_id  chrom  strand(+/-)  exon_starts(comma,0-based)  exon_ends(comma)
or a GTF/GFF file (exon features grouped by transcript_id).
"""

from __future__ import annotations

import functools
import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from parasuite_tpu.config import AlignConfig
from parasuite_tpu.index.kmer import KmerIndex
from parasuite_tpu.index.reference import PackedReference
from parasuite_tpu.utils.dna import revcomp_codes
from parasuite_tpu_torch.pipeline.align import (AlignerEngine, HostAlignments,
                                                LazyCigars, fetch_host,
                                                host_tracebacks_batch,
                                                orient_rows)
from parasuite_tpu_torch.pipeline.clusters import tc_count_from_cigar

TX_PREFIX = "tx::"


@dataclass
class Transcript:
    tx_id: str
    chrom: str
    strand: str                 # '+' or '-'
    exon_starts: np.ndarray     # int64 [n_exons], 0-based, ascending
    exon_ends: np.ndarray       # int64 [n_exons], exclusive

    # cached: project_to_genome runs per junction entry on the hot path —
    # recomputing cumsum/concatenate per call measured ~30% of its cost
    @functools.cached_property
    def spliced_len(self) -> int:
        return int((self.exon_ends - self.exon_starts).sum())

    @functools.cached_property
    def cumlens(self) -> np.ndarray:
        """Spliced-plus offsets of each exon start: [n_exons + 1]."""
        return np.concatenate([[0], np.cumsum(self.exon_ends - self.exon_starts)])


def parse_annotation(path) -> list[Transcript]:
    out = []
    for line in Path(path).read_text().splitlines():
        if not line or line.startswith("#"):
            continue
        tx_id, chrom, strand, starts, ends = line.split("\t")
        s = np.asarray([int(x) for x in starts.split(",") if x], dtype=np.int64)
        e = np.asarray([int(x) for x in ends.split(",") if x], dtype=np.int64)
        if not (len(s) == len(e) and np.all(e > s) and np.all(np.diff(s) > 0)):
            raise ValueError(f"bad exon structure for {tx_id}")
        out.append(Transcript(tx_id, chrom, strand, s, e))
    return out


def parse_gtf(path) -> list[Transcript]:
    """Minimal GTF/GFF2 exon parser -> Transcripts (the reference consumes
    annotation the same way for its combiner; SURVEY.md §2 component 7).

    Uses 'exon' features grouped by transcript_id; start is converted from
    GTF's 1-based inclusive to 0-based half-open.
    """
    import re

    tx_id_re = re.compile(r'transcript_id\s+"([^"]+)"')
    acc: dict[str, dict] = {}
    for line in Path(path).read_text().splitlines():
        if not line or line.startswith("#"):
            continue
        f = line.split("\t")
        if len(f) < 9 or f[2] != "exon":
            continue
        m = tx_id_re.search(f[8])
        if not m:
            raise ValueError(f"exon without transcript_id: {line[:80]}")
        tid = m.group(1)
        rec = acc.setdefault(tid, {"chrom": f[0], "strand": f[6],
                                   "starts": [], "ends": []})
        if rec["chrom"] != f[0] or rec["strand"] != f[6]:
            raise ValueError(f"transcript {tid} spans chroms/strands")
        rec["starts"].append(int(f[3]) - 1)
        rec["ends"].append(int(f[4]))
    out = []
    for tid, rec in acc.items():
        order = np.argsort(rec["starts"])
        out.append(Transcript(
            tid, rec["chrom"], rec["strand"],
            np.asarray(rec["starts"], dtype=np.int64)[order],
            np.asarray(rec["ends"], dtype=np.int64)[order]))
    return out


def load_annotation(path) -> list[Transcript]:
    """Dispatch on extension: .gtf/.gff -> GTF parser, else exon-table TSV."""
    suffix = Path(path).suffix.lower()
    if suffix in (".gtf", ".gff"):
        return parse_gtf(path)
    return parse_annotation(path)


def splice_transcript(genome: dict[str, np.ndarray], tx: Transcript) -> np.ndarray:
    chrom = genome[tx.chrom]
    parts = [chrom[int(s):int(e)] for s, e in zip(tx.exon_starts, tx.exon_ends)]
    spliced = np.concatenate(parts)
    return revcomp_codes(spliced) if tx.strand == "-" else spliced


@dataclass
class CombinedReference:
    """PackedReference over genome chroms + tx:: pseudo-chroms, plus the exon
    tables needed for projection."""

    ref: PackedReference
    transcripts: dict  # tx_id -> Transcript
    genome_names: list

    @classmethod
    def build(cls, genome: dict[str, np.ndarray],
              transcripts: list[Transcript], spacer: int) -> "CombinedReference":
        seqs = dict(genome)
        for tx in transcripts:
            seqs[TX_PREFIX + tx.tx_id] = splice_transcript(genome, tx)
        ref = PackedReference.from_dict(seqs, spacer=spacer)
        return cls(ref=ref, transcripts={t.tx_id: t for t in transcripts},
                   genome_names=list(genome.keys()))

    # --- serialization ---
    def save(self, prefix) -> None:
        self.ref.save(prefix)
        meta = {
            "genome_names": self.genome_names,
            "transcripts": [
                {"tx_id": t.tx_id, "chrom": t.chrom, "strand": t.strand,
                 "exon_starts": t.exon_starts.tolist(),
                 "exon_ends": t.exon_ends.tolist()}
                for t in self.transcripts.values()],
        }
        Path(str(prefix) + ".combined.json").write_text(json.dumps(meta))

    @classmethod
    def load(cls, prefix) -> "CombinedReference":
        ref = PackedReference.load(prefix)
        meta = json.loads(Path(str(prefix) + ".combined.json").read_text())
        txs = {d["tx_id"]: Transcript(
            d["tx_id"], d["chrom"], d["strand"],
            np.asarray(d["exon_starts"], dtype=np.int64),
            np.asarray(d["exon_ends"], dtype=np.int64))
            for d in meta["transcripts"]}
        return cls(ref=ref, transcripts=txs, genome_names=meta["genome_names"])


def project_to_genome(tx: Transcript, tx_pos: int,
                      cigar: list[tuple[str, int]], read_strand: int
                      ) -> tuple[str, int, list[tuple[str, int]], int]:
    """Project a transcript-space alignment to genome space.

    tx_pos: 0-based start in transcript orientation; cigar: M/I/D ops in
    transcript space. Returns (chrom, genomic_start_0based, genomic_cigar
    with N ops for skipped introns, genomic_strand).

    For '-' transcripts the spliced sequence was reverse-complemented, so the
    alignment interval flips to the spliced-plus frame, the CIGAR reverses,
    and the strand toggles (read fwd on a '-' transcript = genome reverse).
    """
    span = sum(ln for op, ln in cigar if op in "MD")
    T = tx.spliced_len
    if tx.strand == "-":
        s_start = T - (tx_pos + span)
        walk_cigar = list(reversed(cigar))
        g_strand = 1 - read_strand
    else:
        s_start = tx_pos
        walk_cigar = list(cigar)
        g_strand = read_strand
    if s_start < 0 or tx_pos + span > T:
        raise ValueError("alignment outside transcript")

    cum = tx.cumlens
    out: list[tuple[str, int]] = []

    def emit(op: str, ln: int) -> None:
        if ln == 0:
            return
        if out and out[-1][0] == op:
            out[-1] = (op, out[-1][1] + ln)
        else:
            out.append((op, ln))

    s = s_start  # position in spliced-plus coords
    genomic_start = None
    prev_gend = None  # genomic end of the last ref-consuming segment
    for op, ln in walk_cigar:
        if op == "I":
            emit("I", ln)
            continue
        # M or D consume spliced bases; split across exons, emitting an N op
        # for every genomic gap (intron) between consecutive segments
        remaining = ln
        while remaining > 0:
            e = int(np.searchsorted(cum, s, side="right")) - 1
            take = min(remaining, int(cum[e + 1] - s))
            gpos = int(tx.exon_starts[e] + (s - cum[e]))
            if genomic_start is None:
                genomic_start = gpos
            if prev_gend is not None and gpos > prev_gend:
                emit("N", gpos - prev_gend)
            emit(op, take)
            prev_gend = gpos + take
            s += take
            remaining -= take
    if genomic_start is None:
        raise ValueError("cigar consumes no reference bases")
    return tx.chrom, genomic_start, out, g_strand


# ---------------------------------------------------------------------------
# combined alignment engine
# ---------------------------------------------------------------------------

def _is_single_m(cigar) -> bool:
    return len(cigar) == 1 and cigar[0][0] == "M"


class CombinedEngine(AlignerEngine):
    """Aligns against the combined genome+transcriptome packing, projects
    transcript hits to genome space, and re-finalizes uniqueness/X0/MAPQ in
    genomic coordinates (a transcript hit and its genomic twin are ONE hit).

    Genome chromosomes are packed first and identically in both the combined
    and genome-only references, so genome-direct packed positions transfer
    unchanged; SAM records are emitted against the genome-only reference.
    Subclasses AlignerEngine: inherits set_profile, the emit path and the
    device step; overrides align_device (the candidate table is needed for
    the genome-space re-finalization) and to_host.
    """

    # combined profile counts accumulate host-side from the EMITTED records:
    # the device winner can be re-decided by projection failure / twin
    # dedupe. pipeline/stream.py checks this flag and routes profile
    # accumulation through accumulate_profile_host.
    counts_from_host = True

    def __init__(self, combined: CombinedReference, index: KmerIndex,
                 cfg: AlignConfig, s_tensor=None, xa_tags: bool = False,
                 xa_limit: int = 10, device="cuda"):
        if cfg.rescue_kmer:
            # rescue would need the combined projection/re-finalize applied
            # to the second pass too — fail loudly rather than silently skip
            raise ValueError("rescue_kmer is not supported in combined "
                             "genome+transcriptome mode")
        # base xa machinery stays off — combined XA needs genome projection,
        # handled in to_host/_slow_path below
        super().__init__(combined.ref, index, cfg, s_tensor=s_tensor,
                         xa_tags=False, device=device)
        self.xa_tags = xa_tags
        self.xa_limit = xa_limit
        self.combined = combined
        # genome-only view for emission (identical packing prefix)
        n_genome = len(combined.genome_names)
        self.genome_ref = PackedReference(
            seq=combined.ref.seq[: int(combined.ref.ends[n_genome - 1]) +
                                 cfg.chrom_spacer],
            names=combined.ref.names[:n_genome],
            starts=combined.ref.starts[:n_genome],
            ends=combined.ref.ends[:n_genome])
        self._n_genome = n_genome
        self.sam_ref = self.genome_ref  # SAM in genome coordinates
        # transcripts pack AFTER genome chromosomes, so "is this candidate a
        # transcript hit" is a single packed-position threshold — the key to
        # the host fast path in to_host
        self._tx_boundary = (int(combined.ref.starts[n_genome])
                             if len(combined.ref.names) > n_genome
                             else int(combined.ref.total_len))
        self._build_tx_tables()

    def _build_tx_tables(self) -> None:
        """Flat per-transcript arrays for the vectorized projection.

        Exon cumlens of all transcripts are concatenated with a per-tx offset
        of i*BIG (BIG > max spliced length), keeping the flat array globally
        ascending — ONE np.searchsorted then resolves the exon of every
        entry at once instead of a per-entry Python walk."""
        cref = self.combined.ref
        txs = [self.combined.transcripts[nm[len(TX_PREFIX):]]
               for nm in cref.names[self._n_genome:]]
        self._txs = txs
        nt = len(txs)
        gname_idx = {nm: i for i, nm in enumerate(self.combined.genome_names)}
        self._tx_minus = np.asarray([t.strand == "-" for t in txs], dtype=bool)
        self._tx_len = np.asarray([t.spliced_len for t in txs],
                                  dtype=np.int64).reshape(nt)
        self._tx_gci = np.asarray([gname_idx[t.chrom] for t in txs],
                                  dtype=np.int64).reshape(nt)
        n_ex = np.asarray([len(t.exon_starts) for t in txs],
                          dtype=np.int64).reshape(nt)
        self._cptr = np.zeros(nt + 1, dtype=np.int64)
        np.cumsum(n_ex + 1, out=self._cptr[1:])
        self._eptr = np.zeros(nt + 1, dtype=np.int64)
        np.cumsum(n_ex, out=self._eptr[1:])
        self._big = int(self._tx_len.max()) + 2 if nt else 1
        self._flat_cum = (np.concatenate(
            [t.cumlens + i * self._big for i, t in enumerate(txs)])
            if nt else np.zeros(0, dtype=np.int64))
        self._flat_estart = (np.concatenate([t.exon_starts for t in txs])
                             if nt else np.zeros(0, dtype=np.int64))
        # spliced-plus -> chrom-local genomic position, per base: turns
        # per-entry junction projection into one window gather + a diff
        # (project_to_genome's exon walk is per entry)
        self._h_spoff = np.zeros(nt, dtype=np.int64)
        if nt:
            np.cumsum(self._tx_len[:-1], out=self._h_spoff[1:])
            self._h_gpos = np.concatenate(
                [np.concatenate([np.arange(int(s), int(e), dtype=np.int64)
                                 for s, e in zip(t.exon_starts, t.exon_ends)])
                 for t in txs])
        else:
            self._h_gpos = np.zeros(1, dtype=np.int64)

    def align_device(self, codes, lengths):
        """Device step -> (AlignResult in combined space, CandidateTable),
        left on the device."""
        return self._step(self.didx, self.cfg, codes, lengths,
                          with_candidates=True)

    def to_host(self, batch, devout):
        """-> HostAlignments in GENOME packed coordinates, CIGARs may contain
        N ops for junction-spanning transcript hits.

        Fast path: reads with NO valid transcript-space candidate take the
        device finalize verbatim (in combined space it equals the plain
        genome finalize when no tx candidate exists, since transcripts pack
        after the genome). Reads with a transcript hit go through a
        numpy-vectorized projection/re-finalize (_slow_path) over the flat
        stream of their valid candidate entries in (row, candidate) order.
        """
        cfg = self.cfg
        res, table = fetch_host(*devout)  # one device->host transfer
        valid = table.valid
        pos = table.pos
        B = valid.shape[0]
        any_tx = (valid & (pos >= self._tx_boundary)).any(axis=1)
        mask = valid & any_tx[:, None]
        g_rows, g_cand = np.nonzero(mask)  # row-major = entry order
        e_st = table.strand[g_rows, g_cand].astype(np.int64)
        e_pos = pos[g_rows, g_cand].astype(np.int64)
        e_score = table.score[g_rows, g_cand].astype(np.int64)
        e_ug = table.ug_equal[g_rows, g_cand]
        e_diag = table.diag[g_rows, g_cand].astype(np.int64)
        g_rows = g_rows.astype(np.int64)
        cref = self.combined.ref

        out_mapped = np.zeros(B, dtype=bool)
        out_strand = np.zeros(B, dtype=np.int32)
        out_pos = np.full(B, -1, dtype=np.int64)
        out_score = np.zeros(B, dtype=np.int32)
        out_mapq = np.zeros(B, dtype=np.int32)
        out_x0 = np.zeros(B, dtype=np.int32)
        out_x1 = np.zeros(B, dtype=np.int32)
        out_nm = np.zeros(B, dtype=np.int32)
        out_ug = np.ones(B, dtype=bool)
        out_tc = np.zeros(B, dtype=np.int32)
        lens = np.asarray(batch.lengths)
        out_cigars = LazyCigars(out_mapped, lens)

        # ---- fast path: genome-only candidates -> device finalize verbatim
        fast = ~any_tx & (lens > 0)
        fm = fast & res.mapped
        out_mapped[fm] = True
        out_strand[fm] = res.strand[fm]
        out_pos[fm] = res.pos[fm]
        out_score[fm] = res.score[fm]
        out_mapq[fm] = res.mapq[fm]
        out_x0[fm] = res.x0[fm]
        out_x1[fm] = res.x1[fm]
        out_nm[fm] = res.nm[fm]
        out_ug[fm] = res.ug_equal[fm]
        out_tc[fm] = res.tc_count[fm]
        grows = np.nonzero(fm & ~res.ug_equal)[0]
        if grows.shape[0]:
            om = orient_rows(batch.codes, lens, grows, out_strand)
            tbs = host_tracebacks_batch(
                cref.seq, self.s_tensor, self.s_comp, cfg, om,
                lens[grows].astype(np.int64), out_strand[grows],
                res.diag[grows])
            for k, b in enumerate(grows):
                p, cigar, total_nm = tbs[k]
                out_pos[b] = p
                out_cigars[b] = cigar
                out_nm[b] = total_nm
                out_tc[b] = tc_count_from_cigar(cref.seq, p,
                                                om[k, : int(lens[b])],
                                                int(out_strand[b]), cigar)

        xa = None
        if self.xa_tags:
            # fast rows: genome-space candidates only -> the plain engine's
            # XA machinery applies verbatim against the genome reference
            xa = self._xa_strings(batch, table, out_mapped, out_strand,
                                  out_pos, out_score, rows=np.nonzero(fm)[0])

        tx_rows = np.nonzero(any_tx & (lens > 0))[0]
        if tx_rows.shape[0]:
            keep_e = lens[g_rows] > 0
            self._slow_path(batch, tx_rows, g_rows[keep_e], e_st[keep_e],
                            e_pos[keep_e], e_score[keep_e], e_ug[keep_e],
                            e_diag[keep_e], out_mapped, out_strand,
                            out_pos, out_score, out_mapq, out_x0, out_x1,
                            out_nm, out_ug, out_tc, out_cigars, xa=xa)

        return HostAlignments(mapped=out_mapped, strand=out_strand,
                              pos=out_pos, score=out_score, mapq=out_mapq,
                              x0=out_x0, x1=out_x1, nm=out_nm,
                              ug_equal=out_ug, cigars=out_cigars,
                              tc_count=out_tc, xa=xa)

    def _slow_path(self, batch, tx_rows, g_rows, e_st, e_pos, e_score, e_ug,
                   e_diag, out_mapped, out_strand, out_pos, out_score,
                   out_mapq, out_x0, out_x1, out_nm, out_ug, out_tc,
                   out_cigars, xa=None) -> None:
        """Vectorized genome-space re-finalization for reads with >= 1
        transcript candidate.

        Input is the flat stream of VALID candidate entries for those rows,
        in (row, candidate) order — the reference implementation's input
        order for tie-breaks (produced identically by the unpacked table
        and the compacted wire). Per entry: resolve genomic (strand, chrom,
        pos, cigar, nm); then dedupe by (strand, chrom, pos) keeping (score
        desc, genome source first, input order), rank by (score desc,
        strand, chrom, pos, src), and derive X0/X1/MAPQ — all as flat-array
        lexsort/reduceat passes. Only junction-CIGAR assembly and gapped
        tracebacks remain per-entry Python."""
        from parasuite_tpu.utils.dna import COMP

        cfg = self.cfg
        cref = self.combined.ref
        G = cref.seq.shape[0]
        L = batch.codes.shape[1]
        lens_t = np.asarray(batch.lengths)[tx_rows].astype(np.int64)
        T = tx_rows.shape[0]

        # oriented reads, both strands, vectorized revcomp: [T, 2, L]
        codes_t = np.asarray(batch.codes)[tx_rows]
        j = np.arange(L)
        src_ix = lens_t[:, None] - 1 - j[None, :]
        rows_ix = np.arange(T)[:, None]
        rc = np.where(src_ix >= 0,
                      COMP[codes_t[rows_ix, np.clip(src_ix, 0, L - 1)]],
                      np.int8(4)).astype(np.int8)
        oriented = np.stack([codes_t, rc], axis=1)

        if g_rows.shape[0] == 0:
            return
        # local row index of each entry within tx_rows (both ascending)
        er = np.searchsorted(tx_rows, g_rows)
        e_len = lens_t[er]
        ci, local = cref.locate(e_pos)
        E = er.shape[0]

        f_ok = np.zeros(E, dtype=bool)
        f_strand = np.zeros(E, dtype=np.int64)
        f_gci = np.zeros(E, dtype=np.int64)
        f_gpk = np.zeros(E, dtype=np.int64)     # genome packed position
        f_nm = np.zeros(E, dtype=np.int64)
        f_src = (ci >= self._n_genome).astype(np.int64)  # 0 genome, 1 tx
        cigar_over: dict = {}                   # entry -> non-single-M cigar

        starts = cref.starts
        ends = cref.ends
        is_ug = e_ug & (ci >= 0)

        # --- ungapped NM for every located ug entry, one window gather ---
        ug_idx = np.nonzero(is_ug)[0]
        if ug_idx.shape[0]:
            p = e_pos[ug_idx]
            widx = p[:, None] + j[None, :]
            inb = (widx >= 0) & (widx < G)
            rb = np.where(inb, cref.seq[np.clip(widx, 0, G - 1)], np.int8(4))
            rd = oriented[er[ug_idx], e_st[ug_idx]]
            act = j[None, :] < e_len[ug_idx][:, None]
            mm = ((rb != rd) | (rb == 4) | (rd == 4)) & act
            f_nm[ug_idx] = mm.sum(axis=1)

        # --- genome-direct ungapped entries: bounds check only ---
        g_ug = np.nonzero(is_ug & (ci < self._n_genome))[0]
        if g_ug.shape[0]:
            cg = ci[g_ug]
            inb = ((e_pos[g_ug] >= starts[cg]) &
                   (e_pos[g_ug] + e_len[g_ug] - 1 < ends[cg]))
            f_ok[g_ug] = inb
            f_strand[g_ug] = e_st[g_ug]
            f_gci[g_ug] = cg
            f_gpk[g_ug] = e_pos[g_ug]

        # --- transcript ungapped entries: vectorized projection ---
        t_ug = np.nonzero(is_ug & (ci >= self._n_genome))[0]
        if t_ug.shape[0]:
            txi = ci[t_ug] - self._n_genome
            txp = local[t_ug]           # >= 0 by locate contract
            ln = e_len[t_ug]
            minus = self._tx_minus[txi]
            tt = self._tx_len[txi]
            ok_p = txp + ln <= tt       # whole span inside the transcript
            s0 = np.where(minus, tt - (txp + ln), txp)
            q = np.where(ok_p, s0, 0) + txi * self._big
            g = np.searchsorted(self._flat_cum, q, side="right") - 1
            exon_end = self._flat_cum[g + 1] - txi * self._big
            single = ok_p & (s0 + ln <= exon_end)
            e_loc = g - self._cptr[txi]
            gpos = (self._flat_estart[self._eptr[txi] + e_loc] +
                    (s0 - (self._flat_cum[g] - txi * self._big)))
            gci_t = self._tx_gci[txi]
            sel = t_ug[single]
            f_ok[sel] = True
            f_strand[sel] = e_st[t_ug][single] ^ minus[single]
            f_gci[sel] = gci_t[single]
            f_gpk[sel] = starts[gci_t[single]] + gpos[single]
            # junction-spanning ungapped entries: ONE window gather from the
            # spliced->genomic position table + a diff gives every entry's
            # M/N structure (replaces project_to_genome's per-entry exon
            # walk; semantics identical — zero-length introns merge into one
            # M run exactly like project_to_genome's emit() merging)
            jun = np.nonzero(ok_p & ~single)[0]
            if jun.shape[0]:
                lnj = ln[jun]
                q0 = self._h_spoff[txi[jun]] + s0[jun]
                Lj = int(lnj.max())
                w_idx = np.minimum(q0[:, None] + np.arange(Lj)[None, :],
                                   self._h_gpos.shape[0] - 1)
                gw = self._h_gpos[w_idx]
                for w_i, kk in enumerate(jun):
                    k = int(t_ug[kk])
                    lnk = int(lnj[w_i])
                    win = gw[w_i, :lnk]
                    brk = np.nonzero(np.diff(win) != 1)[0]
                    gcigar: list = []
                    prev = 0
                    for bki in brk:
                        bki = int(bki)
                        gcigar.append(("M", bki + 1 - prev))
                        gcigar.append(("N", int(win[bki + 1] - win[bki]) - 1))
                        prev = bki + 1
                    gcigar.append(("M", lnk - prev))
                    f_ok[k] = True
                    f_strand[k] = e_st[k] ^ minus[kk]
                    f_gci[k] = int(gci_t[kk])
                    f_gpk[k] = int(starts[int(gci_t[kk])]) + int(win[0])
                    cigar_over[k] = gcigar

        # --- gapped entries (<<1%): batched host DP, per-entry projection ---
        gap_idx = np.nonzero((~e_ug) & (ci >= 0))[0]
        if gap_idx.shape[0]:
            om_g = oriented[er[gap_idx], e_st[gap_idx]]
            tbs_g = host_tracebacks_batch(
                cref.seq, self.s_tensor, self.s_comp, cfg, om_g,
                e_len[gap_idx], e_st[gap_idx], e_diag[gap_idx])
        for kk, k in enumerate(gap_idx):
            k = int(k)
            ln = int(e_len[k])
            st = int(e_st[k])
            p, cigar, nm = tbs_g[kk]
            c = int(ci[k])
            if c < self._n_genome:
                span = sum(l for op, l in cigar if op in "MD")
                if not (p >= starts[c] and p + span - 1 < ends[c]):
                    continue
                f_ok[k] = True
                f_strand[k] = st
                f_gci[k] = c
                f_gpk[k] = p
                f_nm[k] = nm
                if not _is_single_m(cigar):
                    cigar_over[k] = cigar
            else:
                tx = self._txs[c - self._n_genome]
                txp = int(p - starts[c])
                span = sum(l for op, l in cigar if op in "MD")
                if txp < 0 or txp + span > tx.spliced_len:
                    continue
                try:
                    chrom, gp, gcigar, gst = project_to_genome(
                        tx, txp, cigar, st)
                except ValueError:
                    continue
                f_ok[k] = True
                f_strand[k] = gst
                f_gci[k] = int(self._tx_gci[c - self._n_genome])
                f_gpk[k] = int(starts[f_gci[k]]) + gp
                f_nm[k] = nm
                if not _is_single_m(gcigar):
                    cigar_over[k] = gcigar

        # --- dedupe + rank + X0/X1 over surviving entries ---
        keep = np.nonzero(f_ok)[0]
        if keep.shape[0] == 0:
            return
        row = er[keep]
        ks = f_strand[keep]
        kc = f_gci[keep]
        kp = f_gpk[keep]
        sc = e_score[keep]
        sr = f_src[keep]
        orig = np.arange(keep.shape[0])
        # dedupe by (row, strand, chrom, pos): keep best score, genome src
        # first, then input order
        o1 = np.lexsort((orig, sr, -sc, kp, kc, ks, row))
        r1, k1, c1, p1 = row[o1], ks[o1], kc[o1], kp[o1]
        new = np.ones(o1.shape[0], dtype=bool)
        new[1:] = ((r1[1:] != r1[:-1]) | (k1[1:] != k1[:-1]) |
                   (c1[1:] != c1[:-1]) | (p1[1:] != p1[:-1]))
        uq = o1[new]
        # rank: (score desc, strand, chrom, pos, src) within each row
        o2 = np.lexsort((sr[uq], kp[uq], kc[uq], ks[uq], -sc[uq], row[uq]))
        u2 = uq[o2]
        r2 = row[u2]
        seg = np.ones(u2.shape[0], dtype=bool)
        seg[1:] = r2[1:] != r2[:-1]
        seg_idx = np.nonzero(seg)[0]
        win = u2[seg_idx]                     # winner entry (index into keep)
        rows_w = r2[seg_idx]                  # local row id of each winner
        best = sc[win]
        tot = np.add.reduceat(np.ones(u2.shape[0], dtype=np.int64), seg_idx)
        at_best = sc[u2] == np.repeat(best, tot)
        x0 = np.add.reduceat(at_best.astype(np.int64), seg_idx)
        x1 = tot - x0

        gb = tx_rows[rows_w]
        out_mapped[gb] = True
        out_strand[gb] = ks[win]
        out_pos[gb] = kp[win]
        out_score[gb] = best
        out_x0[gb] = x0
        out_x1[gb] = x1
        # integer MAPQ — oracle._mapq shape (int() truncation preserved)
        out_mapq[gb] = np.where(
            x0 > 1, 0,
            np.where(x1 == 0, 37,
                     np.maximum(0, 23 - (4.343 * np.log(
                         np.maximum(x1, 1))).astype(np.int64))))
        out_nm[gb] = f_nm[keep][win]

        # winner CIGAR/ug flag + T->C: vectorized for single-M winners,
        # CIGAR walk for junction/gapped winners
        win_entry = keep[win]                 # index into the E entry arrays
        has_over = np.asarray([int(e) in cigar_over for e in win_entry])
        plain = ~has_over
        if plain.any():
            pw = kp[win][plain]
            stw = ks[win][plain]
            rl = rows_w[plain]
            rd = oriented[rl, stw]
            widx = pw[:, None] + j[None, :]
            Gg = self.genome_ref.seq.shape[0]
            inb = (widx >= 0) & (widx < Gg)
            rb = np.where(inb, self.genome_ref.seq[np.clip(widx, 0, Gg - 1)],
                          np.int8(4))
            act = j[None, :] < lens_t[rl][:, None]
            tc_hit = np.where(stw[:, None] == 1,
                              (rb == 0) & (rd == 2), (rb == 3) & (rd == 1))
            out_tc[gb[plain]] = (tc_hit & act).sum(axis=1)
        for w in np.nonzero(has_over)[0]:
            b = int(gb[w])
            cigar = cigar_over[int(win_entry[w])]
            out_cigars[b] = cigar
            out_ug[b] = _is_single_m(cigar)
            ln = int(lens_t[rows_w[w]])
            st = int(ks[win][w])
            rd = oriented[rows_w[w], st, :ln]
            out_tc[b] = tc_count_from_cigar(self.genome_ref.seq,
                                            int(kp[win][w]), rd, st, cigar)

        # XA alternates for tx rows: the ranked
        # unique entries after the winner, already deduped and projected to
        # genome space — junction alternates carry their N CIGARs, gapped
        # ones their traceback CIGARs. BWA samse convention:
        # chrom,(+/-)pos1,CIGAR,NM; overflow past xa_limit is counted in
        # xa_dropped, never silently discarded.
        if xa is not None:
            from parasuite_tpu.io.sam import cigar_string
            gstarts = self.genome_ref.starts
            gnames = self.genome_ref.names
            nm_keep = f_nm[keep]
            for s in range(seg_idx.shape[0]):
                lo = int(seg_idx[s])
                hi = lo + int(tot[s])
                if hi - lo <= 1:
                    continue
                b = int(gb[s])
                parts = []
                dropped = 0
                for x in (int(v) for v in u2[lo + 1 : hi]):
                    if len(parts) >= self.xa_limit:
                        dropped += 1
                        continue
                    cig = cigar_over.get(int(keep[x]))
                    cs = (cigar_string(cig) if cig is not None
                          else f"{int(lens_t[rows_w[s]])}M")
                    parts.append(
                        f"{gnames[int(kc[x])]},"
                        f"{'+' if ks[x] == 0 else '-'}"
                        f"{int(kp[x] - gstarts[int(kc[x])]) + 1},"
                        f"{cs},{int(nm_keep[x])}")
                self.xa_dropped += dropped
                if parts:
                    xa[b] = "XA:Z:" + ";".join(parts) + ";"

    def accumulate_profile_host(self, batch, host, counts: np.ndarray,
                                ins_counts: np.ndarray,
                                del_counts: np.ndarray) -> tuple[int, int]:
        """Accumulate substitution/indel profile counts from the EMITTED
        records of one batch.

        The plain engine fuses ungapped counts into the device call, keyed
        on the device winner; in combined mode the host re-finalization can
        re-decide the winner (projection failure, twin dedupe), so counting
        must follow HostAlignments — the exact records the SAM writer sees.
        Semantics per read are identical to errormodel.infer
        (machine-frame cycles, N positions skipped); the ungapped majority
        is one vectorized window-gather + bincount, gapped/junction winners
        walk their CIGARs. Returns (n_profiled, n_gapped) increments.
        """
        from parasuite_tpu.errormodel.infer import (
            count_indels_from_cigar, count_substitutions_from_cigar)
        from parasuite_tpu.utils.dna import COMP

        n = batch.n_real
        lens = np.asarray(batch.lengths)[:n].astype(np.int64)
        mapped = np.asarray(host.mapped)[:n] & (lens > 0)
        ug = np.asarray(host.ug_equal)[:n]
        Lc = counts.shape[0]
        seq = self.sam_ref.seq
        G = seq.shape[0]

        rows = np.nonzero(mapped & ug)[0]
        if rows.shape[0]:
            L = batch.codes.shape[1]
            q = np.arange(L)
            ln = lens[rows]
            st = np.asarray(host.strand)[rows].astype(np.int64)
            pos = np.asarray(host.pos)[rows].astype(np.int64)
            widx = pos[:, None] + q[None, :]
            inb = (widx >= 0) & (widx < G)
            rb = np.where(inb, seq[np.clip(widx, 0, G - 1)],
                          np.int8(4)).astype(np.int64)
            # machine frame: cycle i's aligned ref base sits at window
            # offset ln-1-i on the reverse strand, complemented
            flip = np.clip(ln[:, None] - 1 - q[None, :], 0, L - 1)
            rb_rev = COMP[np.take_along_axis(rb, flip, axis=1)]
            ref_b = np.where(st[:, None] == 1, rb_rev, rb)
            read_b = np.asarray(batch.codes)[rows].astype(np.int64)
            ok = ((ref_b < 4) & (read_b < 4) & (q[None, :] < ln[:, None])
                  & (q[None, :] < Lc))
            idx3 = (q[None, :] * 16 + ref_b * 4 + read_b)[ok]
            counts += np.bincount(idx3, minlength=Lc * 16).reshape(Lc, 4, 4)

        n_gapped = 0
        for b in np.nonzero(mapped & ~ug)[0]:
            ln_b = int(lens[b])
            st_b = int(host.strand[b])
            oriented = (batch.codes[b, :ln_b] if st_b == 0
                        else revcomp_codes(batch.codes[b, :ln_b]))
            cigar = host.cigars[b]
            count_substitutions_from_cigar(seq, int(host.pos[b]), oriented,
                                           ln_b, st_b, cigar, counts)
            count_indels_from_cigar(cigar, ln_b, st_b, ins_counts, del_counts)
            n_gapped += 1
        return int(mapped.sum()), n_gapped


def build_combined_index(fasta, annotation, out_prefix, cfg: AlignConfig) -> dict:
    """CLI entry: FASTA + exon table -> combined packed ref + k-mer index."""
    from parasuite_tpu.io.fasta import read_fasta

    genome = read_fasta(fasta)
    txs = load_annotation(annotation)
    comb = CombinedReference.build(genome, txs, spacer=cfg.chrom_spacer)
    idx = KmerIndex.build(comb.ref.seq, cfg.kmer_size)
    comb.save(out_prefix)
    idx.save(out_prefix)
    Path(str(out_prefix) + ".config.json").write_text(cfg.to_json())
    return {"genome_chroms": len(genome), "transcripts": len(txs),
            "packed_len": comb.ref.total_len, "kmers": idx.n_kmers}
