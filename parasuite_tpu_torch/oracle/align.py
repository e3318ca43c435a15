"""Slow, obviously-correct numpy aligner — the executable spec.

A copy of parasuite_tpu/oracle/align.py. SURVEY.md §4.1: the device stages
and kernels (ops/) must match this module bit-for-bit on randomized batches. Every tie-break is spelled out here; when the real
reference mounts, reference-concordance calibration happens HERE first
(SURVEY.md §7 "Hard parts" #1) and the kernels follow automatically via the
parity tests.

Alignment model (device-shaped, mirrored by ops/):
  * seeding: k-mer seeds at read offsets s*cfg.stride (default stride = k,
    i.e. non-overlapping; smaller strides overlap seeds), looked up in the
    dense KmerIndex; seeds whose k-mer occurs > cfg.max_occ times are skipped
    (repeat masking, analogous to BWA's seed occurrence cap); candidate
    diagonal = hit_pos - seed_offset; candidates ranked by
    (votes desc, diagonal asc), top cfg.max_candidates kept per strand.
  * extension: banded glocal affine-gap DP over a 2W+1 diagonal band around
    each candidate; whole read aligned, ref window free; integer scores from
    S[read_pos, ref_base, read_base]; leading insertions disallowed.
  * selection: candidates deduped by (strand, pos_key); best by
    (score desc, strand asc [fwd first], pos_key asc); X0/X1 hit counts;
    BWA-shaped MAPQ (upstream bwase.c bwa_approx_mapQ — exact constants to be
    calibrated on reference mount, SURVEY.md §8.2).
  * output: if the ungapped diagonal score equals the DP optimum the CIGAR is
    trivially "{Lr}M" (gapless fast path); otherwise full traceback here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from parasuite_tpu_torch.config import AlignConfig
from parasuite_tpu_torch.errormodel.scoring import complement_score_tensor
from parasuite_tpu_torch.index.kmer import KmerIndex
from parasuite_tpu_torch.index.reference import PackedReference
from parasuite_tpu_torch.utils.dna import A, C, G, N, T, revcomp_codes

NEG = -(1 << 28)  # -inf sentinel that survives int32 adds


# ---------------------------------------------------------------------------
# seeding
# ---------------------------------------------------------------------------

def seed_candidates(read_codes: np.ndarray, read_len: int, index: KmerIndex,
                    cfg: AlignConfig) -> list[tuple[int, int]]:
    """Candidate diagonals for one (already oriented) read.

    Returns [(diag, votes)] ordered by (votes desc, diag asc), length <= C.
    diag = packed ref position of read base 0 under an ungapped alignment.
    """
    k = index.k
    diags: list[int] = []
    stride = cfg.seed_stride_for(read_len)
    for s in range(cfg.max_seeds):
        off = s * stride
        if off + k > read_len:
            break
        window = read_codes[off : off + k]
        if np.any(window == N):
            continue
        code = 0
        for b in window:
            code = code * 4 + int(b)
        lo = int(index.bucket_starts[code])
        hi = int(index.bucket_starts[code + 1])
        if hi - lo > cfg.max_occ or hi == lo:
            continue  # repetitive (or absent) seed: skip entirely
        for p in index.positions[lo:hi]:
            diags.append(int(p) - off)
    if not diags:
        return []
    uniq, votes = np.unique(np.asarray(diags, dtype=np.int64), return_counts=True)
    order = np.lexsort((uniq, -votes))  # votes desc, then diag asc
    return [(int(uniq[i]), int(votes[i])) for i in order[: cfg.max_candidates]]


# ---------------------------------------------------------------------------
# extension
# ---------------------------------------------------------------------------

def _ref_window(ref_seq: np.ndarray, diag: int, read_len: int, w: int) -> np.ndarray:
    """R[j] = ref[diag - w + j], j in [0, read_len + 2w); out of range -> N."""
    n = read_len + 2 * w
    idx = np.arange(diag - w, diag - w + n)
    out = np.full(n, N, dtype=np.int8)
    ok = (idx >= 0) & (idx < ref_seq.shape[0])
    out[ok] = ref_seq[idx[ok]]
    return out


def _score_rows(s_eff: np.ndarray, read_codes: np.ndarray, read_len: int,
                strand: int) -> np.ndarray:
    """Per-position 5-wide substitution score rows for this read.

    rows[i, r] = score of (ref base r, read base read_codes[i]) at DP step i.
    Forward strand uses S[i]; reverse strand aligns the revcomp'd read forward
    and uses S_comp[Lr-1-i] (see errormodel.scoring.complement_score_tensor).
    """
    rows = np.empty((read_len, 5), dtype=np.int32)
    for i in range(read_len):
        prof = i if strand == 0 else read_len - 1 - i
        rows[i] = s_eff[prof, :, int(read_codes[i])]
    return rows


def banded_dp(score_rows: np.ndarray, refwin: np.ndarray, read_len: int,
              cfg: AlignConfig, keep_tables: bool = False):
    """Banded glocal affine-gap DP (maximization, int32).

    Band coordinate j in [0, 2W]: read base i is aligned to window position
    i + j, i.e. packed ref position diag - W + i + j.

    Recurrences (M=diagonal, Ix=insertion in read, Iy=deletion from ref):
      M[i][j]  = rows[i][R[i+j]] + max(M[i-1][j], Ix[i-1][j], Iy[i-1][j])
      Ix[i][j] = max(M[i-1][j+1] - gap_open, Ix[i-1][j+1] - gap_extend)
      Iy[i][j] = max(M[i][j-1]  - gap_open, Iy[i][j-1]  - gap_extend)
    Leading insertions are disallowed (Ix[0] = -inf); alignments end in M.

    Returns (dp_score, dp_j_end, ug_score, ug_j[, tables]):
      dp_j_end — smallest j attaining the optimal M[Lr-1][j];
      ug_score/ug_j — best ungapped diagonal sum and its smallest j.
    """
    w = cfg.band_width
    band = 2 * w + 1
    go, ge = cfg.gap_open, cfg.gap_extend

    # ungapped: for each j, sum_i rows[i][R[i+j]]
    ug = np.zeros(band, dtype=np.int64)
    for j in range(band):
        ug[j] = int(np.sum(score_rows[np.arange(read_len), refwin[j : j + read_len]]))
    ug_j = int(np.argmax(ug))          # np.argmax returns first (smallest j)
    ug_score = int(ug[ug_j])

    M = np.full((read_len, band), NEG, dtype=np.int64)
    Ix = np.full((read_len, band), NEG, dtype=np.int64)
    Iy = np.full((read_len, band), NEG, dtype=np.int64)

    sub0 = score_rows[0, refwin[0:band]]
    M[0] = sub0
    for j in range(1, band):
        Iy[0][j] = max(M[0][j - 1] - go, Iy[0][j - 1] - ge)
    for i in range(1, read_len):
        sub = score_rows[i, refwin[i : i + band]]
        for j in range(band):
            best_prev = max(M[i - 1][j], Ix[i - 1][j], Iy[i - 1][j])
            M[i][j] = sub[j] + best_prev if best_prev > NEG // 2 else NEG
            if j + 1 < band:
                Ix[i][j] = max(M[i - 1][j + 1] - go, Ix[i - 1][j + 1] - ge)
        for j in range(1, band):
            Iy[i][j] = max(M[i][j - 1] - go, Iy[i][j - 1] - ge)

    last = M[read_len - 1]
    dp_j = int(np.argmax(last))
    dp_score = int(last[dp_j])
    if keep_tables:
        return dp_score, dp_j, ug_score, ug_j, (M, Ix, Iy)
    return dp_score, dp_j, ug_score, ug_j


def traceback_alignment(tables, score_rows: np.ndarray, refwin: np.ndarray,
                        read_len: int, dp_j: int, cfg: AlignConfig):
    """Walk the DP tables back from (Lr-1, dp_j, M).

    Preference order on ties: M > Iy > Ix (prefer diagonal, then deletion) —
    a fixed rule so CIGARs are deterministic. Returns (start_j, cigar, nm)
    where cigar is [(op, length)] with op in "MID" and nm is the SAM edit
    distance (mismatches + inserted + deleted bases).
    """
    M, Ix, Iy = tables
    go, ge = cfg.gap_open, cfg.gap_extend
    i, j, state = read_len - 1, dp_j, "M"
    ops: list[str] = []
    nm = 0
    while True:
        if state == "M":
            ops.append("M")
            if i == 0:
                break
            prev = max(M[i - 1][j], Iy[i - 1][j], Ix[i - 1][j])
            if prev == M[i - 1][j]:
                state = "M"
            elif prev == Iy[i - 1][j]:
                state = "Iy"
            else:
                state = "Ix"
            i -= 1
        elif state == "Ix":
            ops.append("I")
            nm += 1
            if M[i - 1][j + 1] - go >= Ix[i - 1][j + 1] - ge:
                state = "M"
            else:
                state = "Ix"
            i -= 1
            j += 1
        else:  # Iy
            ops.append("D")
            nm += 1
            if M[i][j - 1] - go >= Iy[i][j - 1] - ge:
                state = "M"
            else:
                state = "Iy"
            j -= 1
    ops.reverse()
    cigar: list[tuple[str, int]] = []
    for op in ops:
        if cigar and cigar[-1][0] == op:
            cigar[-1] = (op, cigar[-1][1] + 1)
        else:
            cigar.append((op, 1))
    return j, cigar, nm


# ---------------------------------------------------------------------------
# per-read alignment
# ---------------------------------------------------------------------------

@dataclass
class OracleAlignment:
    mapped: bool
    strand: int = 0            # 0 fwd, 1 rev
    packed_pos: int = -1       # packed start coordinate of the alignment
    score: int = NEG
    mapq: int = 0
    cigar: list = field(default_factory=list)  # [(op, len)]
    nm: int = 0
    x0: int = 0
    x1: int = 0
    ug_equal: bool = True      # gapless fast path taken
    diag: int = 0              # winning candidate diagonal (for re-traceback)
    n_candidates: int = 0
    tc: int = 0                # machine-frame T->C conversions (cluster stats)


def _ungapped_nm(read_codes: np.ndarray, refwin: np.ndarray, j: int,
                 read_len: int) -> int:
    rb = refwin[j : j + read_len]
    cb = read_codes[:read_len]
    return int(np.sum((rb != cb) | (rb == N) | (cb == N)))


def _tc_from_cigar(ref_seq: np.ndarray, packed_pos: int,
                   oriented: np.ndarray, strand: int, cigar: list) -> int:
    """Machine-frame T->C conversions over the M segments. A machine T->C
    shows on the genome strand as (ref T, read C) forward / (ref A, read G)
    reverse; I consumes read only, D/N reference only (same spec as
    pipeline.clusters.tc_count_from_cigar — duplicated here because the
    oracle is the independent executable spec)."""
    tc = 0
    ri, qi = packed_pos, 0
    for op, ln in cigar:
        if op == "M":
            rb = ref_seq[ri : ri + ln]
            cb = oriented[qi : qi + ln]
            if strand == 0:
                tc += int(np.sum((rb == T) & (cb == C)))
            else:
                tc += int(np.sum((rb == A) & (cb == G)))
            ri += ln
            qi += ln
        elif op == "I":
            qi += ln
        else:
            ri += ln
    return tc


def _mapq(x0: int, x1: int) -> int:
    """BWA-approx MAPQ shape (upstream bwase.c bwa_approx_mapQ)."""
    if x0 > 1:
        return 0
    if x1 == 0:
        return 37
    return max(0, 23 - int(4.343 * math.log(x1)))


def align_read(read_codes: np.ndarray, read_len: int, ref: PackedReference,
               index: KmerIndex, s_tensor: np.ndarray, cfg: AlignConfig,
               s_comp: np.ndarray | None = None) -> OracleAlignment:
    """Align one read (both strands) and pick the winner.

    read_codes: int8 [>=read_len] in machine orientation.
    s_tensor: [L, 5, 5] int32 score tensor (flat or learned).
    """
    if s_comp is None:
        s_comp = complement_score_tensor(s_tensor)
    w = cfg.band_width
    fwd = read_codes[:read_len]
    rev = revcomp_codes(fwd)
    oriented = {0: fwd, 1: rev}
    rows = {0: _score_rows(s_tensor, fwd, read_len, 0),
            1: _score_rows(s_comp, rev, read_len, 1)}

    # (strand, pos_key) -> dict(score, diag, ug_equal, j_sel)
    hits: dict[tuple[int, int], dict] = {}
    n_cand = 0
    for strand in (0, 1):
        for diag, _votes in seed_candidates(oriented[strand], read_len, index, cfg):
            n_cand += 1
            refwin = _ref_window(ref.seq, diag, read_len, w)
            dp_score, dp_j, ug_score, ug_j = banded_dp(rows[strand], refwin,
                                                       read_len, cfg)
            ug_equal = ug_score == dp_score
            j_sel = ug_j if ug_equal else dp_j
            pos_key = diag - w + j_sel
            key = (strand, pos_key)
            prev = hits.get(key)
            if prev is None or dp_score > prev["score"]:
                hits[key] = {"score": dp_score, "diag": diag,
                             "ug_equal": ug_equal, "j_sel": j_sel}

    min_score = cfg.min_score(read_len)
    valid = [(k, v) for k, v in hits.items() if v["score"] >= min_score]
    if not valid:
        return OracleAlignment(mapped=False, n_candidates=n_cand)

    # order: score desc, strand asc, pos_key asc
    valid.sort(key=lambda kv: (-kv[1]["score"], kv[0][0], kv[0][1]))
    (strand, pos_key), best = valid[0]
    best_score = best["score"]
    x0 = sum(1 for _, v in valid if v["score"] == best_score)
    x1 = len(valid) - x0

    # chromosome-boundary policy: the whole (ungapped-key) span must lie in one
    # chromosome, else unmapped (spacers guarantee windows never straddle two).
    ci, _local = ref.locate(np.asarray([pos_key]))
    ci_end, _ = ref.locate(np.asarray([pos_key + read_len - 1]))
    if ci[0] < 0 or ci[0] != ci_end[0]:
        return OracleAlignment(mapped=False, n_candidates=n_cand)

    aln = OracleAlignment(mapped=True, strand=strand, score=best_score,
                          mapq=_mapq(x0, x1), x0=x0, x1=x1,
                          ug_equal=best["ug_equal"], diag=best["diag"],
                          n_candidates=n_cand)
    refwin = _ref_window(ref.seq, best["diag"], read_len, w)
    if best["ug_equal"]:
        aln.packed_pos = pos_key
        aln.cigar = [("M", read_len)]
        aln.nm = _ungapped_nm(oriented[strand], refwin, best["j_sel"], read_len)
        aln.tc = _tc_from_cigar(ref.seq, aln.packed_pos, oriented[strand],
                                strand, aln.cigar)
    else:
        dp_score, dp_j, _ug, _ugj, tables = banded_dp(
            rows[strand], refwin, read_len, cfg, keep_tables=True)
        start_j, cigar, gap_nm = traceback_alignment(
            tables, rows[strand], refwin, read_len, dp_j, cfg)
        aln.packed_pos = best["diag"] - w + start_j
        aln.cigar = cigar
        # NM = gap bases + mismatches along the M segments
        nm = gap_nm
        ri = aln.packed_pos
        qi = 0
        for op, ln in cigar:
            if op == "M":
                rb = ref.seq[ri : ri + ln]
                cb = oriented[strand][qi : qi + ln]
                nm += int(np.sum((rb != cb) | (rb == N) | (cb == N)))
                ri += ln
                qi += ln
            elif op == "I":
                qi += ln
            else:
                ri += ln
        aln.nm = nm
        aln.tc = _tc_from_cigar(ref.seq, aln.packed_pos, oriented[strand],
                                strand, cigar)
    return aln


def align_batch_oracle(codes: np.ndarray, lengths: np.ndarray,
                       ref: PackedReference, index: KmerIndex,
                       s_tensor: np.ndarray, cfg: AlignConfig) -> list[OracleAlignment]:
    s_comp = complement_score_tensor(s_tensor)
    out = []
    for b in range(codes.shape[0]):
        ln = int(lengths[b])
        if ln == 0:
            out.append(OracleAlignment(mapped=False))
            continue
        out.append(align_read(codes[b], ln, ref, index, s_tensor, cfg, s_comp))
    return out
