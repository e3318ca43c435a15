"""The plain reference of the benchmark: what the SAM record of a read must
be, worked out with numpy alone from the genome, the annotation and the
read, independent of the program (it imports nothing of parasuite_tpu_torch,
jax or parasuite_tpu, and takes nothing the program made).

It follows the executable spec of the aligner, parasuite_tpu_torch/oracle/
align.py (seed, select, banded affine-gap extension, finalize, traceback),
and the combined mode's genome-space re-finalization as
tests/test_combined.py::_reference_refinalize states it; both are written
again here, vectorized over the candidates of a block of reads so that a
sample of thousands of reads takes seconds:

  * packing: chromosomes (and, in combined mode, the spliced transcripts
    as "tx::<id>" after them) concatenated with `spacer` N bases before
    each and after the last;
  * seeds: max_seeds k-mers per oriented read at offsets s * stride, stride
    max(1, (len - k) // (max_seeds - 1)), while the k-mer fits; a k-mer with
    an N, absent, or found more than max_occ times is skipped; candidate
    diagonal = hit - offset; the diagonals of a strand ranked by (votes
    desc, diagonal asc), the first C kept;
  * extension: the banded glocal affine-gap DP of the oracle (band 2W + 1,
    leading insertions barred), and the best ungapped diagonal;
  * finalize: an entry is valid with DP score >= min_score; entries deduped
    by (strand, key) keeping the better score, then the earlier slot; the
    winner by (score desc, strand, key); X0 / X1; MAPQ; unmapped if the
    ungapped span leaves one chromosome; a gapped winner traced back;
  * combined rows (a valid entry in transcript space): every valid entry
    projected to the genome, deduped by (strand, chrom, pos) keeping (score
    desc, genome first, slot order), ranked by (score desc, strand, chrom,
    pos, source);
  * the SAM line: FLAG, RNAME, POS, MAPQ, CIGAR, SEQ, QUAL and the tags XT,
    NM, X0, X1, AS, MD.

`int_bits` selects the DP's integer width: 32 is the configuration's exact
arithmetic; 8 is the control (every score saturated to [-128, 127]).
`s_fwd`, an integer [max_read_len, 5, 5] tensor S[read cycle, ref base, read
base], replaces the flat one of match_score, mismatch_score and n_score (a
learned pass-2 profile): a forward entry scores its step i with S[i], a
reverse-strand one its step i with the complemented S[ln - 1 - i], the
read's own cycle. The mapping threshold stays min_score_frac * len *
match_score whatever S is.
"""

from __future__ import annotations

import math

import numpy as np

A, C, G, T, N = 0, 1, 2, 3, 4
COMP = np.array([T, G, C, A, N], dtype=np.int8)
CODE_TO_BASE = np.frombuffer(b"ACGTN", dtype=np.uint8)
TX_PREFIX = "tx::"
CHUNK = 8192      # DP entries at a time: [CHUNK, L, band] int64 tables


class Arith:
    """The DP's integer type: exact (32) or saturated to int8 (8)."""

    def __init__(self, bits: int):
        if bits not in (8, 32):
            raise ValueError("int_bits must be 32 or 8")
        self.bits = bits
        self.neg = -(1 << 28) if bits == 32 else -128
        # a cell is reachable when its best predecessor is above this
        self.reach = self.neg // 2 if bits == 32 else self.neg

    def sat(self, x):
        return x if self.bits == 32 else np.clip(x, -128, 127)


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

class Packed:
    def __init__(self, seqs: dict, spacer: int):
        self.names = list(seqs)
        pad = np.full(spacer, N, dtype=np.int8)
        parts, starts, ends, pos = [], [], [], 0
        for name in self.names:
            parts.append(pad)
            pos += spacer
            starts.append(pos)
            parts.append(np.asarray(seqs[name], dtype=np.int8))
            pos += len(seqs[name])
            ends.append(pos)
        parts.append(pad)
        self.seq = np.concatenate(parts)
        self.starts = np.asarray(starts, dtype=np.int64)
        self.ends = np.asarray(ends, dtype=np.int64)

    def locate(self, pos):
        """-> (chrom index or -1 outside every chromosome, local pos)."""
        pos = np.asarray(pos, dtype=np.int64)
        ci = np.clip(np.searchsorted(self.starts, pos, side="right") - 1,
                     0, len(self.names) - 1)
        inside = (pos >= self.starts[ci]) & (pos < self.ends[ci])
        return np.where(inside, ci, -1), pos - self.starts[ci]


def revcomp(codes: np.ndarray) -> np.ndarray:
    return COMP[np.asarray(codes, dtype=np.int64)][..., ::-1]


def splice(genome: dict, tx) -> np.ndarray:
    chrom = genome[tx.chrom]
    s = np.concatenate([chrom[int(a):int(b)]
                        for a, b in zip(tx.exon_starts, tx.exon_ends)])
    return revcomp(s) if tx.strand == "-" else s


# ---------------------------------------------------------------------------
# seeds
# ---------------------------------------------------------------------------

def kmer_codes(seq: np.ndarray, k: int):
    """Codes of every k-window (int32: k <= 15) and whether it is free of
    N."""
    n = seq.shape[0] - k + 1
    base = np.where(seq == N, 0, seq).astype(np.int32)
    codes = np.zeros(n, dtype=np.int32)
    for t in range(k):
        codes *= 4
        codes += base[t:t + n]
    n_cum = np.concatenate([[0], np.cumsum(seq == N, dtype=np.int64)])
    return codes, (n_cum[k:] - n_cum[:-k]) == 0


class SeedTable:
    """Every occurrence, in ascending position, of the k-mers asked for."""

    def __init__(self, seq: np.ndarray, k: int, wanted: np.ndarray):
        codes, ok = kmer_codes(seq, k)
        mark = np.zeros(4 ** k, dtype=bool)
        mark[wanted] = True
        pos = np.flatnonzero(ok & mark[codes])
        hit = codes[pos]
        order = np.argsort(hit, kind="stable")
        self.codes = hit[order]
        self.pos = pos[order]

    def lookup(self, code: int) -> np.ndarray:
        lo = np.searchsorted(self.codes, code, side="left")
        hi = np.searchsorted(self.codes, code, side="right")
        return self.pos[lo:hi]


def seed_offsets(ln: int, p: dict) -> list:
    k, S = p["kmer_size"], p["max_seeds"]
    stride = max(1, (ln - k) // (S - 1)) if S > 1 else 0
    return [s * stride for s in range(S) if s * stride + k <= ln]


def seed_codes(reads: list, p: dict):
    """The seeds of each oriented read -> offsets and codes [R, S] (code -1
    where the k-mer holds an N or no seed fits)."""
    k, S = p["kmer_size"], p["max_seeds"]
    R = len(reads)
    offs = np.zeros((R, S), dtype=np.int64)
    codes = np.full((R, S), -1, dtype=np.int64)
    lens = np.asarray([r.shape[0] for r in reads])
    pow4 = 4 ** np.arange(k - 1, -1, -1, dtype=np.int64)
    for ln in np.unique(lens):
        rows = np.flatnonzero(lens == ln)
        arr = np.stack([reads[r] for r in rows]).astype(np.int64)
        for s, off in enumerate(seed_offsets(int(ln), p)):
            w = arr[:, off:off + k]
            c = (np.where(w == N, 0, w) * pow4).sum(axis=1)
            codes[rows, s] = np.where((w == N).any(axis=1), -1, c)
            offs[rows, s] = off
    return offs, codes


def candidates(offs: np.ndarray, codes: np.ndarray, table: SeedTable,
               p: dict):
    """Every read's ranked candidate diagonals, at most C: the hits of its
    seeds found 1..max_occ times, as diagonals hit - offset, counted as
    votes and ranked by (votes desc, diagonal asc).
    -> (read row, rank, diagonal) arrays."""
    R, S = codes.shape
    lo = np.searchsorted(table.codes, codes, side="left")
    hi = np.searchsorted(table.codes, codes, side="right")
    cnt = np.where(codes >= 0, hi - lo, 0)
    ok = (cnt >= 1) & (cnt <= p["max_occ"])
    rr = np.repeat(np.arange(R), S)[ok.reshape(-1)]
    c, l0, o = cnt[ok], lo[ok], offs[ok]
    within = np.arange(int(c.sum())) - np.repeat(np.cumsum(c) - c, c)
    rid = np.repeat(rr, c)
    diag = table.pos[np.repeat(l0, c) + within] - np.repeat(o, c)
    order = np.lexsort((diag, rid))
    rid, diag = rid[order], diag[order]
    new = np.ones(rid.shape[0], dtype=bool)
    new[1:] = (rid[1:] != rid[:-1]) | (diag[1:] != diag[:-1])
    starts = np.flatnonzero(new)
    votes = np.diff(np.append(starts, rid.shape[0]))
    urid, udiag = rid[starts], diag[starts]
    order = np.lexsort((udiag, -votes, urid))
    urid, udiag = urid[order], udiag[order]
    gstart = np.flatnonzero(np.append(True, urid[1:] != urid[:-1]))
    rank = np.arange(urid.shape[0]) - np.repeat(
        gstart, np.diff(np.append(gstart, urid.shape[0])))
    keep = rank < p["max_candidates"]
    return urid[keep], rank[keep], udiag[keep]


# ---------------------------------------------------------------------------
# extension
# ---------------------------------------------------------------------------

def score_tensor(p: dict, L: int) -> np.ndarray:
    s = np.full((L, 5, 5), p["mismatch_score"], dtype=np.int64)
    for b in range(4):
        s[:, b, b] = p["match_score"]
    s[:, 4, :] = p["n_score"]
    s[:, :, 4] = p["n_score"]
    return s


def complement_tensor(s: np.ndarray) -> np.ndarray:
    comp = COMP.astype(np.int64)
    return s[:, comp][:, :, comp]


def windows(seq: np.ndarray, diag: np.ndarray, ln: int, W: int):
    """R[n, j] = seq[diag - W + j], N outside the sequence."""
    idx = diag[:, None] - W + np.arange(ln + 2 * W)[None, :]
    ok = (idx >= 0) & (idx < seq.shape[0])
    return np.where(ok, seq[np.clip(idx, 0, seq.shape[0] - 1)], np.int8(N))


def dp_block(reads: np.ndarray, strands: np.ndarray, diags: np.ndarray,
             ln: int, seq: np.ndarray, s_fwd, s_rev, p: dict, ar: Arith,
             keep: bool = False):
    """Banded DP of n (oriented read, strand, diagonal) entries of one
    length -> dp_score, dp_j, ug_score, ug_j [n] (and the M, Ix, Iy
    tables [n, ln, band] with keep)."""
    W = p["band_width"]
    band = 2 * W + 1
    go, ge = p["gap_open"], p["gap_extend"]
    n = reads.shape[0]
    i = np.arange(ln)
    rd = reads[:, :ln].astype(np.int64)
    # rows[n, i, r]: score of ref base r against the read's base i, the
    # forward table at step i, the complemented one at step ln - 1 - i
    rows = np.where(strands[:, None, None] == 0, s_fwd[i[None, :], :, rd],
                    s_rev[ln - 1 - i[None, :], :, rd])
    R = windows(seq, diags, ln, W).astype(np.int64)
    jj = i[:, None] + np.arange(band)[None, :]          # [ln, band]
    sub = np.take_along_axis(rows, R[:, jj], axis=2)     # [n, ln, band]
    ug = np.zeros((n, band), dtype=np.int64)
    for r in range(ln):
        ug = ar.sat(ug + sub[:, r, :])
    ug_j = np.argmax(ug, axis=1)
    ug_score = ug[np.arange(n), ug_j]

    NEG = ar.neg
    M = np.full((n, band), NEG, dtype=np.int64)
    Ix = np.full((n, band), NEG, dtype=np.int64)
    Iy = np.full((n, band), NEG, dtype=np.int64)
    tabs = []
    M[:] = sub[:, 0, :]
    for j in range(1, band):
        Iy[:, j] = np.maximum(ar.sat(M[:, j - 1] - go),
                              ar.sat(Iy[:, j - 1] - ge))
    if keep:
        tabs.append((M.copy(), Ix.copy(), Iy.copy()))
    for r in range(1, ln):
        prev = np.maximum(np.maximum(M, Ix), Iy)
        Mn = np.where(prev > ar.reach, ar.sat(sub[:, r, :] + prev), NEG)
        Ixn = np.full((n, band), NEG, dtype=np.int64)
        Ixn[:, :-1] = np.maximum(ar.sat(M[:, 1:] - go),
                                 ar.sat(Ix[:, 1:] - ge))
        Iyn = np.full((n, band), NEG, dtype=np.int64)
        for j in range(1, band):
            Iyn[:, j] = np.maximum(ar.sat(Mn[:, j - 1] - go),
                                   ar.sat(Iyn[:, j - 1] - ge))
        M, Ix, Iy = Mn, Ixn, Iyn
        if keep:
            tabs.append((M.copy(), Ix.copy(), Iy.copy()))
    dp_j = np.argmax(M, axis=1)
    dp_score = M[np.arange(n), dp_j]
    out = (dp_score, dp_j, ug_score, ug_j)
    if keep:
        out += tuple(np.stack([t[q] for t in tabs], axis=1)
                     for q in range(3))
    return out


def traceback(Mt, Ixt, Iyt, ln: int, dp_j: int, p: dict):
    """The oracle's walk from (ln - 1, dp_j, M); ties prefer M, then a
    deletion, then an insertion -> (start_j, cigar, gap bases)."""
    go, ge = p["gap_open"], p["gap_extend"]
    i, j, state = ln - 1, dp_j, "M"
    ops, nm = [], 0
    while True:
        if state == "M":
            ops.append("M")
            if i == 0:
                break
            prev = max(Mt[i - 1][j], Iyt[i - 1][j], Ixt[i - 1][j])
            state = ("M" if prev == Mt[i - 1][j] else
                     "Iy" if prev == Iyt[i - 1][j] else "Ix")
            i -= 1
        elif state == "Ix":
            ops.append("I")
            nm += 1
            state = ("M" if Mt[i - 1][j + 1] - go >= Ixt[i - 1][j + 1] - ge
                     else "Ix")
            i -= 1
            j += 1
        else:
            ops.append("D")
            nm += 1
            state = ("M" if Mt[i][j - 1] - go >= Iyt[i][j - 1] - ge
                     else "Iy")
            j -= 1
    ops.reverse()
    cigar = []
    for op in ops:
        if cigar and cigar[-1][0] == op:
            cigar[-1] = (op, cigar[-1][1] + 1)
        else:
            cigar.append((op, 1))
    return j, cigar, nm


def m_mismatches(seq, pos: int, read: np.ndarray, cigar) -> int:
    nm, ri, qi = 0, pos, 0
    for op, ln in cigar:
        if op == "M":
            rb, cb = seq[ri:ri + ln], read[qi:qi + ln]
            nm += int(np.sum((rb != cb) | (rb == N) | (cb == N)))
            ri += ln
            qi += ln
        elif op == "I":
            qi += ln
        else:
            ri += ln
    return nm


# ---------------------------------------------------------------------------
# the aligner
# ---------------------------------------------------------------------------

class Reference:
    """The plain aligner over a genome (and, with transcripts, the
    combined genome + transcriptome packing)."""

    def __init__(self, genome: dict, params: dict, transcripts=None,
                 int_bits: int = 32, s_fwd=None):
        self.p = params
        self.ar = Arith(int_bits)
        self.genome = Packed(genome, params["chrom_spacer"])
        self.n_genome = len(genome)
        self.txs = list(transcripts) if transcripts else []
        if self.txs:
            seqs = dict(genome)
            for tx in self.txs:
                seqs[TX_PREFIX + tx.tx_id] = splice(genome, tx)
            self.packed = Packed(seqs, params["chrom_spacer"])
            self.tx_boundary = int(self.packed.starts[self.n_genome])
        else:
            self.packed = self.genome
            self.tx_boundary = None
        L = params["max_read_len"]
        if s_fwd is None:
            s_fwd = score_tensor(params, L)
        s_fwd = np.asarray(s_fwd)
        if s_fwd.shape != (L, 5, 5) or s_fwd.dtype.kind not in "iu":
            raise ValueError(f"s_fwd must be an integer [{L}, 5, 5] "
                             f"tensor, not {s_fwd.dtype} {s_fwd.shape}")
        self.s_fwd = s_fwd.astype(np.int64)
        self.s_rev = complement_tensor(self.s_fwd)

    # --- candidates and their DP ---
    def _entries(self, codes: np.ndarray, lengths: np.ndarray):
        """Per read: [(slot, strand, diag, dp, dp_j, ug, ug_j)] in slot
        order (strand 0's candidates, then strand 1's)."""
        p = self.p
        C = p["max_candidates"]
        oriented = [(codes[b, :int(lengths[b])],
                     revcomp(codes[b, :int(lengths[b])]))
                    for b in range(codes.shape[0])]
        offs, kcodes = seed_codes([o[st] for o in oriented
                                   for st in (0, 1)], p)
        table = SeedTable(self.packed.seq, p["kmer_size"],
                          np.unique(kcodes[kcodes >= 0]))
        rid, rank, fd = candidates(offs, kcodes, table, p)
        fb, fs = rid // 2, rid % 2
        order = np.lexsort((rank, fs, fb))          # slot order a read
        fb, fs, rank, fd = fb[order], fs[order], rank[order], fd[order]
        # the share of the 2C candidate slots of a read that hold one
        self.filled_share = fb.shape[0] / max(1, 2 * C * codes.shape[0])
        per_read = [[] for _ in range(codes.shape[0])]
        res = self._dp(fb, fs, fd, oriented, lengths)
        for i in range(fb.shape[0]):
            per_read[fb[i]].append((int(fs[i] * C + rank[i]), int(fs[i]),
                                    int(fd[i])) + res[i])
        return oriented, per_read

    def _dp(self, fb, fs, fd, oriented, lengths, keep: bool = False):
        """dp_block over entries (read, strand, diagonal), by read length
        and in chunks -> per entry (dp, dp_j, ug, ug_j), or with keep the
        traced (packed pos, cigar, nm)."""
        W = self.p["band_width"]
        res = [None] * fb.shape[0]
        lens = lengths[fb]
        for ln in np.unique(lens):
            same = np.flatnonzero(lens == ln)
            for c0 in range(0, same.shape[0], CHUNK):
                idx = same[c0:c0 + CHUNK]
                reads = np.stack([oriented[fb[i]][fs[i]] for i in idx])
                out = dp_block(reads, fs[idx], fd[idx], int(ln),
                               self.packed.seq, self.s_fwd, self.s_rev,
                               self.p, self.ar, keep=keep)
                for q, i in enumerate(idx):
                    if not keep:
                        res[i] = tuple(int(x[q]) for x in out)
                        continue
                    j0, cigar, gap_nm = traceback(
                        out[4][q], out[5][q], out[6][q], int(ln),
                        int(out[1][q]), self.p)
                    pos = int(fd[i]) - W + j0
                    res[i] = (pos, cigar, gap_nm + m_mismatches(
                        self.packed.seq, pos, reads[q], cigar))
        return res

    def align(self, codes: np.ndarray, lengths: np.ndarray) -> list:
        """-> per read None (unmapped) or a dict: strand, pos (genome
        packed), score, mapq, x0, x1, nm, cigar."""
        oriented, per_read = self._entries(codes, lengths)
        valid = [self._valid(per_read[b], int(lengths[b]))
                 for b in range(codes.shape[0])]
        gapped = [(b, e) for b in range(codes.shape[0]) for e in valid[b]
                  if not e["ug"]]
        traced = self._dp(np.asarray([b for b, _ in gapped], dtype=np.int64),
                          np.asarray([e["strand"] for _, e in gapped],
                                     dtype=np.int64),
                          np.asarray([e["diag"] for _, e in gapped],
                                     dtype=np.int64),
                          oriented, lengths, keep=True)
        for (_b, e), t in zip(gapped, traced):
            e["trace"] = t
        out = []
        for b in range(codes.shape[0]):
            ln = int(lengths[b])
            valid_b = valid[b]
            if ln == 0 or not valid_b:
                out.append(None)
            elif self.txs and any(e["key"] >= self.tx_boundary
                                  for e in valid_b):
                out.append(self._combined(oriented[b], ln, valid_b))
            else:
                out.append(self._plain(oriented[b], ln, valid_b))
        return out

    def _valid(self, entries, ln: int) -> list:
        W = self.p["band_width"]
        ms = int(self.p["min_score_frac"] * ln * self.p["match_score"])
        out = []
        for slot, st, diag, dp, dpj, ug, ugj in entries:
            if dp < ms:
                continue
            ug_eq = ug == dp
            out.append({"slot": slot, "strand": st, "diag": diag,
                        "score": dp, "ug": ug_eq,
                        "key": diag - W + (ugj if ug_eq else dpj)})
        return out

    def _plain(self, oriented, ln: int, valid: list):
        best = {}
        for e in valid:                    # slot order: earlier wins ties
            k = (e["strand"], e["key"])
            if k not in best or e["score"] > best[k]["score"]:
                best[k] = e
        uniq = sorted(best.values(),
                      key=lambda e: (-e["score"], e["strand"], e["key"]))
        win = uniq[0]
        x0 = sum(1 for e in uniq if e["score"] == win["score"])
        x1 = len(uniq) - x0
        ci, _ = self.packed.locate([win["key"], win["key"] + ln - 1])
        if ci[0] < 0 or ci[0] != ci[1]:
            return None
        read = oriented[win["strand"]]
        if win["ug"]:
            pos, cigar = win["key"], [("M", ln)]
            nm = m_mismatches(self.packed.seq, pos, read, cigar)
        else:
            pos, cigar, nm = win["trace"]
        return {"strand": win["strand"], "pos": pos, "score": win["score"],
                "mapq": mapq(x0, x1), "x0": x0, "x1": x1, "nm": nm,
                "cigar": cigar}

    def _combined(self, oriented, ln: int, valid: list):
        pk = self.packed
        recs = []   # (score, strand, chrom, genome packed pos, src, cigar, nm)
        for e in valid:
            ci = int(pk.locate([e["key"]])[0][0])
            if ci < 0:
                continue
            st = e["strand"]
            read = oriented[st]
            if e["ug"]:
                p0, cigar = e["key"], [("M", ln)]
                nm = m_mismatches(pk.seq, p0, read, cigar)
            else:
                p0, cigar, nm = e["trace"]
            span = sum(n for op, n in cigar if op in "MD")
            if ci < self.n_genome:
                if not (p0 >= pk.starts[ci] and p0 + span - 1 < pk.ends[ci]):
                    continue
                recs.append((e["score"], st, ci, p0, 0, cigar, nm))
                continue
            tx = self.txs[ci - self.n_genome]
            txp = p0 - int(pk.starts[ci])
            if txp < 0 or txp + span > int(pk.ends[ci] - pk.starts[ci]):
                continue
            gpos, gcigar, gst = project(tx, txp, cigar, st)
            gci = self.genome.names.index(tx.chrom)
            recs.append((e["score"], gst, gci,
                         int(self.genome.starts[gci]) + gpos, 1, gcigar, nm))
        if not recs:
            return None
        seen = {}
        for i, r in enumerate(recs):
            k = (r[1], r[2], r[3])
            j = seen.get(k)
            if j is None or r[0] > recs[j][0] or (
                    r[0] == recs[j][0] and r[4] < recs[j][4]):
                seen[k] = i
        uniq = sorted((recs[i] for i in seen.values()),
                      key=lambda r: (-r[0], r[1], r[2], r[3], r[4]))
        win = uniq[0]
        x0 = sum(1 for r in uniq if r[0] == win[0])
        x1 = len(uniq) - x0
        return {"strand": win[1], "pos": win[3], "score": win[0],
                "mapq": mapq(x0, x1), "x0": x0, "x1": x1, "nm": win[6],
                "cigar": win[5]}

    # --- SAM ---
    def sam_lines(self, codes, lengths, names, qual: bytes) -> list:
        """The SAM line (no newline) of every read, as bytes."""
        out = []
        for b, aln in enumerate(self.align(codes, lengths)):
            ln = int(lengths[b])
            out.append(sam_line(names[b], codes[b, :ln], qual * ln, aln,
                                self.genome))
        return out


def mapq(x0: int, x1: int) -> int:
    if x0 > 1:
        return 0
    if x1 == 0:
        return 37
    return max(0, 23 - int(4.343 * math.log(x1)))


def project(tx, tx_pos: int, cigar: list, read_strand: int):
    """A transcript-space alignment in genome space -> (chrom-local start,
    cigar with an N for every intron crossed, genome strand)."""
    span = sum(n for op, n in cigar if op in "MD")
    Tl = int((tx.exon_ends - tx.exon_starts).sum())
    if tx.strand == "-":
        s, walk, g_strand = Tl - (tx_pos + span), cigar[::-1], 1 - read_strand
    else:
        s, walk, g_strand = tx_pos, list(cigar), read_strand
    cum = np.concatenate([[0], np.cumsum(tx.exon_ends - tx.exon_starts)])
    out = []

    def emit(op, n):
        if n == 0:
            return
        if out and out[-1][0] == op:
            out[-1] = (op, out[-1][1] + n)
        else:
            out.append((op, n))

    start = prev_end = None
    for op, n in walk:
        if op == "I":
            emit("I", n)
            continue
        while n > 0:
            e = int(np.searchsorted(cum, s, side="right")) - 1
            take = min(n, int(cum[e + 1] - s))
            g = int(tx.exon_starts[e] + (s - cum[e]))
            if start is None:
                start = g
            if prev_end is not None and g > prev_end:
                emit("N", g - prev_end)
            emit(op, take)
            prev_end = g + take
            s += take
            n -= take
    return start, out, g_strand


def md_tag(seq: np.ndarray, pos: int, cigar: list, read: np.ndarray) -> str:
    out, run, ri, qi = [], 0, pos, 0
    for op, n in cigar:
        if op == "M":
            for k in range(n):
                rb, cb = int(seq[ri + k]), int(read[qi + k])
                if rb == cb and rb < 4:
                    run += 1
                else:
                    out += [str(run), chr(CODE_TO_BASE[min(rb, 4)])]
                    run = 0
            ri += n
            qi += n
        elif op == "I":
            qi += n
        elif op == "D":
            out += [str(run), "^" + "".join(
                chr(CODE_TO_BASE[min(int(x), 4)]) for x in seq[ri:ri + n])]
            run = 0
            ri += n
        elif op == "N":
            ri += n
    out.append(str(run))
    return "".join(out)


def sam_line(name: str, read: np.ndarray, qual: bytes, aln,
             genome: Packed) -> bytes:
    seq = CODE_TO_BASE[read.astype(np.int64)].tobytes().decode()
    q = qual.decode()
    if aln is None:
        return "\t".join([name, "4", "*", "0", "0", "*", "*", "0", "0",
                          seq, q]).encode()
    ci, local = genome.locate([aln["pos"]])
    aligned = read
    if aln["strand"] == 1:
        aligned = revcomp(read)
        seq = CODE_TO_BASE[aligned.astype(np.int64)].tobytes().decode()
        q = q[::-1]
    cig = "".join(f"{n}{op}" for op, n in aln["cigar"])
    tags = [f"XT:A:{'U' if aln['x0'] == 1 else 'R'}", f"NM:i:{aln['nm']}",
            f"X0:i:{aln['x0']}", f"X1:i:{aln['x1']}",
            f"AS:i:{aln['score']}",
            "MD:Z:" + md_tag(genome.seq, aln["pos"], aln["cigar"], aligned)]
    return "\t".join([name, "16" if aln["strand"] == 1 else "0",
                      genome.names[int(ci[0])], str(int(local[0]) + 1),
                      str(aln["mapq"]), cig, "*", "0", "0", seq, q]
                     + tags).encode()
