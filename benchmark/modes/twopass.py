"""Mode `twopass`: the engine of `cli index` + `twopass` over the genome, one
library call the CLI's two passes (parasuite_tpu_torch/pipeline/
two_pass.py::streaming_two_pass): pass 1 streams the library with the
configuration's flat scores and counts the error profile from its
alignments, the learned score tensor S[cycle, ref, read] is set on the
engine, and pass 2 streams the library again with it.

The tap keeps both passes' records. When the call sets the learned S (a
wrapper around the engine's set_profile, as SamTap wraps emit_sam), pass
1's blocks move to `tap.pass1`, and the tap keeps that S (`tap.learned_s`);
after the call it keeps the program's profile (`tap.profile`). So
`tap.lines()` is pass 2's records. Pass 1's SAM and the profile file are
files in memory beside the run's SAM, made once a run as harness/system.py::
sam_output makes that one; pass 1's checkpoints lie beside them, as the
run's do.

The reference is numpy, as harness/reference.py, and loads nothing of the
program, torch or jax. Given the tap, it judges both passes:
  (a) it counts every pass-1 record into substitution counts [L, 4, 4] by
      machine cycle, ref base and read base: the M segments of a mapped
      record against the genome, a reverse-strand record's cycles reversed
      and both bases complemented, a base pair with an N skipped; and the
      reads (mapped records), the gapped ones (a CIGAR other than one M),
      insertions a base at its cycle, deletions at the cycle of the read
      base after the gap;
  (b) it makes S by profile_score_tensor's formula over (a);
  (c) pass 2 is judged by Reference(s_fwd=S);
  (d) a sampled read whose pass-1 record (found by name) is not the flat
      reference's line comes back marked (MARK), so that it cannot equal
      the program's record; if the program's profile or S is not (a)'s or
      (b)'s in every entry, every sampled line comes back marked. Standard
      error says which check failed.
With no tap (the control), S is made by the same formula from the counts
the read model of CONTROL_MODEL gives: cycle-varying (a multinomial draw
of a library's counts) and strand-asymmetric (T read as C).
"""

from __future__ import annotations

import os
import sys
import weakref
from pathlib import Path

import numpy as np

from harness import reference as plain, spec

ANNOTATION = False
ALIGN = spec.mode("align", Path(__file__).resolve().parents[1])

A, C, G, T, N = 0, 1, 2, 3, 4
COMP = np.array([T, G, C, A, N], dtype=np.int64)
CODE = np.full(256, N, dtype=np.int64)
CODE[np.frombuffer(b"ACGT", dtype=np.uint8)] = [A, C, G, T]
MARK = b"<not the two-pass reference's record>\t"

# The control's read model, configs/chr22_twopass.json `assumed`: the
# parclip50 mix's machine-frame substitutions (0.2%, to each other base
# alike) and T->C at 12% of T, on a genome of even base composition, over a
# library of 1,048,576 mapped reads; the counts a cycle and ref base are a
# multinomial draw (seed) of that model, as a library's are.
CONTROL_MODEL = {"reads": 1_048_576, "sub_rate": 0.002, "tc_rate": 0.12,
                 "seed": 20_160_101}


def build(conf: dict, genome: dict, txs: list, device: str):
    # the pipeline this mode runs: a checkout without it fails here, before
    # the index is built
    from parasuite_tpu_torch.pipeline.two_pass import (  # noqa: F401
        streaming_two_pass)

    return ALIGN.build(conf, genome, txs, device)


def _memory_file(work: Path, name: str, owner) -> str:
    """A path in `work` that links to a file in memory, closed with
    `owner`."""
    fd = os.memfd_create(name)
    path = work / name
    os.symlink(f"/proc/{os.getpid()}/fd/{fd}", path)
    weakref.finalize(owner, os.close, fd)
    return str(path)


def _keep_passes(engine, tap, work: Path) -> None:
    tap.pass1, tap.learned_s, tap.profile = [], None, None
    tap.pass1_sam = _memory_file(work, "pass1.sam", tap)
    tap.profile_out = _memory_file(work, "out.errorprofile", tap)
    set_profile = engine.set_profile

    def marked(s_tensor):
        # pass 1 sets the flat tensor before its first record, and the
        # learned one after its last: the blocks so far are pass 1's
        tap.pass1 = list(tap.blocks)
        tap.blocks.clear()
        tap.learned_s = np.array(s_tensor)
        set_profile(s_tensor)

    engine.set_profile = marked


def call(engine, fastq, out_sam, tap, log=None) -> int:
    """Both passes over the library -> pass 2's records."""
    from parasuite_tpu_torch.pipeline.two_pass import streaming_two_pass
    from parasuite_tpu_torch.utils.runlog import NULL_LOG

    if not hasattr(tap, "pass1"):
        _keep_passes(engine, tap, Path(out_sam).parent)
    tap.blocks.clear()
    n, profile, _n1 = streaming_two_pass(
        engine, fastq, out_sam, pass1_out=tap.pass1_sam,
        profile_out=tap.profile_out, log=NULL_LOG if log is None else log)
    tap.profile = {"counts": profile.counts, "n_reads": profile.n_reads,
                   "ins": profile.ins_counts, "dels": profile.del_counts,
                   "n_gapped": profile.n_gapped}
    return n


def traced(n_batches: int) -> tuple:
    """Pass 1's second half of the call's 2 x n_batches dispatches: the
    pipeline is full, and the step counts the profile (its second graph)
    and the main thread does the profile's accounting; pass 2's device work
    is mode align's."""
    return n_batches // 2, n_batches


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------

def _cigar(text: bytes) -> list:
    ops, num = [], 0
    for ch in text.decode():
        if ch.isdigit():
            num = num * 10 + int(ch)
        else:
            ops.append((ch, num))
            num = 0
    return ops


def profile_from_records(lines, packed: plain.Packed, L: int) -> dict:
    """(a): the profile counted from SAM records (bytes lines, no header)
    over the packed genome -> counts, n_reads, ins, dels, n_gapped."""
    counts = np.zeros(L * 16, dtype=np.int64)
    ins = np.zeros(L, dtype=np.int64)
    dels = np.zeros(L, dtype=np.int64)
    n_reads = n_gapped = 0
    chrom = {name.encode(): int(s) for name, s in zip(packed.names,
                                                      packed.starts)}
    plain_rows: dict = {}       # length -> ([packed pos], [rev], [SEQ])
    for ln in lines:
        f = ln.split(b"\t", 10)
        flag = int(f[1])
        n = len(f[9])
        if flag & 4 or n == 0:
            continue
        n_reads += 1
        p0 = chrom[f[2]] + int(f[3]) - 1
        rev = bool(flag & 16)
        if f[5] == b"%dM" % n:
            rows = plain_rows.setdefault(n, ([], [], []))
            rows[0].append(p0)
            rows[1].append(rev)
            rows[2].append(f[9])
            continue
        n_gapped += 1
        seq = CODE[np.frombuffer(f[9], dtype=np.uint8)]
        ri, qi = p0, 0
        for op, k in _cigar(f[5]):
            if op == "M":
                rb, cb = packed.seq[ri:ri + k].astype(np.int64), seq[qi:qi + k]
                cyc = np.arange(qi, qi + k)
                if rev:
                    cyc, rb, cb = n - 1 - cyc, COMP[rb], COMP[cb]
                ok = (rb < 4) & (cb < 4) & (cyc < L)
                np.add.at(counts, cyc[ok] * 16 + rb[ok] * 4 + cb[ok], 1)
                ri += k
                qi += k
            elif op == "I":
                for q in range(qi, qi + k):
                    c = n - 1 - q if rev else q
                    if c < L:
                        ins[c] += 1
                qi += k
            elif op == "D":
                q = min(qi, n - 1)
                c = n - 1 - q if rev else q
                if c < L:
                    dels[c] += k
                ri += k
    for n, (pos, rev, seqs) in plain_rows.items():
        p0 = np.asarray(pos, dtype=np.int64)
        rev = np.asarray(rev)
        read = CODE[np.frombuffer(b"".join(seqs), dtype=np.uint8)].reshape(
            -1, n)                                         # SAM SEQ
        ref = packed.seq[p0[:, None] + np.arange(n)].astype(np.int64)
        # machine frame: a reverse record's SEQ and ref, reversed and
        # complemented
        read = np.where(rev[:, None], COMP[read[:, ::-1]], read)
        ref = np.where(rev[:, None], COMP[ref[:, ::-1]], ref)
        cyc = np.broadcast_to(np.arange(n), read.shape)
        ok = (ref < 4) & (read < 4) & (cyc < L)
        counts += np.bincount((cyc * 16 + ref * 4 + read)[ok],
                              minlength=L * 16)
    return {"counts": counts.reshape(L, 4, 4), "n_reads": n_reads,
            "ins": ins, "dels": dels, "n_gapped": n_gapped}


def score_tensor(counts: np.ndarray, params: dict) -> np.ndarray:
    """(b): S [L, 5, 5] from substitution counts, by the formula of the
    program's profile_score_tensor over ErrorProfile.probs: probabilities
    smoothed by the pseudocount, log-odds against 1/4 scaled, rounded and
    clipped; any pair with an N scores n_score."""
    c = counts.astype(np.float64) + params["profile_pseudocount"]
    probs = c / c.sum(axis=2, keepdims=True)
    with np.errstate(divide="ignore"):
        logodds = params["profile_scale"] * np.log2(
            np.maximum(probs, 1e-12) / 0.25)
    s4 = np.clip(np.rint(logodds), params["profile_min_score"],
                 params["profile_max_score"])
    s = np.full((counts.shape[0], 5, 5), params["n_score"], dtype=np.int32)
    s[:, :4, :4] = s4.astype(np.int32)
    return s


def model_counts(L: int, model: dict = CONTROL_MODEL) -> np.ndarray:
    """The control's substitution counts [L, 4, 4] (CONTROL_MODEL)."""
    s, t = model["sub_rate"], model["tc_rate"]
    eye = np.eye(4)
    p = (1 - s) * eye + s / 3 * (1 - eye)          # substitutions
    tc = eye.copy()
    tc[T, T], tc[T, C] = 1 - t, t                    # then T->C
    p = p @ tc
    rng = np.random.default_rng(model["seed"])
    return np.asarray([[rng.multinomial(model["reads"] // 4, p[r])
                        for r in range(4)] for _ in range(L)],
                      dtype=np.int64)


class TwoPass:
    """The reference of one two-pass call: sam_lines gives pass 2's lines,
    marked where (d) says; filled_share, packed and s_fwd are pass 2's."""

    def __init__(self, genome: dict, params: dict, txs: list, tap):
        L = params["max_read_len"]
        self.faults: list = []
        self.pass1 = None
        if tap is None:
            counts = model_counts(L)
        else:
            self.flat = plain.Reference(genome, params, txs)
            lines = [ln for ln in b"".join(tap.pass1).split(b"\n") if ln]
            self.pass1 = {ln.split(b"\t", 1)[0]: ln for ln in lines}
            want = profile_from_records(lines, self.flat.genome, L)
            counts = want["counts"]
            got = tap.profile
            for k, v in want.items():
                if not np.array_equal(np.asarray(got[k]), v):
                    self.faults.append(f"profile {k}")
            self.summary = {k: want[k] for k in ("n_reads", "n_gapped")}
        S = score_tensor(counts, params)
        if tap is not None and not np.array_equal(tap.learned_s, S):
            self.faults.append("learned S")
        self.learned = plain.Reference(genome, params, txs, s_fwd=S)

    @property
    def filled_share(self) -> float:
        return self.learned.filled_share

    @property
    def packed(self):
        return self.learned.packed

    @property
    def s_fwd(self):
        return self.learned.s_fwd

    def sam_lines(self, codes, lengths, names, qual: bytes) -> list:
        want = self.learned.sam_lines(codes, lengths, names, qual)
        if self.pass1 is None:
            return want
        if self.faults:
            print(f"two-pass reference: the program's "
                  f"{', '.join(self.faults)} differ from the counts of its "
                  f"pass-1 records: every sampled record marked",
                  file=sys.stderr)
            return [MARK + w for w in want]
        flat = self.flat.sam_lines(codes, lengths, names, qual)
        bad = {i for i, (name, w) in enumerate(zip(names, flat))
               if self.pass1.get(name.encode()) != w}
        print(f"two-pass reference: profile and learned S equal the counts "
              f"of the {len(self.pass1)} pass-1 records (n_reads "
              f"{self.summary['n_reads']}, n_gapped "
              f"{self.summary['n_gapped']}); sampled pass-1 records not the "
              f"flat reference's: {len(bad)}", file=sys.stderr)
        return [MARK + w if i in bad else w for i, w in enumerate(want)]


def reference(genome: dict, params: dict, txs: list, tap):
    return TwoPass(genome, params, txs, tap)
