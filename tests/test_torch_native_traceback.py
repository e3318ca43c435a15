"""The gapped host tracebacks in the native library (native.tracebacks_batch
behind pipeline/align.py::host_tracebacks_batch) against the numpy DP and
Python walk they replace, and against the per-read host_traceback (the
oracle's DP), at tolerance 0: the start, the CIGAR and the NM of every row.

The rows are reads cut from a random reference with substitutions,
insertions, deletions and N, on both strands, at a diagonal a few bases
off their true one."""

from types import SimpleNamespace

import numpy as np
import pytest

from parasuite_tpu_torch import native
from parasuite_tpu_torch.config import AlignConfig
from parasuite_tpu_torch.errormodel.scoring import (complement_score_tensor,
                                                    flat_score_tensor,
                                                    profile_score_tensor)
from parasuite_tpu_torch.oracle.align import banded_dp
from parasuite_tpu_torch.pipeline import align as palign
from parasuite_tpu_torch.utils import runlog
from parasuite_tpu_torch.utils.dna import N
from parasuite_tpu_torch.utils.runlog import RunLog

SPACER = 128


@pytest.fixture(scope="module", autouse=True)
def library():
    assert native.available(), "the native library did not build"


def _reference(rng, n: int, spacer: int = SPACER) -> np.ndarray:
    ref = rng.integers(0, 4, n + 2 * spacer).astype(np.int8)
    ref[:spacer] = N
    ref[n + spacer:] = N
    ref[rng.integers(spacer, n + spacer, n // 200)] = N
    return ref


def _read(rng, ref, start: int, ln: int, n_rate: float = 0.0):
    """ln genome-frame bases from ref[start:] with one to three edits:
    substitutions, single-base insertions and deletions."""
    seq = list(ref[start:start + ln + 8])
    for _ in range(int(rng.integers(1, 4))):
        k = int(rng.integers(1, ln - 1))
        kind = rng.integers(0, 3)
        if kind == 0:
            seq[k] = (seq[k] + 1) % 4
        elif kind == 1:
            seq.insert(k, int(rng.integers(0, 4)))
        else:
            del seq[k]
    read = np.asarray(seq[:ln], dtype=np.int8)
    read[rng.random(ln) < n_rate] = N
    return read


def _rows(rng, ref, cfg, lengths, n_rate: float = 0.0, spacer: int = SPACER):
    """G gapped rows as the engines hand them over: oriented [G, L]
    (N-padded), lens, strands and diagonals."""
    w = cfg.band_width
    lengths = np.asarray(lengths, dtype=np.int64)
    L = int(lengths.max())
    om = np.full((lengths.shape[0], L), N, dtype=np.int8)
    diags = np.empty(lengths.shape[0], dtype=np.int64)
    for g, ln in enumerate(lengths):
        start = int(rng.integers(spacer, ref.shape[0] - spacer - ln - 8))
        om[g, :ln] = _read(rng, ref, start, int(ln), n_rate)
        diags[g] = start + int(rng.integers(-(w // 2), w // 2 + 1))
    strands = rng.integers(0, 2, lengths.shape[0]).astype(np.int32)
    return om, lengths, strands, diags


def _numpy(monkeypatch, *args):
    with monkeypatch.context() as m:
        m.setattr(native, "available", lambda: False)
        return palign.host_tracebacks_batch(*args)


def _assert_three_ways(monkeypatch, ref, s, cfg, om, lens, strands, diags):
    """The native path finishes every row, and equals the numpy path and
    host_traceback row by row; starts and NMs are Python ints."""
    sc = complement_score_tensor(s)
    args = (ref, s, sc, cfg, om, lens, strands, diags)
    assert palign._native_tracebacks(ref, s, sc, cfg, om, lens, strands,
                                     diags) is not None
    got = palign.host_tracebacks_batch(*args)
    assert got == _numpy(monkeypatch, *args)
    per_read = [palign.host_traceback(ref, s, sc, cfg, om[g], int(lens[g]),
                                      int(strands[g]), int(diags[g]))
                for g in range(om.shape[0])]
    assert got == per_read
    assert all(type(p) is int and type(n) is int for p, _c, n in got)
    return got


@pytest.mark.parametrize("w", [3, 5, 8])
@pytest.mark.parametrize("ln", [20, 36, 50, 100])
def test_random_gapped_rows(monkeypatch, w, ln):
    """W = 8 (a band of 17) is wider than the device kernel's band tile,
    which AlignConfig refuses; the host tracebacks read only the band and
    the gap costs, so they take it from a plain namespace."""
    rng = np.random.default_rng(1000 * w + ln)
    base = AlignConfig(max_read_len=100)
    cfg = SimpleNamespace(band_width=w, gap_open=base.gap_open,
                          gap_extend=base.gap_extend)
    ref = _reference(rng, 20_000)
    got = _assert_three_ways(monkeypatch, ref, flat_score_tensor(base), cfg,
                             *_rows(rng, ref, cfg, [ln] * 48))
    ops = {op for _p, cigar, _n in got for op, _l in cigar}
    assert ops == {"M", "I", "D"}


def test_mixed_lengths_strands_and_n(monkeypatch):
    """One batch of 20-100 bp reads on both strands, N in the reads and in
    the reference."""
    rng = np.random.default_rng(7)
    cfg = AlignConfig(max_read_len=100, band_width=5)
    ref = _reference(rng, 20_000)
    om, lens, strands, diags = _rows(rng, ref, cfg,
                                     rng.integers(20, 101, 96), n_rate=0.03)
    assert set(strands.tolist()) == {0, 1} and (om == N).any()
    got = _assert_three_ways(monkeypatch, ref, flat_score_tensor(cfg), cfg,
                             om, lens, strands, diags)
    assert len({len(c) for _p, c, _n in got}) > 2


def test_learned_score_tensor(monkeypatch):
    """A learned S[cycle, ref, read] (twopass pass 2): every cycle its own
    scores, so the strand decides which cycle scores a base."""
    rng = np.random.default_rng(11)
    cfg = AlignConfig(max_read_len=60, band_width=5)
    probs = rng.dirichlet(np.ones(4) * 0.7, size=(60, 4))
    probs[:, np.arange(4), np.arange(4)] += 2.0
    s = profile_score_tensor(probs / probs.sum(-1, keepdims=True), cfg)
    assert len({s[i].tobytes() for i in range(60)}) > 1
    ref = _reference(rng, 10_000)
    _assert_three_ways(monkeypatch, ref, s, cfg,
                       *_rows(rng, ref, cfg, rng.integers(30, 61, 64)))


def _tie_rules(tables, ln: int, dp_j: int, cfg) -> set:
    """The tie rules of traceback_alignment's walk that decided a step of
    this walk: "M=Iy", "M=Ix", "Iy=Ix" out of M, "close I", "close D"."""
    M, Ix, Iy = tables
    go, ge = cfg.gap_open, cfg.gap_extend
    i, j, state, used = ln - 1, dp_j, "M", set()
    while not (state == "M" and i == 0):
        if state == "M":
            m, y, x = M[i - 1][j], Iy[i - 1][j], Ix[i - 1][j]
            top = max(m, y, x)
            used |= {name for name, a, b in (("M=Iy", m, y), ("M=Ix", m, x),
                                             ("Iy=Ix", y, x))
                     if a == b == top}
            state = "M" if top == m else "Iy" if top == y else "Ix"
            i -= 1
        elif state == "Ix":
            if M[i - 1][j + 1] - go == Ix[i - 1][j + 1] - ge:
                used.add("close I")
            state = "M" if M[i - 1][j + 1] - go >= Ix[i - 1][j + 1] - ge \
                else "Ix"
            i, j = i - 1, j + 1
        else:
            if M[i][j - 1] - go == Iy[i][j - 1] - ge:
                used.add("close D")
            state = "M" if M[i][j - 1] - go >= Iy[i][j - 1] - ge else "Iy"
            j -= 1
    return used


def test_rows_built_to_tie(monkeypatch):
    """Scores of -1, 0 and 1 and a gap cost of 1 a base make the three
    states tie along the walks; every tie rule decides some step of this
    batch, and the paths agree on each."""
    rng = np.random.default_rng(5)
    cfg = AlignConfig(max_read_len=40, band_width=4, gap_open=1,
                      gap_extend=1)
    s = rng.integers(-1, 2, (40, 5, 5)).astype(np.int32)
    ref = _reference(rng, 5_000)
    om, lens, strands, diags = _rows(rng, ref, cfg,
                                     rng.integers(12, 41, 128))
    _assert_three_ways(monkeypatch, ref, s, cfg, om, lens, strands, diags)
    sc = complement_score_tensor(s)
    used = set()
    for g in range(om.shape[0]):
        ln, st = int(lens[g]), int(strands[g])
        rows = palign._score_rows(s if st == 0 else sc, om[g], ln, st)
        refwin = palign._ref_window(ref, int(diags[g]), ln, cfg.band_width)
        _sc, dp_j, _u, _uj, tables = banded_dp(rows, refwin, ln, cfg,
                                               keep_tables=True)
        used |= _tie_rules(tables, ln, dp_j, cfg)
    assert used == {"M=Iy", "M=Ix", "Iy=Ix", "close I", "close D"}


def test_windows_across_the_reference_ends(monkeypatch):
    """A window that crosses an end of the reference while the alignment
    stays inside it: the native path finishes the row, equal to numpy. An
    alignment whose M bases leave the reference: the native library leaves
    the batch to numpy, whose NM slice raises ValueError."""
    rng = np.random.default_rng(9)
    cfg = AlignConfig(max_read_len=30, band_width=5)
    s = flat_score_tensor(cfg)
    sc = complement_score_tensor(s)
    ref = rng.integers(0, 4, 400).astype(np.int8)
    dropped = np.concatenate([ref[:10], ref[11:31]])
    inside = [(0, ref[:30]), (2, ref[:30]), (0, dropped),
              (370, ref[370:]), (373, ref[370:])]
    om = np.stack([r for _d, r in inside])
    lens = np.full(len(inside), 30, dtype=np.int64)
    diags = np.array([d for d, _r in inside], dtype=np.int64)
    got = _assert_three_ways(monkeypatch, ref, s, cfg, om, lens,
                             np.zeros(len(inside), dtype=np.int32), diags)
    assert got[0] == got[1] == (0, [("M", 30)], 0)
    assert got[2] == (0, [("M", 10), ("D", 1), ("M", 20)], 1)
    assert got[3] == got[4] == (370, [("M", 30)], 0)
    # beyond the start the window holds N, which no base matches: a poly-A
    # read at the start of a poly-A reference stays at 0
    poly_a = ref.copy()
    poly_a[:40] = 0
    got = _assert_three_ways(monkeypatch, poly_a, s, cfg, poly_a[None, :30],
                             lens[:1], np.zeros(1, dtype=np.int32),
                             np.zeros(1, dtype=np.int64))
    assert got == [(0, [("M", 30)], 0)]

    outside = [(-3, np.concatenate([[0, 1, 2], ref[:27]])),
               (372, np.concatenate([ref[372:], [1, 2]]))]
    for diag, read in outside:
        args = (ref, s, sc, cfg, read[None, :], np.array([30], np.int64),
                np.zeros(1, dtype=np.int32), np.array([diag], np.int64))
        assert palign._native_tracebacks(*args) is None
        with pytest.raises(ValueError, match="broadcast"):
            palign.host_tracebacks_batch(*args)
        with pytest.raises(ValueError, match="broadcast"):
            _numpy(monkeypatch, *args)


def _spans_and_counters(*args):
    log = RunLog(record=True)
    with runlog.bind(log, "main"):
        with runlog.span("engine.to_host", batch=1):
            out = palign.host_tracebacks_batch(*args)
    tb = next(s for s in log.spans if s.name == "engine.tracebacks")
    kids = sorted(s.name for s in log.spans if s.parent == tb.sid)
    return out, kids, log.summary()["counters"]


def test_unavailable_library_takes_the_numpy_path(monkeypatch):
    """With the loader failing, available() is false and the same rows come
    back through the numpy DP and walk: its spans, and no native rows."""
    rng = np.random.default_rng(13)
    cfg = AlignConfig(max_read_len=50, band_width=5)
    ref = _reference(rng, 10_000)
    s = flat_score_tensor(cfg)
    om, lens, strands, diags = _rows(rng, ref, cfg, rng.integers(30, 51, 40))
    args = (ref, s, complement_score_tensor(s), cfg, om, lens, strands,
            diags)
    want, kids, counters = _spans_and_counters(*args)
    assert kids == ["engine.tracebacks.native"]
    assert counters["engine.gapped_rows"] == 40
    assert counters["engine.tracebacks_native"] == 40

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_LIB_PATH", native._DIR / "missing.so")
    monkeypatch.setattr(native, "_make", lambda: None)
    assert not native.available()
    got, kids, counters = _spans_and_counters(*args)
    assert got == want
    assert kids == ["engine.tracebacks.dp", "engine.tracebacks.walk"]
    assert counters["engine.gapped_rows"] == 40
    assert counters.get("engine.tracebacks_native", 0) == 0
