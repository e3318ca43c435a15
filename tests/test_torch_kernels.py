"""The port's kernel modules: plain versions vs the Pallas kernels, the CPU
routing of the wrappers and the lazy build (the CUDA kernels themselves are
tested on a card by test_torch_cuda.py).

The Pallas kernels run in interpret mode at tests/test_pallas.py's tiny
config, as the JAX package's own CPU tests run them. The plain select is
also held to the JAX package at every row width the CUDA kernel is built
for, on the rows the card phase holds the kernel to
(parasuite_tpu_torch.testing: SELECT_CASES and select_case_rows)."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from parasuite_tpu.config import AlignConfig
from parasuite_tpu.errormodel import flat_score_tensor
from parasuite_tpu.index import KmerIndex, PackedReference
from parasuite_tpu.ops import aligner as jx
from parasuite_tpu.ops.device_index import DeviceIndex as JDeviceIndex
from parasuite_tpu.ops.device_index import ScoreParams as JScoreParams
from parasuite_tpu.ops.pallas_extend import extend_candidates_pallas
from parasuite_tpu.ops.pallas_seed import select_candidates_pallas
from parasuite_tpu_torch import convert
from parasuite_tpu_torch.ops import (_build, cuda_extend, cuda_finalize,
                                     cuda_seed)
from parasuite_tpu_torch.ops import aligner as tx
from parasuite_tpu_torch.ops.device_index import DeviceIndex, ScoreParams
from parasuite_tpu_torch.testing import (FINALIZE_CASES, SELECT_CASES,
                                         finalize_case, select_case_rows)

from conftest import sample_reads
from _torch_helpers import finalize_args

torch.set_num_threads(1)

TINY = AlignConfig(max_read_len=24, kmer_size=6, max_seeds=4, max_occ=8,
                   max_candidates=2, band_width=2, chrom_spacer=40)
T_TINY = convert.align_config(dataclasses.asdict(TINY))   # the port's own


def _world(seed, biased):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, 3000)
    ref = PackedReference.from_dict(
        {"c": ((base % 3) if biased else base).astype(np.int8)}, spacer=40)
    idx = KmerIndex.build(ref.seq, TINY.kmer_size)
    codes, lengths, _ = sample_reads(rng, ref, 16, 24, mutate=2, indel=True)
    lengths[3] = 0
    lengths[4] = 17
    codes[4, 17:] = 4
    jd = JDeviceIndex.from_host(ref, idx)
    js = JScoreParams.from_tensor(flat_score_tensor(TINY, 24), TINY)
    td = DeviceIndex.from_numpy(*(np.asarray(getattr(jd, f))
                                  for f in jd._fields), device="cpu")
    ts = ScoreParams.from_numpy(*(np.asarray(getattr(js, f))
                                  for f in js._fields), device="cpu")
    return codes, lengths, jd, js, td, ts


def test_select_plain_equals_pallas_interpret():
    """Alphabet-biased reference -> repeated k-mers -> vote ties."""
    codes, lengths, jd, _, td, _ = _world(501, biased=True)
    oriented = jx.orient_reads(codes, lengths)
    diags = jx.seed_diagonals(oriented, lengths, jd, TINY)
    pal_cand, pal_valid = jax.jit(functools.partial(
        select_candidates_pallas, cfg=TINY, interpret=True))(diags)
    cand, valid = cuda_seed.select_candidates_plain(
        torch.tensor(np.asarray(diags)), T_TINY)
    np.testing.assert_array_equal(cand.numpy(), np.asarray(pal_cand))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(pal_valid))
    assert valid.any() and not valid.all()


# Pallas in interpret mode unrolls n_pad rolls at trace time (a minute at
# n_pad = 128 on a CPU, and it grows faster than n_pad), so it takes the
# widths up to PALLAS_MAX_N and the main path's width (7 seeds x 16
# occurrences = 112, n_pad 128), at C = 8 (each of the C rounds is another
# log2(n_pad) rolls) and, of each case, the first PALLAS_ROWS rows of the
# tie and missing-seed blocks and the three special rows; the wider classes
# (the rescue width 208 and up) are held to the jnp function alone, which
# takes every width and every row
PALLAS_MAX_N = 64
PALLAS_MAIN_N = 112
PALLAS_ROWS = 6


@pytest.mark.parametrize("n,C", SELECT_CASES)
def test_select_plain_equals_jax_at_every_width(n, C):
    """n = 8 .. 4,096 (n_pad 32 .. 4,096 on the card): heavy ties, missing
    seeds, all-I32MAX rows, one repeated diagonal; tolerance 0."""
    rows = select_case_rows(n)
    assert (rows[-3] == cuda_seed.I32MAX).all() and (rows[-2] == 17).all()
    cfg = TINY.replace(max_candidates=C)
    t_cfg = convert.align_config(dataclasses.asdict(cfg))
    cand, valid = cuda_seed.select_candidates_plain(torch.from_numpy(rows),
                                                    t_cfg)
    j_cand, j_valid = jx.select_candidates(rows, cfg)
    np.testing.assert_array_equal(cand.numpy(), np.asarray(j_cand))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))
    assert not valid[-3].any() and valid[-2].sum() == 1
    if C > 8 or (n > PALLAS_MAX_N and n != PALLAS_MAIN_N):
        return
    pick = np.r_[0:PALLAS_ROWS, 32:32 + PALLAS_ROWS, len(rows) - 3:len(rows)]
    p_cand, p_valid = jax.jit(functools.partial(
        select_candidates_pallas, cfg=cfg, interpret=True))(rows[pick])
    np.testing.assert_array_equal(cand.numpy()[pick], np.asarray(p_cand))
    np.testing.assert_array_equal(valid.numpy()[pick], np.asarray(p_valid))


def test_extend_plain_equals_pallas_interpret():
    codes, lengths, jd, js, td, ts = _world(500, biased=False)
    oriented = jx.orient_reads(codes, lengths)
    diags = jx.seed_diagonals(oriented, lengths, jd, TINY)
    cand, _ = jx.select_candidates(diags, TINY)
    pal = jax.jit(functools.partial(extend_candidates_pallas, cfg=TINY,
                                    interpret=True))(
        oriented, lengths, cand, jd, js)
    got = cuda_extend.extend_candidates_plain(
        torch.tensor(np.asarray(oriented)), torch.from_numpy(lengths),
        torch.tensor(np.asarray(cand)), td, ts, T_TINY)
    for name, t, p in zip(["dp_score", "dp_j", "ug_score", "ug_j"], got, pal):
        np.testing.assert_array_equal(t.numpy(), np.asarray(p), err_msg=name)


def test_wrappers_route_cpu_tensors_to_plain(monkeypatch):
    """CPU tensors take the plain versions: no build, no launch counted."""
    def no_build():
        raise AssertionError("a CPU tensor reached the kernel build")

    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(cuda_seed, "launches", 0)
    monkeypatch.setattr(cuda_extend, "launches", 0)
    monkeypatch.setattr(cuda_finalize, "launches", 0)
    codes, lengths, _, _, td, ts = _world(502, biased=False)
    tcodes, tlens = torch.from_numpy(codes), torch.from_numpy(lengths)
    oriented = tx.orient_reads(tcodes, tlens)
    diags = tx.seed_diagonals(oriented, tlens, td, T_TINY)
    got = cuda_seed.select_candidates(diags, T_TINY)
    want = cuda_seed.select_candidates_plain(diags, T_TINY)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    ext = cuda_extend.extend_candidates(oriented, tlens, got[0], td, ts,
                                        T_TINY)
    ext_plain = cuda_extend.extend_candidates_plain(oriented, tlens, got[0],
                                                    td, ts, T_TINY)
    for g, w in zip(ext, ext_plain):
        assert torch.equal(g, w)
    for n, combined in ((16, False), (16, True)):
        args, kw = finalize_args(finalize_case(n, combined), "cpu")
        got = cuda_finalize.finalize_select(*args, **kw)
        want = tx.finalize_core(*args, **kw)
        for g, w in zip((*got[0], got[1]), (*want[0], want[1])):
            assert torch.equal(g, w)
    assert cuda_seed.launches == 0 and cuda_extend.launches == 0
    assert cuda_finalize.launches == 0
    assert _build._lib is None


def test_import_does_not_build():
    """Importing every module of the port compiles and loads nothing: in a
    fresh interpreter (torch already imported), any subprocess or
    shared-library load during the imports fails the run."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import ctypes, subprocess\n"
        "import numpy, torch\n"
        "def refuse(*a, **k):\n"
        "    raise SystemExit('build or load during import')\n"
        "subprocess.run = subprocess.Popen = refuse\n"
        "ctypes.CDLL = refuse\n"
        "import parasuite_tpu_torch.cli, parasuite_tpu_torch.ops.aligner\n"
        "import parasuite_tpu_torch.ops.cuda_finalize\n"
        "import parasuite_tpu_torch.ops.profile_update\n"
        "import parasuite_tpu_torch.pipeline.align\n"
        "import parasuite_tpu_torch.pipeline.stream\n"
        "from parasuite_tpu_torch.ops import _build\n"
        "assert _build._lib is None and _build.build_log == ''\n"
        "print('ok')\n")
    repo = Path(__file__).resolve().parent.parent
    p = subprocess.run([sys.executable, "-c", code], cwd=repo,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0 and p.stdout.strip() == "ok", p.stderr[-2000:]
    assert _build.FLAGS[:2] == ["-gencode", "arch=compute_90a,code=sm_90a"]
    assert [q.name for q in _build._sources()] == [
        "extend_candidates.cu", "finalize_select.cu", "select_candidates.cu"]



# ---------------------------------------------------------------------------
# seed and select in one kernel (cuda_seed.seed_select)
# ---------------------------------------------------------------------------

def _seed_world(L: int, k: int, seed: int, n: int = 24):
    """A 6 kbp random reference with a 700 bp tandem repeat of a 7 bp unit
    (k-mers with 0 and with more than max_occ occurrences) -> (JAX and port
    DeviceIndex, codes, lengths): mutated reads with indels, some from the
    repeat, an all-N read, a read of length 0, one shorter than k, one
    N-padded short read and one with an N inside."""
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 4, 6000).astype(np.int8)
    seq[2000:2700] = np.tile(rng.integers(0, 4, 7), 100)
    ref = PackedReference.from_dict({"c": seq}, spacer=L + 40)
    jd = JDeviceIndex.from_host(ref, KmerIndex.build(ref.seq, k))
    td = DeviceIndex.from_numpy(*(np.asarray(getattr(jd, f))
                                  for f in jd._fields), device="cpu")
    codes, lengths, _ = sample_reads(rng, ref, n, L, mutate=2, indel=True)
    st = int(ref.starts[0]) + 2100
    codes[0] = ref.seq[st:st + L]
    codes[1, : L // 2] = ref.seq[st:st + L // 2]
    codes[2] = 4
    lengths[3] = 0
    codes[3] = 4
    lengths[4] = k - 1
    codes[4, k - 1:] = 4
    lengths[5] = L - 7
    codes[5, L - 7:] = 4
    codes[6, L // 3] = 4
    return jd, td, codes, lengths


SEED_CASES = {   # (L, k, max_seeds, max_occ, max_candidates, placement)
    "adaptive": (24, 6, 4, 8, 2, "adaptive"),
    "fixed": (24, 6, 4, 8, 2, "fixed"),
    "rescue": (36, 6, 13, 16, 8, "adaptive"),   # the rescue tier's cfg
    "one_seed": (24, 6, 1, 8, 2, "adaptive"),
}


@pytest.mark.parametrize("case", list(SEED_CASES))
def test_seed_select_on_cpu_equals_the_plain_pair(case):
    """On CPU tensors seed_select is select_candidates_plain over
    seed_diagonals' rows, and both equal the JAX package's select over its
    seed_diagonals; no kernel is built or counted."""
    L, k, S, M, C, placement = SEED_CASES[case]
    cfg = TINY.replace(max_read_len=L, kmer_size=k, max_seeds=S, max_occ=M,
                       max_candidates=C, seed_placement=placement,
                       seed_stride=6, chrom_spacer=L + 40)
    if case == "rescue":   # the rescue tier AlignerEngine makes of a k = 8 run
        primary = cfg.replace(kmer_size=8, max_seeds=7, rescue_kmer=6,
                              rescue_seeds=13)
        cfg = primary.replace(kmer_size=primary.rescue_kmer, rescue_kmer=0,
                              max_seeds=max(primary.rescue_seeds,
                                            primary.max_seeds))
    t_cfg = convert.align_config(dataclasses.asdict(cfg))
    jd, td, codes, lengths = _seed_world(L, k, 700 + len(case))
    tlens = torch.from_numpy(lengths)
    oriented = tx.orient_reads(torch.from_numpy(codes), tlens)
    n_seeded, lib = cuda_seed.seeded_launches, _build._lib
    got = cuda_seed.seed_select(oriented, tlens, td, t_cfg)
    want = cuda_seed.select_candidates_plain(
        cuda_seed.seed_diagonals(oriented, tlens, td, t_cfg), t_cfg)
    j_or = jx.orient_reads(codes, lengths)
    j_cand, j_valid = jx.select_candidates(
        jx.seed_diagonals(j_or, lengths, jd, cfg), cfg)
    for g, w, j in zip(got, want, (j_cand, j_valid)):
        assert g.dtype == w.dtype and torch.equal(g, w)
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    assert got[1].any() and not got[1].all()
    assert cuda_seed.seeded_launches == n_seeded and _build._lib is lib


def test_seed_select_resolves_like_the_reference():
    """select_impl "auto" is seed_select, "jnp" seed_select_plain, and
    "pallas" raises on CPU tensors, as _kernel_only does."""
    jd, td, codes, lengths = _seed_world(24, 6, 710)
    tlens = torch.from_numpy(lengths)
    oriented = tx.orient_reads(torch.from_numpy(codes), tlens)
    assert tx.resolve_select_fn(T_TINY) is cuda_seed.seed_select
    assert tx.resolve_select_fn(T_TINY.replace(select_impl="jnp")) is \
        cuda_seed.seed_select_plain
    pallas = tx.resolve_select_fn(T_TINY.replace(select_impl="pallas"))
    with pytest.raises(ValueError, match="select_impl='pallas' needs the "
                                         "CUDA kernel"):
        pallas(oriented, tlens, td, T_TINY)


def _trunc_div(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // b
    return q if a >= 0 else -q


def _seeded_row(read, length, cfg, bucket_starts, positions, n_pad):
    """The row select_candidates.cu's SeedRows loads for one oriented read,
    as the kernel indexes it: register path (n_pad <= 1,024) lane by lane
    and register by register, 32 seeds a round handed over by shuffles;
    wide path 256 seeds a round through shared scratch. -> int64 [n_pad]."""
    L, k, S, M = cfg.max_read_len, cfg.kmer_size, cfg.max_seeds, cfg.max_occ
    adaptive = cfg.seed_placement == "adaptive" and S > 1
    st = max(_trunc_div(length - k, S - 1), 1) if adaptive else cfg.stride
    n = S * M
    I32 = int(cuda_seed.I32MAX)

    def seed(s):
        off = min(s * st, L - 1) if adaptive else s * st
        if s >= S or off + k > length:
            return 0, 0, off
        code = 0
        for q in range(k):
            c = int(read[off + q]) if off + q < L else 4
            if not 0 <= c <= 3:
                return 0, 0, off
            code = code * 4 + c
        lo = int(bucket_starts[code])
        cnt = int(bucket_starts[code + 1]) - lo
        return lo, (cnt if 0 < cnt <= M else 0), off

    row = np.full(n_pad, I32, dtype=np.int64)
    if n_pad <= 1024:
        E = n_pad // 32
        v = np.full((32, E), I32, dtype=np.int64)     # [lane, register]
        for g in range(-(-S // 32)):
            made = [seed(g * 32 + lane) for lane in range(32)]
            e0, e1 = g * 32 * M, min(g * 32 * M + 32 * M, n)
            for r in range(E):
                if r * 32 >= e1 or r * 32 + 32 <= e0:
                    continue
                for lane in range(32):
                    e = r * 32 + lane
                    sd = e // M
                    j = e - sd * M
                    lo, cnt, off = made[(sd - g * 32) & 31]
                    if e0 <= e < e1 and j < cnt:
                        v[lane, r] = int(positions[lo + j]) - off
        return v.ravel()
    T = 256
    for g in range(-(-S // T)):
        made = [seed(g * T + t) for t in range(T)]
        e0, e1 = g * T * M, min(g * T * M + T * M, n)
        for e in range(e0, e1):
            sl = (e - e0) // M
            j = (e - e0) - sl * M
            lo, cnt, off = made[sl]
            if j < cnt:
                row[e] = int(positions[lo + j]) - off
    return row


EMULATED = {     # (L, k, max_seeds, max_occ, placement, stride): n_pad
    "main": (50, 8, 7, 16, "adaptive", 6),          # 128, one round
    "fixed": (50, 8, 7, 16, "fixed", 6),
    "rescue": (36, 6, 13, 16, "adaptive", 6),       # 256
    "one_seed": (50, 8, 1, 16, "adaptive", 6),      # 32
    "seeds_over_32": (100, 8, 40, 8, "adaptive", 6),  # 512, two rounds
    "wide": (100, 8, 17, 64, "adaptive", 6),        # 2,048, shared memory
    "wide_fixed": (100, 8, 30, 128, "fixed", 3),    # 4,096
    "wide_over_256": (100, 6, 300, 8, "adaptive", 6),  # 4,096, two rounds
}


@pytest.mark.parametrize("case", list(EMULATED))
def test_seeded_rows_emulated_equal_seed_diagonals(case):
    """The seeded kernel's row, indexed as the kernel indexes it (lanes,
    registers, rounds of seeds, the shuffles' source lanes, the wide path's
    scratch), holds the same diagonals as seed_diagonals' row padded with
    I32MAX to the kernel's width: sorted, the two are equal, so the sort
    network gives select_candidates' results."""
    L, k, S, M, placement, stride = EMULATED[case]
    cfg = T_TINY.replace(max_read_len=L, kmer_size=k, max_seeds=S,
                         max_occ=M, max_candidates=2,
                         seed_placement=placement, seed_stride=stride,
                         chrom_spacer=L + 40)
    _jd, td, codes, lengths = _seed_world(L, k, 720 + len(case), n=12)
    tlens = torch.from_numpy(lengths)
    oriented = tx.orient_reads(torch.from_numpy(codes), tlens)
    rows = cuda_seed.seed_diagonals(oriented, tlens, td, cfg).numpy()
    n_pad = cuda_seed._padded_width("test", S * M, cfg)
    assert n_pad == {"main": 128, "fixed": 128, "rescue": 256,
                     "one_seed": 32, "seeds_over_32": 512, "wide": 2048,
                     "wide_fixed": 4096, "wide_over_256": 4096}[case]
    flat = oriented.reshape(-1, L).numpy()
    bs, pos = td.bucket_starts.numpy(), td.positions.numpy()
    filled = 0
    for r in range(flat.shape[0]):
        got = _seeded_row(flat[r], int(lengths[r // 2]), cfg, bs, pos, n_pad)
        want = np.full(n_pad, cuda_seed.I32MAX, dtype=np.int64)
        want[: rows.shape[1]] = rows[r]
        np.testing.assert_array_equal(np.sort(got), np.sort(want),
                                      err_msg=f"row {r}")
        filled += int((want != cuda_seed.I32MAX).sum())
    assert filled > 0


# ---------------------------------------------------------------------------
# finalize's selection in one warp a read (cuda_finalize.finalize_select)
# ---------------------------------------------------------------------------

def _wrap32(x):
    """int64 -> the int32 value a wrapping int32 sum gives, as int64."""
    return (np.asarray(x, np.int64) + 2 ** 31) % 2 ** 32 - 2 ** 31


def _finalize_warp(case: dict, b: int) -> dict:
    """csrc/finalize_select.cu's finalize_kernel for read b, step by step:
    entry r * 32 + lane in register r of each lane ([E, 32] arrays), the
    dedupe's broadcasts in the kernel's order, the warp reductions with the
    kernel's values for entries past n, ballots for X0 / X1 and the window's
    NM and T->C, the picks at best_idx, the binary search and the masks."""
    n = case["valid"].shape[1]
    E = 1 << max(0, (n - 1).bit_length() - 5)
    assert E in (1, 2, 4, 8) and 32 * E >= n
    NEG, IMAX, IMIN = tx.NEG, 2 ** 31 - 1, -2 ** 31
    e = np.arange(E)[:, None] * 32 + np.arange(32)[None, :]
    in_row = e < n
    ec = np.minimum(e, n - 1)
    strand_row = (case["strand"] if case["strand"].ndim == 1
                  else case["strand"][b])
    ok = in_row & case["valid"][b][ec]
    st = np.where(in_row, strand_row[ec], 0).astype(np.int64)
    pk = np.where(in_row, case["pos_key"][b][ec], 0).astype(np.int64)
    sc = np.where(in_row, case["dps"][b][ec], 0).astype(np.int64)
    has_src = "src" in case
    sr = (np.where(in_row, case["src"][b][ec], 0) if has_src
          else np.zeros_like(e)).astype(np.int64)
    dup = np.zeros_like(in_row)
    for r2 in range(E):
        for j in range(min(32, n - r2 * 32)):
            if not ok[r2, j]:
                continue
            e2 = r2 * 32 + j
            st2, pk2, sc2, sr2 = st[r2, j], pk[r2, j], sc[r2, j], sr[r2, j]
            tie = ((sr2 < sr) | ((sr2 == sr) & (e2 < e))) if has_src \
                else e2 < e
            better = (sc2 > sc) | ((sc2 == sc) & tie)
            dup |= (st2 == st) & (pk2 == pk) & better
    uv = ok & ~dup
    has = bool(uv.any())
    best = np.where(in_row, np.where(uv, sc, NEG), IMIN).max(axis=0).max()
    at_best = uv & (sc == best)
    best_strand = np.where(in_row, np.where(at_best, st, 2), IMAX).min()
    at_bs = at_best & (st == best_strand)
    best_pos = np.where(at_bs, pk, IMAX).min()
    first = np.where(at_bs & (pk == best_pos), e, IMAX).min(axis=0).min()
    bi = 0 if first == IMAX else int(first)
    x0 = sum(int(np.count_nonzero(at_best[r])) for r in range(E))
    x1 = sum(int(np.count_nonzero(uv[r] & (sc[r] < best)))
             for r in range(E))
    mapq = 0 if x0 > 1 else 37 if x1 == 0 else max(
        23 - int(case["mapq_sub"][min(max(x1, 0), 255)]), 0)

    sel_strand = int(strand_row[bi])
    sel_pos = int(case["pos_key"][b, bi])
    sel_ug = bool(case["ug_eq"][b, bi])
    sel_nm_pos = int(case["nm_pos"][b, bi]) if "nm_pos" in case else sel_pos
    sel_nm_strand = (int(case["nm_strand"][b, bi]) if "nm_strand" in case
                     else sel_strand)
    starts, ends = case["chrom_starts"], case["chrom_ends"]
    lo, hi = 0, len(starts)
    while lo < hi:
        mid = (lo + hi) >> 1
        if starts[mid] <= sel_pos:
            lo = mid + 1
        else:
            hi = mid
    ci = min(max(lo - 1, 0), len(starts) - 1)
    length = int(case["lengths"][b])
    mapped = (has and sel_pos >= starts[ci]
              and _wrap32(_wrap32(sel_pos + length) - 1) < ends[ci]
              and length > 0)
    nm = tc = 0
    if mapped:
        ref, L = case["ref_seq"], case["oriented"].shape[2]
        G = ref.shape[0]
        read = case["oriented"][b, int(sel_nm_strand != 0)]
        span = min(L, length)
        lane = np.arange(32)
        for i0 in range(0, span, 32):
            i = i0 + lane
            act = i < span
            ridx = _wrap32(sel_nm_pos + i)
            inr = (ridx >= 0) & (ridx < G)
            rb = np.where(inr, ref[np.clip(ridx, 0, G - 1)], 4)
            rd = np.where(act, read[np.minimum(i, L - 1)], 0)
            mm = act & ((rb != rd) | (rb == 4) | (rd == 4))
            hit = act & (((rb == 0) & (rd == 2)) if sel_nm_strand == 1
                         else ((rb == 3) & (rd == 1)))
            nm += int(np.count_nonzero(mm))
            tc += int(np.count_nonzero(hit))
    return {"mapped": mapped, "strand": sel_strand if mapped else 0,
            "pos": sel_pos if mapped else -1,
            "score": int(case["dps"][b, bi]) if mapped else NEG,
            "mapq": mapq if mapped else 0, "x0": x0 if mapped else 0,
            "x1": x1 if mapped else 0, "ug_equal": sel_ug if mapped else True,
            "nm": nm if mapped else 0,
            "diag": int(case["diag"][b, bi]) if mapped else 0,
            "n_candidates": int(case["n_candidates"][b]),
            "tc_count": tc if mapped and sel_ug else 0, "best_idx": bi}


@pytest.mark.parametrize("n,combined", FINALIZE_CASES)
def test_finalize_warp_emulated_equals_finalize_core(n, combined):
    """The finalize kernel's per-lane algorithm, emulated in numpy read by
    read (_finalize_warp), equals finalize_core on every AlignResult field
    and best_idx over testing.finalize_case's tie-heavy rows (every
    register width, with and without src / nm_pos / nm_strand); the cases
    reach every branch of the selection and of MAPQ."""
    case = finalize_case(n, combined)
    args, kw = finalize_args(case, "cpu")
    res, best_idx = tx.finalize_core(*args, **kw)
    want = {**{f: v.numpy() for f, v in zip(res._fields, res)},
            "best_idx": best_idx.numpy()}
    for b in range(case["valid"].shape[0]):
        got = _finalize_warp(case, b)
        for f, v in got.items():
            assert v == want[f][b], (f, b, v, want[f][b])
    assert set(want["mapq"]) - {0, 37}          # MAPQ from mapq_sub
    assert want["mapped"].any() and not want["mapped"].all()
    assert (want["x0"] == 1).any() and (want["x0"] > 1).any()
    assert want["tc_count"].any() and want["nm"].any()
