"""Port device stages vs the JAX package, stage by stage (exact: int32
scoring, so every array must be equal).

Each case feeds the same numpy inputs to parasuite_tpu.ops (jnp path, CPU)
and to parasuite_tpu_torch.ops (plain PyTorch path on CPU tensors), and
compares orient, seed, select, extend, finalize, align_batch (all 12
AlignResult fields) and the profile counts."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from parasuite_tpu.config import AlignConfig
from parasuite_tpu.errormodel import counts_to_profile, flat_score_tensor
from parasuite_tpu.errormodel.infer import ErrorProfile
from parasuite_tpu.index import KmerIndex, PackedReference
from parasuite_tpu.ops import aligner as jx
from parasuite_tpu.ops import device_index as jdi
from parasuite_tpu.ops.profile_update import profile_counts_batch as jcounts
from parasuite_tpu.utils.dna import revcomp_codes
from parasuite_tpu_torch.ops import aligner as tx
from parasuite_tpu_torch.ops import cuda_extend, cuda_seed
from parasuite_tpu_torch.ops.device_index import DeviceIndex, ScoreParams
from parasuite_tpu_torch.ops.profile_update import profile_counts_batch

from conftest import sample_reads
from _torch_helpers import to_port

torch.set_num_threads(1)
B = 32


@functools.lru_cache(maxsize=None)
def _jax_fns(cfg):
    def jit(fn):
        return jax.jit(functools.partial(fn, cfg=cfg))

    return {"seed": jit(jx.seed_diagonals),
            "select": jit(jx.select_candidates),
            "extend": jit(jx.extend_candidates), "finalize": jit(jx.finalize),
            "align": jit(jx.align_batch), "counts": jit(jcounts),
            "orient": jax.jit(jx.orient_reads)}


def _state(ref, index, cfg, s_tensor):
    jd = jdi.DeviceIndex.from_host(ref, index)
    js = jdi.ScoreParams.from_tensor(s_tensor, cfg)
    td = DeviceIndex.from_numpy(*(np.asarray(getattr(jd, f))
                                  for f in jd._fields), device="cpu")
    ts = ScoreParams.from_numpy(*(np.asarray(getattr(js, f))
                                  for f in js._fields), device="cpu")
    return jd, js, td, ts


def _eq(t, j, what):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=what)


def _fill(rng, ref, n=B, **kw):
    codes, lengths, _ = sample_reads(rng, ref, n, 50, **kw)
    return codes, lengths


def _case(name, ref, index, cfg):
    """-> (cfg, codes [B, L], lengths [B], s_tensor, ref, index)."""
    rng = np.random.default_rng(100 + CASES.index(name))
    s = flat_score_tensor(cfg, cfg.max_read_len)
    if name == "exact":
        codes, lengths = _fill(rng, ref)
    elif name == "mutated":
        codes, lengths = _fill(rng, ref, mutate=4)
    elif name == "indels":
        codes, lengths = _fill(rng, ref, mutate=1, indel=True)
    elif name == "n_run_zero_len_padding":
        codes, lengths = _fill(rng, ref, mutate=2)
        codes[:8] = rng.integers(0, 4, size=(8, 50))   # garbage
        lengths[20:24] = 0                               # padding rows
        codes[20:24] = 4
        codes[5, :25] = 4                                # half-N read
        codes[6, 10:18] = 4                              # inner N run
        lengths[7] = 20                                  # short read
        codes[7, 20:] = 4
    elif name == "mixed_lengths":
        codes, lengths = _fill(rng, ref, mutate=2)
        for b in range(0, B, 3):
            ln = int(rng.integers(36, 50))
            lengths[b] = ln
            codes[b, ln:] = 4
    elif name == "learned_profile":
        counts = rng.integers(0, 50, size=(50, 4, 4)).astype(np.int64)
        counts += np.eye(4, dtype=np.int64)[None] * 5000
        counts[:, 3, 1] += 600  # heavy T->C
        s = counts_to_profile(ErrorProfile(counts=counts), cfg)
        codes, lengths = _fill(rng, ref, mutate=2)
        conv = (codes == 3) & (rng.random(codes.shape) < 0.15)
        codes = np.where(conv, 1, codes).astype(np.int8)
    elif name == "ref_offset_0":
        # the reference without its N spacers: chrA starts at packed
        # position 0, so diagonals and band windows go negative
        seq = ref.seq[int(ref.starts[0]) : int(ref.ends[-1])].copy()
        G = seq.shape[0]
        ref = PackedReference(seq=seq, names=list(ref.names),
                              starts=ref.starts - ref.starts[0],
                              ends=ref.ends - ref.starts[0])
        index = KmerIndex.build(seq, cfg.kmer_size)
        codes, lengths = _fill(rng, ref, mutate=1)
        codes[0] = seq[:50]
        codes[1] = revcomp_codes(seq[:50])
        codes[2, :2] = rng.integers(0, 4, 2)   # true start at -2
        codes[2, 2:] = seq[:48]
        codes[3, 0] = (seq[0] + 1) % 4         # mismatch at the first base
        codes[3, 1:] = seq[1:50]
        codes[4] = seq[G - 50 :]               # last bases of the reference
        codes[5] = revcomp_codes(seq[G - 50 :])
        codes[6, :48] = seq[G - 48 :]          # runs 2 bases off the end
        codes[6, 48:] = rng.integers(0, 4, 2)
    elif name in ("fixed_seeds", "adaptive_L100"):
        if name == "fixed_seeds":
            cfg = dataclasses.replace(cfg, seed_placement="fixed")
            codes, lengths = _fill(rng, ref, mutate=2, indel=True)
        else:
            cfg = AlignConfig(max_read_len=100, batch_size=64, kmer_size=8,
                              max_seeds=5, seed_stride=6, max_occ=32,
                              max_candidates=8, band_width=3,
                              chrom_spacer=128)
            s = flat_score_tensor(cfg, cfg.max_read_len)
            codes = np.full((B, 100), 4, dtype=np.int8)
            lengths = np.zeros(B, dtype=np.int32)
            for b in range(B):
                ln = int(rng.choice([36, 50, 75, 100]))
                p = int(rng.integers(0, 4800 - ln))
                while np.any(ref.seq[p : p + ln] == 4):
                    p = int(rng.integers(0, 4800 - ln))
                frag = ref.seq[p : p + ln].copy()
                frag[int(rng.integers(0, ln))] = rng.integers(0, 4)
                codes[b, :ln] = frag if b % 2 else revcomp_codes(frag)
                lengths[b] = ln
    else:
        raise ValueError(name)
    return (cfg, codes.astype(np.int8), lengths.astype(np.int32), s, ref,
            index)


CASES = ["exact", "mutated", "indels", "n_run_zero_len_padding",
         "mixed_lengths", "learned_profile", "ref_offset_0", "fixed_seeds",
         "adaptive_L100"]


@pytest.mark.parametrize("case", CASES)
def test_stages_equal_jax(case, tiny_ref, tiny_index, small_cfg):
    cfg, codes, lengths, s, ref, index = _case(case, tiny_ref, tiny_index,
                                               small_cfg)
    jd, js, td, ts = _state(ref, index, cfg, s)
    f = _jax_fns(cfg)
    t_cfg = to_port(cfg)
    ms = jdi.min_scores_host(lengths, cfg)
    tcodes, tlens, tms = (torch.from_numpy(codes), torch.from_numpy(lengths),
                          torch.from_numpy(ms))

    j_or = f["orient"](codes, lengths)
    t_or = tx.orient_reads(tcodes, tlens)
    _eq(t_or, j_or, "orient")

    j_diags = f["seed"](j_or, lengths, jd)
    t_diags = tx.seed_diagonals(t_or, tlens, td, t_cfg)
    _eq(t_diags, j_diags, "seed")

    j_cd, j_cv = f["select"](j_diags)
    t_cd, t_cv = cuda_seed.select_candidates_plain(t_diags, t_cfg)
    _eq(t_cd, j_cd, "select diag")
    _eq(t_cv, j_cv, "select valid")

    j_ext = f["extend"](j_or, lengths, j_cd, jd, js)
    t_ext = cuda_extend.extend_candidates_plain(t_or, tlens, t_cd, td, ts,
                                                t_cfg)
    for name, t, j in zip(["dp_score", "dp_j", "ug_score", "ug_j"], t_ext,
                          j_ext):
        _eq(t, j, f"extend {name}")

    j_fin = f["finalize"](j_or, lengths, ms, j_cd, j_cv, *j_ext, jd, js)
    t_fin = tx.finalize(t_or, tlens, tms, t_cd, t_cv, *t_ext, td, ts, t_cfg)
    j_res = f["align"](jd, js, codes, lengths, ms)
    t_res = tx.align_batch(td, ts, tcodes, tlens, tms, t_cfg)
    assert t_res._fields == j_res._fields
    for field in j_res._fields:
        _eq(getattr(t_fin, field), getattr(j_fin, field), f"finalize {field}")
        _eq(getattr(t_res, field), getattr(j_res, field), f"align {field}")
    assert t_res.mapped.any()

    j_c = f["counts"](jd, codes, lengths, j_res.mapped, j_res.strand,
                      j_res.pos, j_res.ug_equal)
    t_c = profile_counts_batch(td, tcodes, tlens, t_res.mapped, t_res.strand,
                               t_res.pos, t_res.ug_equal, t_cfg)
    _eq(t_c, j_c, "profile counts")


def test_batch_size_independence(tiny_ref, tiny_index, small_cfg):
    """Same read, any batch composition -> identical outputs."""
    cfg, codes, lengths, s, ref, index = _case("mutated", tiny_ref,
                                               tiny_index, small_cfg)
    _, _, td, ts = _state(ref, index, cfg, s)
    ms = torch.from_numpy(jdi.min_scores_host(lengths, cfg))
    cfg = to_port(cfg)
    tcodes, tlens = torch.from_numpy(codes), torch.from_numpy(lengths)
    full = tx.align_batch(td, ts, tcodes, tlens, ms, cfg)
    half = tx.align_batch(td, ts, tcodes[:16], tlens[:16], ms[:16], cfg)
    for field in full._fields:
        np.testing.assert_array_equal(getattr(full, field)[:16].numpy(),
                                      getattr(half, field).numpy(),
                                      err_msg=field)


def test_score_params_keep_l_rows(small_cfg):
    """A score tensor longer than max_read_len is cut to L rows, the layout
    the extension's (strand * L + cycle) table offset assumes."""
    s = flat_score_tensor(small_cfg, small_cfg.max_read_len + 7)
    small_cfg = to_port(small_cfg)
    sp = ScoreParams.from_tensor(s, small_cfg, "cpu")
    assert sp.s_fwd.shape == sp.s_comp.shape == (small_cfg.max_read_len, 5, 5)
    np.testing.assert_array_equal(sp.mapq_sub.numpy(), jdi._mapq_table())
    with pytest.raises(ValueError):
        ScoreParams.from_tensor(s[:10], small_cfg, "cpu")
