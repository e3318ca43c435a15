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
from parasuite_tpu_torch.ops import _build, cuda_extend, cuda_seed
from parasuite_tpu_torch.ops import aligner as tx
from parasuite_tpu_torch.ops.device_index import DeviceIndex, ScoreParams
from parasuite_tpu_torch.testing import SELECT_CASES, select_case_rows

from conftest import sample_reads

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
    assert cuda_seed.launches == 0 and cuda_extend.launches == 0
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
        "extend_candidates.cu", "select_candidates.cu"]

