"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version (the extend kernel at every band width it is built for, on
testing.extend_case's edge cases, and on one 65,536-read batch at the bench
config; its SASS holds the DPX instructions at every width; the seeded
select kernel against seed_diagonals + select_candidates_plain at every
row width and placement, and one eager 65,536-read step's memory);
align_batch,
align_batch_with_candidates, the wire step align_batch_packed (with its
fused counts), a rescue engine and CombinedEngine on the card against the
same run on CPU tensors; extend_impl / select_impl "jnp" (the plain
versions, no launch) and "pallas" against "auto" on the card; the
data-parallel step and the chromosome-sharded step on the card (one card
given twice, so each kernel launches twice a call) against the same steps
on CPU devices; the wrappers' refusals; every compiled step of both engines
(ops/compiled.py: a CUDA graph a key, replayed) against its function run
eagerly, with nine results held in flight, the launch counts of replays
(one seeded select launch a step, none over rows of diagonals), and a step
that syncs raising at capture. Every test needs an NVIDIA GPU and skips
elsewhere.

This file imports no jax, so it also runs on a machine with a card and no
JAX installed (PARASUITE_TEST_TPU=1 keeps conftest.py from importing jax):

    PARASUITE_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -q
"""

import re

import numpy as np
import pytest
import torch

from parasuite_tpu_torch.config import AlignConfig
from parasuite_tpu_torch.errormodel import flat_score_tensor
from parasuite_tpu_torch.index import KmerIndex, PackedReference
from parasuite_tpu_torch.ops import aligner as tx
from parasuite_tpu_torch.ops import cuda_extend, cuda_finalize, cuda_seed
from parasuite_tpu_torch.ops.device_index import (DeviceIndex, ScoreParams,
                                                  min_scores_host)
from parasuite_tpu_torch.testing import (EXTEND_CASES, FINALIZE_CASES,
                                         SELECT_CASES, extend_case,
                                         finalize_case, select_case_rows)

from conftest import sample_reads
from _torch_helpers import finalize_args, to_port

pytestmark = pytest.mark.cuda

# (max_read_len, kmer_size, max_seeds, max_occ, max_candidates, band_width):
# the bench shape, the band and row-width extremes the kernels take, and a
# long read
CONFIGS = {
    "bench_L50_W5": (50, 12, 7, 16, 8, 5),
    "band1_C2": (36, 8, 2, 16, 2, 0),
    "band15_n448": (100, 8, 7, 64, 16, 7),
    "wide_n1088": (100, 8, 17, 64, 16, 5),     # n_pad 2,048: shared memory
    "wide_n3840": (100, 8, 30, 128, 8, 5),     # n_pad 4,096
    "L250": (250, 8, 7, 32, 16, 2),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.fixture
def port_ref(tiny_ref):
    """conftest's reference as the port's own PackedReference."""
    return to_port(tiny_ref)


def _inputs(name, tiny_ref):
    """-> (cfg, DeviceIndex and ScoreParams on the CPU, codes, lengths).

    Mutated reads with indels, plus an all-N read (a row of I32MAX
    diagonals), a zero-length row and a short N-padded read."""
    L, k, S, M, C, W = CONFIGS[name]
    spacer = max(64, L + 2 * W + 1)
    cfg = AlignConfig(max_read_len=L, batch_size=64, kmer_size=k,
                      max_seeds=S, max_occ=M, max_candidates=C, band_width=W,
                      chrom_spacer=spacer)
    ref = PackedReference.from_dict(
        {n: tiny_ref.seq[tiny_ref.starts[i]:tiny_ref.ends[i]]
         for i, n in enumerate(tiny_ref.names)}, spacer=spacer)
    rng = np.random.default_rng(404)
    codes, lengths, _ = sample_reads(rng, ref, 64, L, mutate=3, indel=True)
    codes[5] = 4
    lengths[6] = 0
    codes[6] = 4
    short = L - 13
    lengths[7] = short
    codes[7, short:] = 4
    didx = DeviceIndex.from_host(ref, KmerIndex.build(ref.seq, k), "cpu")
    sprof = ScoreParams.from_tensor(flat_score_tensor(cfg, L), cfg, "cpu")
    return cfg, didx, sprof, codes, lengths


def _to(obj, dev):
    return type(obj)(**{f: getattr(obj, f).to(dev)
                        for f in obj.__dataclass_fields__})


def _launches() -> tuple:
    """(seeded select, select over rows of diagonals, extend, finalize)
    launches so far."""
    return (cuda_seed.seeded_launches, cuda_seed.launches,
            cuda_extend.launches, cuda_finalize.launches)


def _since(before: tuple) -> tuple:
    return tuple(a - b for a, b in zip(_launches(), before))


# a step's graph or eager call: one seeded select, one extend, one finalize
STEP = {"seed_select": 1, "select_candidates": 0, "extend_candidates": 1,
        "finalize_select": 1}
NONE = {"seed_select": 0, "select_candidates": 0, "extend_candidates": 0,
        "finalize_select": 0}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_kernels_equal_plain_on_card(cuda, name, tiny_ref):
    """Each kernel is array-equal to its plain version on the same CUDA
    inputs, and each launch is counted."""
    cfg, didx, sprof, codes, lengths = _inputs(name, tiny_ref)
    didx, sprof = _to(didx, cuda), _to(sprof, cuda)
    tcodes = torch.from_numpy(codes).to(cuda)
    tlens = torch.from_numpy(lengths).to(cuda)
    oriented = tx.orient_reads(tcodes, tlens)
    diags = tx.seed_diagonals(oriented, tlens, didx, cfg)
    assert bool((diags[10:12] == cuda_seed.I32MAX).all())   # the all-N read

    n_sel, n_ext = cuda_seed.launches, cuda_extend.launches
    got = cuda_seed.select_candidates(diags, cfg)
    ext = cuda_extend.extend_candidates(oriented, tlens, got[0], didx, sprof,
                                        cfg)
    assert (cuda_seed.launches, cuda_extend.launches) == (n_sel + 1,
                                                         n_ext + 1)
    want = cuda_seed.select_candidates_plain(diags, cfg)
    ext_plain = cuda_extend.extend_candidates_plain(oriented, tlens, got[0],
                                                    didx, sprof, cfg)
    torch.cuda.synchronize()
    for g, w in zip((*got, *ext), (*want, *ext_plain)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert bool(got[1].any()) and not bool(got[1].all())


@pytest.mark.parametrize("n,C", SELECT_CASES)
def test_select_kernel_equals_plain_at_every_width(cuda, n, C):
    """Every row width the kernel is built for (n_pad 32 .. 4,096): ties,
    all-I32MAX rows, one repeated diagonal; tolerance 0. The cases the
    plain version is held to the JAX package on by test_torch_kernels.py."""
    cfg = AlignConfig(max_candidates=C)
    diags = torch.from_numpy(select_case_rows(n)).to(cuda)
    got = cuda_seed.select_candidates(diags, cfg)
    want = cuda_seed.select_candidates_plain(diags, cfg)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("W,L", EXTEND_CASES)
def test_extend_kernel_equals_plain_at_every_band_width(cuda, W, L):
    """Every band width W = 0..7 at L = 36 and 50: learned tables that
    differ by strand, go == ge at even W, reads of length 0 and shorter than
    L, an all-N read, diagonals off both ends, ties for the best j (the
    cases test_torch_extend_recurrence.py holds the plain version and the
    kernel's arithmetic to the JAX package on); tolerance 0."""
    c = extend_case(W, L)
    cfg = AlignConfig(max_read_len=L, band_width=W,
                      max_candidates=c["cand"].shape[1], gap_open=c["go"],
                      gap_extend=c["ge"], chrom_spacer=L + 2 * W)
    zeros = np.zeros(1, dtype=np.int32)
    didx = DeviceIndex.from_numpy(c["ref"], zeros, zeros, zeros, zeros,
                                  device=cuda)
    sprof = ScoreParams.from_numpy(c["s_fwd"], c["s_comp"],
                                   np.zeros(256, dtype=np.int32), device=cuda)
    args = [torch.from_numpy(c[k]).to(cuda)
            for k in ("oriented", "lengths", "cand")]
    n_ext = cuda_extend.launches
    got = cuda_extend.extend_candidates(*args, didx, sprof, cfg)
    assert cuda_extend.launches == n_ext + 1
    want = cuda_extend.extend_candidates_plain(*args, didx, sprof, cfg)
    torch.cuda.synchronize()
    for name, g, w in zip(("dp_score", "dp_j", "ug_score", "ug_j"), got,
                          want):
        assert g.dtype == w.dtype and torch.equal(g, w), name


def _bench_batch(cuda):
    """One 65,536-read batch at the bench config (L = 50, k = 12, 7 seeds x
    16 occurrences, C = 8, W = 5) on a 2 Mbp random reference: reads with
    substitutions and 1% deletions, half reverse strand, 256 all-N ->
    (cfg, DeviceIndex, ScoreParams, codes int8, lengths), on the card."""
    cfg = AlignConfig(max_read_len=50, kmer_size=12, batch_size=65_536,
                      max_candidates=8, max_occ=16)
    rng = np.random.default_rng(65_536)
    ref = PackedReference.from_dict(
        {"chr1": rng.integers(0, 4, 2_000_000).astype(np.int8)},
        spacer=cfg.chrom_spacer)
    n, L = 65_536, 50
    start = ref.starts[0] + rng.integers(0, 2_000_000 - L - 1, n)
    col = np.arange(L)[None, :]
    deletion = (rng.random(n) < 0.01)[:, None] & (col >= 25)
    reads = ref.seq[start[:, None] + col + deletion]
    sub = rng.random((n, L)) < 0.01
    reads = np.where(sub, (reads + 1) % 4, reads)
    rev = rng.random(n) < 0.5
    reads[rev] = 3 - reads[rev, ::-1]               # no N: inside chr1
    reads[:256] = 4
    didx = DeviceIndex.from_host(ref, KmerIndex.build(ref.seq, 12), cuda)
    sprof = ScoreParams.from_tensor(flat_score_tensor(cfg, L), cfg, cuda)
    lens = torch.full((n,), L, dtype=torch.int32, device=cuda)
    codes = torch.from_numpy(reads.astype(np.int8)).to(cuda)
    return cfg, didx, sprof, codes, lens


def test_extend_kernel_equals_plain_on_a_bench_batch(cuda):
    """One 65,536-read batch at the bench config (_bench_batch);
    candidates by the select kernel; tolerance 0."""
    cfg, didx, sprof, codes, lens = _bench_batch(cuda)
    oriented = tx.orient_reads(codes, lens)
    diags = tx.seed_diagonals(oriented, lens, didx, cfg)
    cand, _ = cuda_seed.select_candidates(diags, cfg)
    got = cuda_extend.extend_candidates(oriented, lens, cand, didx, sprof,
                                        cfg)
    want = cuda_extend.extend_candidates_plain(oriented, lens, cand, didx,
                                               sprof, cfg)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int((got[0] > got[2]).sum()) > 0     # gapped winners exist


# the peak above what was allocated before it of one eager align_batch of
# _bench_batch's 65,536 reads, in bytes, on an NVIDIA H100 80GB HBM3
# (PERF.md section 5): finalize's, as the seed rows never exist in the step.
# The caching allocator's bytes depend on the shapes alone, so they repeat
# across cards.
STEP_PEAK_65536 = 180_483_584


def test_an_eager_bench_step_stays_within_its_memory(cuda):
    """One eager align_batch at 65,536 reads peaks, above what was
    allocated before it, at no more than STEP_PEAK_65536 = 180,483,584 B
    (measured on an H100 for PERF.md section 5) plus 5%: a step that holds
    the [2B, S * M] seed rows again (56 MiB, and their chunks) does not
    fit."""
    cfg, didx, sprof, codes, lens = _bench_batch(cuda)
    ms = torch.from_numpy(min_scores_host(lens.cpu().numpy(), cfg)).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    res = tx.align_batch(didx, sprof, codes, lens, ms, cfg)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert peak <= 1.05 * STEP_PEAK_65536, f"peak above the step: {peak} B"
    assert int(res.mapped.sum()) > 60_000


# (L, k, max_seeds, max_occ, max_candidates, placement, seed_stride): every
# row width the kernel is built for, both placements, the rescue tier's k
SEEDED = {
    "bench_adaptive": (50, 12, 7, 16, 8, "adaptive", 6),     # n_pad 128
    "bench_fixed": (50, 12, 7, 16, 8, "fixed", 6),
    "rescue_k6": (36, 6, 13, 16, 8, "adaptive", 6),          # 256
    "one_seed": (50, 8, 1, 32, 8, "adaptive", 6),            # 32
    "n64": (50, 8, 4, 16, 8, "fixed", 12),                   # 64
    "seeds_over_32": (100, 8, 40, 8, 8, "adaptive", 6),      # 512
    "n1024": (100, 8, 16, 64, 16, "adaptive", 6),            # 1,024
    "wide_n1088": (100, 8, 17, 64, 16, "adaptive", 6),       # 2,048
    "wide_fixed_n3840": (100, 8, 30, 128, 8, "fixed", 3),    # 4,096
    "wide_over_256": (100, 6, 300, 8, 8, "adaptive", 6),     # 4,096
    "L250": (250, 8, 7, 32, 16, "adaptive", 6),              # 256
}


def _seeded_case(name, cuda, n=96):
    """SEEDED[name] -> (cfg, DeviceIndex on the card, oriented, lengths).

    A 20 kbp random reference with a 2,100 bp tandem repeat of a 7 bp unit
    (seeds with more than max_occ occurrences; mutated seeds find none);
    mutated reads with indels, one from the repeat and one half in it, an
    all-N read, a read of length 0, one shorter than k, one a little
    longer than k (the adaptive offsets pile up at its end), an N-padded
    short read and one with an N inside."""
    L, k, S, M, C, placement, stride = SEEDED[name]
    cfg = AlignConfig(max_read_len=L, batch_size=n, kmer_size=k,
                      max_seeds=S, max_occ=M, max_candidates=C,
                      seed_placement=placement, seed_stride=stride,
                      band_width=3, chrom_spacer=L + 64)
    rng = np.random.default_rng(2400 + len(name))
    seq = rng.integers(0, 4, 20_000).astype(np.int8)
    seq[5000:7100] = np.tile(rng.integers(0, 4, 7), 300)
    ref = PackedReference.from_dict({"c": seq}, spacer=cfg.chrom_spacer)
    codes, lengths, _ = sample_reads(rng, ref, n, L, mutate=2, indel=True)
    st = int(ref.starts[0]) + 5100
    codes[0] = ref.seq[st:st + L]
    codes[1, : L // 2] = ref.seq[st:st + L // 2]
    codes[2] = 4
    lengths[3] = 0
    codes[3] = 4
    for row, ln in ((4, k - 1), (5, k + 3), (6, L - 7)):
        lengths[row] = ln
        codes[row, ln:] = 4
    codes[7, L // 3] = 4
    didx = DeviceIndex.from_host(ref, KmerIndex.build(ref.seq, k), cuda)
    tlens = torch.from_numpy(lengths).to(cuda)
    oriented = tx.orient_reads(torch.from_numpy(codes).to(cuda), tlens)
    return cfg, didx, oriented, tlens


@pytest.mark.parametrize("name", list(SEEDED))
def test_seeded_select_equals_the_plain_pair_on_card(cuda, name):
    """seed_select's one launch (the kernel builds each row from the reads
    and the index) equals select_candidates_plain over seed_diagonals' rows
    on the same CUDA tensors, bit for bit in cand_diag and cand_valid, and
    launches nothing over rows of diagonals."""
    cfg, didx, oriented, tlens = _seeded_case(name, cuda)
    before = _launches()
    got = cuda_seed.seed_select(oriented, tlens, didx, cfg)
    assert _since(before) == (1, 0, 0, 0)
    diags = cuda_seed.seed_diagonals(oriented, tlens, didx, cfg)
    want = cuda_seed.select_candidates_plain(diags, cfg)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert bool(got[1].any()) and not bool(got[1].all())
    assert bool((diags[4:6] == cuda_seed.I32MAX).all())   # the all-N read
    assert bool((diags[0] == cuda_seed.I32MAX).all())     # over max_occ


def test_seeded_select_of_no_reads_on_card(cuda):
    """No reads: empty [0, C] outputs and no launch."""
    cfg, didx, oriented, tlens = _seeded_case("bench_adaptive", cuda)
    before = _launches()
    cand, valid = cuda_seed.seed_select(oriented[:0], tlens[:0], didx, cfg)
    assert _since(before) == (0, 0, 0, 0)
    assert cand.shape == valid.shape == (0, cfg.max_candidates)
    assert (cand.dtype, valid.dtype) == (torch.int32, torch.bool)


@pytest.mark.parametrize("n,combined", FINALIZE_CASES)
def test_finalize_kernel_equals_finalize_core_on_card(cuda, n, combined):
    """finalize_select's one launch equals finalize_core on the same CUDA
    tensors, bit for bit in every AlignResult field and in best_idx, over
    testing.finalize_case's rows (n = 2 .. 254 entries a read; tie-heavy
    keys and scores on both strands, all-invalid, length-0 and all-N rows,
    windows off either end of ref_seq, spans across a chromosome boundary,
    three chromosomes; with combined src / nm_pos / nm_strand and a learned
    mapq_sub). The plain step's strand row broadcast (row stride 0) gives
    what the same strands laid out row by row give."""
    case = finalize_case(n, combined)
    args, kw = finalize_args(case, cuda)
    before = _launches()
    got = cuda_finalize.finalize_select(*args, **kw)
    assert _since(before) == (0, 0, 0, 1)
    want = tx.finalize_core(*args, **kw)
    laid = list(args)
    laid[3] = args[3].contiguous()
    again = cuda_finalize.finalize_select(*laid, **kw)
    torch.cuda.synchronize()
    for k, (g, w, a) in enumerate(zip((*got[0], got[1]), (*want[0], want[1]),
                                      (*again[0], again[1]))):
        assert g.dtype == w.dtype and torch.equal(g, w), k
        assert torch.equal(a, w), k
    assert got[0].n_candidates is args[8]
    mapped = want[0].mapped
    assert bool(mapped.any()) and not bool(mapped.all())
    assert bool((want[0].x0 == 1).any()) and bool(want[0].tc_count.any())


def test_finalize_kernel_of_no_reads_on_card(cuda):
    """No reads: empty [0] outputs of finalize_core's dtypes and no
    launch."""
    args, kw = finalize_args(finalize_case(16, True), cuda)
    empty = [a[:0] if isinstance(a, torch.Tensor) else a for a in args]
    kw = {k: v[:0] for k, v in kw.items()}
    before = _launches()
    res, best_idx = cuda_finalize.finalize_select(*empty, **kw)
    assert _since(before) == (0, 0, 0, 0)
    want, want_idx = tx.finalize_core(*empty, **kw)
    for g, w in zip((*res, best_idx), (*want, want_idx)):
        assert g.shape == (0,) and g.dtype == w.dtype


def test_extend_kernel_uses_dpx_at_every_band_width(cuda):
    """cuobjdump -sass of the built library: the extend kernel of every
    band width holds VIMNMX3 (three-way max) and VIADDMNMX (add-max), so
    the DPX intrinsics are not emulated."""
    from parasuite_tpu_torch.ops import _build

    _build.load()
    ops = {int(m.group(1)): v for sym, v in _build.sass_opcodes().items()
           if (m := re.search(r"extend_kernelILi(\d+)E", sym))}
    assert sorted(ops) == [2 * w + 1 for w in range(8)]
    for band, v in ops.items():
        assert v.get("VIMNMX3", 0) > 0 and v.get("VIADDMNMX", 0) > 0, band


@pytest.mark.parametrize("name", ["bench_L50_W5", "band15_n448"])
def test_align_batch_on_card_equals_cpu(cuda, name, tiny_ref):
    """align_batch through both kernels equals the all-plain CPU run in all
    12 AlignResult fields."""
    cfg, didx, sprof, codes, lengths = _inputs(name, tiny_ref)
    ms = torch.from_numpy(min_scores_host(lengths, cfg))
    args = (torch.from_numpy(codes), torch.from_numpy(lengths), ms)
    cpu = tx.align_batch(didx, sprof, *args, cfg)
    card = tx.align_batch(_to(didx, cuda), _to(sprof, cuda),
                          *(a.to(cuda) for a in args), cfg)
    for field in cpu._fields:
        np.testing.assert_array_equal(getattr(card, field).cpu().numpy(),
                                      getattr(cpu, field).numpy(),
                                      err_msg=field)
    assert bool(cpu.mapped.any())


@pytest.mark.parametrize("name", ["bench_L50_W5", "band15_n448"])
def test_align_batch_with_candidates_on_card_equals_cpu(cuda, name,
                                                        tiny_ref):
    """The XA / combined device step: all AlignResult and CandidateTable
    fields on the card equal the CPU run's."""
    cfg, didx, sprof, codes, lengths = _inputs(name, tiny_ref)
    ms = torch.from_numpy(min_scores_host(lengths, cfg))
    args = (torch.from_numpy(codes), torch.from_numpy(lengths), ms)
    cpu = tx.align_batch_with_candidates(didx, sprof, *args, cfg)
    card = tx.align_batch_with_candidates(_to(didx, cuda), _to(sprof, cuda),
                                          *(a.to(cuda) for a in args), cfg)
    for c_out, g_out in zip(cpu, card):
        for field in c_out._fields:
            np.testing.assert_array_equal(
                getattr(g_out, field).cpu().numpy(),
                getattr(c_out, field).numpy(), err_msg=field)
    assert bool(cpu[1].valid.any())


def _wire(cfg, codes, lengths, dev):
    """The wire step's inputs on `dev`: 2-bit codes, N mask, uint16 lengths
    and the min-score table."""
    from parasuite_tpu_torch.ops.device_index import min_score_table

    two, nmask = tx.pack_codes_host(codes)
    return (torch.from_numpy(two).to(dev), torch.from_numpy(nmask).to(dev),
            torch.from_numpy(lengths.astype(np.uint16)).to(dev),
            torch.from_numpy(min_score_table(cfg)).to(dev))


@pytest.mark.parametrize("name", ["bench_L50_W5", "band15_n448"])
def test_wire_step_on_card_equals_cpu(cuda, name, tiny_ref):
    """align_batch_packed on the card: the PackedResult bytes and the fused
    counts equal the CPU run's, one launch of the seeded select kernel,
    one of the extend kernel and one of the finalize kernel a step, and the
    unpacked result equals align_batch on the card field by field."""
    from parasuite_tpu_torch.pipeline.align import fetch_host

    cfg, didx, sprof, codes, lengths = _inputs(name, tiny_ref)
    cpu = tx.align_batch_packed(didx, sprof, *_wire(cfg, codes, lengths,
                                                    "cpu"), cfg,
                                with_counts=True)
    d_didx, d_sprof = _to(didx, cuda), _to(sprof, cuda)
    before = _launches()
    card = tx.align_batch_packed(d_didx, d_sprof,
                                 *_wire(cfg, codes, lengths, cuda), cfg,
                                 with_counts=True)
    assert _since(before) == (1, 0, 1, 1)
    (c_host,), (g_host,) = fetch_host(cpu[0]), fetch_host(card[0])
    for c, g in zip(c_host, g_host):
        assert c.tobytes() == g.tobytes()
    assert torch.equal(card[1].cpu(), cpu[1])
    ms = torch.from_numpy(min_scores_host(lengths, cfg)).to(cuda)
    (want,) = fetch_host(tx.align_batch(
        d_didx, d_sprof, torch.from_numpy(codes).to(cuda),
        torch.from_numpy(lengths).to(cuda), ms, cfg))
    got = tx.unpack_result_host(g_host, cfg.band_width)
    for field in want._fields:
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    assert bool(want.mapped.any())


@pytest.mark.parametrize("name", ["bench_L50_W5", "band15_n448"])
def test_impl_switches_on_card(cuda, name, tiny_ref):
    """On the card "jnp" takes the plain seed, select and extend (no
    launch of theirs) and "pallas" their kernels; both give "auto"'s
    PackedResult byte for byte. The finalize kernel, which no cfg field
    selects, launches once a step under each."""
    from parasuite_tpu_torch.pipeline.align import fetch_host

    cfg, didx, sprof, codes, lengths = _inputs(name, tiny_ref)
    d_didx, d_sprof = _to(didx, cuda), _to(sprof, cuda)
    wire = _wire(cfg, codes, lengths, cuda)
    outs = {}
    for impl in ("auto", "jnp", "pallas"):
        c = cfg.replace(extend_impl=impl, select_impl=impl)
        before = _launches()
        (outs[impl],) = fetch_host(tx.align_batch_packed(d_didx, d_sprof,
                                                         *wire, c))
        want = 0 if impl == "jnp" else 1
        assert _since(before) == (want, 0, want, 1), impl
    for impl in ("jnp", "pallas"):
        for a, b in zip(outs["auto"], outs[impl]):
            assert a.tobytes() == b.tobytes(), impl


HOST_FIELDS = ("mapped", "strand", "pos", "score", "mapq", "x0", "x1", "nm",
               "ug_equal", "tc_count")


def _hosts_equal(want, got):
    for f in HOST_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    for i in range(len(want.mapped)):
        assert got.cigars[i] == want.cigars[i], i
    assert got.xa == want.xa


def test_rescue_engine_on_card_equals_cpu(cuda, port_ref):
    """Two-tier rescue (k = 8, then k = 6 for the unmapped rows, over the
    256-row cap): to_host on the card equals the CPU engine's, counters
    included."""
    from parasuite_tpu_torch.io.batch import ReadBatch
    from parasuite_tpu_torch.pipeline.align import AlignerEngine

    cfg = AlignConfig(max_read_len=50, batch_size=64, kmer_size=8,
                      max_seeds=4, max_occ=32, max_candidates=8,
                      band_width=3, chrom_spacer=64, rescue_kmer=6)
    index = KmerIndex.build(port_ref.seq, 8)
    rng = np.random.default_rng(808)
    codes, lengths, _ = sample_reads(rng, port_ref, 600, 36, mutate=5)
    codes[::2] = rng.integers(0, 4, codes[::2].shape)
    codes = np.concatenate([codes, np.full((600, 14), 4, np.int8)], axis=1)
    batch = ReadBatch(codes=codes, lengths=lengths)
    hosts, engines = [], []
    for dev in ("cpu", "cuda"):
        eng = AlignerEngine(port_ref, index, cfg, device=dev)
        hosts.append(eng.align_to_host(batch))
        engines.append(eng)
    _hosts_equal(*hosts)
    assert [(e.rescue_mapped, e.rescue_overflow) for e in engines[1:]] == \
        [(engines[0].rescue_mapped, engines[0].rescue_overflow)]
    assert engines[0].rescue_mapped > 0 and engines[0].rescue_overflow > 0


def _combined_world():
    """Combined reference (two transcripts, a genomic duplicate) and 128
    genomic, exonic and junction reads with one substitution each."""
    from parasuite_tpu_torch.io.batch import ReadBatch
    from parasuite_tpu_torch.utils.dna import revcomp_codes
    from parasuite_tpu_torch.pipeline.combined import (CombinedReference,
                                                       Transcript,
                                                       splice_transcript)

    rng = np.random.default_rng(77)
    genome = {"chrA": rng.integers(0, 4, 6000).astype(np.int8)}
    genome["chrA"][300:350] = genome["chrA"][5300:5350]   # a duplicate
    txs = [Transcript("tx1", "chrA", "+", np.asarray([1000, 2000, 3000]),
                      np.asarray([1200, 2200, 3100])),
           Transcript("tx2", "chrA", "-", np.asarray([4000, 4500]),
                      np.asarray([4150, 4650]))]
    comb = CombinedReference.build(genome, txs, spacer=64)
    index = KmerIndex.build(comb.ref.seq, 8)
    spliced = [splice_transcript(genome, t) for t in txs]
    reads = [genome["chrA"][5300:5350].copy()]
    for _ in range(127):
        src = spliced[int(rng.integers(0, 2))] if rng.random() < 0.6 \
            else genome["chrA"]
        p = int(rng.integers(0, len(src) - 50))
        r = src[p:p + 50].copy()
        r[int(rng.integers(0, 50))] = rng.integers(0, 4)
        reads.append(revcomp_codes(r) if rng.random() < 0.5 else r)
    codes = np.stack(reads)
    return comb, index, ReadBatch(codes=codes,
                                  lengths=np.full(128, 50, np.int32))


COMBINED_CFG = AlignConfig(max_read_len=50, batch_size=64, kmer_size=8,
                           max_seeds=4, max_occ=32, max_candidates=8,
                           band_width=3, chrom_spacer=64)


def test_combined_engine_on_card_equals_cpu(cuda):
    """CombinedEngine with XA tags on genomic, exonic and junction reads:
    to_host on the card equals the CPU engine's, XA strings included."""
    from parasuite_tpu_torch.pipeline.combined import CombinedEngine

    comb, index, batch = _combined_world()
    hosts = [CombinedEngine(comb, index, COMBINED_CFG, xa_tags=True,
                            device=dev).align_to_host(batch)
             for dev in ("cpu", "cuda")]
    _hosts_equal(*hosts)
    assert any(len(hosts[0].cigars[i]) > 1 for i in range(128))
    assert hosts[0].xa[0] is not None


@pytest.mark.parametrize("cap", [1.0, 0.02])
def test_combined_projected_step_on_card_equals_cpu(cuda, cap):
    """The projected combined step (device projection, compaction,
    junction winners) on the card: its to_host equals the CPU engine's
    and the unprojected step's, with the same counters; at cap 0.02 the
    batch overflows and re-runs unprojected on both devices."""
    from parasuite_tpu_torch.pipeline.combined import CombinedEngine

    comb, index, batch = _combined_world()
    cfg = COMBINED_CFG.replace(combined_wire_cap=cap,
                               combined_wire_jun_cap=cap)
    engines = [CombinedEngine(comb, index, cfg, device=dev)
               for dev in ("cpu", "cuda")]
    hosts = [e.to_host(batch, e.align_device_packed(batch.codes,
                                                    batch.lengths))
             for e in engines]
    _hosts_equal(*hosts)
    _hosts_equal(hosts[0], engines[1].to_host(
        batch, engines[1].align_device(batch.codes, batch.lengths)))
    counters = [(e.packed_batches, e.packed_entries, e.packed_junctions,
                 e.packed_overflow) for e in engines]
    assert counters[0] == counters[1]
    assert counters[0][3] == (1 if cap < 1 else 0)
    assert any(len(hosts[0].cigars[i]) > 1 for i in range(128))


@pytest.mark.parametrize("n_replicas", [1, 2])
def test_dist_step_on_card_equals_cpu(cuda, n_replicas, tiny_ref):
    """make_dist_align_step over the card (given once and twice) equals the
    step over CPU devices in every AlignResult field and in the int64
    counts; each kernel launches once per replica and call; a mesh of the
    machine's cards refuses one card more than it has."""
    from parasuite_tpu_torch.parallel import make_dist_align_step, make_mesh

    cfg, didx, sprof, codes, lengths = _inputs("bench_L50_W5", tiny_ref)
    ms = min_scores_host(lengths, cfg)
    card0 = torch.device("cuda", 0)
    want, want_counts = make_dist_align_step(
        cfg, make_mesh(devices=["cpu"] * n_replicas))(
            didx, sprof, codes, lengths, ms)
    step = make_dist_align_step(cfg, make_mesh(devices=[card0] * n_replicas))
    on_card = (_to(didx, card0), _to(sprof, card0))
    for _ in range(2):     # the second call finds its replicas in place
        before = _launches()
        got, counts = step(*on_card, codes, lengths, ms)
        assert _since(before) == (n_replicas, 0, n_replicas, n_replicas)
        assert counts.dtype == torch.int64 and counts.device == card0
        assert torch.equal(counts.cpu(), want_counts)
        for field in want._fields:
            assert torch.equal(getattr(got, field).cpu(),
                               getattr(want, field)), field
    assert int(want_counts.sum()) > 0
    n_cards = torch.cuda.device_count()
    assert make_mesh().size == n_cards
    with pytest.raises(ValueError, match=f"have {n_cards}"):
        make_mesh(n_cards + 1)


def test_sharded_step_on_card_equals_cpu(cuda):
    """make_sharded_step on a 1 x 2 grid of the card equals the same step
    on CPU devices in every field, with two launches of each kernel a
    call."""
    from parasuite_tpu_torch.parallel.mesh import make_mesh2
    from parasuite_tpu_torch.parallel.shards import (build_sharded_index,
                                                     make_sharded_step)

    cfg = AlignConfig(max_read_len=50, batch_size=64, kmer_size=8,
                      max_seeds=4, max_occ=32, max_candidates=8,
                      band_width=3, chrom_spacer=64)
    rng = np.random.default_rng(600)
    seqs = {f"chr{i}": rng.integers(0, 4, 1500 + 700 * i).astype(np.int8)
            for i in range(5)}
    sharded, full = build_sharded_index(seqs, 2, cfg)
    codes, lengths, _ = sample_reads(np.random.default_rng(601), full, 64,
                                     50, mutate=2)
    ms = min_scores_host(lengths, cfg)
    s = flat_score_tensor(cfg, cfg.max_read_len)
    card0 = torch.device("cuda", 0)
    outs = {}
    for dev in ("cpu", card0):
        step = make_sharded_step(cfg, make_mesh2(1, 2, devices=[dev] * 2))
        before = _launches()
        outs[dev] = step(sharded.slabs(cfg), sharded.orig_chrom,
                         ScoreParams.from_tensor(s, cfg, dev), codes,
                         lengths, ms)
        want = 0 if dev == "cpu" else 2
        assert _since(before) == (want, 0, want, want)
    for k, w in outs["cpu"].items():
        g = outs[card0][k]
        assert g.device == card0 and g.dtype == w.dtype, k
        assert torch.equal(g.cpu(), w), k
    assert int(outs["cpu"]["mapped"].sum()) >= 60
    assert set(outs["cpu"]["shard"].tolist()) >= {0, 1}


def test_wrappers_refuse_what_the_kernels_cannot_take(cuda, tiny_ref):
    cfg, didx, sprof, codes, lengths = _inputs("bench_L50_W5", tiny_ref)
    didx, sprof = _to(didx, cuda), _to(sprof, cuda)
    tlens = torch.from_numpy(lengths).to(cuda)
    oriented = tx.orient_reads(torch.from_numpy(codes).to(cuda), tlens)
    diags = tx.seed_diagonals(oriented, tlens, didx, cfg)
    with pytest.raises(ValueError, match="int32"):
        cuda_seed.select_candidates(diags.long(), cfg)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_seed.select_candidates(diags.t().contiguous().t(), cfg)
    with pytest.raises(ValueError, match="fewer than max_candidates"):
        cuda_seed.select_candidates(diags[:, :4].contiguous(), cfg)
    assert 37 * diags.shape[1] > cuda_seed.MAX_PAD   # 112 a row -> 4,144
    with pytest.raises(ValueError, match="widest row"):
        cuda_seed.select_candidates(diags.repeat(1, 37), cfg)
    cand, _ = cuda_seed.select_candidates(diags, cfg)
    with pytest.raises(ValueError, match="int32 \\[B, 2, L\\]"):
        cuda_seed.seed_select(oriented.long(), tlens, didx, cfg)
    with pytest.raises(ValueError, match="lengths must be int32"):
        cuda_seed.seed_select(oriented, tlens.long(), didx, cfg)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_seed.seed_select(oriented.transpose(0, 1).contiguous()
                              .transpose(0, 1), tlens, didx, cfg)
    with pytest.raises(ValueError, match="different devices"):
        cuda_seed.seed_select(oriented, tlens.cpu(), didx, cfg)
    with pytest.raises(ValueError, match="bucket_starts"):
        cuda_seed.seed_select(oriented, tlens, didx, cfg.replace(kmer_size=11))
    with pytest.raises(ValueError, match="widest row"):
        cuda_seed.seed_select(oriented, tlens, didx,
                              cfg.replace(max_occ=cfg.max_occ * 37))
    with pytest.raises(ValueError, match="lengths int32"):
        cuda_extend.extend_candidates(oriented, tlens.long(), cand, didx,
                                      sprof, cfg)
    with pytest.raises(ValueError, match="different devices"):
        cuda_extend.extend_candidates(oriented, tlens.cpu(), cand, didx,
                                      sprof, cfg)
    args, kw = finalize_args(finalize_case(16, True), cuda)
    fin = cuda_finalize.finalize_select

    def with_arg(i, x):
        return [x if k == i else a for k, a in enumerate(args)]

    with pytest.raises(ValueError, match="pos_key must be torch.int32"):
        fin(*with_arg(4, args[4].long()), **kw)
    with pytest.raises(ValueError, match="strand must be contiguous"):
        fin(*with_arg(3, args[3].t().contiguous().t()), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        fin(*with_arg(5, args[5].t().contiguous().t()), **kw)
    with pytest.raises(ValueError, match="different devices"):
        fin(*with_arg(1, args[1].cpu()), **kw)
    with pytest.raises(ValueError, match="takes 1 to 256"):
        wide = [a.repeat(1, 17) if k in (2, 3, 4, 5, 6, 7) else a
                for k, a in enumerate(args)]
        fin(*wide, **{k: v.repeat(1, 17) for k, v in kw.items()})


# ---------------------------------------------------------------------------
# the compiled steps (ops/compiled.py): CUDA graphs of every engine step
# ---------------------------------------------------------------------------

class _Both:
    """Stands in for an engine's CompiledStep: each call runs the graphed
    step and the step's function eagerly on the same inputs, and keeps
    both outputs."""

    def __init__(self, step):
        self.step, self.pairs = step, []

    def __call__(self, *tensors, **static):
        got = self.step(*tensors, **static)
        self.pairs.append((got, self.step.fn(*tensors, **static)))
        return got


GRAPH_KINDS = ["unpacked", "with_candidates", "packed", "packed_counts",
               "counts", "rescue", "combined", "combined_unprojected"]


def _graph_case(kind, port_ref):
    """-> (engine on the card, its tier cfg and step name for `kind`, the
    engine call that runs the step, ten batches of one shape)."""
    from parasuite_tpu_torch.pipeline.align import AlignerEngine
    from parasuite_tpu_torch.pipeline.combined import CombinedEngine

    if kind.startswith("combined"):
        comb, index, batch = _combined_world()
        eng = CombinedEngine(comb, index, COMBINED_CFG, device="cuda")
        batches = [(np.roll(batch.codes, 13 * k, axis=0), batch.lengths)
                   for k in range(10)]
        if kind == "combined":
            return eng, eng.cfg, "combined", eng.align_device_packed, batches
        return eng, eng.cfg, "unpacked", eng.align_device, batches
    cfg = COMBINED_CFG.replace(rescue_kmer=6 if kind == "rescue" else 0)
    eng = AlignerEngine(port_ref, KmerIndex.build(port_ref.seq, 8), cfg,
                        xa_tags=kind == "with_candidates", device="cuda")
    n, L = (256, 36) if kind == "rescue" else (64, 50)
    batches = []
    for k in range(10):
        rng = np.random.default_rng(900 + k)
        codes, lengths, _ = sample_reads(rng, port_ref, n, L, mutate=3,
                                         indel=True)
        codes = np.concatenate([codes, np.full((n, 50 - L), 4, np.int8)],
                               axis=1)
        batches.append((codes, lengths))
    if kind == "rescue":
        cfg2, didx2, _cap = eng._rescue
        return eng, cfg2, "packed", lambda c, ln: eng._step_packed(
            didx2, cfg2, c, ln), batches
    if kind in ("unpacked", "with_candidates"):
        return eng, cfg, "unpacked", eng.align_device, batches
    if kind == "counts":
        return eng, cfg, "counts", lambda c, ln: eng.profile_counts_device(
            c, ln, eng.align_device(c, ln)), batches
    return eng, cfg, "packed", lambda c, ln: eng.align_device_packed(
        c, ln, with_counts=kind == "packed_counts"), batches


@pytest.mark.parametrize("kind", GRAPH_KINDS)
def test_graphed_steps_equal_eager_on_card(cuda, kind, port_ref):
    """Every step kind of both engines runs as one replayed CUDA graph and
    equals its function run eagerly on the same inputs in every output,
    tolerance 0; each output is compared after all ten calls, so nine
    were held while later replays ran."""
    from torch.utils._pytree import tree_leaves

    eng, tier, name, run, batches = _graph_case(kind, port_ref)
    both = _Both(eng._steps[tier][name])
    eng._steps[tier][name] = both
    for b in batches:
        run(*b)
    torch.cuda.synchronize()
    assert len(both.pairs) == 10 and both.step.graphs == 1
    (entry,) = both.step.entries.values()
    assert entry.held == (NONE if kind == "counts" else STEP)
    for k, (got, want) in enumerate(both.pairs):
        for g, w in zip(tree_leaves(got), tree_leaves(want), strict=True):
            assert g.dtype == w.dtype and torch.equal(g, w), (kind, k)


def test_replays_count_their_launches(cuda, port_ref):
    """The first call of a key (its eager warm-up) and every replay add one
    launch of the seeded select kernel, one of the extend kernel and one of
    the finalize kernel, and none of the select kernel over rows of
    diagonals; the capture adds none. The graph holds one seeded launch and
    no row launch: engagement seeded / (seeded + rows) is 1; and one
    finalize launch a step: its engagement is 1."""
    eng, _tier, _name, run, batches = _graph_case("packed", port_ref)
    before = _launches()
    for k, b in enumerate(batches[:4]):
        run(*b)
        assert _since(before) == (k + 1, 0, k + 1, k + 1)
    step = eng.compiled_steps()["packed k=8"]
    assert step.graphs == 1 and step.capture_ms > 0
    (entry,) = step.entries.values()
    assert entry.held == STEP


def test_a_step_that_syncs_raises_at_capture(cuda):
    """A step with .item() inside raises at capture, naming the step, on
    every call: it never runs eagerly instead; the caller's stream is
    restored and the card keeps working."""
    from parasuite_tpu_torch.ops.compiled import CompiledStep

    step = CompiledStep(lambda x: x * int(x.sum().item()), cuda, "syncs")
    x = torch.arange(8, device=cuda)
    for _ in range(2):
        with pytest.raises(RuntimeError,
                           match="capture of step 'syncs' failed"):
            step(x)
    assert not step.entries
    assert torch.cuda.current_stream(cuda) == torch.cuda.default_stream(cuda)
    torch.cuda.synchronize()
    assert torch.equal((x * 28).cpu(), torch.arange(8) * 28)


# ---------------------------------------------------------------------------
# the compiled multi-device steps (parallel/dist_align.py, parallel/shards.py)
# ---------------------------------------------------------------------------

MULTI_KINDS = {"counts": (True, False), "no_counts": (False, False),
               "candidates": (False, True), "sharded": None}


def _sharded_world():
    """Five chromosomes over two shards (the CPU tests' world) -> (cfg,
    ShardedIndex, flat score tensor, codes, lengths)."""
    from parasuite_tpu_torch.parallel.shards import build_sharded_index

    cfg = AlignConfig(max_read_len=50, batch_size=64, kmer_size=8,
                      max_seeds=4, max_occ=32, max_candidates=8,
                      band_width=3, chrom_spacer=64)
    rng = np.random.default_rng(600)
    seqs = {f"chr{i}": rng.integers(0, 4, 1500 + 700 * i).astype(np.int8)
            for i in range(5)}
    sharded, full = build_sharded_index(seqs, 2, cfg)
    codes, lengths, _ = sample_reads(np.random.default_rng(601), full, 64,
                                     50, mutate=2, indel=True)
    return cfg, sharded, flat_score_tensor(cfg, 50), codes, lengths


def _multi_step(kind, devices, tiny_ref):
    """The multi-device step of `kind` over `devices` -> (step, call of a
    batch (codes, lengths), ten batches of one shape, the ScoreParams the
    calls pass, on the first device)."""
    from parasuite_tpu_torch.parallel import make_dist_align_step, make_mesh
    from parasuite_tpu_torch.parallel.mesh import make_mesh2
    from parasuite_tpu_torch.parallel.shards import make_sharded_step

    if kind == "sharded":
        cfg, sharded, s, codes, lengths = _sharded_world()
        sprof = ScoreParams.from_tensor(s, cfg, devices[0])
        step = make_sharded_step(cfg, make_mesh2(1, len(devices),
                                                 devices=devices))
        slabs = sharded.slabs(cfg)

        def call(c, ln):
            return step(slabs, sharded.orig_chrom, sprof, c, ln,
                        min_scores_host(ln, cfg))
    else:
        with_counts, with_candidates = MULTI_KINDS[kind]
        cfg, didx, sprof, codes, lengths = _inputs("bench_L50_W5", tiny_ref)
        sprof = _to(sprof, devices[0])
        state = (_to(didx, devices[0]), sprof)
        step = make_dist_align_step(cfg, make_mesh(devices=devices),
                                    with_counts=with_counts,
                                    with_candidates=with_candidates)

        def call(c, ln):
            return step(*state, c, ln, min_scores_host(ln, cfg))
    batches = [(np.roll(codes, 7 * k, axis=0), np.roll(lengths, 7 * k))
               for k in range(10)]
    return step, call, batches, sprof


def _spy_slots(step) -> list:
    """Every slot of a bound multi-device step -> a _Both; -> the _Both
    objects (the merges of a sharded step last)."""
    if hasattr(step, "cells"):
        step.cells = [[_Both(c) for c in row] for row in step.cells]
        step.merges = [_Both(m) for m in step.merges]
        return [*sum(step.cells, []), *step.merges]
    step.slots = [_Both(s) for s in step.slots]
    return list(step.slots)


@pytest.mark.parametrize("kind", list(MULTI_KINDS))
def test_graphed_multi_device_steps_equal_eager_on_card(cuda, kind,
                                                        tiny_ref):
    """Each slot of the data-parallel step (with counts, without, with
    candidates) and each cell and merge of the sharded step, on card 0
    given twice, runs as one replayed CUDA graph and equals its function
    run eagerly on the same inputs, tolerance 0, every output compared
    after all ten calls; the first call equals the same step on CPU
    devices."""
    from torch.utils._pytree import tree_leaves

    card0 = torch.device("cuda", 0)
    step, call, batches, _sprof = _multi_step(kind, [card0] * 2, tiny_ref)
    first = call(*batches[0])       # binds and captures every slot
    cpu_call = _multi_step(kind, [torch.device("cpu")] * 2, tiny_ref)[1]
    for g, w in zip(tree_leaves(first), tree_leaves(cpu_call(*batches[0])),
                    strict=True):
        assert g.device == card0 and torch.equal(g.cpu(), w), kind
    spies = _spy_slots(step)
    for b in batches[1:]:
        call(*b)
    torch.cuda.synchronize()
    assert len(spies) == (3 if kind == "sharded" else 2)
    for spy in spies:
        assert len(spy.pairs) == 9 and spy.step.graphs == 1, spy.step.name
        (entry,) = spy.step.entries.values()
        want = NONE if spy.step.name.startswith("merge") else STEP
        assert entry.held == want, spy.step.name
        for k, (got, eager) in enumerate(spy.pairs):
            for g, w in zip(tree_leaves(got), tree_leaves(eager),
                            strict=True):
                assert g.dtype == w.dtype and torch.equal(g, w), \
                    (spy.step.name, k)


@pytest.mark.parametrize("kind", ["counts", "sharded"])
def test_multi_device_replays_count_their_launches(cuda, kind, tiny_ref):
    """Card 0 given twice: the first call (each slot's eager warm-up) and
    every replay add two launches of the seeded select kernel, of the
    extend kernel and of the finalize kernel, one a slot; the captures add
    none, and each slot holds one graph."""
    card0 = torch.device("cuda", 0)
    step, call, batches, _sprof = _multi_step(kind, [card0] * 2, tiny_ref)
    before = _launches()
    for k, b in enumerate(batches[:4]):
        call(*b)
        assert _since(before) == (2 * (k + 1), 0, 2 * (k + 1),
                                  2 * (k + 1))
    steps = step.compiled_steps()
    assert len(steps) == (3 if kind == "sharded" else 2)
    assert all(s.graphs == 1 and s.capture_ms > 0 for s in steps.values())


@pytest.mark.parametrize("kind", ["counts", "sharded"])
def test_two_cards_capture_each_slot_on_its_own(cuda, kind, tiny_ref):
    """A mesh over cards 0 and 1: each slot's graph, inputs and outputs lie
    on its own card, the result equals the CPU step's, and (data-parallel)
    new scores copied in place into card 0's ScoreParams reach card 1's
    replica by the next call. Skipped where the machine has one card."""
    from torch.utils._pytree import tree_leaves

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    step, call, batches, sprof = _multi_step(kind, cards, tiny_ref)
    _cpu, cpu_call, _b, cpu_sprof = _multi_step(
        kind, [torch.device("cpu")] * 2, tiny_ref)
    for b in batches[:3]:
        for g, w in zip(tree_leaves(call(*b)), tree_leaves(cpu_call(*b)),
                        strict=True):
            assert torch.equal(g.cpu(), w), kind
    for name, s in step.compiled_steps().items():
        (entry,) = s.entries.values()
        assert s.graphs == 1 and str(s.device) in name
        for t in (*entry.inputs, *entry.outputs):
            assert t.device == s.device, name
    if kind == "sharded":
        return
    # a learned-looking profile (T->C scored as a match), copied in place
    # as AlignerEngine.set_profile does
    cfg = step.cfg
    s2 = flat_score_tensor(cfg, cfg.max_read_len).copy()
    s2[:, 3, 1] = s2[:, 3, 3]
    new = ScoreParams.from_tensor(s2, cfg, "cpu")
    before = call(*batches[0])[0].score.cpu()
    for target in (sprof, cpu_sprof):
        for f in new.__dataclass_fields__:
            getattr(target, f).copy_(getattr(new, f))
    got, want = call(*batches[0]), cpu_call(*batches[0])
    for g, w in zip(tree_leaves(got), tree_leaves(want), strict=True):
        assert torch.equal(g.cpu(), w)
    assert not torch.equal(got[0].score[32:].cpu(), before[32:]), \
        "the new scores did not reach card 1"
