"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version; align_batch, align_batch_with_candidates, a rescue engine
and CombinedEngine on the card against the same run on CPU tensors; the
wrappers' refusals. Every test needs an NVIDIA GPU and skips elsewhere.

This file imports no jax, so it also runs on a machine with a card and no
JAX installed (PARASUITE_TEST_TPU=1 keeps conftest.py from importing jax):

    PARASUITE_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from parasuite_tpu.config import AlignConfig
from parasuite_tpu.errormodel import flat_score_tensor
from parasuite_tpu.index import KmerIndex, PackedReference
from parasuite_tpu_torch.ops import aligner as tx
from parasuite_tpu_torch.ops import cuda_extend, cuda_seed
from parasuite_tpu_torch.ops.device_index import (DeviceIndex, ScoreParams,
                                                  min_scores_host)

from conftest import sample_reads

pytestmark = pytest.mark.cuda

# (max_read_len, kmer_size, max_seeds, max_occ, max_candidates, band_width):
# the bench shape, the band and row-width extremes the kernels take, and a
# long read
CONFIGS = {
    "bench_L50_W5": (50, 12, 7, 16, 8, 5),
    "band1_C2": (36, 8, 2, 16, 2, 0),
    "band15_n448": (100, 8, 7, 64, 16, 7),
    "L250": (250, 8, 7, 32, 16, 2),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


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


HOST_FIELDS = ("mapped", "strand", "pos", "score", "mapq", "x0", "x1", "nm",
               "ug_equal", "tc_count")


def _hosts_equal(want, got):
    for f in HOST_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    for i in range(len(want.mapped)):
        assert got.cigars[i] == want.cigars[i], i
    assert got.xa == want.xa


def test_rescue_engine_on_card_equals_cpu(cuda, tiny_ref):
    """Two-tier rescue (k = 8, then k = 6 for the unmapped rows, over the
    256-row cap): to_host on the card equals the CPU engine's, counters
    included."""
    from parasuite_tpu.io.batch import ReadBatch
    from parasuite_tpu_torch.pipeline.align import AlignerEngine

    cfg = AlignConfig(max_read_len=50, batch_size=64, kmer_size=8,
                      max_seeds=4, max_occ=32, max_candidates=8,
                      band_width=3, chrom_spacer=64, rescue_kmer=6)
    index = KmerIndex.build(tiny_ref.seq, 8)
    rng = np.random.default_rng(808)
    codes, lengths, _ = sample_reads(rng, tiny_ref, 600, 36, mutate=5)
    codes[::2] = rng.integers(0, 4, codes[::2].shape)
    codes = np.concatenate([codes, np.full((600, 14), 4, np.int8)], axis=1)
    batch = ReadBatch(codes=codes, lengths=lengths)
    hosts, engines = [], []
    for dev in ("cpu", "cuda"):
        eng = AlignerEngine(tiny_ref, index, cfg, device=dev)
        hosts.append(eng.align_to_host(batch))
        engines.append(eng)
    _hosts_equal(*hosts)
    assert [(e.rescue_mapped, e.rescue_overflow) for e in engines[1:]] == \
        [(engines[0].rescue_mapped, engines[0].rescue_overflow)]
    assert engines[0].rescue_mapped > 0 and engines[0].rescue_overflow > 0


def test_combined_engine_on_card_equals_cpu(cuda):
    """CombinedEngine with XA tags on genomic, exonic and junction reads:
    to_host on the card equals the CPU engine's, XA strings included."""
    from parasuite_tpu.io.batch import ReadBatch
    from parasuite_tpu.utils.dna import revcomp_codes
    from parasuite_tpu_torch.pipeline.combined import (CombinedEngine,
                                                       CombinedReference,
                                                       Transcript,
                                                       splice_transcript)

    cfg = AlignConfig(max_read_len=50, batch_size=64, kmer_size=8,
                      max_seeds=4, max_occ=32, max_candidates=8,
                      band_width=3, chrom_spacer=64)
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
    batch = ReadBatch(codes=codes, lengths=np.full(128, 50, np.int32))
    hosts = [CombinedEngine(comb, index, cfg, xa_tags=True,
                            device=dev).align_to_host(batch)
             for dev in ("cpu", "cuda")]
    _hosts_equal(*hosts)
    assert any(len(hosts[0].cigars[i]) > 1 for i in range(128))
    assert hosts[0].xa[0] is not None


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
    with pytest.raises(ValueError, match="row buffer"):
        cuda_seed.select_candidates(diags.repeat(1, 10), cfg)
    cand, _ = cuda_seed.select_candidates(diags, cfg)
    with pytest.raises(ValueError, match="lengths int32"):
        cuda_extend.extend_candidates(oriented, tlens.long(), cand, didx,
                                      sprof, cfg)
    with pytest.raises(ValueError, match="different devices"):
        cuda_extend.extend_candidates(oriented, tlens.cpu(), cand, didx,
                                      sprof, cfg)
