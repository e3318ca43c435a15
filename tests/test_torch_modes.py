"""The port's XA tags, two-tier rescue, two-pass library API and
gapped_indel_counts vs the JAX package, and the copy of sim/genome.py.

Each case feeds the same seeded numpy inputs through the JAX engine (on the
CPU, as tests/test_pipeline.py runs it) and the port's engine on CPU
tensors (the kernels' plain versions). Tolerance 0 throughout: every output
is an integer array, a string or bytes."""

import numpy as np
import pytest
import torch

from parasuite_tpu.index import KmerIndex, PackedReference
from parasuite_tpu.io.batch import ReadBatch
from parasuite_tpu.io.fastq import iter_fastq_batches, write_fastq
from parasuite_tpu.ops import device_index as jdi
from parasuite_tpu.pipeline import align as jalign
from parasuite_tpu.pipeline import two_pass as jtwo
from parasuite_tpu.pipeline.stream import streaming_align as j_stream
from parasuite_tpu.sim import genome as jgenome
from parasuite_tpu_torch.io.fastq import \
    iter_fastq_batches as t_iter_fastq_batches
from parasuite_tpu_torch.ops import device_index as tdi
from parasuite_tpu_torch.pipeline import align as talign
from parasuite_tpu_torch.pipeline import two_pass as ttwo
from parasuite_tpu_torch.pipeline.stream import streaming_align as t_stream
from parasuite_tpu_torch.sim import genome as tgenome

from conftest import sample_reads
from _torch_helpers import to_port

torch.set_num_threads(1)

HOST_FIELDS = ("mapped", "strand", "pos", "score", "mapq", "x0", "x1", "nm",
               "ug_equal", "tc_count")


def _mk_batch(codes, lengths, prefix="r"):
    names = [f"{prefix}{i}" for i in range(codes.shape[0])]
    quals = [b"I" * int(lengths[i]) for i in range(codes.shape[0])]
    return ReadBatch(codes=codes, lengths=lengths, names=names, quals=quals)


def _engines(ref, index, cfg, **kw):
    """The reference engine on the JAX package's objects, the port's on its
    own (to_port)."""
    return (jalign.AlignerEngine(ref, index, cfg, **kw),
            talign.AlignerEngine(to_port(ref), to_port(index), to_port(cfg),
                                 device="cpu", **kw))


def _hosts_equal(want, got, n):
    for f in HOST_FIELDS:
        np.testing.assert_array_equal(getattr(got, f)[:n],
                                      getattr(want, f)[:n], err_msg=f)
    for i in range(n):
        assert got.cigars[i] == want.cigars[i], i
    assert got.xa == want.xa


class _Buf:
    """Writer with both emit routes (per-record text and native blocks)."""

    def __init__(self):
        self.data = bytearray()

    def write(self, line):
        self.data += line.encode("ascii") + b"\n"

    def write_block(self, data):
        self.data += data


def _emitted(engine, batch, host) -> bytes:
    w = _Buf()
    engine.emit_sam(batch, host, w)
    return bytes(w.data)


# ---------------------------------------------------------------------------
# XA tags
# ---------------------------------------------------------------------------

def _xa_world(name, cfg):
    """-> ({name: codes}, reads, lengths, xa_limit): the worlds of
    tests/test_pipeline.py's XA tests, and a repeat-structured genome."""
    if name == "duplicate":          # test_xa_alternative_hits
        rng = np.random.default_rng(900)
        core = rng.integers(0, 4, 300).astype(np.int8)
        seq = np.concatenate([core, rng.integers(0, 4, 400).astype(np.int8),
                              core])
        codes = np.stack([core[20:70],
                          rng.integers(0, 4, 50).astype(np.int8)])
        return ({"dup": seq}, codes, np.full(2, 50, dtype=np.int32), 10)
    if name == "gapped_alternate":   # test_xa_gapped_alternate_and_drop_count
        rng = np.random.default_rng(901)
        core = rng.integers(0, 4, 80).astype(np.int8)
        gapped_copy = np.concatenate([core[:35], core[36:]])
        seq = np.concatenate([rng.integers(0, 4, 200).astype(np.int8), core,
                              rng.integers(0, 4, 150).astype(np.int8),
                              gapped_copy,
                              rng.integers(0, 4, 100).astype(np.int8)])
        return ({"dup": seq}, core[:50][None, :].astype(np.int8),
                np.full(1, 50, dtype=np.int32), 10)
    if name == "over_limit":         # ... its xa_limit=2 overflow half
        rng = np.random.default_rng(902)
        core = rng.integers(0, 4, 120).astype(np.int8)
        parts = []
        for _ in range(5):
            parts += [core, rng.integers(0, 4, 200).astype(np.int8)]
        return ({"rep": np.concatenate(parts)},
                core[20:70][None, :].astype(np.int8),
                np.full(1, 50, dtype=np.int32), 2)
    # repeat-structured genome: diverged repeat copies give ungapped and
    # gapped alternates, several per read
    seqs, _ = jgenome.chr22_like(seed=22, scale=0.002)
    ref = PackedReference.from_dict(seqs, spacer=cfg.chrom_spacer)
    rng = np.random.default_rng(903)
    codes, lengths, _ = sample_reads(rng, ref, 96, 50, mutate=1, indel=True)
    return seqs, codes, lengths, 3


@pytest.mark.parametrize("name", ["duplicate", "gapped_alternate",
                                  "over_limit", "repeats"])
def test_xa_strings_equal_reference(name, small_cfg):
    """to_host().xa strings, xa_dropped, every HostAlignments field and the
    emitted SAM records (XA records on the per-record path) are equal."""
    seqs, codes, lengths, limit = _xa_world(name, small_cfg)
    ref = PackedReference.from_dict(seqs, spacer=small_cfg.chrom_spacer)
    index = KmerIndex.build(ref.seq, small_cfg.kmer_size)
    jeng, teng = _engines(ref, index, small_cfg, xa_tags=True,
                          xa_limit=limit)
    batch = _mk_batch(codes, lengths)
    t_batch = to_port(batch)
    want, got = jeng.align_to_host(batch), teng.align_to_host(t_batch)
    _hosts_equal(want, got, codes.shape[0])
    assert any(x is not None for x in got.xa)
    assert teng.xa_dropped == jeng.xa_dropped
    if name == "over_limit":
        assert teng.xa_dropped == 2
    if name == "gapped_alternate":
        assert got.xa[0] == "XA:Z:dup,+431,35M1I14M,1;"
    assert _emitted(teng, t_batch, got) == _emitted(jeng, batch, want)


@pytest.mark.parametrize("name", ["repeats", "indels"])
def test_candidate_table_equals_reference(name, small_cfg, tiny_ref,
                                          tiny_index):
    """align_batch_with_candidates: all 12 AlignResult fields and all 6
    CandidateTable fields are array-equal to the reference's."""
    if name == "repeats":
        seqs, codes, lengths, _ = _xa_world(name, small_cfg)
        ref = PackedReference.from_dict(seqs, spacer=small_cfg.chrom_spacer)
        index = KmerIndex.build(ref.seq, small_cfg.kmer_size)
    else:
        ref, index = tiny_ref, tiny_index
        rng = np.random.default_rng(904)
        codes, lengths, _ = sample_reads(rng, ref, 64, 50, mutate=2,
                                         indel=True)
        codes[3] = 4                 # all-N read
        lengths[4] = 0               # padding row
        codes[4] = 4
        lengths[5] = 37              # short read
        codes[5, 37:] = 4
    jeng, teng = _engines(ref, index, small_cfg, xa_tags=True)
    jres, jtab = jeng.align_device(codes, lengths)
    tres, ttab = teng.align_device(codes, lengths)
    for want, got in ((jres, tres), (jtab, ttab)):
        assert got._fields == want._fields
        for f in want._fields:
            g = getattr(got, f).numpy()
            w = np.asarray(getattr(want, f))
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)
    assert bool(ttab.valid.any()) and not bool(ttab.valid.all())
    assert bool((~ttab.ug_equal & ttab.valid).any())


# ---------------------------------------------------------------------------
# two-tier rescue
# ---------------------------------------------------------------------------

def _rescue_reads(name, ref):
    """Reads the primary k = 8 pass leaves partly unmapped: the case of
    tests/test_pipeline.py::test_rescue_kmer_two_tier, and a batch whose
    unmapped rows exceed the rescue batch cap (256 rows)."""
    if name == "unmapped_36bp":
        rng = np.random.default_rng(808)
        codes, lengths, _ = sample_reads(rng, ref, 128, 36, mutate=5)
    else:
        rng = np.random.default_rng(809)
        codes, lengths, _ = sample_reads(rng, ref, 360, 36, mutate=5)
        junk = rng.integers(0, 4, (240, 36)).astype(np.int8)
        codes = np.concatenate([codes, junk])
        lengths = np.full(600, 36, dtype=np.int32)
        order = rng.permutation(600)
        codes = codes[order]
        lengths[7] = 0               # a padding row is never rescued
        codes[7] = 4
    pad = np.full((codes.shape[0], 50 - 36), 4, dtype=np.int8)
    return np.concatenate([codes, pad], axis=1), lengths


@pytest.mark.parametrize("name", ["unmapped_36bp", "over_cap"])
def test_rescue_equals_reference(name, small_cfg, tiny_ref, tiny_index):
    """HostAlignments (rescued rows take the k = 6 result), rescue_mapped,
    rescue_overflow and last_rescue_rows are equal to the reference's; the
    batch past the cap leaves its overflow rows unmapped in both."""
    cfg = small_cfg.replace(rescue_kmer=6)
    codes, lengths = _rescue_reads(name, tiny_ref)
    jeng, teng = _engines(tiny_ref, tiny_index, cfg)
    batch = ReadBatch(codes=codes, lengths=lengths)
    want = jeng.align_to_host(batch)
    got = teng.align_to_host(to_port(batch))
    _hosts_equal(want, got, codes.shape[0])
    assert teng.rescue_mapped == jeng.rescue_mapped >= 3
    assert teng.rescue_overflow == jeng.rescue_overflow
    np.testing.assert_array_equal(teng.last_rescue_rows,
                                  jeng.last_rescue_rows)
    if name == "over_cap":
        assert teng.rescue_overflow > 0
    # a batch with nothing to rescue resets last_rescue_rows
    teng.align_to_host(to_port(ReadBatch(
        codes=tiny_ref.seq[None, 100:150].copy(),
        lengths=np.full(1, 50, dtype=np.int32))))
    assert teng.last_rescue_rows is None


def test_rescue_min_scores_equal(small_cfg):
    """The rescue step takes min scores from the primary cfg's table; the
    reference's unpacked branch computes them under cfg2. Equal for every
    length."""
    cfg = small_cfg.replace(rescue_kmer=6)
    cfg2 = cfg.replace(kmer_size=6, rescue_kmer=0,
                       max_seeds=max(cfg.rescue_seeds, cfg.max_seeds))
    lens = np.arange(cfg.max_read_len + 1)
    np.testing.assert_array_equal(tdi.min_score_table(to_port(cfg))[lens],
                                  jdi.min_scores_host(lens, cfg2))


def test_rescue_stream_equals_reference(small_cfg, tiny_ref, tiny_index,
                                        tmp_path):
    """The case of tests/test_stream.py::test_rescue_profile_counts_in_stream
    through both streaming_aligns: SAM bytes, profile counts (rescued rows
    included), indel counts and the rescue counters are equal."""
    cfg = small_cfg.replace(rescue_kmer=6)
    rng = np.random.default_rng(909)
    codes, lengths, _ = sample_reads(rng, tiny_ref, 128, 36, mutate=5)
    codes = np.concatenate(
        [codes, np.full((128, 50 - 36), 4, dtype=np.int8)], axis=1)
    fq = tmp_path / "rescue.fastq"
    write_fastq(fq, [f"q{i}" for i in range(128)], codes, lengths)
    jeng, teng = _engines(tiny_ref, tiny_index, cfg)
    outs = {}
    for name, eng, run in (("jax", jeng, j_stream), ("torch", teng,
                                                     t_stream)):
        indels: dict = {}
        out = tmp_path / f"{name}.sam"
        n, counts, n_prof = run(eng, fq, out, with_profile_counts=True,
                                indel_out=indels, command_line="t")
        outs[name] = (out.read_bytes(), n, counts, n_prof, indels)
    (jb, jn, jc, jp, ji), (tb, tn, tc, tp, ti) = outs["jax"], outs["torch"]
    assert tb == jb and (tn, tp) == (jn, jp)
    np.testing.assert_array_equal(tc, jc)
    for key in ("ins", "dels"):
        np.testing.assert_array_equal(ti[key], ji[key])
    assert ti["n_gapped"] == ji["n_gapped"]
    assert teng.rescue_mapped == jeng.rescue_mapped > 0


# ---------------------------------------------------------------------------
# gapped_indel_counts and the two-pass library API
# ---------------------------------------------------------------------------

def test_gapped_indel_counts_equal_reference(small_cfg, tiny_ref,
                                             tiny_index):
    rng = np.random.default_rng(905)
    codes, lengths, _ = sample_reads(rng, tiny_ref, 64, 50, mutate=1,
                                     indel=True)
    batch = _mk_batch(codes, lengths)
    got = []
    engines = _engines(tiny_ref, tiny_index, small_cfg, xa_tags=True)
    for eng, batch in zip(engines, (batch, to_port(batch))):
        L = small_cfg.max_read_len
        ins, dels = np.zeros(L, np.int64), np.zeros(L, np.int64)
        subs = np.zeros((L, 4, 4), np.int64)
        n = eng.gapped_indel_counts(batch, eng.align_device(codes, lengths),
                                    ins, dels, sub_counts=subs)
        got.append((n, ins, dels, subs))
    (jn, *jarrs), (tn, *tarrs) = got
    assert tn == jn > 0
    for t, j in zip(tarrs, jarrs):
        np.testing.assert_array_equal(t, j)
    assert got[1][1].sum() + got[1][2].sum() > 0


def test_accumulate_profile_host_counts_every_record(small_cfg, tiny_ref,
                                                     tiny_index, tmp_path):
    """The plain engine's host share of the profile on a batch with gapped
    and rescued rows: the step's fused counts plus what
    accumulate_profile_host adds equal count_substitutions_from_cigar and
    count_indels_from_cigar summed over every mapped record to_host gives
    the writer (SURVEY.md §3.3), and its (n_profiled, n_gapped) and counts
    equal what streaming_align reports for the same batch."""
    from parasuite_tpu_torch.errormodel.infer import (
        count_indels_from_cigar, count_substitutions_from_cigar)
    from parasuite_tpu_torch.utils.dna import revcomp_codes

    cfg = to_port(small_cfg.replace(batch_size=128, rescue_kmer=6))
    rng = np.random.default_rng(910)
    gapped, g_lens, _ = sample_reads(rng, tiny_ref, 64, 50, mutate=1,
                                     indel=True)
    short, s_lens, _ = sample_reads(rng, tiny_ref, 64, 36, mutate=5)
    codes = np.concatenate(
        [gapped, np.concatenate([short, np.full((64, 14), 4, np.int8)],
                                axis=1)])
    lengths = np.concatenate([g_lens, s_lens])
    eng = talign.AlignerEngine(to_port(tiny_ref), to_port(tiny_index), cfg,
                               device="cpu")
    batch = to_port(_mk_batch(codes, lengths))
    res, c = eng.align_device_packed(codes, lengths, with_counts=True)
    host = eng.to_host(batch, res)
    L = cfg.max_read_len
    subs = c.numpy().astype(np.int64)
    ins, dels = np.zeros(L, np.int64), np.zeros(L, np.int64)
    n_prof, n_gap = eng.accumulate_profile_host(batch, host, subs, ins, dels)

    rescued = eng.last_rescue_rows
    assert rescued is not None and host.ug_equal[rescued].any()
    want_subs = np.zeros((L, 4, 4), np.int64)
    want_ins, want_dels = np.zeros(L, np.int64), np.zeros(L, np.int64)
    n_mapped = n_gapped = 0
    for b in range(codes.shape[0]):
        if not host.mapped[b]:
            continue
        ln, st = int(lengths[b]), int(host.strand[b])
        read = codes[b, :ln] if st == 0 else revcomp_codes(codes[b, :ln])
        count_substitutions_from_cigar(tiny_ref.seq, int(host.pos[b]), read,
                                       ln, st, host.cigars[b], want_subs)
        count_indels_from_cigar(host.cigars[b], ln, st, want_ins, want_dels)
        n_mapped += 1
        n_gapped += not host.ug_equal[b]
    np.testing.assert_array_equal(subs, want_subs)
    np.testing.assert_array_equal(ins, want_ins)
    np.testing.assert_array_equal(dels, want_dels)
    assert (n_prof, n_gap) == (n_mapped, n_gapped)
    assert n_gap > 0 and want_ins.sum() + want_dels.sum() > 0

    fq = tmp_path / "mixed.fastq"
    write_fastq(fq, [f"m{i}" for i in range(codes.shape[0])], codes,
                lengths)
    indels: dict = {}
    _n, counts, n_profiled = t_stream(eng, fq, tmp_path / "mixed.sam",
                                      with_profile_counts=True,
                                      indel_out=indels)
    assert (n_profiled, indels["n_gapped"]) == (n_prof, n_gap)
    np.testing.assert_array_equal(counts, subs)
    np.testing.assert_array_equal(indels["ins"], ins)
    np.testing.assert_array_equal(indels["dels"], dels)


@pytest.mark.parametrize("mode", ["plain", "rescue", "xa"])
def test_two_pass_api_equals_reference(mode, small_cfg, tiny_ref, tiny_index,
                                       tmp_path):
    """infer_profile_streaming + two_pass_align: equal ErrorProfiles (counts,
    indels, read counts) and pass-2 SAM bytes. With rescue, both leave the
    rescued rows out of the profile (the reference's behaviour)."""
    cfg = small_cfg.replace(batch_size=32)
    kw = {}
    if mode == "rescue":
        cfg = cfg.replace(rescue_kmer=6)
    if mode == "xa":
        kw["xa_tags"] = True
    rng = np.random.default_rng(906)
    codes, lengths, _ = sample_reads(rng, tiny_ref, 80, 50, mutate=2,
                                     indel=True)
    if mode == "rescue":
        codes[:, 36:] = 4
        lengths[:] = 36
        codes[::3] = rng.integers(0, 4, codes[::3].shape)
        codes[::3, 36:] = 4
    fq = tmp_path / "reads.fastq"
    write_fastq(fq, [f"p{i}" for i in range(80)], codes, lengths)

    def source(read=iter_fastq_batches):
        return read(fq, cfg.batch_size, cfg.max_read_len)

    sources = (source, lambda: source(t_iter_fastq_batches))
    results = []
    for eng, api, src in zip(_engines(tiny_ref, tiny_index, cfg, **kw),
                             (jtwo, ttwo), sources):
        w = _Buf()
        prof = api.two_pass_align(eng, src, sam_writer=w,
                                  profile_path=tmp_path / f"{api.__name__}.p")
        results.append((prof, bytes(w.data),
                        (tmp_path / f"{api.__name__}.p").read_bytes()))
    (jp, jsam, jfile), (tp, tsam, tfile) = results
    np.testing.assert_array_equal(tp.counts, jp.counts)
    np.testing.assert_array_equal(tp.ins_counts, jp.ins_counts)
    np.testing.assert_array_equal(tp.del_counts, jp.del_counts)
    assert (tp.n_reads, tp.n_gapped) == (jp.n_reads, jp.n_gapped)
    assert tp.n_reads > 0
    assert tfile == jfile
    assert tsam == jsam and tsam.count(b"\n") == 80


# ---------------------------------------------------------------------------
# sim/genome.py copy
# ---------------------------------------------------------------------------

def _synth(m):
    stats = m.GenomeStats()
    seq = m.synth_chromosome(60_000, 3, n_gap_lead=2_000, n_gap_internal=1,
                             satellite_bases=1_000, segdup_blocks=0,
                             stats=stats)
    return {"c": seq}, stats


GENOME_CALLS = {
    "chr22_like": lambda m: m.chr22_like(seed=22, scale=0.01),
    "multi_chrom": lambda m: m.multi_chrom(1_200_000, 2, seed=5),
    "synth_chromosome": _synth,
}


@pytest.mark.parametrize("fn", list(GENOME_CALLS))
def test_genome_copy_equals_reference(fn):
    (jseqs, jst), (tseqs, tst) = (GENOME_CALLS[fn](jgenome),
                                  GENOME_CALLS[fn](tgenome))
    assert list(tseqs) == list(jseqs)
    for name in jseqs:
        np.testing.assert_array_equal(tseqs[name], jseqs[name])
    assert (tst.length, tst.n_bases, tst.repeat_bases,
            tst.family_bases) == (jst.length, jst.n_bases, jst.repeat_bases,
                                  jst.family_bases)
