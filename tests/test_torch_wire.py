"""The port's wire step (2-bit codes and N mask up, PackedResult down, the
profile counts fused) and the extend_impl / select_impl switches against
the JAX package.

The same seeded numpy inputs go through parasuite_tpu (jnp path, CPU) and
parasuite_tpu_torch (plain PyTorch versions on CPU tensors); the port's side
is built from its own objects (to_port) and imports nothing of the JAX
package. Tolerance 0 throughout: every compared value is an integer array or
bytes."""

import json

import jax
import numpy as np
import pytest
import torch

from parasuite_tpu.index import KmerIndex
from parasuite_tpu.io.batch import ReadBatch
from parasuite_tpu.io.fastq import write_fastq
from parasuite_tpu.ops import aligner as ja
from parasuite_tpu.pipeline import align as jalign
from parasuite_tpu.pipeline import combined as jc
from parasuite_tpu.pipeline.stream import streaming_align as j_stream
from parasuite_tpu_torch.ops import aligner as ta
from parasuite_tpu_torch.ops import cuda_extend, cuda_seed
from parasuite_tpu_torch.pipeline import align as talign
from parasuite_tpu_torch.pipeline import combined as tc
from parasuite_tpu_torch.pipeline.stream import StreamCheckpoint
from parasuite_tpu_torch.pipeline.stream import streaming_align as t_stream

from conftest import sample_reads
from _torch_helpers import to_port

torch.set_num_threads(1)

HOST_FIELDS = ("mapped", "strand", "pos", "score", "mapq", "x0", "x1", "nm",
               "ug_equal", "tc_count")
LENGTHS = [36, 50, 51, 100]


def _codes_with_edge_ns(L: int, n: int = 24, seed: int = 0) -> np.ndarray:
    """Random codes with N at both row edges, a whole N row, and N runs
    across the byte boundaries of both packed buffers."""
    rng = np.random.default_rng(seed + L)
    codes = rng.integers(0, 4, (n, L)).astype(np.int8)
    codes[0, 0] = codes[0, -1] = 4
    codes[1, :] = 4
    codes[2, 3:9] = 4
    codes[3, -(L % 8 or 8):] = 4
    codes[rng.random((n, L)) < 0.03] = 4
    return codes


def _engines(ref, index, cfg, **kw):
    return (jalign.AlignerEngine(ref, index, cfg, **kw),
            talign.AlignerEngine(to_port(ref), to_port(index), to_port(cfg),
                                 device="cpu", **kw))


def _eq_fields(got, want, what=""):
    for f in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{what} {f}")


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L", LENGTHS)
def test_pack_codes_host_equals_reference(L):
    codes = _codes_with_edge_ns(L)
    got, want = ta.pack_codes_host(codes), ja.pack_codes_host(codes)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.uint8 and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    assert got[0].shape == (codes.shape[0], -(-L // 4))
    assert got[1].shape == (codes.shape[0], -(-L // 8))


@pytest.mark.parametrize("L", LENGTHS)
def test_unpack_codes_equals_reference_and_round_trips(L):
    codes = _codes_with_edge_ns(L, seed=1)
    two, nmask = ja.pack_codes_host(codes)
    want = np.asarray(ja.unpack_codes(two, nmask, L))
    got = ta.unpack_codes(torch.from_numpy(two), torch.from_numpy(nmask), L)
    assert got.dtype == torch.int8
    assert got.numpy().tobytes() == want.tobytes()
    np.testing.assert_array_equal(got.numpy(), codes)


def _result_rows(W: int, C: int, n: int = 64, seed: int = 7) -> dict:
    """AlignResult arrays at every edge of the wire's ranges: unmapped rows
    (score NEG, pos -1), diag - pos + W at 0 and 2W, score +-32385, nm and
    tc_count 255, x0 / x1 / n_candidates at 2C."""
    rng = np.random.default_rng(seed + W)
    mapped = rng.random(n) < 0.8
    pos = rng.integers(0, 2**31 - 64, n).astype(np.int32)
    j = rng.integers(0, 2 * W + 1, n)
    diag = (pos + W - j).astype(np.int32)
    r = dict(
        mapped=mapped, strand=rng.integers(0, 2, n).astype(np.int32),
        pos=pos, score=rng.integers(-32385, 32386, n).astype(np.int32),
        mapq=rng.integers(0, 38, n).astype(np.int32),
        x0=rng.integers(0, 2 * C + 1, n).astype(np.int32),
        x1=rng.integers(0, 2 * C + 1, n).astype(np.int32),
        ug_equal=rng.random(n) < 0.7,
        nm=rng.integers(0, 256, n).astype(np.int32), diag=diag,
        n_candidates=rng.integers(0, 2 * C + 1, n).astype(np.int32),
        tc_count=rng.integers(0, 256, n).astype(np.int32))
    r["diag"][:2] = r["pos"][:2] + W - np.array([0, 2 * W])
    r["mapped"][:4] = True
    r["score"][2:4] = (32385, -32385)
    for f in ("nm", "tc_count"):
        r[f][4] = 255
    for f in ("x0", "x1", "n_candidates"):
        r[f][5] = 2 * C
    r["mapped"][6:8] = False
    # what finalize gives an unmapped row
    for f, v in (("strand", 0), ("pos", -1), ("score", ta.NEG), ("mapq", 0),
                 ("x0", 0), ("x1", 0), ("nm", 0), ("diag", 0),
                 ("tc_count", 0)):
        r[f][~r["mapped"]] = v
    r["ug_equal"][~r["mapped"]] = True
    return r


@pytest.mark.parametrize("W", [3, 15])
def test_pack_result_equals_reference_and_round_trips(W):
    C = 127
    rows = _result_rows(W, C)
    want = jax.device_get(ja.pack_result(
        ja.AlignResult(**{k: jax.numpy.asarray(v) for k, v in rows.items()}),
        W))
    got = ta.pack_result(ta.AlignResult(
        **{k: torch.from_numpy(v) for k, v in rows.items()}), W)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape
        assert g.numpy().tobytes() == w.tobytes()
    assert [int(got.u8[r, 0]) >> 3 for r in (0, 1)] == [2 * W, 0]
    back = ta.unpack_result_host(
        ta.PackedResult(*(x.numpy() for x in got)), W)
    j_back = ja.unpack_result_host(want, W)
    for f in ta.AlignResult._fields:
        np.testing.assert_array_equal(getattr(back, f), rows[f], err_msg=f)
        np.testing.assert_array_equal(getattr(back, f),
                                      np.asarray(getattr(j_back, f)),
                                      err_msg=f)
        assert getattr(back, f).dtype == (bool if rows[f].dtype == bool
                                          else np.int32), f


def test_fetch_host_moves_each_field_in_its_own_dtype():
    """One transfer of a PackedResult is 13 bytes a read; fields of mixed
    widths (a 0-d count, int16, bool) come back in their dtypes and
    shapes."""
    rows = _result_rows(5, 8, n=33)
    res = ta.AlignResult(**{k: torch.from_numpy(v) for k, v in rows.items()})
    packed = ta.pack_result(res, 5)
    assert sum(x.numel() * x.element_size() for x in packed) == 13 * 33
    odd = ta.PackedJunctions(n_jun=torch.tensor(3, dtype=torch.int32),
                             row=torch.arange(5, dtype=torch.int32),
                             q0=torch.arange(5, dtype=torch.int32) * 7)
    (p, r, none, j) = talign.fetch_host(packed, res, None, odd)
    assert none is None
    for got, want in ((p, packed), (r, res), (j, odd)):
        for g, w in zip(got, want):
            assert g.dtype == w.numpy().dtype and g.shape == tuple(w.shape)
            np.testing.assert_array_equal(g, w.numpy())


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _packed_reads(ref, seed=900):
    rng = np.random.default_rng(seed)
    codes, lengths, _ = sample_reads(rng, ref, 64, 50, mutate=3, indel=True)
    codes[60:] = rng.integers(0, 4, size=(4, 50)).astype(np.int8)
    lengths[62] = 37               # a short read: the uint16 length path
    codes[62, 37:] = 4
    codes[59, 7] = codes[59, 31] = 4   # in-read Ns: the N mask
    lengths[63] = 0
    codes[63] = 4
    return codes, lengths


def test_align_device_packed_equals_reference(tiny_ref, tiny_index,
                                              small_cfg):
    """tests/test_jnp_aligner.py::test_packed_wire_path_bit_identical on
    both packages: the PackedResult bytes and the fused counts equal the
    JAX engine's, and the unpacked result equals the port's own
    align_device and profile_counts_device."""
    codes, lengths = _packed_reads(tiny_ref)
    jeng, teng = _engines(tiny_ref, tiny_index, small_cfg)
    assert jeng.supports_packed and teng.supports_packed
    jp, jcounts = jax.device_get(jeng.align_device_packed(
        codes, lengths, with_counts=True))
    tp, tcounts = teng.align_device_packed(codes, lengths, with_counts=True)
    (host,) = talign.fetch_host(tp)
    for g, w in zip(host, jp):
        assert g.tobytes() == np.asarray(w).tobytes()
    assert tcounts.numpy().dtype == np.asarray(jcounts).dtype
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    got = ta.unpack_result_host(host, small_cfg.band_width)
    ref_res = teng.align_device(codes, lengths)
    (want,) = talign.fetch_host(ref_res)
    for f in want._fields:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    np.testing.assert_array_equal(
        tcounts.numpy(),
        teng.profile_counts_device(codes, lengths, ref_res).numpy())
    assert bool(want.mapped.any()) and not bool(want.ug_equal.all())
    # to_host takes either form to the same records
    batch = ReadBatch(codes=codes, lengths=lengths)
    hp = teng.to_host(to_port(batch), tp)
    hu = teng.to_host(to_port(batch), ref_res)
    for f in HOST_FIELDS:
        np.testing.assert_array_equal(getattr(hp, f), getattr(hu, f))
    assert [hp.cigars[i] for i in range(64)] == \
        [hu.cigars[i] for i in range(64)]


SUPPORTS_GRID = {
    "bench": {},
    "W7": {"band_width": 7, "chrom_spacer": 100},
    "xa": {"xa_tags": True},
    "L256": {"max_read_len": 256, "chrom_spacer": 300},
    "C128": {"max_candidates": 128, "max_seeds": 8, "max_occ": 32},
    "W16": {"band_width": 16, "chrom_spacer": 100},
}


@pytest.mark.parametrize("name", list(SUPPORTS_GRID))
def test_supports_packed_equals_reference(name, tiny_ref, tiny_index,
                                          small_cfg):
    """The wire's bounds (L <= 255, 2C <= 255, W <= 15, no XA) give both
    engines the same answer. A band of W = 16 is refused by both configs
    (2W + 1 over the 16 lanes of the Pallas band tile), so W <= 15 never
    binds."""
    kw = dict(SUPPORTS_GRID[name])
    xa = kw.pop("xa_tags", False)
    if name == "W16":
        for cfg in (small_cfg, to_port(small_cfg)):
            with pytest.raises(ValueError, match="band"):
                cfg.replace(**kw)
        return
    cfg = small_cfg.replace(**kw)
    jeng, teng = _engines(tiny_ref, tiny_index, cfg, xa_tags=xa)
    assert teng.supports_packed == jeng.supports_packed
    assert teng.supports_packed == (name in ("bench", "W7"))


@pytest.mark.parametrize("name", ["unmapped_36bp", "over_cap"])
def test_rescue_on_the_packed_step_equals_reference(name, small_cfg,
                                                    tiny_ref, tiny_index):
    """The rescue tier takes the wire step at the smaller k, as the
    reference's does (pipeline/align.py:452-476): the same records and
    counters as the JAX engine, every rescue step a packed one."""
    from test_torch_modes import _rescue_reads

    cfg = small_cfg.replace(rescue_kmer=6)
    codes, lengths = _rescue_reads(name, tiny_ref)
    jeng, teng = _engines(tiny_ref, tiny_index, cfg)
    assert teng.supports_packed
    steps = []
    packed = teng._step_packed

    def counted(didx, cfg2, *a, **kw):
        steps.append(cfg2.kmer_size)
        return packed(didx, cfg2, *a, **kw)

    teng._step_packed = counted
    batch = ReadBatch(codes=codes, lengths=lengths)
    want = jeng.to_host(batch, jeng.align_device_packed(codes, lengths))
    got = teng.to_host(to_port(batch), teng.align_device_packed(codes,
                                                                lengths))
    for f in HOST_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert [got.cigars[i] for i in range(len(codes))] == \
        [want.cigars[i] for i in range(len(codes))]
    assert (teng.rescue_mapped, teng.rescue_overflow) == \
        (jeng.rescue_mapped, jeng.rescue_overflow)
    assert teng.rescue_mapped >= 3
    assert steps == [8, 6]


def _combined_engines(small_cfg):
    from test_torch_combined import _txs

    rng = np.random.default_rng(77)
    genome = {"chrA": rng.integers(0, 4, 6000).astype(np.int8)}
    out = []
    for mod, extra in ((jc, {}), (tc, {"device": "cpu"})):
        comb = mod.CombinedReference.build(genome, list(_txs(mod)),
                                           spacer=small_cfg.chrom_spacer)
        index = KmerIndex.build(comb.ref.seq, small_cfg.kmer_size)
        cfg = small_cfg
        if mod is tc:
            index, cfg = to_port(index), to_port(cfg)
        out.append(mod.CombinedEngine(comb, index, cfg, **extra))
    return genome, out


@pytest.mark.parametrize("seed", [99, 7])
def test_combined_packed_step_equals_reference(seed, small_cfg):
    """align_batch_combined_packed through both engines: the PackedResult,
    PackedCandidates and PackedJunctions records are byte-equal to the JAX
    package's, and to_host reads them to the same records."""
    from test_torch_combined import _random_soup

    genome, (jeng, teng) = _combined_engines(small_cfg)
    assert jeng.supports_packed and teng.supports_packed
    codes, lengths = _random_soup(genome, seed=seed)
    lengths[::9] = 44
    want = jax.device_get(jeng.align_device_packed(codes, lengths))
    got = talign.fetch_host(*teng.align_device_packed(codes, lengths))
    for g_rec, w_rec in zip(got, want):
        assert type(g_rec).__name__ == type(w_rec).__name__
        assert g_rec._fields == w_rec._fields
        for f, g, w in zip(w_rec._fields, g_rec, w_rec):
            w = np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape, f
            assert g.tobytes() == w.tobytes(), f
    assert int(got[1].n_sel) > 0 and int(got[2].n_jun) > 0
    batch = ReadBatch(codes=codes, lengths=lengths,
                      names=[f"r{i}" for i in range(len(codes))],
                      quals=[b"I" * int(x) for x in lengths])
    hw = jeng.to_host(batch, jeng.align_device_packed(codes, lengths))
    hg = teng.to_host(to_port(batch), teng.align_device_packed(codes,
                                                               lengths))
    for f in HOST_FIELDS:
        np.testing.assert_array_equal(getattr(hg, f), getattr(hw, f),
                                      err_msg=f)
    assert [hg.cigars[i] for i in range(len(codes))] == \
        [hw.cigars[i] for i in range(len(codes))]


# ---------------------------------------------------------------------------
# the implementation switches
# ---------------------------------------------------------------------------

SWITCHES = {
    "extend_impl": (ta.resolve_extend_fn, cuda_extend.extend_candidates,
                    cuda_extend.extend_candidates_plain),
    "select_impl": (ta.resolve_select_fn, cuda_seed.seed_select,
                    cuda_seed.seed_select_plain),
}


@pytest.mark.parametrize("impl", ["auto", "jnp", "pallas"])
@pytest.mark.parametrize("field", list(SWITCHES))
def test_resolve_fn_maps_like_the_reference(field, impl, tiny_ref,
                                            tiny_index, small_cfg):
    """"auto" is the wrapper (the kernel on CUDA tensors, the plain version
    on CPU tensors), "jnp" the plain version on every device, "pallas" the
    kernel alone: a CPU tensor raises. The config keeps the JAX package's
    JSON and hash."""
    resolve, wrapper, plain = SWITCHES[field]
    cfg = small_cfg.replace(**{field: impl})
    t_cfg = to_port(cfg)
    assert t_cfg.to_json() == cfg.to_json()
    fn = resolve(t_cfg)
    if impl == "auto":
        assert fn is wrapper
    elif impl == "jnp":
        assert fn is plain
    else:
        assert fn not in (wrapper, plain)
    codes, lengths = _packed_reads(tiny_ref, seed=31)
    jeng, teng = _engines(tiny_ref, tiny_index, cfg)
    if impl == "pallas":
        with pytest.raises(ValueError, match="NVIDIA GPU"):
            teng.align_device(codes, lengths)
        with pytest.raises(ValueError, match=field):
            teng.align_device_packed(codes, lengths)
        return
    (got,) = talign.fetch_host(teng.align_device(codes, lengths))
    _eq_fields(got, jax.device_get(jeng.align_device(codes, lengths)), impl)


# ---------------------------------------------------------------------------
# the stream and the CLI
# ---------------------------------------------------------------------------

def test_profile_pass_uploads_each_batch_once(tiny_ref, tiny_index,
                                              small_cfg, tmp_path):
    """twopass pass 1 (streaming_align with profile counts) on the wire:
    one upload a batch, one packed step a batch and no separate counts
    step; the SAM and the counts equal the JAX stream's, and the
    checkpoint's counts (the manifest's and the side file) equal them."""
    cfg = small_cfg.replace(batch_size=32)
    rng = np.random.default_rng(41)
    codes, lengths, _ = sample_reads(rng, tiny_ref, 150, 50, mutate=2,
                                     indel=True)
    fq = tmp_path / "r.fastq"
    write_fastq(fq, [f"q{i}" for i in range(150)], codes, lengths)
    jeng, teng = _engines(tiny_ref, tiny_index, cfg)
    calls = {"upload": 0, "packed": 0, "counts": 0}
    upload, step = teng._upload, teng.align_device_packed

    def counted_upload(*a):
        calls["upload"] += 1
        return upload(*a)

    def counted_step(*a, **kw):
        calls["packed"] += 1
        assert kw == {"with_counts": True}
        return step(*a, **kw)

    def no_counts_step(*a):
        calls["counts"] += 1
        raise AssertionError("a second counts step")

    teng._upload = counted_upload
    teng.align_device_packed = counted_step
    teng.profile_counts_device = no_counts_step
    got = tmp_path / "t.sam"
    n, t_counts, t_prof = t_stream(teng, fq, got, with_profile_counts=True,
                                   command_line="t")
    n_j, j_counts, j_prof = j_stream(jeng, fq, tmp_path / "j.sam",
                                     with_profile_counts=True,
                                     command_line="t")
    n_batches = -(-150 // 32)
    assert calls == {"upload": n_batches, "packed": n_batches, "counts": 0}
    assert (n, t_prof) == (n_j, j_prof) and n == 150
    np.testing.assert_array_equal(t_counts, j_counts)
    assert got.read_bytes() == (tmp_path / "j.sam").read_bytes()
    ckpt = StreamCheckpoint(got, to_port(cfg))
    state = ckpt.load()
    np.testing.assert_array_equal(
        ckpt.load_counts(t_counts.shape, state), t_counts)
    np.testing.assert_array_equal(np.load(ckpt.counts_path), t_counts)
    assert t_counts.sum() > 0


def test_cli_align_on_a_plain_index(tmp_path, tiny_ref, capsys):
    """`align` on a plain index through the port's CLI: the plain engine
    takes the wire step, and the JSON line carries none of the combined
    engine's projected-step counters."""
    from parasuite_tpu.io.fasta import write_fasta
    from parasuite_tpu_torch.cli import main

    write_fasta(tmp_path / "ref.fa",
                {name: tiny_ref.seq[tiny_ref.starts[i]:tiny_ref.ends[i]]
                 for i, name in enumerate(tiny_ref.names)})
    rng = np.random.default_rng(12)
    codes, lengths, _ = sample_reads(rng, tiny_ref, 40, 50, mutate=1)
    write_fastq(tmp_path / "r.fastq", [f"q{i}" for i in range(40)], codes,
                lengths)
    flags = ["--max-read-len", "50", "--kmer-size", "8", "--band-width", "3",
             "--batch-size", "16"]
    assert main(["index", str(tmp_path / "ref.fa"), str(tmp_path / "idx"),
                 *flags]) == 0
    capsys.readouterr()
    assert main(["align", str(tmp_path / "idx"), str(tmp_path / "r.fastq"),
                 str(tmp_path / "out.sam"), "--device", "cpu", *flags]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["reads"] == 40
    assert not any(k.startswith("packed_") for k in line)
