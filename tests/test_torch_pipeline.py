"""The port's pipeline vs the JAX package: streamed SAM/BAM, profile counts,
resume, the CLI, and the copied host helpers — all byte- or array-identical.

The port runs on CPU tensors here (the kernels' plain versions). Both CLIs
write `@PG ID:parasuite_tpu` (io/sam.py); the tests pass the same --pg-cl to
both, so whole files compare byte for byte, header included."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from parasuite_tpu.io.fastq import write_fastq
from parasuite_tpu.ops import device_index as jdi
from parasuite_tpu.pipeline import align as jalign
from parasuite_tpu.pipeline import clusters as jclusters
from parasuite_tpu.pipeline.stream import streaming_align as j_stream
from parasuite_tpu.utils.dna import revcomp_codes
from parasuite_tpu_torch.ops import device_index as tdi
from parasuite_tpu_torch.pipeline import align as talign
from parasuite_tpu_torch.pipeline import clusters as tclusters
from parasuite_tpu_torch.pipeline.stream import streaming_align as t_stream

from conftest import sample_reads

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
N_READS = 100


@pytest.fixture(scope="module")
def cfg(small_cfg):
    return small_cfg.replace(batch_size=32)


@pytest.fixture(scope="module")
def engines(tiny_ref, tiny_index, cfg):
    return (jalign.AlignerEngine(tiny_ref, tiny_index, cfg),
            talign.AlignerEngine(tiny_ref, tiny_index, cfg, device="cpu"))


def _reads(ref, n=N_READS, seed=31):
    """Mutated reads with indels, T->C conversions, an all-N read and a
    short read: every record shape (ungapped, gapped, unmapped)."""
    rng = np.random.default_rng(seed)
    codes, lengths, _ = sample_reads(rng, ref, n, 50, mutate=1, indel=True)
    conv = (codes == 3) & (rng.random(codes.shape) < 0.1)
    codes = np.where(conv, 1, codes).astype(np.int8)
    codes[7] = 4
    lengths[9] = 37
    codes[9, 37:] = 4
    return codes, lengths


@pytest.fixture(scope="module")
def fastq(tmp_path_factory, tiny_ref):
    codes, lengths = _reads(tiny_ref)
    p = tmp_path_factory.mktemp("torch_stream") / "reads.fastq"
    write_fastq(p, [f"r{i}" for i in range(N_READS)], codes, lengths)
    return p


@pytest.mark.parametrize("ext", ["sam", "bam"])
def test_stream_byte_identical(engines, fastq, tmp_path, ext):
    """FASTQ -> SAM/BAM through streaming_align, profile counts and indel
    counts on: identical bytes, counts and indels."""
    jeng, teng = engines
    outs = {}
    for name, eng, run in (("jax", jeng, j_stream), ("torch", teng, t_stream)):
        indels: dict = {}
        out = tmp_path / f"{name}.{ext}"
        n, counts, n_prof = run(eng, fastq, out, with_profile_counts=True,
                                indel_out=indels, command_line="t")
        outs[name] = (out.read_bytes(), n, counts, n_prof, indels)
    (jb, jn, jc, jp, ji), (tb, tn, tc, tp, ti) = outs["jax"], outs["torch"]
    assert tb == jb
    assert (tn, tp) == (jn, jp) and tn == N_READS
    np.testing.assert_array_equal(tc, jc)
    assert ji["n_gapped"] == ti["n_gapped"] > 0
    for key in ("ins", "dels"):
        np.testing.assert_array_equal(ti[key], ji[key])


@pytest.mark.parametrize("ext", ["sam", "bam"])
def test_resume_byte_identical(engines, fastq, tmp_path, ext):
    """A run killed after batch 2, with bytes flushed past its last
    checkpoint, resumes to the same bytes and counts as an unbroken run."""
    _, teng = engines
    full = tmp_path / f"full.{ext}"
    _, c_full, p_full = t_stream(teng, fastq, full, with_profile_counts=True)

    # committed state after batches 1-2 = a complete run over 64 reads
    fq64 = tmp_path / "first64.fastq"
    fq64.write_bytes(b"".join(fastq.read_bytes().splitlines(keepends=True)
                              [: 64 * 4]))
    part = tmp_path / f"part.{ext}"
    t_stream(teng, fq64, part, with_profile_counts=True)
    manifest = Path(str(part) + ".progress.json")
    state = json.loads(manifest.read_text())
    with open(part, "r+b") as fh:
        fh.truncate(state["sam_bytes"])   # BAM: drop the EOF marker
        fh.seek(state["sam_bytes"])
        fh.write(b"\x1f\x8b junk past the checkpoint\n")
    manifest.write_text(json.dumps({**state, "complete": False,
                                    "batches_done": 2, "records": 64,
                                    "batch_records": [32, 32]}))

    n, c_res, p_res = t_stream(teng, fastq, part, resume=True,
                               with_profile_counts=True)
    assert n == N_READS
    assert part.read_bytes() == full.read_bytes()
    np.testing.assert_array_equal(c_res, c_full)
    assert p_res == p_full


def _cli(pkg, *argv, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-m", f"{pkg}.cli", *map(str, argv)],
                       capture_output=True, text=True, cwd=cwd, env=env,
                       timeout=600)
    assert p.returncode == 0, f"{pkg} cli failed: {p.stderr[-2000:]}"
    return json.loads(p.stdout.strip().splitlines()[-1])


CFG_FLAGS = ["--max-read-len", "50", "--kmer-size", "8", "--band-width", "3",
             "--batch-size", "64"]


def test_cli_align_and_twopass_byte_identical(tmp_path, tiny_ref, fastq):
    """index, align and twopass --learned-gaps through both CLIs: index files,
    SAMs, pass-1 SAM, .errorprofile, configs and checkpoint manifests are
    byte-identical."""
    from parasuite_tpu.io.fasta import write_fasta

    write_fasta(tmp_path / "ref.fa",
                {name: tiny_ref.seq[tiny_ref.starts[i]:tiny_ref.ends[i]]
                 for i, name in enumerate(tiny_ref.names)})
    outs = {}
    for pkg, extra in (("parasuite_tpu", []),
                       ("parasuite_tpu_torch", ["--device", "cpu"])):
        d = tmp_path / pkg
        d.mkdir()
        _cli(pkg, "index", tmp_path / "ref.fa", d / "idx", *CFG_FLAGS,
             cwd=d)
        _cli(pkg, "align", d / "idx", fastq, d / "al.sam", "--pg-cl", "x",
             *CFG_FLAGS, *extra, cwd=d)
        tp = _cli(pkg, "twopass", d / "idx", fastq, d / "tp.sam",
                  "--learned-gaps", "--pg-cl", "x", *CFG_FLAGS, *extra, cwd=d)
        outs[pkg] = (d, tp)
    (jd, jtp), (td, ttp) = outs["parasuite_tpu"], outs["parasuite_tpu_torch"]
    assert (ttp["gap_open"], ttp["gap_extend"]) == (jtp["gap_open"],
                                                   jtp["gap_extend"])
    assert ttp["device"] == "cpu"
    names = sorted(p.name for p in jd.iterdir())
    assert names == sorted(p.name for p in td.iterdir())
    for name in ["al.sam", "tp.sam.pass1.sam", "tp.sam.errorprofile",
                 "tp.sam", "tp.sam.config.json", "idx.config.json"]:
        assert name in names
    for name in names:
        assert (td / name).read_bytes() == (jd / name).read_bytes(), name


def _helper_case(name, engines, tiny_ref, cfg):
    """-> (reference result, port result) of one copied host helper."""
    rng = np.random.default_rng(77)
    if name == "min_scores_host":
        lens = rng.integers(0, 51, 500)
        return (jdi.min_scores_host(lens, cfg), tdi.min_scores_host(lens, cfg))
    if name == "tc_count_from_cigar":
        ref_seq = rng.integers(0, 5, 400).astype(np.int8)
        got, want = [], []
        for _ in range(200):
            ops = [(str(rng.choice(list("MIDN"))), int(rng.integers(1, 9)))
                   for _ in range(int(rng.integers(1, 6)))]
            read = rng.integers(0, 5, 60).astype(np.int8)
            args = (ref_seq, int(rng.integers(0, 300)), read,
                    int(rng.integers(0, 2)), ops)
            want.append(jclusters.tc_count_from_cigar(*args))
            got.append(tclusters.tc_count_from_cigar(*args))
        return want, got
    # host_traceback(s_batch) on the gapped winners of an indel batch
    _, teng = engines
    codes, lengths, _ = sample_reads(rng, tiny_ref, 32, 50, mutate=1,
                                     indel=True)
    res = teng.align_device(codes, lengths)
    mapped, ug = res.mapped.numpy(), res.ug_equal.numpy()
    rows = np.nonzero(mapped & ~ug)[0]
    assert rows.shape[0] > 0
    strand, diag = res.strand.numpy()[rows], res.diag.numpy()[rows]
    om = np.full((rows.shape[0], 50), 4, dtype=np.int8)
    for k, b in enumerate(rows):
        om[k] = codes[b] if strand[k] == 0 else revcomp_codes(codes[b])
    if name == "host_traceback":
        want, got = [], []
        for k, b in enumerate(rows):
            args = (tiny_ref.seq, teng.s_tensor, teng.s_comp, cfg, om[k],
                    int(lengths[b]), int(strand[k]), int(diag[k]))
            want.append(jalign.host_traceback(*args))
            got.append(talign.host_traceback(*args))
        return want, got
    args = (tiny_ref.seq, teng.s_tensor, teng.s_comp, cfg, om, lengths[rows],
            strand, diag)
    return (jalign.host_tracebacks_batch(*args),
            talign.host_tracebacks_batch(*args))


@pytest.mark.parametrize("helper", ["host_traceback", "host_tracebacks_batch",
                                    "tc_count_from_cigar", "min_scores_host"])
def test_host_helper_copies_equal_reference(helper, engines, tiny_ref, cfg):
    want, got = _helper_case(helper, engines, tiny_ref, cfg)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g, w) if isinstance(g, np.ndarray) else g == w


def test_engine_refuses_what_it_cannot_run(tiny_ref, tiny_index, cfg):
    """No silent fallback: a missing CUDA device is an error, and combined
    mode refuses rescue as the reference does."""
    from parasuite_tpu_torch.pipeline.combined import (CombinedEngine,
                                                       CombinedReference)

    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA error path")
    with pytest.raises(RuntimeError, match="cuda"):
        talign.AlignerEngine(tiny_ref, tiny_index, cfg, device="cuda")
    genome = {name: tiny_ref.seq[tiny_ref.starts[i]:tiny_ref.ends[i]]
              for i, name in enumerate(tiny_ref.names)}
    comb = CombinedReference.build(genome, [], spacer=cfg.chrom_spacer)
    with pytest.raises(ValueError, match="rescue_kmer"):
        CombinedEngine(comb, tiny_index, cfg.replace(rescue_kmer=6),
                       device="cpu")


@pytest.mark.parametrize("mode", ["xa", "rescue"])
def test_xa_and_rescue_engines_run_on_cpu(mode, tiny_ref, tiny_index, cfg):
    """The XA and rescue engines build and run on CPU tensors: XA strings
    for a read with an alternate, rescued reads for 36 bp reads the k = 8
    pass leaves unmapped."""
    from parasuite_tpu.io.batch import ReadBatch

    rng = np.random.default_rng(12)
    if mode == "xa":
        eng = talign.AlignerEngine(tiny_ref, tiny_index, cfg, xa_tags=True,
                                   device="cpu")
        codes, lengths, _ = sample_reads(rng, tiny_ref, 32, 50, mutate=6)
    else:
        eng = talign.AlignerEngine(tiny_ref, tiny_index,
                                   cfg.replace(rescue_kmer=6), device="cpu")
        codes, lengths, _ = sample_reads(rng, tiny_ref, 64, 36, mutate=5)
        codes = np.concatenate(
            [codes, np.full((64, 14), 4, dtype=np.int8)], axis=1)
    host = eng.align_to_host(ReadBatch(codes=codes, lengths=lengths))
    assert host.mapped.any()
    if mode == "xa":
        assert len(host.xa) == 32 and eng.xa_dropped >= 0
        assert all(x is None or x.startswith("XA:Z:") for x in host.xa)
    else:
        assert eng.rescue_mapped > 0 and host.xa is None
        assert host.mapped[eng.last_rescue_rows].all()
