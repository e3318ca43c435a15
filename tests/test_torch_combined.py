"""The port's combined genome+transcriptome mode vs the JAX package: the
copied host functions, CombinedEngine.to_host against the reference's
unpacked and packed paths, profile counts from the emitted records,
combined XA, and whole CLI runs (combine, align --xa, twopass
--learned-gaps, twopass --rescue-kmer) compared file by file.

The cases are those of tests/test_combined.py. The port runs on CPU tensors
(the kernels' plain versions). Tolerance 0: integers, strings and bytes."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from parasuite_tpu.index import KmerIndex
from parasuite_tpu.io.batch import ReadBatch
from parasuite_tpu.io.fastq import write_fastq
from parasuite_tpu.pipeline import combined as jc
from parasuite_tpu.pipeline.stream import streaming_align as j_stream
from parasuite_tpu.utils.dna import revcomp_codes
from parasuite_tpu_torch.ops.aligner import AlignResult, CandidateTable
from parasuite_tpu_torch.pipeline import combined as tc
from parasuite_tpu_torch.pipeline.stream import streaming_align as t_stream

from conftest import sample_reads

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
HOST_FIELDS = ("mapped", "strand", "pos", "score", "mapq", "x0", "x1", "nm",
               "ug_equal", "tc_count")


@pytest.fixture(scope="module")
def genome():
    rng = np.random.default_rng(77)
    return {"chrA": rng.integers(0, 4, 6000).astype(np.int8)}


def _txs(mod):
    return (mod.Transcript("tx1", "chrA", "+",
                           np.asarray([1000, 2000, 3000], dtype=np.int64),
                           np.asarray([1200, 2200, 3100], dtype=np.int64)),
            mod.Transcript("tx2", "chrA", "-",
                           np.asarray([4000, 4500], dtype=np.int64),
                           np.asarray([4150, 4650], dtype=np.int64)))


def _mk_batch(codes, lengths):
    n = codes.shape[0]
    return ReadBatch(codes=codes, lengths=lengths,
                     names=[f"r{i}" for i in range(n)],
                     quals=[b"I" * int(lengths[i]) for i in range(n)])


def _hosts_equal(want, got, n):
    for f in HOST_FIELDS:
        np.testing.assert_array_equal(getattr(got, f)[:n],
                                      getattr(want, f)[:n], err_msg=f)
    for i in range(n):
        assert got.cigars[i] == want.cigars[i], i
    assert got.xa == want.xa


class _Buf:
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
# host copies
# ---------------------------------------------------------------------------

PROJECT_CASES = [  # (tx index, tx_pos, cigar, read strand)
    (0, 50, [("M", 100)], 0), (0, 150, [("M", 100)], 0),
    (0, 100, [("M", 250)], 0), (1, 0, [("M", 100)], 0),
    (1, 100, [("M", 100)], 0), (1, 100, [("M", 100)], 1),
    (0, 150, [("M", 30), ("D", 2), ("M", 68)], 0),
    (0, 150, [("M", 50), ("I", 3), ("M", 47)], 0),
    (0, 450, [("M", 100)], 0), (1, 260, [("M", 50)], 1),
    (0, 0, [("I", 5)], 0),
]


def _host_copy_case(name, genome, tmp_path):
    """-> (reference result, port result) of one copied host function."""
    if name == "splice_transcript":
        return tuple([mod.splice_transcript(genome, tx) for tx in _txs(mod)]
                     for mod in (jc, tc))
    if name == "project_to_genome":
        out = []
        for mod in (jc, tc):
            txs, res = _txs(mod), []
            for ti, p, cig, st in PROJECT_CASES:
                try:
                    res.append(mod.project_to_genome(txs[ti], p, cig, st))
                except ValueError as e:
                    res.append(("ValueError", str(e)))
            out.append(res)
        return tuple(out)
    if name == "is_single_m":
        cigars = [[("M", 50)], [("M", 25), ("N", 800), ("M", 25)],
                  [("I", 3)], [("M", 1), ("M", 1)]]
        return tuple([mod._is_single_m(c) for c in cigars]
                     for mod in (jc, tc))
    if name in ("parse_annotation", "parse_gtf"):
        tsv = tmp_path / "ann.tsv"
        tsv.write_text("#header\n"
                       "tx1\tchrA\t+\t1000,2000,3000\t1200,2200,3100\n"
                       "tx2\tchrA\t-\t4000,4500\t4150,4650\n")
        gtf = tmp_path / "ann.gtf"
        gtf.write_text(
            '#comment\n'
            'chrA\tsrc\ttranscript\t1001\t3100\t.\t+\t.\ttranscript_id "tx1";\n'
            'chrA\tsrc\texon\t2001\t2200\t.\t+\t.\ttranscript_id "tx1";\n'
            'chrA\tsrc\texon\t1001\t1200\t.\t+\t.\ttranscript_id "tx1";\n'
            'chrA\tsrc\texon\t3001\t3100\t.\t+\t.\ttranscript_id "tx1";\n'
            'chrA\tsrc\texon\t4001\t4150\t.\t-\t.\ttranscript_id "tx2";\n'
            'chrA\tsrc\texon\t4501\t4650\t.\t-\t.\ttranscript_id "tx2";\n')
        bad = tmp_path / "bad.tsv"
        bad.write_text("tx9\tchrA\t+\t100,50\t120,80\n")

        def parse(mod):
            fn = getattr(mod, name)
            txs = fn(tsv if name == "parse_annotation" else gtf)
            txs += mod.load_annotation(gtf) + mod.load_annotation(tsv)
            rows = [(t.tx_id, t.chrom, t.strand, t.exon_starts.tolist(),
                     t.exon_ends.tolist(), t.spliced_len,
                     t.cumlens.tolist()) for t in txs]
            with pytest.raises(ValueError, match="bad exon structure"):
                mod.parse_annotation(bad)
            return rows
        return parse(jc), parse(tc)
    # CombinedReference.build/save/load and build_combined_index: the files
    # either package writes are byte-identical, and each loads the other's
    from parasuite_tpu.io.fasta import write_fasta

    write_fasta(tmp_path / "g.fa", genome)
    (tmp_path / "ann.tsv").write_text(
        "tx1\tchrA\t+\t1000,2000,3000\t1200,2200,3100\n"
        "tx2\tchrA\t-\t4000,4500\t4150,4650\n")
    from parasuite_tpu.config import AlignConfig

    cfg = AlignConfig(max_read_len=50, kmer_size=8, band_width=3,
                      chrom_spacer=64)
    out = []
    for mod in (jc, tc):
        d = tmp_path / mod.__name__.split(".")[0]
        d.mkdir()
        if name == "build_combined_index":
            meta = mod.build_combined_index(tmp_path / "g.fa",
                                            tmp_path / "ann.tsv", d / "c",
                                            cfg)
        else:
            comb = mod.CombinedReference.build(genome, list(_txs(mod)), 64)
            comb.save(d / "c")
            meta = {"names": comb.ref.names}
        files = {p.name: p.read_bytes() for p in sorted(d.iterdir())}
        other = tc if mod is jc else jc
        back = other.CombinedReference.load(d / "c")
        loaded = (back.genome_names, back.ref.names, sorted(back.transcripts),
                  back.ref.seq.tobytes(),
                  [(t.exon_starts.tolist(), t.strand)
                   for t in back.transcripts.values()])
        out.append((meta, files, loaded))
    return tuple(out)


@pytest.mark.parametrize("name", ["splice_transcript", "project_to_genome",
                                  "is_single_m", "parse_annotation",
                                  "parse_gtf", "save_load",
                                  "build_combined_index"])
def test_host_copies_equal_reference(name, genome, tmp_path):
    want, got = _host_copy_case(name, genome, tmp_path)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


# ---------------------------------------------------------------------------
# CombinedEngine
# ---------------------------------------------------------------------------

def _engines(genome, cfg, txs=None, **kw):
    out = []
    for mod, extra in ((jc, {}), (tc, {"device": "cpu"})):
        comb = mod.CombinedReference.build(
            genome, list(txs[mod] if txs else _txs(mod)),
            spacer=cfg.chrom_spacer)
        index = KmerIndex.build(comb.ref.seq, cfg.kmer_size)
        out.append(mod.CombinedEngine(comb, index, cfg, **kw, **extra))
    return out


def _random_soup(genome, n=96, seed=99):
    """tests/test_combined.py's read soup: genomic, exonic and junction
    reads, 0-2 substitutions, half reverse-complemented."""
    rng = np.random.default_rng(seed)
    spl = [jc.splice_transcript(genome, tx) for tx in _txs(jc)]
    reads = []
    for _ in range(n):
        kind = rng.integers(0, 3)
        if kind == 0:
            p = int(rng.integers(0, 6000 - 50))
            r = genome["chrA"][p : p + 50].copy()
        else:
            s = spl[int(rng.integers(0, 2))]
            p = int(rng.integers(0, len(s) - 50))
            r = s[p : p + 50].copy()
        for _m in range(int(rng.integers(0, 3))):
            q = int(rng.integers(0, 50))
            r[q] = rng.integers(0, 4)
        if rng.random() < 0.5:
            r = revcomp_codes(r)
        reads.append(r)
    return np.stack(reads), np.full(n, 50, dtype=np.int32)


def _junction_reads(genome):
    """tests/test_combined.py::test_combined_align_junction_and_dedup."""
    s1, s2 = (jc.splice_transcript(genome, tx) for tx in _txs(jc))
    codes = np.stack([s1[175:225], s1[370:420], revcomp_codes(s1[175:225]),
                      s2[125:175], genome["chrA"][1050:1100],
                      genome["chrA"][5000:5050]])
    return codes, np.full(6, 50, dtype=np.int32)


@pytest.mark.parametrize("case", ["soup99", "soup7", "junctions",
                                  "indels_and_padding"])
def test_combined_to_host_equals_reference(case, genome, small_cfg):
    """Port to_host == the reference's unpacked path == its packed wire path
    (every HostAlignments field and CIGAR, junction N-CIGARs included), and
    the emitted SAM records are byte-identical."""
    if case == "junctions":
        codes, lengths = _junction_reads(genome)
    elif case == "indels_and_padding":
        comb = jc.CombinedReference.build(genome, list(_txs(jc)), 64)
        rng = np.random.default_rng(5)
        codes, lengths, _ = sample_reads(rng, comb.ref, 64, 50, mutate=1,
                                         indel=True)
        lengths[3] = 0
        codes[3] = 4
        lengths[4] = 41
        codes[4, 41:] = 4
    else:
        codes, lengths = _random_soup(genome, seed=int(case[4:]))
    jeng, teng = _engines(genome, small_cfg)
    assert jeng.supports_packed and not teng.supports_packed
    batch = _mk_batch(codes, lengths)
    want_u = jeng.to_host(batch, jeng.align_device(codes, lengths))
    want_p = jeng.to_host(batch, jeng.align_device_packed(codes, lengths))
    got = teng.to_host(batch, teng.align_device(codes, lengths))
    n = codes.shape[0]
    _hosts_equal(want_u, got, n)
    _hosts_equal(want_p, got, n)
    assert any(len(got.cigars[i]) > 1 for i in range(n))
    if case == "junctions":
        ci, local = teng.genome_ref.locate(got.pos)
        assert (int(local[0]), got.cigars[0]) == (
            1175, [("M", 25), ("N", 800), ("M", 25)])
        assert got.cigars[3] == [("M", 25), ("N", 350), ("M", 25)]
    assert _emitted(teng, batch, got) == _emitted(jeng, batch, want_u)


def test_combined_profile_counts_equal_reference(genome, small_cfg,
                                                 tmp_path):
    """Streamed SAM and the profile counts accumulated from the emitted
    records (counts_from_host) are equal to the reference's."""
    cfg = small_cfg.replace(batch_size=32)
    codes, lengths = _random_soup(genome, seed=13)
    fq = tmp_path / "soup.fastq"
    write_fastq(fq, [f"s{i}" for i in range(len(codes))], codes, lengths)
    outs = []
    for eng, run, name in zip(_engines(genome, cfg), (j_stream, t_stream),
                              ("jax", "torch")):
        indels: dict = {}
        out = tmp_path / f"{name}.sam"
        n, counts, n_prof = run(eng, fq, out, with_profile_counts=True,
                                indel_out=indels, command_line="t")
        outs.append((out.read_bytes(), n, counts, n_prof, indels))
    (jb, jn, jcnt, jp, ji), (tb, tn, tcnt, tp, ti) = outs
    assert tb == jb and (tn, tp) == (jn, jp) and tp > 0
    np.testing.assert_array_equal(tcnt, jcnt)
    assert ti["n_gapped"] == ji["n_gapped"]
    for key in ("ins", "dels"):
        np.testing.assert_array_equal(ti[key], ji[key])


def test_projection_failure_not_counted(genome, small_cfg):
    """tests/test_combined.py::test_projection_failure_not_counted on the
    port: a transcript winner whose projection fails ends unmapped and adds
    nothing to the profile."""
    _, teng = _engines(genome, small_cfg)
    cref = teng.combined.ref
    bad_pos = int(cref.starts[teng._n_genome]) + 500 - 10  # tx1 is 500 long
    B, n = 1, 2 * small_cfg.max_candidates
    z = torch.zeros((B, n), dtype=torch.int32)
    table = CandidateTable(valid=torch.zeros((B, n), dtype=torch.bool),
                           strand=z.clone(), pos=z.clone(), score=z.clone(),
                           ug_equal=torch.ones((B, n), dtype=torch.bool),
                           diag=z.clone())
    table.valid[0, 0] = True
    table.pos[0, 0] = bad_pos
    table.diag[0, 0] = bad_pos + small_cfg.band_width
    table.score[0, 0] = 300
    zb = torch.zeros(B, dtype=torch.int32)
    res = AlignResult(mapped=torch.zeros(B, dtype=torch.bool), strand=zb,
                      pos=zb - 1, score=zb, mapq=zb, x0=zb, x1=zb,
                      ug_equal=torch.ones(B, dtype=torch.bool), nm=zb,
                      diag=zb, n_candidates=zb, tc_count=zb)
    batch = _mk_batch(np.zeros((B, 50), dtype=np.int8),
                      np.full(B, 50, dtype=np.int32))
    host = teng.to_host(batch, (res, table))
    assert not host.mapped[0]
    L = small_cfg.max_read_len
    counts = np.zeros((L, 4, 4), dtype=np.int64)
    ins, dels = np.zeros(L, np.int64), np.zeros(L, np.int64)
    assert teng.accumulate_profile_host(batch, host, counts, ins,
                                        dels) == (0, 0)
    assert counts.sum() == 0


def test_combined_xa_equals_reference(small_cfg):
    """tests/test_combined.py::test_combined_xa_junction_alternate: a
    junction alternate with its N CIGAR (slow path) and a genomic duplicate
    (fast path) give the reference's XA strings, counters and records."""
    rng = np.random.default_rng(424)
    chrA = rng.integers(0, 4, 6000).astype(np.int8)
    starts = np.asarray([1000, 2000], dtype=np.int64)
    ends = np.asarray([1200, 2200], dtype=np.int64)
    txs = {m: [m.Transcript("txj", "chrA", "+", starts, ends)]
           for m in (jc, tc)}
    spliced = jc.splice_transcript({"chrA": chrA}, txs[jc][0])
    junction_read = spliced[175:225]
    chrA[100:150] = junction_read
    chrA[4000:4050] = chrA[5000:5050]
    jeng, teng = _engines({"chrA": chrA}, small_cfg, txs=txs, xa_tags=True)
    codes = np.stack([junction_read, chrA[4000:4050]])
    lengths = np.full(2, 50, dtype=np.int32)
    batch = _mk_batch(codes, lengths)
    want, got = jeng.align_to_host(batch), teng.align_to_host(batch)
    _hosts_equal(want, got, 2)
    assert got.xa[0] == "XA:Z:chrA,+1176,25M800N25M,0;"
    assert teng.xa_dropped == jeng.xa_dropped
    assert _emitted(teng, batch, got) == _emitted(jeng, batch, want)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def _cli(pkg, *argv, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-m", f"{pkg}.cli", *map(str, argv)],
                       capture_output=True, text=True, cwd=cwd, env=env,
                       timeout=600)
    assert p.returncode == 0, f"{pkg} cli failed: {p.stderr[-2000:]}"
    return json.loads(p.stdout.strip().splitlines()[-1])


FLAGS = ["--max-read-len", "50", "--kmer-size", "8", "--band-width", "3",
         "--batch-size", "64"]


def test_cli_combined_xa_rescue_byte_identical(tmp_path, genome):
    """combine, align --xa (SAM and BAM) on the combined index, twopass
    --learned-gaps on it, and index + twopass --learned-gaps --rescue-kmer
    on the genome alone, through both CLIs: every file is byte-identical."""
    from parasuite_tpu.io.fasta import write_fasta

    write_fasta(tmp_path / "g.fa", genome)
    (tmp_path / "ann.tsv").write_text(
        "tx1\tchrA\t+\t1000,2000,3000\t1200,2200,3100\n"
        "tx2\tchrA\t-\t4000,4500\t4150,4650\n")
    codes, lengths = _random_soup(genome, n=120, seed=21)
    codes[::7, 36:] = 4                # 36 bp reads with heavy mutation:
    lengths[::7] = 36                  # the k = 8 pass leaves some unmapped
    rng = np.random.default_rng(3)
    for b in range(0, 120, 7):
        q = rng.choice(36, 5, replace=False)
        codes[b, q] = (codes[b, q] + 1) % 4
    write_fastq(tmp_path / "r.fastq", [f"q{i}" for i in range(120)], codes,
                lengths)
    outs = {}
    for pkg, extra in (("parasuite_tpu", []),
                       ("parasuite_tpu_torch", ["--device", "cpu"])):
        d = tmp_path / pkg
        d.mkdir()
        fq = tmp_path / "r.fastq"
        _cli(pkg, "combine", tmp_path / "g.fa", tmp_path / "ann.tsv",
             d / "cidx", *FLAGS, cwd=d)
        _cli(pkg, "index", tmp_path / "g.fa", d / "gidx", *FLAGS, cwd=d)
        for out in ("xa.sam", "xa.bam"):
            _cli(pkg, "align", d / "cidx", fq, d / out, "--xa", "--pg-cl",
                 "x", *FLAGS, *extra, cwd=d)
        _cli(pkg, "twopass", d / "cidx", fq, d / "ctp.sam", "--learned-gaps",
             "--pg-cl", "x", *FLAGS, *extra, cwd=d)
        rs = _cli(pkg, "twopass", d / "gidx", fq, d / "rtp.bam",
                  "--learned-gaps", "--rescue-kmer", "6", "--pg-cl", "x",
                  *FLAGS, *extra, cwd=d)
        outs[pkg] = (d, rs)
    (jd, _), (td, trs) = outs["parasuite_tpu"], outs["parasuite_tpu_torch"]
    assert trs["rescue_mapped"] > 0
    names = sorted(p.name for p in jd.iterdir())
    assert names == sorted(p.name for p in td.iterdir())
    for name in ["cidx.combined.json", "xa.sam", "xa.bam", "ctp.sam",
                 "ctp.sam.pass1.sam", "ctp.sam.errorprofile", "rtp.bam",
                 "rtp.bam.pass1.sam", "rtp.bam.errorprofile"]:
        assert name in names
    for name in names:
        assert (td / name).read_bytes() == (jd / name).read_bytes(), name
    assert b"XA:Z:" in (td / "xa.sam").read_bytes()
    assert re.search(rb"\t\d+M\d+N\d+M", (td / "ctp.sam").read_bytes())
