"""The port's own copies of the host layers (config, utils, index, io,
native, oracle, errormodel, the CLI helpers) against the JAX package's: the
same inputs, made from a seed with numpy, go through the same function of
both packages and give equal results — arrays with equal dtype and values,
files with equal bytes, tolerance 0. An index written by either package
loads in the other, and convert.py builds the port's objects from the JAX
package's arrays and dicts.

Each case is a function of (package namespace, scratch directory) that
returns plain data; it runs once per package.

One copy differs from its original by design, in more than its imports:
native/__init__.py builds the C++ library under a per-process name and
renames it into place (so processes that start together never load a
half-written file), and says so once on stderr when the build or the load
fails; native/Makefile takes the output's name for that. What the library
computes is held to the original's here all the same (native_library), and
tests/test_torch_tools.py starts two processes on a directory without the
library."""

import contextlib
import dataclasses
import gzip
import importlib
import io
import json
from types import SimpleNamespace

import numpy as np
import pytest

from _torch_helpers import to_port

MODULES = {"config": "config", "dna": "utils.dna", "runlog": "utils.runlog",
           "reference": "index.reference", "kmer": "index.kmer",
           "fasta": "io.fasta", "fastq": "io.fastq", "batch": "io.batch",
           "sam": "io.sam", "bam": "io.bam", "oracle": "oracle.align",
           "infer": "errormodel.infer", "scoring": "errormodel.scoring",
           "native": "native", "cli": "cli", "stream": "pipeline.stream"}


def _package(base):
    return SimpleNamespace(base=base, **{
        name: importlib.import_module(f"{base}.{mod}")
        for name, mod in MODULES.items()})


@pytest.fixture(scope="module")
def packages():
    return _package("parasuite_tpu"), _package("parasuite_tpu_torch")


def _plain(x):
    """Results as plain data: dataclasses and name blocks unpacked, so
    equality never depends on which package's class holds the values."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if hasattr(x, "blob") and hasattr(x, "off"):      # NameBlock
        return list(x)
    return x


def _assert_same(a, b, where="result"):
    assert type(a) is type(b), f"{where}: {type(a)} vs {type(b)}"
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


# ---------------------------------------------------------------------------
# shared inputs (numpy, from seeds)
# ---------------------------------------------------------------------------

CFG_KW = dict(max_read_len=50, batch_size=16, kmer_size=8, max_seeds=4,
              max_occ=32, max_candidates=8, band_width=3, chrom_spacer=64)


def _genome(seed=11):
    rng = np.random.default_rng(seed)
    seqs = {"chrA": rng.integers(0, 4, 3000).astype(np.int8),
            "chrB": rng.integers(0, 4, 1800).astype(np.int8)}
    seqs["chrA"][700:712] = 4
    seqs["chrB"][100:140] = seqs["chrA"][200:240]      # a repeat
    return seqs


def _reads(P, ref, n=36, L=50, seed=12):
    """Reads off the packed reference: substitutions, a deletion in every
    third, half reverse strand, one all-N, one short."""
    rng = np.random.default_rng(seed)
    codes = np.full((n, L), 4, dtype=np.int8)
    lengths = np.full(n, L, dtype=np.int32)
    for i in range(n):
        ci = int(rng.integers(0, len(ref.names)))
        while True:
            p = int(rng.integers(ref.starts[ci], ref.ends[ci] - L - 1))
            frag = ref.seq[p:p + L + 1].copy()
            if not np.any(frag == 4):
                break
        if i % 3 == 0:
            cut = int(rng.integers(5, L - 5))
            frag = np.delete(frag, cut)
        frag = frag[:L]
        for _ in range(int(rng.integers(0, 3))):
            q = int(rng.integers(0, L))
            frag[q] = (frag[q] + 1 + rng.integers(0, 3)) % 4
        codes[i] = P.dna.revcomp_codes(frag) if i % 2 else frag
    codes[5] = 4
    lengths[7] = 36
    codes[7, 36:] = 4
    quals = rng.integers(35, 74, (n, L)).astype(np.uint8)
    return codes, lengths, [f"read{i}" for i in range(n)], quals


_WORLDS = {}


def _world(P):
    """cfg, packed reference, index, reads and a SAM text (oracle
    alignments formatted by the package's own io.sam), once per package."""
    if P.base in _WORLDS:
        return _WORLDS[P.base]
    cfg = P.config.AlignConfig(**CFG_KW)
    ref = P.reference.PackedReference.from_dict(_genome(),
                                                spacer=cfg.chrom_spacer)
    index = P.kmer.build_index(ref, cfg.kmer_size)
    codes, lengths, names, quals = _reads(P, ref)
    s = P.scoring.flat_score_tensor(cfg)
    alns = P.oracle.align_batch_oracle(codes, lengths, ref, index, s, cfg)
    lines = [P.sam.format_record(
        names[i], codes[i], int(lengths[i]), quals[i].tobytes(), ref,
        mapped=a.mapped, strand=a.strand, packed_pos=a.packed_pos,
        mapq=a.mapq, cigar=a.cigar, score=a.score, nm=a.nm, x0=a.x0, x1=a.x1)
        for i, a in enumerate(alns)]
    sam_text = P.sam.sam_header(ref, command_line="copies") + "".join(
        line + "\n" for line in lines)
    w = SimpleNamespace(cfg=cfg, ref=ref, index=index, codes=codes,
                        lengths=lengths, names=names, quals=quals, s=s,
                        alns=alns, sam_text=sam_text)
    _WORLDS[P.base] = w
    return w


def _write_sam(P, tmp):
    path = tmp / "in.sam"
    path.write_text(_world(P).sam_text)
    return path


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

def config_json(P, tmp):
    C = P.config.AlignConfig
    cfgs = [C(), C(**CFG_KW), C(**CFG_KW, rescue_kmer=6, seed_stride=4),
            C(max_read_len=36, kmer_size=11, seed=7)]
    return [[c.to_json(), C.from_json(c.to_json()).to_json(),
             dataclasses.asdict(c)] for c in cfgs]


def config_cfg_hash(P, tmp):
    C = P.config.AlignConfig
    return [P.stream._cfg_hash(c) for c in
            (C(), C(**CFG_KW), C(**CFG_KW).replace(batch_size=4096),
             C(**CFG_KW, rescue_kmer=6))]


def config_derived_and_refusals(P, tmp):
    C = P.config.AlignConfig
    c = C(**CFG_KW, seed_stride=5)
    derived = {n: getattr(c, n) for n in dir(c)
               if not n.startswith("_") and not callable(getattr(c, n))}
    refusals = []
    for kw in (dict(chrom_spacer=10), dict(seed_stride=-1),
               dict(seed_placement="x"), dict(kmer_size=16),
               dict(rescue_kmer=12), dict(rescue_kmer=3),
               dict(match_score=200), dict(nonsense=1)):
        with pytest.raises((ValueError, TypeError)) as e:
            C(**kw)
        refusals.append(str(e.value).replace(P.base, "PKG"))
    return [derived, refusals, [c.min_score(n) for n in (0, 20, 36, 50)]]


def utils_dna(P, tmp):
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 5, 200).astype(np.int8)
    text = P.dna.decode_seq(codes)
    return [text, P.dna.encode_seq(text), P.dna.encode_seq(text.encode()),
            P.dna.encode_seq("acgtnNRyx-"), P.dna.revcomp_codes(codes),
            P.dna.complement_codes(codes), np.asarray(P.dna.COMP),
            np.asarray(P.dna.CODE_TO_BASE), dict(P.dna.BASE_TO_CODE)
            if isinstance(P.dna.BASE_TO_CODE, dict)
            else np.asarray(P.dna.BASE_TO_CODE),
            [P.dna.A, P.dna.C, P.dna.G, P.dna.T, P.dna.N]]


def utils_runlog(P, tmp):
    log = P.runlog.RunLog(tmp / "run.jsonl", run_id="r1")
    recs = [log.event("align.start", reads=10),
            log.event("align.done", reads=10, rate=2.5, nested={"a": [1]})]
    log.close()
    lines = [json.loads(x) for x in (tmp / "run.jsonl").read_text()
             .splitlines()]
    for r in (*recs, *lines):
        assert isinstance(r.pop("ts"), float)
    return [recs, lines, P.runlog.NULL_LOG.event("x", k=1).keys() >= {"k"}]


def index_reference(P, tmp):
    ref = _world(P).ref
    pos = np.random.default_rng(4).integers(-5, ref.total_len + 5, 300)
    return [ref, ref.total_len, [ref.chrom_len(i) for i in range(2)],
            list(ref.locate(pos))]


def index_kmer(P, tmp):
    w = _world(P)
    codes, valid = P.kmer.kmer_codes(w.ref.seq, 8)
    py = P.kmer.KmerIndex.build(w.ref.seq, 8, use_native="never")
    auto = P.kmer.KmerIndex.build(w.ref.seq, 8)
    k5 = P.kmer.KmerIndex.build(w.ref.seq[:500], 5, use_native="never")
    return [codes, valid, py, auto, k5, py.n_kmers,
            [py.lookup(c) for c in (0, 77, 4 ** 8 - 1)]]


def index_files(P, tmp):
    w = _world(P)
    w.ref.save(tmp / "idx")
    w.index.save(tmp / "idx")
    files = {p.name: p.read_bytes() for p in sorted(tmp.glob("idx.*"))
             if p.suffix != ".npz"}
    with np.load(tmp / "idx.kidx.npz") as z:
        files["kidx"] = {k: z[k] for k in z.files}
    return [files, P.reference.PackedReference.load(tmp / "idx"),
            P.kmer.KmerIndex.load(tmp / "idx")]


def io_fasta(P, tmp):
    seqs = _genome()
    P.fasta.write_fasta(tmp / "g.fa", seqs)
    P.fasta.write_fasta(tmp / "g61.fa", seqs, width=61)
    P.fasta.write_fasta(tmp / "g.fa.gz", seqs)
    (tmp / "odd.fa").write_text(">s1 description here\nacgtNN\nRYKM\n\n"
                                ">s2\n\nTTTT\n")
    return [(tmp / "g.fa").read_bytes(), (tmp / "g61.fa").read_bytes(),
            P.fasta.read_fasta(tmp / "g.fa"),
            P.fasta.read_fasta(tmp / "g.fa.gz"),
            P.fasta.read_fasta(tmp / "odd.fa")]


def io_fastq(P, tmp):
    w = _world(P)
    P.fastq.write_fastq(tmp / "r.fastq", w.names, w.codes, w.lengths,
                        w.quals)
    P.fastq.write_fastq(tmp / "flat.fastq", w.names, w.codes, w.lengths)
    P.fastq.write_fastq(tmp / "r.fastq.gz", w.names, w.codes, w.lengths,
                        [w.quals[i, :int(w.lengths[i])].tobytes()
                         for i in range(len(w.names))])
    batches = [list(P.fastq.iter_fastq_batches(tmp / f, 16, 50))
               for f in ("r.fastq", "r.fastq.gz")]
    groups = list(P.fastq._iter_groups_python(tmp / "r.fastq", 10, 40))
    return [(tmp / "r.fastq").read_bytes(), (tmp / "flat.fastq").read_bytes(),
            P.fastq.read_fastq(tmp / "r.fastq", 50),
            P.fastq.read_fastq(tmp / "r.fastq", 40, batch_size=16),
            batches, groups, P.fastq.count_fastq_records(tmp / "r.fastq"),
            list(P.fastq._iter_records(tmp / "r.fastq.gz"))[:3]]


def io_batch(P, tmp):
    w = _world(P)
    seqs = [w.codes[i, :int(w.lengths[i])] for i in range(9)]
    quals = [w.quals[i, :int(w.lengths[i])].tobytes() for i in range(9)]
    b = P.batch.ReadBatch.from_arrays(seqs, w.names[:9], quals, 44, pad_to=12)
    nb = P.batch.NameBlock.from_list(w.names[:9])
    cat = P.batch.NameBlock.concat([nb, P.batch.NameBlock.from_list(["zz"])])
    return [b, b.n_total, b.n_real, b.max_len, b.qual_bytes(7), list(nb),
            nb[2:5], list(nb.raw(3, 6)), list(cat), len(cat),
            P.batch.ReadBatch(codes=w.codes[:4], lengths=w.lengths[:4])]


def io_sam(P, tmp):
    w = _world(P)
    cig = [("M", 20), ("I", 2), ("M", 10), ("D", 3), ("M", 18)]
    text = P.sam.cigar_string(cig)
    path = _write_sam(P, tmp)
    with P.sam.SamWriter(tmp / "w.sam", w.ref, command_line="x y") as wr:
        wr.write("a\t4\t*\t0\t0\t*\t*\t0\t0\tACGT\tIIII")
        wr.write_block(b"b\t4\t*\t0\t0\t*\t*\t0\t0\tAC\tII\n")
        n = wr.n_records
    P.sam.merge_shards(tmp / "m.sam", [path, tmp / "w.sam"], w.ref, "merge")
    return [w.sam_text, P.sam.sam_header(w.ref, "coordinate"), text,
            P.sam.parse_cigar(text), P.sam.parse_cigar("*"),
            P.sam.cigar_ref_span(cig), P.sam.cigar_string(None),
            P.sam.md_tag(w.ref.seq, int(w.ref.starts[0]) + 40, cig,
                         w.codes[0]),
            list(P.sam.read_sam(path)), (tmp / "w.sam").read_text(), n,
            (tmp / "m.sam").read_text(), w.alns]


def io_bam(P, tmp):
    w = _world(P)
    path = _write_sam(P, tmp)
    n1 = P.bam.sam_to_bam(path, tmp / "a.bam")
    n2 = P.bam.bam_to_sam(tmp / "a.bam", tmp / "back.sam")
    rid = {n: i for i, n in enumerate(w.ref.names)}
    recs = [line.split("\t") for line in w.sam_text.splitlines()
            if not line.startswith("@")]
    enc = [P.bam.encode_bam_record(f, rid) for f in recs]
    dec = [P.bam.decode_bam_record(e[4:], w.ref.names) for e in enc]
    with gzip.open(tmp / "a.bam", "rb") as fh:
        header = list(P.bam.read_bam_header(fh))
    out = P.bam.BgzfWriter(tmp / "raw.bgzf")
    out.write(b"parasuite" * 20000)
    out.close()
    return [n1, n2, (tmp / "a.bam").read_bytes(),
            (tmp / "back.sam").read_text() == w.sam_text, enc, dec, header,
            (tmp / "raw.bgzf").read_bytes(), P.bam.BGZF_EOF,
            [P.bam._reg2bin(b, e) for b, e in ((0, 1), (70000, 200000),
                                               (2 ** 26, 2 ** 26 + 5))]]


def io_bam_sort(P, tmp):
    path = _write_sam(P, tmp)
    P.bam.sam_to_bam(path, tmp / "a.bam")
    runs = {}
    for name, src, dst, kw in (
            ("sam", path, "s.sam", {}),
            ("bam", tmp / "a.bam", "s.bam", {}),
            ("bam_python", tmp / "a.bam", "p.bam", {"native_ok": False}),
            ("spill", path, "sp.sam", {"max_in_memory": 7}),
            ("bam_spill", tmp / "a.bam", "sp.bam", {"max_in_memory": 7}),
            ("filter", path, "f.bam", {"min_mapq": 20, "mapped_only": True}),
            ("bam_to_sam", tmp / "a.bam", "x.sam", {"min_mapq": 1})):
        n = P.bam.coordinate_sort(src, tmp / dst, **kw)
        runs[name] = [n, (tmp / dst).read_bytes()]
    assert runs["bam"][1] == runs["bam_python"][1] == runs["bam_spill"][1]
    return runs


def oracle_align(P, tmp):
    w = _world(P)
    W, L = w.cfg.band_width, 50
    s_comp = P.scoring.complement_score_tensor(w.s)
    seeds = [P.oracle.seed_candidates(w.codes[i], int(w.lengths[i]), w.index,
                                      w.cfg) for i in range(8)]
    tables = []
    for i in (0, 3, 6, 9):
        diag = w.alns[i].diag if w.alns[i].mapped else int(w.ref.starts[0])
        for shift in (0, 1, -2):
            refwin = P.oracle._ref_window(w.ref.seq, diag + shift, L, W)
            rows = P.oracle._score_rows(w.s, w.codes[i], L, 0)
            dp = P.oracle.banded_dp(rows, refwin, L, w.cfg, keep_tables=True)
            tb = P.oracle.traceback_alignment(dp[4], rows, refwin, L, dp[1],
                                              w.cfg)
            tables.append([refwin, rows, _plain(dp),
                           P.oracle.banded_dp(rows, refwin, L, w.cfg),
                           _plain(tb)])
    one = P.oracle.align_read(w.codes[2], 50, w.ref, w.index, w.s, w.cfg,
                              s_comp)
    return [seeds, tables, w.alns, one, [P.oracle._mapq(a, b) for a, b in
                                         ((1, 0), (1, 3), (2, 0), (9, 9))]]


def errormodel_scoring(P, tmp):
    C = P.config.AlignConfig
    rng = np.random.default_rng(8)
    probs = rng.dirichlet(np.ones(4), (50, 4))
    out = []
    for cfg in (C(**CFG_KW), C(max_read_len=36), C(**CFG_KW, match_score=2)):
        flat = P.scoring.flat_score_tensor(cfg)
        out += [flat, P.scoring.flat_score_tensor(cfg, 20),
                P.scoring.complement_score_tensor(flat)]
    prof = P.scoring.profile_score_tensor(probs, C(**CFG_KW))
    return [*out, prof, P.scoring.complement_score_tensor(prof)]


def errormodel_infer(P, tmp):
    w = _world(P)
    a = w.alns
    mapped = np.asarray([x.mapped for x in a])
    strand = np.asarray([x.strand if x.mapped else 0 for x in a], np.int32)
    pos = np.asarray([x.packed_pos if x.mapped else 0 for x in a], np.int64)
    ungapped = np.asarray([x.mapped and len(x.cigar) == 1 for x in a])
    prof = P.infer.infer_counts_numpy(w.codes, w.lengths, mapped, strand, pos,
                                      w.ref, 50, ungapped_only=ungapped)
    gapped = []
    for i, x in enumerate(a):
        if x.mapped and len(x.cigar) > 1:
            read = P.dna.revcomp_codes(w.codes[i]) if x.strand else w.codes[i]
            sub = np.zeros((50, 4, 4), dtype=np.int64)
            P.infer.count_substitutions_from_cigar(
                w.ref.seq, x.packed_pos, read, 50, x.strand, x.cigar, sub)
            ins, dele = np.zeros(50, np.int64), np.zeros(50, np.int64)
            P.infer.count_indels_from_cigar(x.cigar, 50, x.strand, ins, dele)
            prof.ins_counts += ins
            prof.del_counts += dele
            prof.n_gapped += 1
            gapped.append([i, sub, ins, dele])
    assert gapped, "the world has no gapped winner"
    prof.save(tmp / "p.errorprofile")
    back = P.infer.ErrorProfile.load(tmp / "p.errorprofile")
    return [prof, gapped, (tmp / "p.errorprofile").read_bytes(), back,
            prof.probs(), prof.conversion_rate(3, 1), list(prof.indel_rates()),
            list(prof.gap_penalties(w.cfg)), prof.read_len,
            P.infer.counts_to_profile(prof, w.cfg),
            P.infer.counts_to_profile(back, w.cfg.replace(max_read_len=60,
                                                          chrom_spacer=128))]


def native_library(P, tmp):
    """The C++ fast paths against each other (and, inside io_* cases,
    against the numpy paths). Needs the library, which builds here."""
    w = _world(P)
    assert P.native.available(), "the native library did not build"
    assert P.base in str(P.native._LIB_PATH.parent).split("/")
    starts, positions = P.native.kmer_index_build(w.ref.seq, 8)
    P.fastq.write_fastq(tmp / "r.fastq", w.names, w.codes, w.lengths,
                        w.quals)
    buf = (tmp / "r.fastq").read_bytes()
    scan = list(P.native.fastq_scan_chunk(buf, 20, 50))
    scan2 = list(P.native.fastq_scan_chunk(bytearray(buf), 64, 40,
                                           length=len(buf) // 2))
    path = _write_sam(P, tmp)
    P.bam.sam_to_bam(path, tmp / "a.bam")
    data = bytes(np.random.default_rng(9).integers(0, 7, 200_000)
                 .astype(np.uint8))
    return [starts, positions, scan, scan2,
            P.native.bgzf_compress(data), P.native.bgzf_compress(data, 1),
            list(P.native.sam_cluster_columns(path, w.ref)),
            list(P.native.bam_cluster_columns(tmp / "a.bam", w.ref))]


def _cli(P, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert P.cli.main([str(a) for a in argv]) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def cli_helpers(P, tmp):
    import argparse

    parser = argparse.ArgumentParser()
    P.cli._add_cfg_flags(parser)
    flags = ["--max-read-len", "50", "--kmer-size", "8", "--band-width", "3",
             "--max-candidates", "4", "--max-occ", "9", "--max-seeds", "5",
             "--seed-stride", "6", "--batch-size", "32", "--rescue-kmer", "6",
             "--seed", "3"]
    cfgs = [P.cli._cfg_from_args(parser.parse_args(a)).to_json()
            for a in ([], flags, flags[:4])]
    P.fasta.write_fasta(tmp / "g.fa", _genome())
    path = _write_sam(P, tmp)
    out = [_cli(P, ["index", tmp / "g.fa", tmp / "idx", "--kmer-size", "8",
                    "--max-read-len", "50"]),
           _cli(P, ["convert", path, tmp / "c.bam"]),
           _cli(P, ["convert", tmp / "c.bam", tmp / "c.sam"]),
           _cli(P, ["sort", tmp / "c.bam", tmp / "s.bam"]),
           _cli(P, ["sort", path, tmp / "s.sam", "--min-mapq", "10",
                    "--mapped-only"])]
    for o in out:
        o.pop("out", None)                  # a path under the scratch dir
    with pytest.raises(SystemExit):
        P.cli.main(["convert", str(path), str(tmp / "again.sam")])
    files = {p.name: p.read_bytes() for p in sorted(tmp.iterdir())
             if p.suffix != ".npz"}
    with np.load(tmp / "idx.kidx.npz") as z:
        files["kidx"] = {k: z[k] for k in z.files}
    return [cfgs, out, files]


CASES = [config_json, config_cfg_hash, config_derived_and_refusals, utils_dna,
         utils_runlog, index_reference, index_kmer, index_files, io_fasta,
         io_fastq, io_batch, io_sam, io_bam, io_bam_sort, oracle_align,
         errormodel_scoring, errormodel_infer, native_library, cli_helpers]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_copy_equals_reference(case, packages, tmp_path):
    results = []
    for P in packages:
        scratch = tmp_path / P.base
        scratch.mkdir()
        results.append(_plain(case(P, scratch)))
    _assert_same(*results, where=case.__name__)


# ---------------------------------------------------------------------------
# state carried across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", [0, 1], ids=["jax_writes", "port_writes"])
def test_index_written_by_one_loads_in_the_other(writer, packages, tmp_path):
    W, R = packages[writer], packages[1 - writer]
    w = _world(W)
    w.ref.save(tmp_path / "idx")
    w.index.save(tmp_path / "idx")
    (tmp_path / "idx.config.json").write_text(w.cfg.to_json())
    ref = R.reference.PackedReference.load(tmp_path / "idx")
    index = R.kmer.KmerIndex.load(tmp_path / "idx")
    cfg = R.config.AlignConfig.from_json(
        (tmp_path / "idx.config.json").read_text())
    assert type(ref).__module__.split(".")[0] == R.base
    _assert_same(_plain(ref), _plain(w.ref))
    _assert_same(_plain(index), _plain(w.index))
    assert cfg.to_json() == w.cfg.to_json()
    # and it aligns the same there
    r = _world(R)
    alns = R.oracle.align_batch_oracle(r.codes[:8], r.lengths[:8], ref, index,
                                       r.s, cfg)
    _assert_same(_plain(alns), _plain(w.alns[:8]))


def _is_port(obj):
    return type(obj).__module__.startswith("parasuite_tpu_torch.")


@pytest.mark.parametrize("what", ["align_config", "packed_reference",
                                  "kmer_index", "error_profile",
                                  "read_batch"])
def test_convert_builds_the_ports_objects(what, packages, tmp_path):
    from parasuite_tpu_torch import convert

    J, T = packages
    w = _world(J)
    if what == "align_config":
        src = w.cfg.replace(rescue_kmer=6)
        got = convert.align_config(dataclasses.asdict(src))
        assert got.to_json() == src.to_json()
        assert T.stream._cfg_hash(got) == J.stream._cfg_hash(src)
        with pytest.raises(TypeError):
            convert.align_config({"no_such_field": 1})
    elif what == "packed_reference":
        src = w.ref
        got = convert.packed_reference(src.seq, src.names, src.starts,
                                       src.ends)
        assert got.seq is src.seq                      # shared, not copied
    elif what == "kmer_index":
        src = w.index
        got = convert.kmer_index(src.k, src.bucket_starts, src.positions)
        assert got.n_kmers == src.n_kmers
    elif what == "error_profile":
        rng = np.random.default_rng(2)
        src = J.infer.ErrorProfile(
            counts=rng.integers(0, 90, (50, 4, 4)), n_reads=77,
            ins_counts=rng.integers(0, 3, 50),
            del_counts=rng.integers(0, 3, 50), n_gapped=5)
        got = convert.error_profile(src.counts, src.n_reads, src.ins_counts,
                                    src.del_counts, src.n_gapped)
        np.testing.assert_array_equal(T.infer.counts_to_profile(got, T.config
                                      .AlignConfig(**CFG_KW)),
                                      J.infer.counts_to_profile(src, w.cfg))
        bare = convert.error_profile(src.counts)
        assert bare.n_reads == 0 and not bare.ins_counts.any()
    else:
        P = J
        P.fastq.write_fastq(tmp_path / "r.fastq", w.names, w.codes, w.lengths,
                            w.quals)
        src = next(iter(P.fastq.iter_fastq_batches(tmp_path / "r.fastq", 16,
                                                   50)))
        got = convert.read_batch(src.codes, src.lengths, list(src.names),
                                 src.quals)
        assert got.n_real == src.n_real == 16
        block = to_port(src)
        assert _is_port(block.names) and list(block.names) == got.names
        assert block.names.raw(2, 5)[0] == src.names.raw(2, 5)[0]
        assert convert.read_batch(src.codes, src.lengths, []).quals.shape \
            == src.codes.shape
    assert _is_port(got) and not _is_port(src)
    _assert_same(_plain(got), _plain(src))
