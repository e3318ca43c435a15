"""The port's host-side subcommands against parasuite_tpu.cli, tolerance 0:
simulate (flat, --profile --learned-indels, on a combined index), cluster
(SAM and BAM input), sort and convert write byte-identical files and print
the same JSON; benchmark --device cpu gives the same counts; benchmark
--scaling exits non-zero. The cases are those of tests/test_cli.py:46-113
and tests/test_bam.py:140-156. Also pins the port's copies of the cluster
caller and of benchkit.evaluate to the originals."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from parasuite_tpu import cli as jcli
from parasuite_tpu_torch import cli as tcli

from conftest import sample_reads
from _torch_helpers import to_port

torch.set_num_threads(1)
FLAGS = ["--max-read-len", "50", "--kmer-size", "8", "--band-width", "3",
         "--batch-size", "64"]


def _run(mod, *argv) -> tuple[int, dict | None]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main([str(a) for a in argv])
    lines = buf.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


@pytest.fixture(scope="module")
def world(tmp_path_factory, tiny_ref):
    """Shared inputs, made by the JAX CLI: index, combined index, reads,
    a twopass SAM (+ .errorprofile) and an align BAM."""
    from parasuite_tpu.io.fasta import write_fasta
    from parasuite_tpu.io.fastq import write_fastq

    d = tmp_path_factory.mktemp("tcli")
    write_fasta(d / "ref.fa", {name: tiny_ref.seq[tiny_ref.starts[i]:
                                                  tiny_ref.ends[i]]
                               for i, name in enumerate(tiny_ref.names)})
    (d / "ann.tsv").write_text("txA\tchrA\t+\t1200,2400\t1500,2700\n")
    codes, lengths, _ = sample_reads(np.random.default_rng(77), tiny_ref,
                                     200, 50, mutate=1, indel=True)
    write_fastq(d / "r.fastq", [f"q{i}" for i in range(200)], codes, lengths)
    for argv in (["index", d / "ref.fa", d / "idx"],
                 ["combine", d / "ref.fa", d / "ann.tsv", d / "cidx"],
                 ["twopass", d / "idx", d / "r.fastq", d / "tp.sam",
                  "--pg-cl", "x"],
                 ["align", d / "idx", d / "r.fastq", d / "al.bam",
                  "--pg-cl", "x"]):
        assert _run(jcli, *argv, *FLAGS)[0] == 0
    return d


def _tool_runs(d, out):
    """(label, argv, output files) of every host-tool case, writing to
    directory out."""
    return [
        ("simulate_flat", ["simulate", d / "idx", out / "s.fastq",
                           "--n-reads", "200", "--tc-rate", "0.15", *FLAGS],
         ["s.fastq"]),
        ("simulate_profile", ["simulate", d / "idx", out / "sp.fastq",
                              "--n-reads", "300", "--profile",
                              d / "tp.sam.errorprofile", "--learned-indels",
                              *FLAGS], ["sp.fastq"]),
        ("simulate_combined", ["simulate", d / "cidx", out / "sc.fastq",
                               "--n-reads", "120", "--flat-qual", *FLAGS],
         ["sc.fastq"]),
        ("cluster_sam", ["cluster", d / "idx", d / "tp.sam", out / "cs.tsv",
                         "--cluster-min-reads", "1", *FLAGS], ["cs.tsv"]),
        ("cluster_bam", ["cluster", d / "idx", d / "al.bam", out / "cb.tsv",
                         "--cluster-min-reads", "1", *FLAGS], ["cb.tsv"]),
        ("sort_sam", ["sort", d / "tp.sam", out / "sorted.sam",
                      "--min-mapq", "1"], ["sorted.sam"]),
        ("sort_bam", ["sort", d / "al.bam", out / "sorted.bam",
                      "--mapped-only"], ["sorted.bam"]),
        ("convert_bam_to_sam", ["convert", d / "al.bam", out / "al.sam"],
         ["al.sam"]),
        ("convert_sam_to_bam", ["convert", d / "tp.sam", out / "tp.bam"],
         ["tp.bam"]),
    ]


TOOL_CASES = ["simulate_flat", "simulate_profile", "simulate_combined",
              "cluster_sam", "cluster_bam", "sort_sam", "sort_bam",
              "convert_bam_to_sam", "convert_sam_to_bam"]


@pytest.mark.parametrize("case", TOOL_CASES)
def test_host_tools_byte_identical(case, world, tmp_path):
    """Each host tool through both CLIs: same exit code, same JSON line
    (paths aside), byte-identical output files."""
    got = {}
    for name, mod in (("jax", jcli), ("torch", tcli)):
        out = tmp_path / name
        out.mkdir()
        (_, argv, files), = [r for r in _tool_runs(world, out)
                             if r[0] == case]
        rc, js = _run(mod, *argv)
        js.pop("out", None)
        got[name] = (rc, js, {f: (out / f).read_bytes() for f in files})
    assert got["torch"][0] == got["jax"][0] == 0
    assert got["torch"][1] == got["jax"][1]
    for f, data in got["jax"][2].items():
        assert len(data) > 0 and got["torch"][2][f] == data, f
    if case.startswith("cluster"):
        assert got["jax"][1]["clusters"] > 0
    if case == "simulate_profile":
        assert got["jax"][1]["indels"] > 0


def test_benchmark_counts_equal(world):
    """benchmark --device cpu: the same reads (the port's simulator), the
    same n_mapped/n_correct/sensitivity/precision as the JAX CLI; the
    report has the JAX CLI's keys."""
    argv = ["benchmark", world / "idx", "--n-reads", "150", "--tc-rate",
            "0.1", *FLAGS]
    rc_j, want = _run(jcli, *argv)
    rc_t, got = _run(tcli, *argv, "--device", "cpu")
    assert rc_j == rc_t == 0
    assert sorted(got) == sorted(want)
    for k in ("n_reads", "n_mapped", "n_correct", "sensitivity",
              "precision", "tolerance", "items", "name", "tool"):
        assert got[k] == want[k], k
    assert got["n_correct"] > 140 and got["items_per_second"] > 0


def test_benchmark_scaling_exits_nonzero(world, capsys):
    """--scaling with more devices than there are (the CPU is one): a
    non-zero exit and a message naming the count, never replicas on one
    device measured as if they were devices. With a count the machine has
    it prints the JAX CLI's report shape."""
    rc, js = _run(tcli, "benchmark", world / "idx", "--scaling", "1,2",
                  "--n-reads", "64", *FLAGS, "--device", "cpu")
    assert rc != 0 and js is None
    assert "requested 2 devices, have 1" in capsys.readouterr().err
    rc, js = _run(tcli, "benchmark", world / "idx", "--scaling", "1",
                  "--n-reads", "64", *FLAGS, "--device", "cpu")
    assert rc == 0 and js["tool"] == "benchmark" and js["mode"] == "weak"
    assert js["backend"] == "cpu" and js["per_device_reads"] == 64
    assert [p["n_devices"] for p in js["points"]] == [1]
    assert sorted(js["points"][0]) == ["efficiency", "n_devices",
                                       "per_device", "reads_per_s"]


def test_cluster_copies_equal_reference(world):
    """call_clusters / write_clusters / Cluster / cluster_columns_python
    (the no-native fallback) and benchkit.evaluate_against_truth of the
    port equal the originals on the same inputs."""
    from parasuite_tpu.benchkit.evaluate import evaluate_against_truth as je
    from parasuite_tpu.config import AlignConfig
    from parasuite_tpu.index import PackedReference
    from parasuite_tpu.pipeline import clusters as jc
    from parasuite_tpu.sim.generate import simulate_reads as jsim
    from parasuite_tpu_torch.benchkit import evaluate_against_truth as te
    from parasuite_tpu_torch.pipeline import clusters as tc
    from parasuite_tpu_torch.sim.generate import simulate_reads as tsim

    ref = PackedReference.load(world / "idx")
    t_ref = to_port(ref)
    cols_j = jcli.cluster_columns_python(world / "tp.sam", ref)
    cols_t = tcli.cluster_columns_python(world / "tp.sam", t_ref)
    for a, b in zip(cols_j, cols_t):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for min_reads in (1, 2, 3):
        cfg = AlignConfig(cluster_min_reads=min_reads)
        want = jc.call_clusters(ref, *cols_j, cfg)
        got = tc.call_clusters(t_ref, *cols_t, to_port(cfg))
        assert [c.to_tsv() for c in got] == [c.to_tsv() for c in want]
        assert len(want) > 0
    assert tc.TSV_HEADER == jc.TSV_HEADER
    assert tc.call_clusters(t_ref, *(x[:0] for x in cols_t),
                            to_port(cfg)) == []

    cfg = AlignConfig(max_read_len=50, kmer_size=8)
    _, _, jt = jsim(ref, 64, 50, cfg, seed=4)
    _, _, tt = tsim(t_ref, 64, 50, to_port(cfg), seed=4)
    rng = np.random.default_rng(0)
    mapped = rng.random(64) < 0.9
    strand = np.where(rng.random(64) < 0.9, tt.strand, 1 - tt.strand)
    pos = tt.packed_pos + rng.integers(-2, 3, 64)
    for tol in (0, 2):
        assert (te(tt, mapped, strand, pos, tol).to_dict()
                == je(jt, mapped, strand, pos, tol).to_dict())
