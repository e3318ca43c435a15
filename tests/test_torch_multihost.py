"""The port's file-side multi-host mode (`dist-align --host-index`,
`merge-shards`, parallel/multihost.py) vs the JAX CLI, the cases of
tests/test_multihost.py: the merged SAM and .errorprofile are byte-identical
to the JAX CLI's at 1, 3 and 5 hosts, shards written by either package
merge under the other, and unfinished shards are refused. Tolerance 0
(files compared as bytes, count matrices as integer arrays). The port runs
with --device cpu (the kernels' plain PyTorch versions)."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from parasuite_tpu import cli as jcli
from parasuite_tpu.io.fasta import write_fasta
from parasuite_tpu.io.fastq import write_fastq
from parasuite_tpu.sim import simulate_reads
from parasuite_tpu_torch import cli as tcli
from parasuite_tpu_torch.index import PackedReference
from parasuite_tpu_torch.parallel import multihost

from _torch_helpers import to_port

torch.set_num_threads(1)
CFG_FLAGS = ["--max-read-len", "50", "--kmer-size", "8", "--band-width", "3",
             "--batch-size", "32"]
CPU = ["--device", "cpu"]
SHARD_FILES = (".sam", ".sam.done.json", ".sam.counts.npy",
               ".sam.indels.npz")


def _run(mod, *argv) -> tuple[int, dict | None]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main([str(a) for a in argv])
    lines = buf.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


def _align_hosts(mod, d, tag, n_hosts, hosts=None):
    extra = CPU if mod is tcli else []
    outs = []
    for h in (range(n_hosts) if hosts is None else hosts):
        rc, js = _run(mod, "dist-align", d / "idx", d / "reads.fastq",
                      d / tag, "--host-index", h, "--n-hosts", n_hosts,
                      *CFG_FLAGS, *extra)
        assert rc == 0
        outs.append(js)
    return outs


def _merge(mod, d, tag, n_hosts) -> tuple[bytes, bytes]:
    rc, js = _run(mod, "merge-shards", d / "idx", d / tag, d / f"{tag}.sam",
                  "--n-hosts", n_hosts, "--profile-out",
                  d / f"{tag}.errorprofile", "--pg-cl", "merge", *CFG_FLAGS)
    assert rc == 0 and js["records"] == 200 and js["profiled"] > 150
    return ((d / f"{tag}.sam").read_bytes(),
            (d / f"{tag}.errorprofile").read_bytes())


@pytest.fixture(scope="module")
def workdir(tmp_path_factory, tiny_ref, small_cfg):
    """Reference, index and 200 reads; `jax3`: the JAX CLI's three shards,
    merged (the reference bytes of every case)."""
    d = tmp_path_factory.mktemp("tmh")
    seqs = {name: tiny_ref.seq[tiny_ref.starts[i]:tiny_ref.ends[i]]
            for i, name in enumerate(tiny_ref.names)}
    write_fasta(d / "ref.fa", seqs)
    assert _run(jcli, "index", d / "ref.fa", d / "idx", *CFG_FLAGS)[0] == 0
    codes, lengths, truth = simulate_reads(tiny_ref, 200, 50, small_cfg,
                                           seed=31, tc_rate=0.12)
    write_fastq(d / "reads.fastq", truth.names(), codes, lengths)
    _align_hosts(jcli, d, "jax3", 3)
    return d


@pytest.fixture(scope="module")
def reference(workdir):
    sam, prof = _merge(jcli, workdir, "jax3", 3)
    assert sum(1 for line in sam.splitlines()
               if not line.startswith(b"@")) == 200
    return sam, prof


@pytest.mark.parametrize("n_hosts", [1, 3, 5])
def test_multihost_merge_matches_reference(workdir, reference, n_hosts):
    """Same reads, any host count -> the JAX CLI's merged SAM and
    .errorprofile, byte for byte (200 reads / batch 32 = 7 batches, so both
    multi-host layouts are uneven round-robins)."""
    d = workdir
    tag = f"port{n_hosts}"
    outs = _align_hosts(tcli, d, tag, n_hosts)
    assert sum(o["records"] for o in outs) == 200
    assert all(o["device"] == "cpu" for o in outs)
    sam, prof = _merge(tcli, d, tag, n_hosts)
    assert sam == reference[0]
    assert prof == reference[1]


def test_shard_files_equal_reference(workdir):
    """Every shard file of a three-host run has the JAX CLI's layout and
    content: SAM body and .done.json as bytes, the count and indel arrays
    equal with equal dtypes."""
    d = workdir
    _align_hosts(tcli, d, "lay3", 3)
    for h in range(3):
        got, want = (f"{d}/{tag}.shard{h:04d}" for tag in ("lay3", "jax3"))
        for ext in (".sam", ".sam.done.json"):
            assert open(got + ext, "rb").read() == open(want + ext,
                                                        "rb").read(), ext
        g, w = np.load(got + ".sam.counts.npy"), np.load(
            want + ".sam.counts.npy")
        assert g.dtype == w.dtype == np.int64
        np.testing.assert_array_equal(g, w)
        gz, wz = np.load(got + ".sam.indels.npz"), np.load(
            want + ".sam.indels.npz")
        assert sorted(gz.files) == sorted(wz.files)
        for k in wz.files:
            assert gz[k].dtype == wz[k].dtype
            np.testing.assert_array_equal(gz[k], wz[k])
    assert multihost.shard_paths(d / "lay3", 2) == [
        f"{d}/lay3.shard0000.sam", f"{d}/lay3.shard0001.sam"]


@pytest.mark.parametrize("case", ["jax_shards_port_merge",
                                  "port_shards_jax_merge", "mixed_shards"])
def test_shards_merge_across_packages(workdir, reference, case):
    """Shards written by one package merge under the other, and a run with
    one host of each merges under both, to the same bytes."""
    d = workdir
    if case == "jax_shards_port_merge":
        assert _merge(tcli, d, "jax3", 3) == reference
        return
    if case == "port_shards_jax_merge":
        _align_hosts(tcli, d, "xp", 3)
        assert _merge(jcli, d, "xp", 3) == reference
        return
    _align_hosts(jcli, d, "mix", 2, hosts=[0])
    _align_hosts(tcli, d, "mix", 2, hosts=[1])
    assert _merge(jcli, d, "mix", 2) == reference
    assert _merge(tcli, d, "mix", 2) == reference


def test_merge_refuses_incomplete_shards(workdir, tmp_path):
    d = workdir
    ref = PackedReference.load(d / "idx")
    with pytest.raises(RuntimeError, match="shard not finished"):
        multihost.merge_host_outputs(ref, d / "nonexistent",
                                     tmp_path / "x.sam", 2)
    # one of two hosts done: still refused, by the CLI too
    _align_hosts(tcli, d, "half", 2, hosts=[0])
    with pytest.raises(RuntimeError, match="shard0001.sam"):
        _run(tcli, "merge-shards", d / "idx", d / "half", tmp_path / "h.sam",
             "--n-hosts", 2, *CFG_FLAGS)
    assert not (tmp_path / "h.sam").exists()


def test_dist_align_needs_a_mode_and_resumes(workdir, capsys):
    """Neither --host-index/--n-hosts nor --coordinator, or a coordinator
    without the group's size and the process's id: exit 2 and a message.
    --resume on a finished shard aligns nothing again."""
    d = workdir
    rc, js = _run(tcli, "dist-align", d / "idx", d / "reads.fastq",
                  d / "none", *CFG_FLAGS, *CPU)
    assert rc == 2 and js is None
    assert "--host-index/--n-hosts required" in capsys.readouterr().err
    rc, js = _run(tcli, "dist-align", d / "idx", d / "reads.fastq",
                  d / "none", "--coordinator", "127.0.0.1:1", *CFG_FLAGS, *CPU)
    assert rc == 2 and js is None
    assert "needs --num-processes" in capsys.readouterr().err
    first = _align_hosts(tcli, d, "res", 2, hosts=[1])[0]
    body = (d / "res.shard0001.sam").read_bytes()
    rc, again = _run(tcli, "dist-align", d / "idx", d / "reads.fastq",
                     d / "res", "--host-index", 1, "--n-hosts", 2,
                     "--resume", "--log", d / "res.log", *CFG_FLAGS, *CPU)
    assert rc == 0 and again == first
    assert (d / "res.shard0001.sam").read_bytes() == body
    assert "already complete" in (d / "res.log").read_text()


def test_run_local_hosts(workdir, reference, small_cfg):
    """Two real subprocesses of the port's CLI on the CPU, then the library
    merge: the reference bytes, and the JAX profile's arrays."""
    from parasuite_tpu.errormodel.infer import ErrorProfile

    d = workdir
    outs = multihost.run_local_hosts(d / "idx", d / "reads.fastq", d / "loc",
                                     2, to_port(small_cfg),
                                     extra_args=CFG_FLAGS, timeout=300,
                                     device="cpu")
    assert [o["host"] for o in outs] == [0, 1]
    assert sum(o["records"] for o in outs) == 200
    n, profile = multihost.merge_host_outputs(
        PackedReference.load(d / "idx"), d / "loc", d / "loc.sam", 2,
        profile_out=d / "loc.errorprofile", command_line="merge")
    assert n == 200
    assert (d / "loc.sam").read_bytes() == reference[0]
    assert (d / "loc.errorprofile").read_bytes() == reference[1]
    (d / "ref.errorprofile").write_bytes(reference[1])
    want = ErrorProfile.load(d / "ref.errorprofile")
    np.testing.assert_array_equal(profile.counts, want.counts)
    np.testing.assert_array_equal(profile.ins_counts, want.ins_counts)
    assert profile.n_reads == want.n_reads
    # a host that fails ends the run with its message
    with pytest.raises(RuntimeError, match="host 0 failed"):
        multihost.run_local_hosts(d / "missing_idx", d / "reads.fastq",
                                  d / "bad", 2, to_port(small_cfg),
                                  extra_args=CFG_FLAGS, timeout=300,
                                  device="cpu")
