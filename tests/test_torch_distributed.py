"""The port's torch.distributed mode (`dist-align --coordinator`,
parallel/distributed.py) vs the JAX CLI, the cases of
tests/test_distributed.py and tests/test_cli.py's coordinator runs.

Two real processes of the port's CLI form one gloo group on the CPU
(--device cpu: the kernels' plain PyTorch versions); the error-profile count
matrix is summed in-step across them by all_reduce. The merged SAM and
.errorprofile must equal, byte for byte (tolerance 0), the JAX CLI's
file-side run on the same reads and the port's own one-process run — on a
plain index, with the two-tier rescue pass, and on a combined
genome+transcriptome index. Every subprocess has a timeout, and a failure
kills its sibling."""

import contextlib
import io
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from parasuite_tpu import cli as jcli
from parasuite_tpu.io.fasta import write_fasta
from parasuite_tpu.io.fastq import write_fastq
from parasuite_tpu.sim import simulate_reads
from parasuite_tpu_torch import cli as tcli

from conftest import sample_reads

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
CFG_FLAGS = ["--max-read-len", "50", "--kmer-size", "8", "--band-width", "3",
             "--batch-size", "32"]
# (index, reads, extra flags) of each case
CASES = {
    "plain": ("idx", "reads.fastq", []),
    "rescue": ("idx", "hard.fastq", ["--rescue-kmer", "6"]),
    "combined": ("cidx", "creads.fastq", []),
}


def _run(mod, *argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert mod.main([str(a) for a in argv]) == 0, argv
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _coordinator_procs(d, index, fastq, tag, n_proc, extra=(), fastq_of=None):
    """Start n_proc processes of the port's CLI as one group -> [Popen].
    fastq_of maps a process id to another FASTQ path (to make one fail)."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"
    port = _free_port()
    procs = []
    for pid in range(n_proc):
        fq = (fastq_of or {}).get(pid, d / fastq)
        argv = [sys.executable, "-m", "parasuite_tpu_torch.cli", "dist-align",
                str(d / index), str(fq), str(d / tag), "--coordinator",
                f"127.0.0.1:{port}", "--num-processes", str(n_proc),
                "--process-id", str(pid), "--device", "cpu", *CFG_FLAGS,
                *extra]
        procs.append(subprocess.Popen(argv, cwd=d, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE))
    return procs


def _finish(procs, timeout=300) -> list[tuple[int, str, str]]:
    """(exit code, stdout, stderr) of every process; none is left behind."""
    try:
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out.decode(), err.decode()))
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _coordinator_run(d, index, fastq, tag, n_proc, extra=()) -> list[dict]:
    outs = _finish(_coordinator_procs(d, index, fastq, tag, n_proc, extra))
    for pid, (rc, _out, err) in enumerate(outs):
        assert rc == 0, f"process {pid} failed:\n{err[-3000:]}"
    return [json.loads(out.strip().splitlines()[-1]) for _, out, _ in outs]


def _merged(mod, d, index, tag, n_hosts) -> tuple[bytes, bytes]:
    _run(mod, "merge-shards", d / index, d / tag, d / f"{tag}.sam",
         "--n-hosts", n_hosts, "--profile-out", d / f"{tag}.errorprofile",
         "--pg-cl", "merge", *CFG_FLAGS)
    return ((d / f"{tag}.sam").read_bytes(),
            (d / f"{tag}.errorprofile").read_bytes())


@pytest.fixture(scope="module")
def workdir(tmp_path_factory, tiny_ref, small_cfg):
    """The worlds of tests/test_distributed.py, made by the JAX CLI: a plain
    and a combined index, 200 simulated reads, 160 reads simulated on the
    combined index, and 120 heavily mutated reads for the rescue pass."""
    d = tmp_path_factory.mktemp("tdist")
    seqs = {name: tiny_ref.seq[tiny_ref.starts[i]:tiny_ref.ends[i]]
            for i, name in enumerate(tiny_ref.names)}
    write_fasta(d / "ref.fa", seqs)
    _run(jcli, "index", d / "ref.fa", d / "idx", *CFG_FLAGS)
    codes, lengths, truth = simulate_reads(tiny_ref, 200, 50, small_cfg,
                                           seed=31, tc_rate=0.12)
    write_fastq(d / "reads.fastq", truth.names(), codes, lengths)
    codes, lengths, _ = sample_reads(np.random.default_rng(41), tiny_ref,
                                     120, 50, mutate=7, indel=True)
    write_fastq(d / "hard.fastq", [f"h{i}" for i in range(120)], codes,
                lengths)
    (d / "cann.tsv").write_text("txA\tchrA\t+\t1200,2400\t1500,2700\n")
    _run(jcli, "combine", d / "ref.fa", d / "cann.tsv", d / "cidx",
         *CFG_FLAGS)
    _run(jcli, "simulate", d / "cidx", d / "creads.fastq", "--n-reads",
         "160", "--tc-rate", "0.12", *CFG_FLAGS)
    return d


@pytest.mark.parametrize("case", list(CASES))
def test_two_process_matches_single_and_reference(workdir, case):
    d = workdir
    index, fastq, extra = CASES[case]
    n_reads = sum(1 for _ in open(d / fastq)) // 4
    # the JAX CLI, file-side over two hosts: the reference bytes
    for h in range(2):
        _run(jcli, "dist-align", d / index, d / fastq, d / f"{case}_jax",
             "--host-index", h, "--n-hosts", 2, *CFG_FLAGS, *extra)
    want = _merged(jcli, d, index, f"{case}_jax", 2)
    # the port in one process, file-side
    _run(tcli, "dist-align", d / index, d / fastq, d / f"{case}_one",
         "--host-index", 0, "--n-hosts", 1, "--device", "cpu", *CFG_FLAGS,
         *extra)
    assert _merged(tcli, d, index, f"{case}_one", 1) == want

    # two real torch.distributed processes: counts summed in-step
    outs = _coordinator_run(d, index, fastq, f"{case}_two", 2, extra)
    assert all(o["mode"] == "torch.distributed" for o in outs)
    assert all(o["backend"] == "gloo" and o["device"] == "cpu"
               for o in outs)
    assert [o["host"] for o in outs] == [0, 1]
    assert sum(o["records"] for o in outs) == n_reads
    # no kernel launches on CPU tensors: the plain versions ran
    assert all(set(o["launches"].values()) == {0} for o in outs)
    got = _merged(tcli, d, index, f"{case}_two", 2)
    assert got[0] == want[0]
    assert got[1] == want[1]
    # the JAX CLI merges the port's coordinator shards to the same bytes
    assert _merged(jcli, d, index, f"{case}_two", 2) == want

    # who saves what: the summed matrix is global, so only process 0 saves
    # it; a combined run's counts are local and every shard saves its own
    shard1 = d / f"{case}_two.shard0001.sam"
    assert Path(str(shard1) + ".counts.npy").exists() == (case == "combined")
    z = np.load(str(shard1) + ".indels.npz")
    assert ("gsub" in z.files) == (case != "combined")
    if case == "rescue":
        # rescued ungapped rows ride the indels file's gsub matrix
        gsub = sum(np.load(f"{d}/{case}_two.shard{h:04d}.sam.indels.npz")
                   ["gsub"].sum() for h in range(2))
        assert gsub > 0


def test_one_process_group_on_combined_index(workdir):
    """--num-processes 1 (tests/test_cli.py's coordinator run): a group of
    one equals the plain `align` records of the port and of the JAX CLI."""
    d = workdir
    (out,) = _coordinator_run(d, "cidx", "creads.fastq", "solo", 1)
    assert out["mode"] == "torch.distributed" and out["records"] == 160
    sam, _ = _merged(tcli, d, "cidx", "solo", 1)
    got = [line for line in sam.splitlines() if not line.startswith(b"@")]
    _run(jcli, "align", d / "cidx", d / "creads.fastq", d / "calign.sam",
         "--pg-cl", "x", *CFG_FLAGS)
    want = [line for line in (d / "calign.sam").read_bytes().splitlines()
            if not line.startswith(b"@")]
    assert got == want and len(got) == 160
    assert all(b"tx::" not in line for line in got)


def test_a_dead_peer_ends_the_run(workdir):
    """Process 1 fails on its input after joining the group; process 0, in
    the middle of a step's sum, must end with a non-zero exit code and a
    message, not wait for good."""
    d = workdir
    procs = _coordinator_procs(d, "idx", "reads.fastq", "dead", 2,
                               fastq_of={1: d / "no_such.fastq"})
    outs = _finish(procs, timeout=240)
    assert outs[1][0] != 0 and "no_such.fastq" in outs[1][2]
    assert outs[0][0] != 0, outs[0][1]
    assert outs[0][2].strip(), "process 0 failed without a message"
    assert not (d / "dead.shard0000.sam.done.json").exists()
