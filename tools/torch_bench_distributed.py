"""1-vs-2-process scaling point of the port's `dist-align --coordinator`
(torch.distributed, the error-profile counts summed in-step by all_reduce):
the port's counterpart of tools/bench_distributed.py.

The world is the original's: a 2 Mbp default_rng(21) reference, k = 10,
batch 8,192, simulate_reads(seed=22, tc_rate=0.12), 131,072 reads by
default. The measurement too: a 1-process and a 2-process run of the port's
CLI in interleaved rounds, the median of 3 (--rounds); while the efficiency
rps(2 processes) / (2 x rps(1 process)) is above 1.0 the pair is measured
again, at most twice. Each process reports its own loop time; the slowest
process's is the group's wall (lockstep: every process runs every global
step).

  --device cpu:  gloo, each process pinned to one core with taskset and one
                 thread, as the original pins its processes;
  --device cuda: each process takes a card of its own when the machine has
                 at least 2 (NCCL), else both share the one card (gloo, as
                 chip_smoke.py's dist_coord phase runs it); the line says
                 which ("cards", "backend").

One check beyond the original: merge-shards of the last 2-process run gives
the bytes of the last 1-process run's merged SAM and .errorprofile
(SHA-256 in the line; the script fails when they differ).

    python tools/torch_bench_distributed.py [n_reads] [--rounds N]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

TOOLS = Path(__file__).resolve().parent
sys.path.insert(0, str(TOOLS))

import numpy as np                                  # noqa: E402

import _torch_bench as tb                           # noqa: E402

REPO = tb.REPO
READ_LEN = 50
BATCH = 8192
REF_LEN = 2_000_000
CFG_FLAGS = ["--max-read-len", str(READ_LEN), "--kmer-size", "10",
             "--batch-size", str(BATCH)]
MAX_REMEASURES = 2


def make_world(d: Path, n_reads: int) -> None:
    """The original's world as files under d: ref.fa, the index idx.* with
    its config, reads.fastq."""
    from parasuite_tpu_torch.config import AlignConfig
    from parasuite_tpu_torch.index import KmerIndex, PackedReference
    from parasuite_tpu_torch.io.fasta import write_fasta
    from parasuite_tpu_torch.io.fastq import write_fastq
    from parasuite_tpu_torch.sim.generate import simulate_reads

    cfg = AlignConfig(max_read_len=READ_LEN, kmer_size=10, batch_size=BATCH)
    rng = np.random.default_rng(21)
    seqs = {"chrD": rng.integers(0, 4, REF_LEN).astype(np.int8)}
    write_fasta(d / "ref.fa", seqs)
    ref = PackedReference.from_dict(seqs, spacer=cfg.chrom_spacer)
    KmerIndex.build(ref.seq, cfg.kmer_size).save(d / "idx")
    ref.save(d / "idx")
    (d / "idx.config.json").write_text(cfg.to_json())
    codes, lengths, truth = simulate_reads(ref, n_reads, READ_LEN, cfg,
                                           seed=22, tc_rate=0.12)
    write_fastq(d / "reads.fastq", truth.names(), np.asarray(codes),
                np.asarray(lengths))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_nproc(d: Path, nproc: int, device: str,
              timeout: int = 1500) -> tuple[float, list]:
    """nproc processes of `cli dist-align --coordinator` on d's world
    -> (records over the slowest process's loop seconds, their JSON lines).
    A process that fails or outlasts the timeout ends the run, and none is
    left behind."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    cpu = device.startswith("cpu")
    if cpu:
        env["OMP_NUM_THREADS"] = "1"
    ncores = os.cpu_count() or 1
    port = _free_port()
    procs = []
    try:
        for pid in range(nproc):
            pin = ["taskset", "-c", str(pid % ncores)] if cpu else []
            argv = [*pin, sys.executable, "-m", "parasuite_tpu_torch.cli",
                    "dist-align", str(d / "idx"), str(d / "reads.fastq"),
                    str(d / f"s{nproc}"), "--coordinator",
                    f"127.0.0.1:{port}", "--num-processes", str(nproc),
                    "--process-id", str(pid), "--device", device, *CFG_FLAGS]
            procs.append(subprocess.Popen(argv, cwd=d, env=env,
                                          stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
        lines = []
        for pid, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise RuntimeError(f"process {pid} of {nproc} exited "
                                   f"{p.returncode}:\n{err[-3000:]}")
            lines.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = max(ln["seconds"] for ln in lines)
    return sum(ln["records"] for ln in lines) / wall, lines


def merged_digests(d: Path, nproc: int) -> dict:
    """merge-shards of the nproc-process run -> SHA-256 of the SAM and the
    .errorprofile (the @PG line pinned, so runs compare byte for byte)."""
    from parasuite_tpu_torch.cli import main as cli

    prefix = d / f"s{nproc}"
    with contextlib.redirect_stdout(io.StringIO()):
        if cli(["merge-shards", str(d / "idx"), str(prefix),
                f"{prefix}.sam", "--n-hosts", str(nproc), "--pg-cl",
                "bench", "--profile-out", f"{prefix}.errorprofile",
                *CFG_FLAGS]) != 0:
            raise RuntimeError(f"merge-shards of {prefix} failed")
    return {ext: hashlib.sha256(Path(f"{prefix}.{ext}").read_bytes())
            .hexdigest() for ext in ("sam", "errorprofile")}


def measure(n_reads: int, device: str, rounds: int = 3) -> dict:
    """The scaling point -> the JSON line (module docstring)."""
    import torch

    if device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("torch_bench_distributed: --device cuda, but "
                         "torch.cuda.is_available() is false")
    cards = (min(2, torch.cuda.device_count()) if device.startswith("cuda")
             else 0)
    r1: list = []
    r2: list = []
    launches: dict = {}
    backends: set = set()
    with tempfile.TemporaryDirectory(prefix="ps_dist_bench_") as td:
        d = Path(td)
        make_world(d, n_reads)

        def one_round():
            for nproc, into in ((1, r1), (2, r2)):
                rps, lines = run_nproc(d, nproc, device)
                into.append(rps)
                if sum(ln["records"] for ln in lines) != n_reads:
                    raise RuntimeError(f"{nproc} processes wrote {lines}")
                for ln in lines:
                    backends.add((nproc, ln["backend"]))
                    for k, v in ln["launches"].items():
                        launches[k] = launches.get(k, 0) + v

        for _ in range(rounds):
            one_round()
        eff = statistics.median(r2) / (2.0 * statistics.median(r1))
        retries = 0
        while eff > 1.0 and retries < MAX_REMEASURES:
            one_round()
            eff = statistics.median(r2) / (2.0 * statistics.median(r1))
            retries += 1
        one, two = merged_digests(d, 1), merged_digests(d, 2)
    if one != two:
        raise RuntimeError(f"2-process output {two} differs from the "
                           f"1-process output {one}")
    backend = {n: b for n, b in backends}
    return {
        "n_reads": n_reads, "batch": BATCH,
        "devices_per_process": 1,
        "rps_1proc": round(statistics.median(r1), 1),
        "rps_2proc": round(statistics.median(r2), 1),
        "rounds_1proc": [round(x, 1) for x in r1],
        "rounds_2proc": [round(x, 1) for x in r2],
        "spread_1proc": round(tb.spread_of(r1), 3),
        "spread_2proc": round(tb.spread_of(r2), 3),
        "scaling_efficiency_2proc": round(eff, 3),
        "remeasure_rounds": retries,
        "suspect": eff > 1.0,
        "note": ("port, torch.distributed, in-step all_reduce of the "
                 "profile counts; steady-state loop time of the slowest "
                 "process; interleaved 1p/2p rounds, median-of-N; "
                 "suspect=true means efficiency stayed >1.0 after "
                 "remeasures (noise-dominated)"
                 + ("; both processes share one card: not a scaling number"
                    if cards == 1 else "")),
        "device": device, "cards": cards,
        "backend": backend.get(2), "backend_1proc": backend.get(1),
        "launches": launches,
        "sam_sha256_1proc": one["sam"], "sam_sha256_2proc": two["sam"],
        "errorprofile_sha256": one["errorprofile"],
        "same_output": True, "gpu": tb.gpu_line(device),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_reads", nargs="?", type=int, default=16 * BATCH)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    print(json.dumps(measure(a.n_reads, a.device, a.rounds)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
