"""Shared helpers of the tools/torch_*.py measurement scripts: the port's
counterparts of bench.py's make_cfg, build_state, run_throughput and
run_end_to_end, the bench world as files (chip_smoke.py's phases read them),
and the pieces every script prints (the card's name and power limit).

Everything here drives parasuite_tpu_torch only. The worlds are pure
functions of their seeds (numpy, and the port's simulator, which gives the
JAX package's reads bit for bit), so every accuracy count can be held to the
JAX package's on the same reads.

Timing rules: warm-up excluded, torch.cuda.synchronize() around every timed
region, results fetched to the host inside it, every round listed, and the
spread computed over the list that is printed.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

REF_LEN = 20_000_000        # bench.REF_LEN
READ_LEN = 50
BATCH = int(os.environ.get("PARASUITE_BENCH_BATCH", 65536))
N_READS = 16 * BATCH        # bench.N_READS_TPU
TIMED_ROUNDS = 3
E2E_ROUNDS = 5
# the file world of chip_smoke.py (write_world)
SMOKE_READS = 262_144       # 4 batches of 65,536
N_PIN = 16_384              # reads pinned to the JAX package's digests
N_ALL_N = 256


def device_arg(argv=None, description: str = ""):
    """Parse `--device` (default cuda) and leave the rest -> (device, rest).
    Every tool takes it; the tests pass cpu."""
    import argparse

    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda")
    ns, rest = ap.parse_known_args(argv)
    return ns.device, rest


def gpu_line(device="cuda") -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` for a
    CUDA device; for the CPU the word cpu (no card number is then a card's)."""
    if str(device).startswith("cpu"):
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def environment(device="cuda") -> dict:
    """What a measurement stands beside: gpu_line(device) and the torch,
    CUDA and nvcc versions ("not found" where this machine has no nvcc)."""
    import torch

    from parasuite_tpu_torch.ops._build import nvcc_path

    try:
        nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                              text=True, timeout=60).stdout.strip()
    except OSError:
        nvcc = ""
    return {"gpu": gpu_line(device), "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "nvcc": nvcc.splitlines()[-1] if nvcc else "not found"}


def sync(device) -> None:
    """Wait for the device: what every timed region starts and ends with."""
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def spread_of(rates) -> float:
    return (max(rates) - min(rates)) / min(rates)


def make_cfg(batch_size: int = BATCH):
    """bench.make_cfg(): L = 50, k = 12, 7 seeds at stride 6, max_occ 16,
    C = 8."""
    from parasuite_tpu_torch.config import AlignConfig

    return AlignConfig(max_read_len=READ_LEN, kmer_size=12,
                       batch_size=batch_size, max_candidates=8, max_occ=16)


def build_state(cfg, ref_len, seed=1, device="cuda"):
    """bench.build_state(): the uniform default_rng(seed) reference of
    ref_len bases, its k-mer index and an AlignerEngine on `device` (the
    engine holds the DeviceIndex and the flat ScoreParams)
    -> (ref, index, engine)."""
    from parasuite_tpu_torch.index import KmerIndex, PackedReference
    from parasuite_tpu_torch.pipeline.align import AlignerEngine

    rng = np.random.default_rng(seed)
    seqs = {"chr_bench": rng.integers(0, 4, ref_len).astype(np.int8)}
    ref = PackedReference.from_dict(seqs, spacer=cfg.chrom_spacer)
    index = KmerIndex.build(ref.seq, cfg.kmer_size)
    return ref, index, AlignerEngine(ref, index, cfg, device=device)


def device_loop(engine, codes, lengths, batch_size, rounds=TIMED_ROUNDS):
    """bench.py's device loop on the port: every batch through
    engine.align_device_packed (host packing, upload of the wire, the
    step), then every PackedResult fetched to the host as its bytes, timed
    as one region per round; the results are unpacked (unpack_result_host)
    after the clock stops -> (rates reads/s per round, the last round's
    AlignResults as numpy namedtuples). One warm-up batch first."""
    from parasuite_tpu_torch.ops.aligner import unpack_result_host
    from parasuite_tpu_torch.pipeline.align import fetch_host

    dev = engine.device
    n = codes.shape[0]
    fetch_host(engine.align_device_packed(codes[:batch_size],
                                          lengths[:batch_size]))
    sync(dev)
    rates, fetched = [], None
    for _ in range(rounds):
        sync(dev)
        t0 = time.perf_counter()
        outs = [engine.align_device_packed(codes[i:i + batch_size],
                                           lengths[i:i + batch_size])
                for i in range(0, n, batch_size)]
        fetched = [fetch_host(o)[0] for o in outs]
        sync(dev)
        rates.append(n / (time.perf_counter() - t0))
    return rates, [unpack_result_host(p, engine.cfg.band_width)
                   for p in fetched]


def accuracy_extras(truth, results) -> dict:
    """bench.run_throughput's accuracy extras from the device results."""
    from parasuite_tpu_torch.benchkit import evaluate_against_truth

    mapped = np.concatenate([r.mapped for r in results])
    strand = np.concatenate([r.strand for r in results])
    pos = np.concatenate([r.pos for r in results])
    rep = evaluate_against_truth(truth, mapped, strand, pos)
    return {"sensitivity": round(rep.sensitivity, 4),
            "precision": round(rep.precision, 4),
            "n_unmapped": rep.n_reads - rep.n_mapped,
            "n_mismapped": rep.n_mapped - rep.n_correct}


def run_throughput(cfg, n_reads, batch_size, ref_len, check_accuracy=False,
                   state=None, read_len=READ_LEN, device="cuda",
                   rounds=TIMED_ROUNDS):
    """bench.run_throughput() on the port: simulate_reads(seed=2,
    tc_rate=0.12) on the bench reference through device_loop
    -> (best reads/s, accuracy extras or {}, every round's reads/s)."""
    from parasuite_tpu_torch.sim.generate import simulate_reads

    ref, _index, engine = state if state else build_state(cfg, ref_len,
                                                          device=device)
    codes, lengths, truth = simulate_reads(ref, n_reads, read_len, cfg,
                                           seed=2, tc_rate=0.12)
    rates, results = device_loop(engine, np.asarray(codes),
                                 np.asarray(lengths), batch_size, rounds)
    extras = accuracy_extras(truth, results) if check_accuracy else {}
    return max(rates), extras, rates


def stream_rate(engine, fastq, n_reads, tmpdir, rounds=3,
                name="bench_out.sam"):
    """FASTQ -> SAM reads/s through streaming_align: one warm-up run, then
    `rounds` timed ones -> (median, every timed round)."""
    from parasuite_tpu_torch.pipeline.stream import streaming_align

    rates = []
    for r in range(rounds + 1):
        out = Path(tmpdir) / name
        sync(engine.device)
        t0 = time.perf_counter()
        n_rec, _c, _p = streaming_align(engine, fastq, out)
        sync(engine.device)
        dt = time.perf_counter() - t0
        out.unlink(missing_ok=True)
        Path(str(out) + ".progress.json").unlink(missing_ok=True)
        if n_rec != n_reads:
            raise AssertionError(f"{n_rec} records for {n_reads} reads")
        if r > 0:
            rates.append(n_reads / dt)
    return statistics.median(rates), rates


def run_end_to_end(cfg, state, n_reads, tmpdir, rounds=E2E_ROUNDS):
    """bench.run_end_to_end() on the port: simulate_reads(seed=3) written to
    a FASTQ, then streaming_align to SAM -> (best, median, every round)."""
    from parasuite_tpu_torch.io.fastq import write_fastq
    from parasuite_tpu_torch.sim.generate import simulate_reads

    ref, _index, engine = state
    codes, lengths, _truth = simulate_reads(ref, n_reads, READ_LEN, cfg,
                                            seed=3, tc_rate=0.12)
    fastq = Path(tmpdir) / "bench_e2e.fastq"
    write_fastq(fastq, [f"r{i}" for i in range(n_reads)], np.asarray(codes),
                np.asarray(lengths))
    median, rates = stream_rate(engine, fastq, n_reads, tmpdir, rounds,
                                name="bench_e2e.sam")
    return max(rates), median, rates


# ---------------------------------------------------------------------------
# the bench world as files (numpy only, so the JAX package can be run on the
# same files)
# ---------------------------------------------------------------------------

def bench_chrom() -> np.ndarray:
    """build_state's reference: default_rng(1), REF_LEN uniform bases, one
    chromosome."""
    return np.random.default_rng(1).integers(0, 4, REF_LEN).astype(np.int8)


def draw_reads(chrom: np.ndarray, n: int, L: int, seed: int,
               sub_rate: float = 0.002):
    """The file world's read model -> (reads int8 [n, L], start, reverse).

    default_rng(seed): starts uniform over the windows of L + 1 bases that
    hold no N, exactly half reverse-strand, 1% with a single-base deletion,
    `sub_rate` substitutions, T->C at 12% of the read's T positions (machine
    frame), N_ALL_N all-N reads."""
    rng = np.random.default_rng(seed)
    last = chrom.shape[0] - L - 1
    n_before = np.concatenate([[0], np.cumsum(chrom == 4, dtype=np.int32)])
    clean = np.flatnonzero(n_before[L + 1 : last + L + 1] == n_before[:last])
    start = clean[rng.integers(0, clean.shape[0], n)]
    deletion = rng.random(n) < 0.01
    cut = rng.integers(5, L - 5, n)
    col = np.arange(L)[None, :]
    idx = start[:, None] + col + (deletion[:, None] & (col >= cut[:, None]))
    frag = chrom[idx]
    sub = rng.random((n, L)) < sub_rate
    frag = np.where(sub, (frag + rng.integers(1, 4, (n, L))) % 4, frag)
    reverse = np.zeros(n, dtype=bool)
    reverse[rng.permutation(n)[: n // 2]] = True
    reads = np.where(reverse[:, None], 3 - frag[:, ::-1], frag)
    conv = (reads == 3) & (rng.random((n, L)) < 0.12)
    reads = np.where(conv, 1, reads).astype(np.int8)
    reads[rng.choice(n, N_ALL_N, replace=False)] = 4
    return reads, start, reverse


def write_world(out_dir, n_reads: int = SMOKE_READS) -> dict:
    """Reference FASTA, all-reads and pinned FASTQs and the truth (.npz):
    bench_chrom() and draw_reads(seed 2) at READ_LEN."""
    from parasuite_tpu_torch.io.fasta import write_fasta
    from parasuite_tpu_torch.io.fastq import write_fastq

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    chrom = bench_chrom()
    write_fasta(out / "ref.fa", {"chr_bench": chrom})
    reads, start, reverse = draw_reads(chrom, n_reads, READ_LEN, 2)
    lengths = np.full(n_reads, READ_LEN, dtype=np.int32)
    names = [f"r{i}" for i in range(n_reads)]
    write_fastq(out / "all.fastq", names, reads, lengths)
    write_fastq(out / "pin.fastq", names[:N_PIN], reads[:N_PIN],
                lengths[:N_PIN])
    truth = {"start": start, "reverse": reverse}
    np.savez(out / "truth.npz", **truth)
    return truth
