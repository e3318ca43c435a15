#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (parasuite_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's main path on the bench world of the JAX package (a 20 Mbp
random reference, k = 12, 50 bp PAR-CLIP reads, bench.make_cfg()), in phases;
each prints one line, and any failure raises (exit code != 0):

  1. environment: CUDA present, the package present, GPU name and power
     limit, torch / CUDA / nvcc / Triton versions;
  2. build: both CUDA kernels compiled from parasuite_tpu_torch/csrc;
  3. world: reference, k-mer index (through the port's CLI) and 262,144
     reads with truth, written under .smoke/;
  4. kernels vs plain: on real stage inputs of 16,384 reads each kernel is
     array-equal to its plain PyTorch version (tolerance 0: integer
     outputs); median times of both, and the kernels alone at 65,536 reads;
  5. pinned to the JAX package: `twopass --learned-gaps` through the port's
     CLI on the first 16,384 reads; the pass-1 SAM, .errorprofile and final
     SAM must have the SHA-256 digests the JAX package's CLI produced on the
     CPU (PINNED below);
  6. at scale: `align` to SAM and `twopass` to BAM on all 262,144 reads;
     every read gets a record, both kernels ran once per batch and pass
     (launch counters), the outputs have the JAX package's digests
     (AT_SCALE), sensitivity and precision are within 0.002 of the JAX
     package's on the same reads (JAX_ACCURACY); device-step and
     FASTQ->SAM reads/s beside the GPU's name and power limit.

Then one JSON line on the kernels, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

The world is a pure function of the seeds, so the digests can be recomputed
anywhere with the JAX package:

    python -c "import chip_smoke; chip_smoke.write_world('W')"
    python -m parasuite_tpu.cli index W/ref.fa W/idx FLAGS
    python -m parasuite_tpu.cli twopass W/idx W/pin.fastq W/pin.sam \\
        --learned-gaps --pg-cl smoke --batch-size 4096 FLAGS
    python -m parasuite_tpu.cli align W/idx W/all.fastq W/all.sam \\
        --pg-cl smoke --batch-size 4096 FLAGS
    python -m parasuite_tpu.cli twopass W/idx W/all.fastq W/all.bam \\
        --learned-gaps --pg-cl smoke --batch-size 4096 FLAGS
    python -c "from parasuite_tpu.io.bam import bam_to_sam; \\
        bam_to_sam('W/all.bam', 'W/all_tp.sam')"
    FLAGS = --max-read-len 50 --kmer-size 12 --max-candidates 8 --max-occ 16

Outputs do not depend on the batch size, so the JAX runs use batches of
4,096 reads (small enough for a CPU) and the port the world's 65,536.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
WORK = REPO / ".smoke"

REF_LEN = 20_000_000        # bench.REF_LEN
READ_LEN = 50
N_READS = 262_144           # 4 batches of 65,536
N_PIN = 16_384              # reads pinned to the JAX package's digests
N_ALL_N = 256
BATCH = 65_536              # bench.BATCH_TPU
PIN_BATCH = 4_096
FLAGS = ["--max-read-len", "50", "--kmer-size", "12", "--max-candidates",
         "8", "--max-occ", "16"]

# SHA-256 of the files `python -m parasuite_tpu.cli` (JAX on the CPU) wrote
# for the commands in the module docstring
PINNED = {
    "pin.fastq":
        "ec30bfcc82825b0a8fd79e7104c0fd66316615aced4267a6bf0723872f74cc14",
    "pin.sam.pass1.sam":
        "33fa793c2c683b27fdb1749bde446a7b50caeb3c57fc245b94c777e7a756c6e6",
    "pin.sam.errorprofile":
        "54910bb5da4e7cfdaf55472b3b42771e85c53fba8e22bd0de853e38e2869bef4",
    "pin.sam":
        "ee3e6d6718a34d3cca14232abc272da7702f07a17e109a86f09091332cea6e58",
}
# ... and for all N_READS reads (`align` and `twopass --learned-gaps` with
# --pg-cl smoke --batch-size 4096; the twopass BAM compared as bam_to_sam
# text, since BGZF block cuts follow the batch size)
AT_SCALE = {
    "all.sam":
        "2fb32b7dc27e74e779d0ef4dca2707a65e7ff04cd15be640aa3a8b8e95ca259a",
    "all.bam.pass1.sam":
        "2fb32b7dc27e74e779d0ef4dca2707a65e7ff04cd15be640aa3a8b8e95ca259a",
    "all.bam.errorprofile":
        "06b61ddc56c233f992641846145346ebaa76598ec6503d667178d0473c862c02",
    "all_tp.sam":
        "e74c6fed6ead8b988d4e35f19495b38d59364ee99aae2a96d8f1cf2582d57fcb",
}
# the JAX package's accuracy on those runs (accuracy() on its SAMs)
JAX_ACCURACY = {
    "align": {"sensitivity": 0.990203857421875,
              "precision": 0.9999845904923338},
    "twopass": {"sensitivity": 0.9898834228515625,
                "precision": 0.9996571397752532},
}
ACCURACY_SLACK = 0.002


def sha256(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def phase(label: str, /, **fields) -> None:
    print(json.dumps({"phase": label, **fields}), flush=True)


# ---------------------------------------------------------------------------
# the world (numpy only, so the JAX package can be run on the same files)
# ---------------------------------------------------------------------------

def write_world(out_dir, n_reads: int = N_READS) -> dict:
    """Reference FASTA, all-reads and pinned FASTQs and the truth (.npz).

    Reference: bench.build_state's (default_rng(1), REF_LEN uniform bases,
    one chromosome). Reads (default_rng(2)): exactly half reverse-strand,
    1% with a single-base deletion, 0.2% substitutions, T->C at 12% of the
    read's T positions (machine frame), N_ALL_N all-N reads."""
    from parasuite_tpu.io.fasta import write_fasta
    from parasuite_tpu.io.fastq import write_fastq

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    chrom = np.random.default_rng(1).integers(0, 4, REF_LEN).astype(np.int8)
    write_fasta(out / "ref.fa", {"chr_bench": chrom})

    rng = np.random.default_rng(2)
    n, L = n_reads, READ_LEN
    start = rng.integers(0, REF_LEN - L - 1, n)
    deletion = rng.random(n) < 0.01
    cut = rng.integers(5, L - 5, n)
    col = np.arange(L)[None, :]
    idx = start[:, None] + col + (deletion[:, None] & (col >= cut[:, None]))
    frag = chrom[idx]
    sub = rng.random((n, L)) < 0.002
    frag = np.where(sub, (frag + rng.integers(1, 4, (n, L))) % 4, frag)
    reverse = np.zeros(n, dtype=bool)
    reverse[rng.permutation(n)[: n // 2]] = True
    reads = np.where(reverse[:, None], 3 - frag[:, ::-1], frag)
    conv = (reads == 3) & (rng.random((n, L)) < 0.12)
    reads = np.where(conv, 1, reads).astype(np.int8)
    reads[rng.choice(n, N_ALL_N, replace=False)] = 4
    lengths = np.full(n, L, dtype=np.int32)
    names = [f"r{i}" for i in range(n)]
    write_fastq(out / "all.fastq", names, reads, lengths)
    write_fastq(out / "pin.fastq", names[:N_PIN], reads[:N_PIN],
                lengths[:N_PIN])
    truth = {"start": start, "reverse": reverse}
    np.savez(out / "truth.npz", **truth)
    return truth


def accuracy(sam_path, truth: dict) -> dict:
    """Sensitivity and precision of a SAM in read order against the truth:
    correct = mapped to the true strand and start (tolerance 0)."""
    flags, pos, n = [], [], 0
    with open(sam_path) as fh:
        for line in fh:
            if line.startswith("@"):
                continue
            f = line.split("\t", 4)
            flags.append(int(f[1]))
            pos.append(int(f[3]) - 1)
            n += 1
    flags, pos = np.asarray(flags), np.asarray(pos)
    mapped = (flags & 4) == 0
    correct = (mapped & (((flags & 16) != 0) == truth["reverse"][:n])
               & (pos == truth["start"][:n]))
    return {"n_reads": n, "n_mapped": int(mapped.sum()),
            "n_correct": int(correct.sum()),
            "sensitivity": float(correct.sum() / n),
            "precision": float(correct.sum() / max(int(mapped.sum()), 1))}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def environment() -> str:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false — "
                         "this needs an NVIDIA GPU")
    if not (REPO / "parasuite_tpu_torch" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke: no parasuite_tpu_torch package beside "
                         f"{Path(__file__).name} — run it from the repo root")
    gpu = gpu_line()
    from parasuite_tpu_torch.ops._build import nvcc_path

    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = "not installed"
    print(gpu, flush=True)
    phase("environment", gpu=gpu, torch=torch.__version__,
          cuda=torch.version.cuda, nvcc=nvcc[-1] if nvcc else "",
          triton=triton_version, python=sys.version.split()[0])
    return gpu


def build() -> None:
    from parasuite_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build()
    _build.load()
    regs = [line.strip() for line in _build.build_log.splitlines()
            if "registers" in line]
    phase("build", seconds=round(time.perf_counter() - t0, 3),
          library=str(_build.LIB.relative_to(REPO)), ptxas=regs)


def world() -> dict:
    from parasuite_tpu_torch.cli import main as cli

    t0 = time.perf_counter()
    if WORK.exists():
        shutil.rmtree(WORK)
    truth = write_world(WORK)
    with contextlib.redirect_stdout(io.StringIO()):
        cli(["index", str(WORK / "ref.fa"), str(WORK / "idx"), *FLAGS])
    pin = sha256(WORK / "pin.fastq")
    if pin != PINNED["pin.fastq"]:
        raise AssertionError(f"world differs from the pinned one: pin.fastq "
                             f"{pin}")
    phase("world", seconds=round(time.perf_counter() - t0, 3),
          reads=N_READS, ref_len=REF_LEN, pin_fastq_sha256=pin)
    return truth


def _median_ms(fn, reps: int = 10) -> float:
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kernels_vs_plain(engine) -> list[dict]:
    """Each kernel against its plain version on real stage inputs."""
    import torch

    from parasuite_tpu.io.fastq import read_fastq
    from parasuite_tpu_torch.ops import aligner, cuda_extend, cuda_seed

    cfg, didx, sprof, dev = engine.cfg, engine.didx, engine.sprof, \
        engine.device
    batch = read_fastq(WORK / "all.fastq", READ_LEN)

    def stage_inputs(n):
        codes = torch.from_numpy(batch.codes[:n]).to(dev)
        lens = torch.from_numpy(batch.lengths[:n].astype(np.int32)).to(dev)
        oriented = aligner.orient_reads(codes, lens)
        return oriented, lens, aligner.seed_diagonals(oriented, lens, didx,
                                                      cfg)

    out = []
    oriented, lens, diags = stage_inputs(N_PIN)
    cand, valid = cuda_seed.select_candidates(diags, cfg)
    cand_p, valid_p = cuda_seed.select_candidates_plain(diags, cfg)
    ext = cuda_extend.extend_candidates(oriented, lens, cand, didx, sprof,
                                        cfg)
    ext_p = cuda_extend.extend_candidates_plain(oriented, lens, cand, didx,
                                                sprof, cfg)
    torch.cuda.synchronize()
    checks = {
        "select_candidates": [(cand, cand_p), (valid, valid_p)],
        "extend_candidates": list(zip(ext, ext_p)),
    }
    timed = {
        "select_candidates": (
            lambda d: cuda_seed.select_candidates(d[2], cfg),
            lambda d: cuda_seed.select_candidates_plain(d[2], cfg)),
        "extend_candidates": (
            lambda d: cuda_extend.extend_candidates(d[0], d[1], cand, didx,
                                                    sprof, cfg),
            lambda d: cuda_extend.extend_candidates_plain(
                d[0], d[1], cand, didx, sprof, cfg)),
    }
    sources = {"select_candidates": ("select_candidates.cu",
                                     "parasuite_tpu/ops/pallas_seed.py:40"),
               "extend_candidates": ("extend_candidates.cu",
                                     "parasuite_tpu/ops/pallas_extend.py:56")}
    d16 = (oriented, lens, diags)
    for name, pairs in checks.items():
        err = 0
        for k, p in pairs:
            if k.shape != p.shape or k.dtype != p.dtype:
                raise AssertionError(f"{name}: kernel {k.shape} {k.dtype} vs "
                                     f"plain {p.shape} {p.dtype}")
            err = max(err, int((k.long() - p.long()).abs().max()))
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from plain, max "
                                 f"abs err {err}")
        kern, plain = timed[name]
        out.append({"name": name, "route": "cuda",
                    "source": f"parasuite_tpu_torch/csrc/{sources[name][0]}",
                    "replaces": sources[name][1], "launches": 0,
                    "max_abs_err": err, "reads": int(lens.shape[0]),
                    "ms": _median_ms(lambda: kern(d16)),
                    "plain_ms": _median_ms(lambda: plain(d16))})
    # the kernels alone at the main path's batch of 65,536 reads
    oriented, lens, diags = stage_inputs(BATCH)
    cand, _ = cuda_seed.select_candidates(diags, cfg)
    out[0]["ms_65536"] = _median_ms(
        lambda: cuda_seed.select_candidates(diags, cfg))
    out[1]["ms_65536"] = _median_ms(
        lambda: cuda_extend.extend_candidates(oriented, lens, cand, didx,
                                              sprof, cfg))
    for k in out:
        phase("kernel", **k)
    return out


def _cli_json(argv) -> dict:
    from parasuite_tpu_torch.cli import main as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if cli(argv) != 0:
            raise AssertionError(f"cli failed: {argv}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _reset_counters():
    from parasuite_tpu_torch.ops import cuda_extend, cuda_seed

    cuda_seed.launches = 0
    cuda_extend.launches = 0


def _counters() -> dict:
    from parasuite_tpu_torch.ops import cuda_extend, cuda_seed

    return {"select_candidates": cuda_seed.launches,
            "extend_candidates": cuda_extend.launches}


def _expect_launches(got: dict, want: int, what: str) -> None:
    if any(v != want for v in got.values()):
        raise AssertionError(f"{what}: kernel launches {got}, want {want} "
                             f"each (batches x passes)")


def pinned_twopass() -> None:
    _reset_counters()
    t0 = time.perf_counter()
    res = _cli_json(["twopass", str(WORK / "idx"), str(WORK / "pin.fastq"),
                     str(WORK / "pin.sam"), "--learned-gaps", "--pg-cl",
                     "smoke", "--batch-size", str(PIN_BATCH), *FLAGS,
                     "--device", "cuda"])
    dt = time.perf_counter() - t0
    launches = _counters()
    _expect_launches(launches, 2 * (N_PIN // PIN_BATCH), "pinned twopass")
    digests = {name: sha256(WORK / name) for name in PINNED}
    bad = {k: v for k, v in digests.items() if v != PINNED[k]}
    phase("pinned", seconds=round(dt, 3), reads=res["reads"],
          gap_open=res["gap_open"], gap_extend=res["gap_extend"],
          launches=launches, digests=digests)
    if bad:
        raise AssertionError(f"outputs differ from the JAX package's: {bad}")


def at_scale(truth: dict, gpu: str) -> dict:
    from parasuite_tpu.io.bam import bam_to_sam

    _reset_counters()
    al = _cli_json(["align", str(WORK / "idx"), str(WORK / "all.fastq"),
                    str(WORK / "all.sam"), "--pg-cl", "smoke",
                    "--batch-size", str(BATCH), *FLAGS, "--device", "cuda"])
    tp = _cli_json(["twopass", str(WORK / "idx"), str(WORK / "all.fastq"),
                    str(WORK / "all.bam"), "--learned-gaps", "--pg-cl",
                    "smoke", "--batch-size", str(BATCH), *FLAGS, "--device",
                    "cuda"])
    launches = _counters()
    n_batches = -(-N_READS // BATCH)
    _expect_launches(launches, 3 * n_batches, "align + twopass")
    bam_to_sam(WORK / "all.bam", WORK / "all_tp.sam")
    digests = {name: sha256(WORK / name) for name in AT_SCALE}
    bad = {k: v for k, v in digests.items() if v != AT_SCALE[k]}
    if bad:
        raise AssertionError(f"outputs differ from the JAX package's: {bad}")
    acc = {"align": accuracy(WORK / "all.sam", truth),
           "twopass": accuracy(WORK / "all_tp.sam", truth)}
    for run, a in acc.items():
        if a["n_reads"] != N_READS:
            raise AssertionError(f"{run}: {a['n_reads']} records for "
                                 f"{N_READS} reads")
        for metric in ("sensitivity", "precision"):
            floor = JAX_ACCURACY[run][metric] - ACCURACY_SLACK
            if a[metric] < floor:
                raise AssertionError(f"{run} {metric} {a[metric]} below "
                                     f"{floor}")
    phase("at_scale", launches=launches, accuracy=acc, digests=digests,
          fastq_to_sam_reads_per_s=al["reads_per_second"],
          twopass_reads=tp["reads"], gpu=gpu)
    return launches


def device_rate(engine, gpu: str) -> None:
    """Reads/s of the device step alone: host codes in, AlignResult on the
    device (upload included, result fetch excluded), warm-up excluded."""
    import torch

    from parasuite_tpu.io.fastq import read_fastq

    batch = read_fastq(WORK / "all.fastq", READ_LEN)
    chunks = [(batch.codes[i:i + BATCH], batch.lengths[i:i + BATCH])
              for i in range(0, N_READS, BATCH)]
    engine.align_device(*chunks[0])
    torch.cuda.synchronize()
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        for codes, lens in chunks:
            engine.align_device(codes, lens)
        torch.cuda.synchronize()
        rates.append(N_READS / (time.perf_counter() - t0))
    phase("device_step", reads_per_s=rates, batch=BATCH, gpu=gpu)
    stage_split(engine, *chunks[0], gpu)


def stage_split(engine, codes, lengths, gpu: str) -> None:
    """Median ms of each stage of one device step at the main path's
    batch (CUDA events): where the device step's time goes."""
    import torch

    from parasuite_tpu_torch.ops import aligner, cuda_extend, cuda_seed

    cfg, didx, sprof = engine.cfg, engine.didx, engine.sprof
    c, ln = engine._upload(codes, lengths)
    ms = engine._ms_table[ln.long()]
    o = aligner.orient_reads(c, ln)
    d = aligner.seed_diagonals(o, ln, didx, cfg)
    cd, cv = cuda_seed.select_candidates(d, cfg)
    ext = cuda_extend.extend_candidates(o, ln, cd, didx, sprof, cfg)
    res = aligner.finalize(o, ln, ms, cd, cv, *ext, didx, sprof, cfg)
    stages = {
        "upload": lambda: engine._upload(codes, lengths),
        "orient": lambda: aligner.orient_reads(c, ln),
        "seed": lambda: aligner.seed_diagonals(o, ln, didx, cfg),
        "select": lambda: cuda_seed.select_candidates(d, cfg),
        "extend": lambda: cuda_extend.extend_candidates(o, ln, cd, didx,
                                                        sprof, cfg),
        "finalize": lambda: aligner.finalize(o, ln, ms, cd, cv, *ext, didx,
                                             sprof, cfg),
        "profile_counts": lambda: engine.profile_counts_device(
            codes, lengths, res),
        "fetch": lambda: torch.stack([x.to(torch.int32) for x in res]).cpu(),
    }
    phase("stages", batch=BATCH, gpu=gpu,
          ms={name: _median_ms(fn) for name, fn in stages.items()})


def main() -> int:
    gpu = environment()
    build()
    truth = world()

    import torch

    from parasuite_tpu.config import AlignConfig
    from parasuite_tpu.index import KmerIndex, PackedReference
    from parasuite_tpu_torch.pipeline.align import AlignerEngine

    cfg = AlignConfig(max_read_len=READ_LEN, kmer_size=12, batch_size=BATCH,
                      max_candidates=8, max_occ=16)   # bench.make_cfg()
    engine = AlignerEngine(PackedReference.load(WORK / "idx"),
                           KmerIndex.load(WORK / "idx"), cfg, device="cuda")
    kernels = kernels_vs_plain(engine)
    pinned_twopass()
    launches = at_scale(truth, gpu)
    device_rate(engine, gpu)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
