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
     FASTQ->SAM reads/s beside the GPU's name and power limit;
  7. xa: `align --xa` on a 51 Mbp repeat-structured chr22-class genome
     (write_xa_world), 131,072 reads of 50 bp; the SAM, the number of
     XA-tagged records and xa_dropped equal the JAX package's (XA_PINNED);
  8. rescue: `twopass --learned-gaps --rescue-kmer 11` to BAM on 131,072
     reads of 36 bp with 3% substitutions on the bench reference
     (write_rescue_reads); pass-1 SAM, .errorprofile, final SAM and the
     rescue counters equal the JAX package's (RESCUE_PINNED), and both
     kernels equal their plain versions at the rescue pass's shapes;
  9. combined: `combine` on tools/bench_combined.py's world (an 8 Mbp
     genome with 400 three-exon transcripts, write_combined_world), then
     `twopass --learned-gaps` on its 262,144 reads and `align --xa` on the
     first 16,384; the index files and every output equal the JAX package's
     (COMBINED_PINNED); FASTQ->SAM reads/s of combined and plain mode
     (`align` on a genome-only index) on the same reads.
Phases 7-9 run through the port's CLI with --device cuda and check the exact
kernel launch counts of their runs.

Then one JSON line on the kernels (launches summed over phases 5-9), and as
the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

The worlds are pure functions of the seeds, so the digests can be
recomputed anywhere with the JAX package:

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

Phases 7-9 (RFLAGS = FLAGS with --max-read-len 36):

    python -c "import chip_smoke as c; c.write_rescue_reads('W'); \\
        c.write_xa_world('W/xa'); c.write_combined_world('W/comb')"
    python -m parasuite_tpu.cli index W/xa/ref.fa W/xa/idx FLAGS
    python -m parasuite_tpu.cli align W/xa/idx W/xa/reads.fastq W/xa/xa.sam \\
        --xa --pg-cl smoke --batch-size 4096 --log W/xa/log FLAGS
    python -m parasuite_tpu.cli twopass W/idx W/rescue.fastq W/rescue.bam \\
        --learned-gaps --rescue-kmer 11 --pg-cl smoke --batch-size 16384 RFLAGS
    python -c "from parasuite_tpu.io.bam import bam_to_sam; \\
        bam_to_sam('W/rescue.bam', 'W/rescue_tp.sam')"
    python -m parasuite_tpu.cli combine W/comb/ref.fa W/comb/exons.tsv \\
        W/comb/cidx FLAGS
    python -m parasuite_tpu.cli twopass W/comb/cidx W/comb/all.fastq \\
        W/comb/tp.sam --learned-gaps --pg-cl smoke --batch-size 4096 FLAGS
    python -m parasuite_tpu.cli align W/comb/cidx W/comb/xa.fastq \\
        W/comb/xa.sam --xa --pg-cl smoke --batch-size 4096 FLAGS

xa_dropped is the `align.done` event of W/xa/log; the JAX CLI prints no
rescue counters, so RESCUE_PINNED's are the JAX engines' `rescue_mapped`
and `rescue_overflow` summed over the run's two engines (read by wrapping
parasuite_tpu.cli._load_engine).

Outputs do not depend on the batch size, so the JAX runs use batches of
4,096 reads (small enough for a CPU) and the port the world's 65,536. The
one exception is rescue: its batch is capped at max(256, batch / 8) rows,
so both packages run it at RESCUE_BATCH.
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
N_MODE_READS = 131_072      # reads of the xa and rescue phases
RESCUE_LEN = 36
RESCUE_BATCH = 16_384       # rescue output depends on the batch (its cap)
COMB_GENOME = 8_000_000     # tools/bench_combined.py's world
COMB_TX = 400
COMB_DRAWN = 262_144        # reads drawn before spacer-straddlers drop
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
RFLAGS = [*FLAGS, "--max-read-len", str(RESCUE_LEN)]
# phases 7-9: the JAX package's outputs for the commands in the docstring
# (inputs included, so a world that drifted is named as such)
XA_PINNED = {
    "xa/reads.fastq":
        "6b55efc9d1b990d0ace00c933bc7310e6f8f58e41ce7f015c2208bf93b8f7c8c",
    "xa/xa.sam":
        "e2991d45c8880bed563c914dd0892cd1c4097c7ce066c36ffd0390977d9b082c",
    "xa_records": 8433,
    "xa_dropped": 0,
}
RESCUE_PINNED = {
    "rescue.fastq":
        "1412f2dfa8ffda589730829eda7f541b88eeb176b815ba7378cf5e4b770476a0",
    "rescue.bam.pass1.sam":
        "a2a61d21a325fbfea1e6cf845a49a5c7c58887ce6d59b258da805bd75279616b",
    "rescue.bam.errorprofile":
        "96e7df7c139f73c8cf90678737b671b0ab80654fae4ead8c91f3056c964d4b37",
    "rescue_tp.sam":
        "9e38714031360d2dd18bc0b054c17fe3dcd6951dc753a82921fd2f307b5348c8",
    "rescue_mapped": 7701,
    "rescue_overflow": 0,
}
COMBINED_PINNED = {
    "comb/all.fastq":
        "0da7e01b995b46ba949537e67df1dfae44ec2b99f5ce5efb063023135cc6762b",
    "comb/exons.tsv":
        "19a477908bbe25e7d26194591936e324e49789d4d62aa4243ae32bf725556d7a",
    "comb/cidx.combined.json":
        "b31c514c551e6d0e41c98b58ef0eb0f46385a3eb0c4a67a1c3a8e6981cf9f73f",
    "comb/cidx.config.json":
        "4342874f376c7c8a8b8ad416b711727f9f44af8085083c56f9baee82a0747a85",
    "comb/cidx.kidx.npz":
        "c964d9eef6034d3578ca84c2f078c010074d46b55c90c74f08893d4278ed67d2",
    "comb/cidx.ref.json":
        "e836debbfc5599e883bce61bd3634fcc6503241610e66caa228b93ac2713e27d",
    "comb/cidx.seq.npy":
        "d3d8896dc6f277f6990907600237dd2489ad3841122dc01a9ed1e4b4e577ad34",
    "comb/tp.sam.pass1.sam":
        "9ad6279d91196b0dc1350dbcc40a27dc532509ce40583bd83e919319ed53076a",
    "comb/tp.sam.errorprofile":
        "5a5d0a84399c10ddb56147c1e46086e3f2eb94f00ccfcc1d0fe46be0013000ba",
    "comb/tp.sam":
        "78344f7e706a2cad13c722de0aecff5ece416123778a393104c773d3b10aee2b",
    "comb/xa.sam":
        "7714e7d4d1d7e71660258f9649bb6465f91afe96998100332c9f2db930c2f815",
}


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

def bench_chrom() -> np.ndarray:
    """bench.build_state's reference: default_rng(1), REF_LEN uniform
    bases, one chromosome."""
    return np.random.default_rng(1).integers(0, 4, REF_LEN).astype(np.int8)


def draw_reads(chrom: np.ndarray, n: int, L: int, seed: int,
               sub_rate: float = 0.002):
    """The bench read model -> (reads int8 [n, L], start, reverse).

    default_rng(seed): starts uniform over the windows of L + 1 bases that
    hold no N, exactly half reverse-strand, 1% with a single-base deletion,
    `sub_rate` substitutions, T->C at 12% of the read's T positions (machine
    frame), N_ALL_N all-N reads. On a reference without N the draws are
    bench.py's."""
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


def write_world(out_dir, n_reads: int = N_READS) -> dict:
    """Reference FASTA, all-reads and pinned FASTQs and the truth (.npz):
    bench_chrom() and draw_reads(seed 2) at READ_LEN."""
    from parasuite_tpu.io.fasta import write_fasta
    from parasuite_tpu.io.fastq import write_fastq

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


def write_rescue_reads(out_dir) -> None:
    """rescue.fastq: N_MODE_READS reads of RESCUE_LEN bp on the bench
    reference, draw_reads(seed 3) at 3% substitutions, so the primary
    k = 12 pass leaves reads unmapped."""
    from parasuite_tpu.io.fastq import write_fastq

    reads, _, _ = draw_reads(bench_chrom(), N_MODE_READS, RESCUE_LEN, 3,
                             sub_rate=0.03)
    write_fastq(Path(out_dir) / "rescue.fastq",
                [f"s{i}" for i in range(N_MODE_READS)], reads,
                np.full(N_MODE_READS, RESCUE_LEN, dtype=np.int32))


def write_xa_world(out_dir) -> None:
    """ref.fa: chr22_like(seed=22), the 51 Mbp repeat-structured stand-in
    for hg19 chr22 (a ~10.3 Mbp leading N block, interspersed repeat
    families, satellite, segmental duplications); reads.fastq: N_MODE_READS
    reads of READ_LEN bp, draw_reads(seed 4) over windows without N."""
    from parasuite_tpu.io.fasta import write_fasta
    from parasuite_tpu.io.fastq import write_fastq
    from parasuite_tpu_torch.sim.genome import chr22_like

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    seqs, _ = chr22_like(seed=22)
    write_fasta(out / "ref.fa", seqs)
    reads, _, _ = draw_reads(seqs["chr22s"], N_MODE_READS, READ_LEN, 4)
    write_fastq(out / "reads.fastq", [f"x{i}" for i in range(N_MODE_READS)],
                reads, np.full(N_MODE_READS, READ_LEN, dtype=np.int32))


def write_combined_world(out_dir) -> int:
    """The world of tools/bench_combined.py, without jax: an 8 Mbp chr1
    (default_rng(11)) with 400 three-exon transcripts (exons 120-400 bp,
    introns 200-2,000 bp, alternating strands) -> ref.fa + exons.tsv; reads
    (default_rng(12)): COMB_DRAWN drawn from the combined packing, half
    genomic and half spliced-transcript (many junction-spanning), T->C at
    12% of T, reads straddling a spacer dropped, shuffled -> all.fastq, and
    the first N_PIN of them -> xa.fastq. Returns the number of reads."""
    from parasuite_tpu.config import AlignConfig
    from parasuite_tpu.io.fasta import write_fasta
    from parasuite_tpu.io.fastq import write_fastq
    from parasuite_tpu_torch.pipeline.combined import (CombinedReference,
                                                       Transcript)

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(11)
    genome = {"chr1": rng.integers(0, 4, COMB_GENOME).astype(np.int8)}
    txs = []
    for t in range(COMB_TX):
        start = int(rng.integers(0, COMB_GENOME - 10_000))
        starts, ends, p = [], [], start
        for _ in range(3):
            e = int(rng.integers(120, 400))
            starts.append(p)
            ends.append(p + e)
            p += e + int(rng.integers(200, 2000))
        txs.append(Transcript(f"t{t}", "chr1", "+" if t % 2 else "-",
                              np.asarray(starts, dtype=np.int64),
                              np.asarray(ends, dtype=np.int64)))
    write_fasta(out / "ref.fa", genome)
    (out / "exons.tsv").write_text("".join(
        f"{t.tx_id}\t{t.chrom}\t{t.strand}\t"
        f"{','.join(map(str, t.exon_starts))}\t"
        f"{','.join(map(str, t.exon_ends))}\n" for t in txs))
    ref = CombinedReference.build(genome, txs,
                                  AlignConfig().chrom_spacer).ref

    rng = np.random.default_rng(12)
    n_g = COMB_DRAWN // 2
    gpos = rng.integers(int(ref.starts[0]), int(ref.ends[0]) - READ_LEN, n_g)
    n_t = COMB_DRAWN - n_g
    ti = rng.integers(0, len(txs), n_t)
    name_to_ci = {nm: i for i, nm in enumerate(ref.names)}
    tstart = np.asarray([ref.starts[name_to_ci[f"tx::{t.tx_id}"]]
                         for t in txs])
    tlen = np.asarray([t.spliced_len for t in txs])
    toff = (rng.random(n_t) * np.maximum(tlen[ti] - READ_LEN, 1)).astype(int)
    pos = np.concatenate([gpos, tstart[ti] + toff])
    codes = ref.seq[pos[:, None] + np.arange(READ_LEN)[None, :]]
    conv = (codes == 3) & (rng.random(codes.shape) < 0.12)
    codes = np.where(conv, 1, codes).astype(np.int8)
    codes = codes[~np.any(codes == 4, axis=1)]
    codes = codes[rng.permutation(codes.shape[0])]
    n = codes.shape[0]
    lengths = np.full(n, READ_LEN, dtype=np.int32)
    names = [f"c{i}" for i in range(n)]
    write_fastq(out / "all.fastq", names, codes, lengths)
    write_fastq(out / "xa.fastq", names[:N_PIN], codes[:N_PIN],
                lengths[:N_PIN])
    return n


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
    return launches


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


def _digests(pins: dict) -> dict:
    """SHA-256 of every file pinned in pins (the keys with str values)."""
    return {name: sha256(WORK / name) for name, want in pins.items()
            if isinstance(want, str)}


def _finish(label: str, pins: dict, got: dict, launches: dict,
            want_launches: int, **fields) -> None:
    """Print the phase line, then fail on a pinned value (file digest or
    counter) that differs from the JAX package's, or on a launch count
    that is not the run's."""
    phase(label, launches=launches, pinned=got, **fields)
    bad = {k: {"got": got[k], "jax": pins[k]} for k in pins
           if got[k] != pins[k]}
    if bad:
        raise AssertionError(f"{label}: differs from the JAX package's: "
                             f"{bad}")
    _expect_launches(launches, want_launches, label)


def _records(sam_path):
    """Alignment lines of a SAM file, header skipped."""
    with open(sam_path) as fh:
        return [line for line in fh if not line.startswith("@")]


def _n_batches(n: int, batch: int) -> int:
    return -(-n // batch)


def xa_phase(gpu: str) -> dict:
    t0 = time.perf_counter()
    write_xa_world(WORK / "xa")
    _cli_json(["index", str(WORK / "xa/ref.fa"), str(WORK / "xa/idx"),
               *FLAGS])
    t_world = time.perf_counter() - t0
    _reset_counters()
    res = _cli_json(["align", str(WORK / "xa/idx"),
                     str(WORK / "xa/reads.fastq"), str(WORK / "xa/xa.sam"),
                     "--xa", "--pg-cl", "smoke", "--batch-size", str(BATCH),
                     *FLAGS, "--device", "cuda"])
    launches = _counters()
    n_xa = sum("\tXA:Z:" in line for line in _records(WORK / "xa/xa.sam"))
    if n_xa == 0:
        raise AssertionError("xa: no XA-tagged record")
    _finish("xa", XA_PINNED,
            {**_digests(XA_PINNED), "xa_records": n_xa,
             "xa_dropped": res["xa_dropped"]},
            launches, _n_batches(N_MODE_READS, BATCH),
            seconds=round(time.perf_counter() - t0, 3),
            world_and_index_seconds=round(t_world, 3), reads=res["reads"],
            align_seconds=res["seconds"],
            reads_per_s=res["reads_per_second"], gpu=gpu)
    return launches


def _kernels_equal_plain(didx, sprof, cfg, codes, lengths) -> dict:
    """Both kernels against their plain versions on the stage inputs of
    one batch -> {kernel: max abs err}; raises unless every output is
    array-equal."""
    import torch

    from parasuite_tpu_torch.ops import aligner, cuda_extend, cuda_seed

    dev = didx.ref_seq.device
    c = torch.from_numpy(codes).to(dev)
    ln = torch.from_numpy(lengths.astype(np.int32)).to(dev)
    o = aligner.orient_reads(c, ln)
    d = aligner.seed_diagonals(o, ln, didx, cfg)
    pairs = {"select_candidates": list(zip(
        cuda_seed.select_candidates(d, cfg),
        cuda_seed.select_candidates_plain(d, cfg)))}
    cand = pairs["select_candidates"][0][0]
    pairs["extend_candidates"] = list(zip(
        cuda_extend.extend_candidates(o, ln, cand, didx, sprof, cfg),
        cuda_extend.extend_candidates_plain(o, ln, cand, didx, sprof, cfg)))
    torch.cuda.synchronize()
    errs = {name: max(int((k.long() - p.long()).abs().max()) for k, p in ps)
            for name, ps in pairs.items()}
    if any(errs.values()):
        raise AssertionError(f"kernels differ from plain at shape "
                             f"{tuple(d.shape)}: {errs}")
    return {**errs, "diagonals_per_row": int(d.shape[1]),
            "rows": int(d.shape[0])}


def rescue_phase(gpu: str) -> dict:
    from parasuite_tpu.config import AlignConfig
    from parasuite_tpu.index import KmerIndex, PackedReference
    from parasuite_tpu.io.bam import bam_to_sam
    from parasuite_tpu.io.fastq import read_fastq
    from parasuite_tpu_torch.pipeline.align import AlignerEngine

    t0 = time.perf_counter()
    write_rescue_reads(WORK)
    _reset_counters()
    t1 = time.perf_counter()
    res = _cli_json(["twopass", str(WORK / "idx"),
                     str(WORK / "rescue.fastq"), str(WORK / "rescue.bam"),
                     "--learned-gaps", "--rescue-kmer", "11", "--pg-cl",
                     "smoke", "--batch-size", str(RESCUE_BATCH), *RFLAGS,
                     "--device", "cuda"])
    t_run = time.perf_counter() - t1
    launches = _counters()
    bam_to_sam(WORK / "rescue.bam", WORK / "rescue_tp.sam")
    if res["rescue_mapped"] <= 0:
        raise AssertionError("rescue: no read rescued")
    # per pass: one primary step per batch, plus one rescue step in each
    # batch with unmapped rows; every batch of this world has some (all-N
    # reads are never mapped), which the final records confirm
    n_b = _n_batches(N_MODE_READS, RESCUE_BATCH)
    for sam in ("rescue.bam.pass1.sam", "rescue_tp.sam"):
        unmapped = [int(line.split("\t", 2)[1]) & 4 != 0
                    for line in _records(WORK / sam)]
        if not all(any(unmapped[i:i + RESCUE_BATCH])
                   for i in range(0, N_MODE_READS, RESCUE_BATCH)):
            raise AssertionError(f"rescue: a batch of {sam} has no unmapped "
                                 f"read; its launch count is not known")
    dt = time.perf_counter() - t0
    # the kernels at the rescue pass's shapes (k = 11, 13 seeds, L = 36)
    cfg = AlignConfig(max_read_len=RESCUE_LEN, kmer_size=12,
                      batch_size=RESCUE_BATCH, max_candidates=8, max_occ=16,
                      rescue_kmer=11)
    eng = AlignerEngine(PackedReference.load(WORK / "idx"),
                        KmerIndex.load(WORK / "idx"), cfg, device="cuda")
    cfg2, didx2, cap = eng._rescue
    batch = read_fastq(WORK / "rescue.fastq", RESCUE_LEN)
    vs_plain = _kernels_equal_plain(didx2, eng.sprof, cfg2,
                                    batch.codes[:cap], batch.lengths[:cap])
    _finish("rescue", RESCUE_PINNED,
            {**_digests(RESCUE_PINNED), "rescue_mapped": res["rescue_mapped"],
             "rescue_overflow": res["rescue_overflow"]},
            launches, 2 * 2 * n_b, seconds=round(dt, 3), reads=res["reads"],
            twopass_seconds=round(t_run, 3),
            twopass_reads_per_s=round(res["reads"] / t_run, 1),
            gap_open=res["gap_open"], gap_extend=res["gap_extend"],
            kernels_vs_plain_at_rescue_shapes=vs_plain, gpu=gpu)
    return launches


def combined_phase(gpu: str) -> dict:
    t0 = time.perf_counter()
    comb = WORK / "comb"
    n_reads = write_combined_world(comb)
    _cli_json(["combine", str(comb / "ref.fa"), str(comb / "exons.tsv"),
               str(comb / "cidx"), *FLAGS])
    _cli_json(["index", str(comb / "ref.fa"), str(comb / "gidx"), *FLAGS])
    t_world = time.perf_counter() - t0

    def align(index, fastq, out, *extra):
        return _cli_json(["align", str(comb / index), str(comb / fastq),
                          str(comb / out), "--pg-cl", "smoke",
                          "--batch-size", str(BATCH), *extra, *FLAGS,
                          "--device", "cuda"])

    _reset_counters()
    # FASTQ->SAM of plain and combined mode on the same reads, in turns
    rates = {"plain": [], "combined": []}
    for mode in ("plain", "combined", "combined", "plain"):
        index = "gidx" if mode == "plain" else "cidx"
        r = align(index, "all.fastq", f"{mode}.sam")
        if r["reads"] != n_reads:
            raise AssertionError(f"combined: {mode} align wrote {r['reads']} "
                                 f"records for {n_reads} reads")
        rates[mode].append(r["reads_per_second"])
    tp = _cli_json(["twopass", str(comb / "cidx"), str(comb / "all.fastq"),
                    str(comb / "tp.sam"), "--learned-gaps", "--pg-cl",
                    "smoke", "--batch-size", str(BATCH), *FLAGS, "--device",
                    "cuda"])
    xa = align("cidx", "xa.fastq", "xa.sam", "--xa")
    launches = _counters()
    n_b = _n_batches(n_reads, BATCH)
    got = _digests(COMBINED_PINNED)
    if sha256(comb / "combined.sam") != got["comb/tp.sam.pass1.sam"]:
        raise AssertionError("combined: align SAM differs from the twopass "
                             "pass-1 SAM")
    n_xa = sum("\tXA:Z:" in line for line in _records(comb / "xa.sam"))
    plain_rate = float(np.median(rates["plain"]))
    comb_rate = float(np.median(rates["combined"]))
    _finish("combined", COMBINED_PINNED, got, launches,
            4 * n_b + 2 * n_b + _n_batches(N_PIN, BATCH),
            seconds=round(time.perf_counter() - t0, 3),
            world_and_index_seconds=round(t_world, 3), reads=n_reads,
            fastq_to_sam_reads_per_s=rates,
            combined_over_plain=comb_rate / plain_rate,
            twopass_reads=tp["reads"], gap_open=tp["gap_open"],
            gap_extend=tp["gap_extend"], xa_reads=xa["reads"],
            xa_records=n_xa, xa_dropped=xa["xa_dropped"], gpu=gpu)
    return launches


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
    runs = [pinned_twopass(), at_scale(truth, gpu)]
    device_rate(engine, gpu)
    runs += [xa_phase(gpu), rescue_phase(gpu), combined_phase(gpu)]
    for k in kernels:
        k["launches"] = sum(r[k["name"]] for r in runs)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
