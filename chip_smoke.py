#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (parasuite_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's main path on the bench world of the JAX package (a 20 Mbp
random reference, k = 12, 50 bp PAR-CLIP reads, bench.make_cfg()), in phases;
each prints one line, and any failure raises (exit code != 0):

  1. environment: CUDA present, the package present, GPU name and power
     limit, torch / CUDA / nvcc / Triton versions; the port's own C++ host
     library (parasuite_tpu_torch/native) built and loaded;
  2. build: both CUDA kernels compiled from parasuite_tpu_torch/csrc; for
     each band width of the extend kernel, ptxas' registers and spills and
     the count of its DPX instructions in the SASS (cuobjdump): it fails on
     a spill or on a width without VIMNMX3 and VIADDMNMX
     (extend_build_report);
  3. world: reference, k-mer index (through the port's CLI) and 262,144
     reads with truth, written under .smoke/;
  4. kernels vs plain: on real stage inputs of 16,384 reads each kernel is
     array-equal to its plain PyTorch version (tolerance 0: integer
     outputs); median times of both, and the kernels alone at 65,536 reads
     (timed call by call, and per call over 20 back to back), each beside
     its bound (select_bound, extend_bound: the larger of bytes
     over the memory rate and operations over their rate; extend counts 6
     a DP cell, bound_ops_per_cell) — a kernel faster than its bound is a
     miscount and fails; the extend kernel's launch shape and blocks
     resident per SM (extend_occupancy); then the select kernel
     against its plain version at every row width it is built for
     (SELECT_CASES on select_case_rows: ties, all-I32MAX rows, one repeated
     diagonal);
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
     (COMBINED_PINNED). align and twopass run the projected step (device
     projection + re-finalization); the phase reports the entries and
     junction winners it sent to the host per batch and its overflow
     re-runs. FASTQ->SAM reads/s of plain mode (`align` on a genome-only
     index), combined mode, and combined mode on the unprojected step (the
     step before the projection) on the same reads, in turns; then the host
     split of one 65,536-read batch in each (device step, fetch + to_host,
     emit);
 10. sim: `simulate` of 262,144 reads of 50 bp on the bench index, flat,
     with `--profile` (the pinned pass-1 .errorprofile of phase 5)
     `--learned-indels`, and on the combined index; each FASTQ has the JAX
     CLI's SHA-256 (SIM_PINNED); reads/s of each;
 11. benchmark: `benchmark --n-reads 262144` on the bench index; n_mapped
     and n_correct equal the JAX CLI's (BENCH_PINNED); items_per_second;
 12. tools: `cluster` on phase 6's SAM and BAM, `sort` of both and
     `convert` of the sorted BAM to SAM (TOOLS_PINNED), and `convert` of
     the SAM to BAM and back to the same bytes.
 13. dist_step: the data-parallel step (parallel/dist_align.py, a
     compiled step a mesh slot) over the machine's cards and over the first
     card given twice, on one batch of 65,536 bench reads; AlignResult and
     the int64 counts array-equal to the engine's single-device step; one
     launch of each kernel per mesh device and call;
 14. dist_file: `dist-align --host-index h --n-hosts 2` for both hosts (in
     this process) on all 262,144 reads and `merge-shards`; the merged SAM
     and .errorprofile have the JAX CLI's digests (DIST_PINNED: those of
     its one-process `align` and of its twopass profile);
 15. dist_coord: `dist-align --coordinator` as two processes of the port's
     CLI that share the card (torch.distributed, the counts summed in-step
     by all_reduce; gloo, since NCCL takes one process per card), then as
     one process; each merged to the same two digests; the launches of the
     processes' JSON lines sum to the batch count plus one warm-up step a
     process; reads/s printed as what it is, two processes on one card;
 16. shards: the chromosome-sharded index (parallel/shards.py) on a world
     of two uniform 50 Mbp chromosomes (shards_world) and 65,536 reads of
     50 bp: build_sharded_index over two shards, make_sharded_step on a
     1 x 2 grid of the first card given twice; the outputs have the SHA-256
     of the JAX package's sharded step (SHARDS_PINNED), and against the
     port's replicated align_batch on the full 100 Mbp index no read is
     lost and every read the replicated path maps is equal in every field
     (the replicated candidate list saturates on this reference, so the
     sharded step maps a few hundred reads more: parallel/shards.py); two
     launches of each kernel a call; ms per call beside the replicated
     step's;
 17. scaling: `benchmark --scaling` over the machine's cards, and its
     refusal (exit code 2) of one card more than the machine has;
 18. entry: parasuite_tpu_torch.entry's entry() step and its dry run.
 19. profile_e2e: tools/torch_profile_e2e.py on the files of phases 6, 7
     and 9 — where FASTQ -> SAM time goes (the program's spans a thread,
     to_host split further, its counters), the device-busy share of the
     wall and the share of the idle card the main thread worked, from
     torch.profiler with the main thread's spans as ranges in its trace,
     bytes up and down per batch — in plain mode, with --xa and in
     combined mode; the recorded SAMs are the unrecorded ones;
 20. sweep_lengths: tools/torch_sweep_lengths.py, adaptive placement at 36,
     50, 75 and 100 bp, 65,536 reads each (SWEEP_PINNED);
 21. rescue_sens: sensitivity at 36 bp with rescue_kmer 11 on phase 8's
     reads against their truth (RESCUE_SENS_PINNED);
 22. genome: tools/torch_bench_genome.py at full width — the 200 Mbp
     five-chromosome genome at k = 13, batch 65,536, 262,144 reads, and the
     51 Mbp world of phase 7 at k = 12: index census, seeding-blind reads,
     accuracy overall and on X0 == 1 (GENOME_PINNED), resident bytes, device
     reads/s;
 23. scale: tools/torch_scale_run.py at 524,288 reads in its own process —
     simulate, twopass to BAM, a SIGKILL mid-run, --resume, sort, cluster;
     the resumed bytes equal the control's and the cluster count is the JAX
     CLI's (SCALE_PINNED);
 24. shards_k15: phase 16's world again at k = 15, where the replicated
     candidate list saturates on no read, so the sharded and the replicated
     step must agree in all nine fields on all 65,536 reads
     (SHARDS_K15_PINNED);
 25. bench_leg: bench_torch.py's main at full size (1,048,576 reads of
     50 bp, batch 65,536): the device leg, the end-to-end leg, the rerun and
     suspect rules and the CPU leg in its subprocess; its one JSON line
     (every key of bench.py's, and the GPU line); sensitivity, precision,
     n_unmapped and n_mismapped equal the JAX package's bench.run_throughput
     on the same reads (BENCH_LEG_PINNED);
 26. dist_bench: tools/torch_bench_distributed.py at 65,536 reads and one
     round: one and two processes of `dist-align --coordinator` on its 2 Mbp
     world; the records add up and the two-process merged SAM and
     .errorprofile are the one-process run's bytes; a launch a batch and a
     warm-up step a process;
 27. shards_scale: tools/torch_bench_shards_scale.py at full size, the
     200 Mbp two-chromosome genome on a 2 x 2 data x index mesh (the card
     given four times on a one-card machine), 2,048 reads: the dominance
     counts and the sensitivity equal the JAX tool's record
     (torch_bench_shards_scale.PINNED).
 28. wire: the wire step (align_device_packed: 2-bit codes and N mask up,
     PackedResult down, profile counts fused), which phases 5-27 stream
     through, against the unpacked step (align_device): on every batch of
     the bench world the unpacked PackedResult equals the AlignResult field
     by field and the fused counts equal profile_counts_device; the same for
     one batch of the rescue world through a rescue engine (to_host, and the
     k = 11 step) and of the combined world (the projected step against
     the unprojected one, to_host); bytes up and down a batch counted from
     the tensors (at most 22 and 13 a read at L = 50); step + fetch ms of
     both, alone and as a profile pass, 10 turns; the PyTorch operators,
     wrapper launches and profiler CUDA events of each step; extend_impl /
     select_impl "jnp" on the card (no launch) equal to "auto" on 4,096
     reads; then `align` and `twopass --learned-gaps` through the CLI on
     both steps in turns (wire, unpacked, unpacked, wire, twice): the same
     output bytes, the align SAM and the pass-1 outputs the JAX package's
     (AT_SCALE).
 29. graph: the compiled steps (parasuite_tpu_torch/ops/compiled.py: one
     CUDA graph per step and key, replayed), which phases 5-28 stream
     through, against the same steps run eagerly (each CompiledStep's own
     function): on every batch of the bench world each step kind (plain,
     XA's candidate table, wire with and without counts, profile counts)
     equals its eager run at tolerance 0 with 8 calls in flight, and so do
     the rescue tier's steps on one rescue batch and the combined projected
     and unprojected steps on one combined batch; keys, graphs and capture
     ms; PyTorch operators, CUDA events, graph and wrapper launches of a
     step + fetch; host enqueue ms (the engine call, and the step alone);
     step + fetch ms alone and as a profile pass; the bench loop
     (tools/_torch_bench.py device_loop); `cli align` and `twopass
     --learned-gaps`; graphed and eager in turns, with equal output bytes,
     the JAX package's (AT_SCALE).
 30. dist_graph: the multi-device steps compiled (a CompiledStep a mesh
     slot, and a row's merge in the sharded step) against the same steps
     with every slot run eagerly, in turns: the data-parallel step at the
     bench config with 65,536 reads a device over the machine's cards and
     over card 0 given twice, the sharded step on the shards world (its
     first output pinned to SHARDS_PINNED) on a 1 x 2 grid of card 0 given
     twice, and `dist-align --coordinator` as one process (in this process,
     NCCL); equal outputs at tolerance 0 with every result held, the
     coordinator's shard the same bytes on both routes and merged to
     DIST_PINNED; PyTorch operators, graph and wrapper launches a call;
     host enqueue ms and ms per call (median of 10 turns); keys, graphs
     and capture ms of every slot; the coordinator's reads/s, g e e g twice.
Phase 4 also holds the select kernel's shared-memory path (rows of 2,048 and
4,096 entries) to the plain version, as the select_wide line.
Phases 7-9, 11, 13-22 and 24-30 run on the card and check the exact kernel
launch counts of their runs; phases 10 and 12 launch none, and phase 23's
launches happen in its own subprocesses and are not counted here (those of
phase 26's processes are, from their JSON lines; the CPU leg of phase 25
runs the plain versions). Every phase line carries elapsed_seconds, the
time since the run started.

Then one JSON line on the kernels (launches summed over phases 5-30, those
of phases 15 and 26's processes included, of phase 28 its CLI runs on the
wire step, of phase 29 its graphed CLI runs and of phase 30 its graphed
runs), a check that neither jax nor the JAX package was imported, and as
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
    python -m parasuite_tpu.cli convert W/all.bam W/all_tp.sam
    FLAGS = --max-read-len 50 --kmer-size 12 --max-candidates 8 --max-occ 16

Phases 7-9 (RFLAGS = FLAGS with --max-read-len 36):

    python -c "import chip_smoke as c; c.write_rescue_reads('W'); \\
        c.write_xa_world('W/xa'); c.write_combined_world('W/comb')"
    python -m parasuite_tpu.cli index W/xa/ref.fa W/xa/idx FLAGS
    python -m parasuite_tpu.cli align W/xa/idx W/xa/reads.fastq W/xa/xa.sam \\
        --xa --pg-cl smoke --batch-size 4096 --log W/xa/log FLAGS
    python -m parasuite_tpu.cli twopass W/idx W/rescue.fastq W/rescue.bam \\
        --learned-gaps --rescue-kmer 11 --pg-cl smoke --batch-size 16384 RFLAGS
    python -m parasuite_tpu.cli convert W/rescue.bam W/rescue_tp.sam
    python -m parasuite_tpu.cli combine W/comb/ref.fa W/comb/exons.tsv \\
        W/comb/cidx FLAGS
    python -m parasuite_tpu.cli twopass W/comb/cidx W/comb/all.fastq \\
        W/comb/tp.sam --learned-gaps --pg-cl smoke --batch-size 4096 FLAGS
    python -m parasuite_tpu.cli align W/comb/cidx W/comb/xa.fastq \\
        W/comb/xa.sam --xa --pg-cl smoke --batch-size 4096 FLAGS

Phases 10-12 (after the commands above):

    python -m parasuite_tpu.cli simulate W/idx W/sim_flat.fastq \\
        --n-reads 262144 --read-len 50 FLAGS
    python -m parasuite_tpu.cli simulate W/idx W/sim_prof.fastq \\
        --n-reads 262144 --read-len 50 --profile W/pin.sam.errorprofile \\
        --learned-indels FLAGS
    python -m parasuite_tpu.cli simulate W/comb/cidx W/comb/sim.fastq \\
        --n-reads 262144 --read-len 50 FLAGS
    python -m parasuite_tpu.cli benchmark W/idx --n-reads 262144 \\
        --batch-size 4096 FLAGS
    python -m parasuite_tpu.cli cluster W/idx W/all.sam W/clusters_sam.tsv \\
        FLAGS
    python -m parasuite_tpu.cli cluster W/idx W/all.bam W/clusters_bam.tsv \\
        FLAGS
    python -m parasuite_tpu.cli sort W/all.sam W/sorted.sam
    python -m parasuite_tpu.cli sort W/all.bam W/sorted.bam
    python -m parasuite_tpu.cli convert W/sorted.bam W/sorted_bam.sam

Phases 14-16:

    python -m parasuite_tpu.cli dist-align W/idx W/all.fastq W/dist \\
        --host-index 0 --n-hosts 2 --batch-size 4096 FLAGS    (and 1)
    python -m parasuite_tpu.cli merge-shards W/idx W/dist W/dist.sam \\
        --n-hosts 2 --pg-cl smoke --profile-out W/dist.errorprofile FLAGS

and for SHARDS_PINNED, in Python with the JAX package on a CPU with two
virtual devices (--xla_force_host_platform_device_count=2): seqs, reads =
chip_smoke.shards_world(); parasuite_tpu.parallel.shards'
build_sharded_index(seqs, 2, cfg) and make_sharded_step(cfg, make_mesh2(1,
2)) with cfg = FLAGS' AlignConfig, flat scores and min_scores_host at
length 50, over the reads in chunks of 4,096; chip_smoke.shards_digest of
the concatenated outputs at n = 16,384 and n = 65,536.

The pins of phases 19-25 and 27 come from the JAX package's own tools on
the CPU; the comment above SWEEP_PINNED names the function behind each. The
worlds are the port's (tools/_torch_bench.py, sim/), which give the JAX
simulator's reads bit for bit.

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
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
WORK = REPO / ".smoke"
# the measurement scripts beside the package: the bench world (one copy,
# tools/_torch_bench.py) and the tools the later phases run
sys.path.insert(0, str(REPO / "tools"))

import _torch_bench as tb                                   # noqa: E402
from _torch_bench import (N_PIN, READ_LEN, REF_LEN,         # noqa: E402,F401
                          bench_chrom, draw_reads, write_world)

N_READS = tb.SMOKE_READS    # 262,144: 4 batches of 65,536
BATCH = 65_536              # bench.BATCH_TPU
PIN_BATCH = 4_096
N_MODE_READS = 131_072      # reads of the xa and rescue phases
RESCUE_LEN = 36
RESCUE_BATCH = 16_384       # rescue output depends on the batch (its cap)
COMB_GENOME = 8_000_000     # tools/bench_combined.py's world
COMB_TX = 400
COMB_DRAWN = 262_144        # reads drawn before spacer-straddlers drop
SHARD_CHROM = 50_000_000    # the shards world: two such chromosomes
N_SHARD_READS = 65_536
SHARD_FIELDS = ("mapped", "strand", "chrom", "local_pos", "score", "mapq",
                "x0", "x1", "ug_equal", "nm", "shard")
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
# phases 10-12: the JAX CLI's outputs for the commands in the docstring
N_SIM = 262_144
SIM_PINNED = {
    "sim_flat.fastq":
        "de348cae39e276ccda0fec83ebe8c18f2aa589eccef579c63b400ce2d5a1baf5",
    "sim_prof.fastq":
        "b8c3ed3250594b923ac7a3a1eebbd82fe9a93fe98a77540b748c7a86b9ad12af",
    "comb/sim.fastq":
        "530889b5c276920b19a795560d78180e69e5ffb9d69042fad6825269f2fe9c69",
}
BENCH_PINNED = {"n_mapped": 259566, "n_correct": 259563}
TOOLS_PINNED = {
    "clusters_sam.tsv":
        "2b57f716212ebd5c6b8cda3c4f135770c434740df2f0c981d0a4647f38184574",
    "clusters_bam.tsv":
        "de6d5c64a418808a84294366ff34a799c45a92a496634e30f98e2143704fb25a",
    "sorted.sam":
        "e023573ce95ae28477bb83ef600e0e869a8cae8ff682d4aea0d471fedd84171d",
    "sorted_bam.sam":
        "2edcecd6d6db0c28e2d1145ad7712d383960139c2de7c56d8f8249f6deec0353",
}
# phases 13-16: the JAX CLI's file-side run over two hosts, merged, has the
# digests of its one-process `align` and of its twopass profile (AT_SCALE);
# the JAX package's sharded step on the shards world (commands in the
# docstring)
DIST_PINNED = {"sam": AT_SCALE["all.sam"],
               "errorprofile": AT_SCALE["all.bam.errorprofile"]}
SHARDS_PINNED = {
    "first_16384":
        "10c3dfaec7fddaa7a5e98ae06f4c7c004ba75f141508c6ab18f0542d83be6d4e",
    "all_65536":
        "2f487bacd1b76f7dbd789a6eaf9913d8d22f86dd40f8ad1c9992935080ae4e3d",
}
# ... and at k = 15 (the same commands with kmer_size=15), where its
# replicated step saturates no candidate list
SHARDS_K15_PINNED = {
    "first_16384":
        "2c6868de39301627990b61b5146dcd1151b630072abd534df2db40fb766c1a6a",
    "all_65536":
        "306da0a77c2e365bc3be3ff1ee9d0e11712042e8f92cebf2e1b2b0aa331438f0",
}
# phases 19-24: the measurement scripts beside the package (tools/torch_*.py)
# on the card, pinned to the JAX package's numbers on the same reads,
# computed on the CPU with the original tools' own functions:
# tools/sweep_lengths.py's loop body (bench.run_throughput, adaptive
# placement, 65,536 reads a length), tools/bench_genome.py's run_world
# (chr22_like(seed=22) at k = 12 with 65,536 reads; multi_chrom(200_000_000,
# 5) at k = 13 with 262,144), tools/bench_rescue.py's engine_accuracy (the
# rescue phase's reads and truth, rescue_kmer 11, batch RESCUE_BATCH), and
# the cluster count of tools/scale_run.py's stages through the JAX CLI
# (index, simulate_fastq, twopass, sort, cluster) at PARASUITE_SCALE_READS=
# 524288. Fractions are the tools' own, rounded to 4 places. The census
# numbers also stand in BENCH_GENOME_r05.json (they depend on no hardware).
SWEEP_PINNED = {
    36: {"stride_eff": 4, "sensitivity": 0.9759, "precision": 1.0,
         "n_unmapped": 1576, "n_mismapped": 2},
    50: {"stride_eff": 6, "sensitivity": 0.9917, "precision": 1.0,
         "n_unmapped": 546, "n_mismapped": 1},
    75: {"stride_eff": 10, "sensitivity": 0.9969, "precision": 1.0,
         "n_unmapped": 202, "n_mismapped": 1},
    100: {"stride_eff": 14, "sensitivity": 0.9988, "precision": 1.0,
          "n_unmapped": 80, "n_mismapped": 0},
}
N_SWEEP_READS = 65_536
GENOME_PINNED = {
    "chr22_class_51Mbp": {
        "kmers_total": 40468619, "buckets_nonzero": 14940169,
        "bucket_max": 3600, "buckets_over_max_occ": 19731,
        "reads_all_seeds_dropped": 656, "sensitivity": 0.9595,
        "precision": 0.986, "sensitivity_unique": 0.9904},
    "multi_chrom_200Mbp": {
        "kmers_total": 199380030, "buckets_nonzero": 63210192,
        "bucket_max": 2087, "buckets_over_max_occ": 79754,
        "reads_all_seeds_dropped": 1491, "sensitivity": 0.9565,
        "precision": 0.9937, "sensitivity_unique": 0.9952},
}
GENOME_EXACT = ("kmers_total", "buckets_nonzero", "bucket_max",
                "buckets_over_max_occ", "reads_all_seeds_dropped")
GENOME_FRACTIONS = ("sensitivity", "precision", "sensitivity_unique")
N_GENOME_READS = {"chr22_class_51Mbp": 65_536, "multi_chrom_200Mbp": 262_144}
RESCUE_SENS_PINNED = {"sensitivity": 0.9299, "precision": 0.9996,
                      "mapped_frac": 0.9303, "n_reads": 131072,
                      "rescue_mapped": 3831, "rescue_overflow": 0}
# bench.run_throughput(bench.make_cfg(), 1048576, 65536, 20000000,
# check_accuracy=True) under JAX_PLATFORMS=cpu (the numbers BENCH_r05.json
# also holds; they depend on no hardware)
BENCH_LEG_PINNED = {"sensitivity": 0.9914, "precision": 1.0,
                    "n_unmapped": 8985, "n_mismapped": 13}
N_DIST_BENCH_READS = 65_536
N_SCALE_READS = 524_288
SCALE_PINNED = {
    "clusters": 24311, "alignments": 517684,
    "fastq_sha256":
        "945b9166c3e9e3e678e92d771a182a5057538cdb1e08f32018a17c9f80a407b8",
    "clusters_sha256":
        "98aef33eba9c4fb0ab8964af3fe8ddbc4cae0a77d4337670a48608277a1228ec",
    "errorprofile_sha256":
        "ef9fba58aa5eab030b058a98dc48fe540a08dd254aaefaa70721298931a4da7b",
}
# what one process of a coordinator run executes: the port's CLI, its
# stdout held back until the check that neither jax nor the JAX package
# came in has passed
COORD_CHILD = """
import contextlib, io, sys
from parasuite_tpu_torch.cli import main
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    rc = main(sys.argv[1:])
foreign = sorted(m for m in sys.modules
                 if m.split('.')[0] in ('jax', 'jaxlib', 'parasuite_tpu'))
if foreign:
    raise SystemExit(f'the process imported {foreign[:5]}')
sys.stdout.write(buf.getvalue())
sys.exit(rc)
"""
PACKED_KEYS = ("packed_batches", "packed_entries", "packed_junctions",
               "packed_overflow")
# published peaks of one H100 SXM (NVIDIA's data sheet): device memory rate,
# and the int32 add/min/max rate — 64 lanes per SM per clock, a quarter of
# the 67 TFLOP/s float32 figure (128 lanes, 2 flop per FMA); the instruction
# rate, one warp instruction per clock on each of an SM's four schedulers
# (128 lanes per clock, half the float32 figure), bounds instructions of any
# type
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
INSTR_OPS_PER_S = 67e12 / 2
EXTEND_OPS_PER_CELL = 6


def sha256(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


T_START = time.perf_counter()


def phase(label: str, /, **fields) -> None:
    print(json.dumps({"phase": label, **fields, "elapsed_seconds": round(
        time.perf_counter() - T_START, 3)}), flush=True)


# ---------------------------------------------------------------------------
# the world (numpy only, so the JAX package can be run on the same files)
# ---------------------------------------------------------------------------

def write_rescue_reads(out_dir) -> dict:
    """rescue.fastq: N_MODE_READS reads of RESCUE_LEN bp on the bench
    reference, draw_reads(seed 3) at 3% substitutions, so the primary
    k = 12 pass leaves reads unmapped. Returns the truth (start, reverse)."""
    from parasuite_tpu_torch.io.fastq import write_fastq

    reads, start, reverse = draw_reads(bench_chrom(), N_MODE_READS,
                                       RESCUE_LEN, 3, sub_rate=0.03)
    write_fastq(Path(out_dir) / "rescue.fastq",
                [f"s{i}" for i in range(N_MODE_READS)], reads,
                np.full(N_MODE_READS, RESCUE_LEN, dtype=np.int32))
    return {"start": start, "reverse": reverse}


def write_xa_world(out_dir):
    """ref.fa: chr22_like(seed=22), the 51 Mbp repeat-structured stand-in
    for hg19 chr22 (a ~10.3 Mbp leading N block, interspersed repeat
    families, satellite, segmental duplications); reads.fastq: N_MODE_READS
    reads of READ_LEN bp, draw_reads(seed 4) over windows without N.
    Returns the genome's GenomeStats."""
    from parasuite_tpu_torch.io.fasta import write_fasta
    from parasuite_tpu_torch.io.fastq import write_fastq
    from parasuite_tpu_torch.sim.genome import chr22_like

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    seqs, stats = chr22_like(seed=22)
    write_fasta(out / "ref.fa", seqs)
    reads, _, _ = draw_reads(seqs["chr22s"], N_MODE_READS, READ_LEN, 4)
    write_fastq(out / "reads.fastq", [f"x{i}" for i in range(N_MODE_READS)],
                reads, np.full(N_MODE_READS, READ_LEN, dtype=np.int32))
    return stats


def write_combined_world(out_dir) -> int:
    """The world of tools/torch_bench_combined.py (build_world, make_reads)
    as files: an 8 Mbp chr1 (default_rng(11)) with 400 three-exon
    transcripts (exons 120-400 bp, introns 200-2,000 bp, alternating
    strands) -> ref.fa + exons.tsv; reads (default_rng(12)): COMB_DRAWN
    drawn from the combined packing, half genomic and half
    spliced-transcript (many junction-spanning), T->C at 12% of T, reads
    straddling a spacer dropped, shuffled -> all.fastq, and the first N_PIN
    of them -> xa.fastq. Returns the number of reads."""
    import torch_bench_combined as bench_combined
    from parasuite_tpu_torch.config import AlignConfig
    from parasuite_tpu_torch.io.fasta import write_fasta
    from parasuite_tpu_torch.io.fastq import write_fastq

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    genome, txs, combined = bench_combined.build_world(
        AlignConfig(), COMB_GENOME, COMB_TX)
    write_fasta(out / "ref.fa", genome)
    (out / "exons.tsv").write_text("".join(
        f"{t.tx_id}\t{t.chrom}\t{t.strand}\t"
        f"{','.join(map(str, t.exon_starts))}\t"
        f"{','.join(map(str, t.exon_ends))}\n" for t in txs))
    codes, lengths = bench_combined.make_reads(combined, txs, COMB_DRAWN)
    n = codes.shape[0]
    names = [f"c{i}" for i in range(n)]
    write_fastq(out / "all.fastq", names, codes, lengths)
    write_fastq(out / "xa.fastq", names[:N_PIN], codes[:N_PIN],
                lengths[:N_PIN])
    return n


def shards_world():
    """The world of the shards phase -> (seqs, reads int8 [N_SHARD_READS,
    READ_LEN]): two uniform random chromosomes of SHARD_CHROM bases
    (default_rng(5) and default_rng(6)), and reads by draw_reads on each
    (seeds 7 and 8), interleaved: read 2i is from chrS0, read 2i + 1 from
    chrS1."""
    seqs = {f"chrS{i}": np.random.default_rng(5 + i).integers(
                0, 4, SHARD_CHROM, dtype=np.int8) for i in range(2)}
    halves = [draw_reads(seqs[f"chrS{i}"], N_SHARD_READS // 2, READ_LEN,
                         7 + i)[0] for i in range(2)]
    return seqs, np.stack(halves, axis=1).reshape(N_SHARD_READS, READ_LEN)


def shards_digest(out: dict, n: int) -> str:
    """SHA-256 over the first n reads of the sharded step's output (a dict
    of numpy arrays): every field of SHARD_FIELDS in that order, as int32."""
    h = hashlib.sha256()
    for k in SHARD_FIELDS:
        h.update(np.ascontiguousarray(
            np.asarray(out[k][:n]).astype(np.int32)).tobytes())
    return h.hexdigest()


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


def _bound(n_bytes: int, n_ops: int,
           ops_per_s: float = INT32_OPS_PER_S) -> dict:
    """The least time an H100 could take: bytes over the memory rate or
    operations over their rate, whichever is larger (ms)."""
    by_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    by_ops = 1e3 * n_ops / ops_per_s
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bound_bytes": int(n_bytes), "bound_ops": int(n_ops)}


def select_bound(rows: int, n: int, C: int) -> dict:
    """Bytes: the int32 [rows, n] diagonals in, int32 + bool [rows, C] out.
    Operations per row, whatever the algorithm: a comparison sort of the
    row's n entries takes n * ceil(log2 n) compares, run starts and votes
    are 2 per entry, and each of the C results is one pick."""
    compares = n * max(1, int(n - 1).bit_length())
    return _bound(rows * (4 * n + 5 * C), rows * (compares + 2 * n + C))


def seed_select_bound(rows: int, L: int, S: int, filled: int, n: int,
                      C: int) -> dict:
    """select_bound's operations over rows of n entries; bytes: the oriented
    reads int32 [rows, L], the lengths, S bucket pairs a row, the `filled`
    positions the rows hold, int32 + bool [rows, C] out."""
    compares = n * max(1, int(n - 1).bit_length())
    return _bound(rows * (4 * L + 2 + 8 * S + 5 * C) + 4 * filled,
                  rows * (compares + 2 * n + C))


def finalize_bound(B: int, n: int, window_bases: int) -> dict:
    """Bytes: each read's n entries' valid (a byte), pos_key and dps (4
    each), the strand row every read shares (4n once), at the pick its
    ug_eq and diag (5), its length, the `window_bases` bases of the mapped
    reads' windows (min(L, length) a read: 4 bytes of the oriented strand
    and 1 of ref_seq each), and 42 bytes out (nine int32 and two bool
    fields of the AlignResult, best_idx). Operations per read, whatever the
    algorithm: a dedupe by sorting its n (strand, pos_key, score) keys, n *
    ceil(log2 n) compares."""
    compares = n * max(1, int(n - 1).bit_length())
    return _bound(B * (9 * n + 5 + 4 + 42) + 4 * n + 5 * window_bases,
                  B * compares)


def extend_bound(lengths: np.ndarray, C: int, L: int, W: int, G: int) -> dict:
    """Bytes: oriented reads int32 [2B, L], lengths, candidates int32
    [2B, C], the reference windows (L + 2W bytes a pair, at most the whole
    reference), both score tables, four int32 [2B, C] outputs.

    Operations: EXTEND_OPS_PER_CELL = 6 int32 operations per cell of the
    M / Ix / Iy / ungapped recurrence, over 2W + 1 cells a row and as many
    rows as the read is long. With T = max(M, Ix, Iy) of the row above, a
    cell needs M = sub + T and ug += sub (two adds: every M and every ug is
    a distinct sum), mg = M - go (one add, shared by both gap states), the
    Iy walk max(Iy[j-1] - ge, mg[j-1]) and the next row's Ix
    max(Ix[j+1] - ge, mg[j+1]) (one DPX add-max each, __viaddmax_s32) and
    the next row's T (one three-way max, __vimax3_s32). The earlier count
    was 10 (each add and max on its own), at the int32 rate; but three of
    the six are adds, which the compiler may emit as IMAD on the FMA pipe,
    so the rate that bounds any kernel is the instruction rate
    (INSTR_OPS_PER_S; the three max operations at the int32 rate give the
    same time). Both other counts are in the result for comparison:
    bound_ms_int32_pipe (6 at the int32 rate) and bound_ms_10_ops (the
    earlier count)."""
    B = int(lengths.shape[0])
    pairs = 2 * B * C
    cells = 2 * C * (2 * W + 1) * int(np.minimum(lengths, L).sum())
    n_bytes = (2 * B * L * 4 + B * 4 + pairs * 4
               + min(G, pairs * (L + 2 * W)) + 2 * L * 25 * 4 + 4 * pairs * 4)
    return {**_bound(n_bytes, EXTEND_OPS_PER_CELL * cells, INSTR_OPS_PER_S),
            "bound_ops_per_cell": EXTEND_OPS_PER_CELL, "bound_cells": cells,
            "bound_ms_int32_pipe": _bound(n_bytes, EXTEND_OPS_PER_CELL * cells)
            ["bound_ms"],
            "bound_ms_10_ops": _bound(n_bytes, 10 * cells)["bound_ms"]}


def _against_bound(name: str, ms: float, bound: dict,
                   suffix: str = "") -> dict:
    """The bound's fields and the share of it the kernel reached, keys
    suffixed; a kernel faster than its bound is a miscount."""
    share = bound["bound_ms"] / ms
    if share > 1.0:
        raise AssertionError(f"{name}: {ms} ms is under its bound {bound}")
    return {**{k + suffix: v for k, v in bound.items()},
            "share_of_bound" + suffix: share}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def environment() -> str:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false — "
                         "this needs an NVIDIA GPU")
    if not (REPO / "parasuite_tpu_torch" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke: no parasuite_tpu_torch package beside "
                         f"{Path(__file__).name} — run it from the repo root")
    env = tb.environment("cuda")
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = "not installed"
    print(env["gpu"], flush=True)
    phase("environment", **env, triton=triton_version,
          python=sys.version.split()[0], native=native_library())
    return env["gpu"]


def native_library() -> bool:
    """Build (at first use) and load the port's own C++ host library; the
    compiler's message and a failure if it does not load."""
    from parasuite_tpu_torch import native

    if native.available():
        return True
    make = subprocess.run(
        ["make", "-B", "-C", str(Path(native.__file__).parent)],
        capture_output=True, text=True, timeout=300)
    raise AssertionError(f"parasuite_tpu_torch/native did not load; make "
                         f"exit {make.returncode}:\n{make.stdout[-2000:]}"
                         f"{make.stderr[-2000:]}")


def build() -> None:
    from parasuite_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build()
    _build.load()
    seconds = round(time.perf_counter() - t0, 3)
    regs = [line.strip() for line in _build.build_log.splitlines()
            if "registers" in line]
    # the same sources through one nvcc call, for the cost of not building
    # them in parallel (the library it writes is thrown away); its ptxas
    # report is the extend kernel's, whether or not build() had to compile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=_build.BUILD) as tmp:
        one = subprocess.run([_build.nvcc_path(), *_build.FLAGS, "-shared",
                              "-o", str(Path(tmp) / "one.so"),
                              *map(str, _build._sources())], check=True,
                             capture_output=True, text=True, timeout=900)
    phase("build", seconds=seconds,
          one_nvcc_seconds=round(time.perf_counter() - t0, 3),
          library=str(_build.LIB.relative_to(REPO)), ptxas=regs,
          extend_kernel=extend_build_report(one.stdout + one.stderr))


def extend_build_report(log: str) -> dict:
    """Per band width W of the extend kernel: ptxas' registers, stack and
    spills, and the DPX instructions in its SASS (cuobjdump). Fails unless
    all eight widths are there, none spills, and each holds VIMNMX3 and
    VIADDMNMX (the three-way max and the add-max: nothing emulated)."""
    import re

    from parasuite_tpu_torch.ops import _build

    def by_w(report: dict) -> dict:
        out = {}
        for sym, v in report.items():
            m = re.search(r"extend_kernelILi(\d+)E", sym)
            if m:
                out[(int(m.group(1)) - 1) // 2] = v
        return out

    ptxas, sass = by_w(_build.ptxas_report(log)), by_w(_build.sass_opcodes())
    report = {w: {**ptxas.get(w, {}),
                  **{op: sass.get(w, {}).get(op, 0)
                     for op in ("VIMNMX3", "VIADDMNMX", "LDS", "IADD3",
                                "IMAD")}}
              for w in range(8)}
    bad = {w: r for w, r in report.items()
           if "registers" not in r or r.get("spill_stores", 1)
           or r.get("spill_loads", 1) or not r["VIMNMX3"]
           or not r["VIADDMNMX"]}
    if bad:
        raise AssertionError(f"extend kernel: spills, a missing width or no "
                             f"DPX instruction: {bad}")
    return report


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


def kernels_vs_plain(engine, gpu: str) -> list[dict]:
    """Each kernel against its plain version on real stage inputs."""
    import torch

    from parasuite_tpu_torch.io.fastq import read_fastq
    from parasuite_tpu_torch.ops import (aligner, cuda_extend, cuda_finalize,
                                         cuda_seed)

    cfg, didx, sprof, dev = engine.cfg, engine.didx, engine.sprof, \
        engine.device
    batch = read_fastq(WORK / "all.fastq", READ_LEN)

    def stage_inputs(n):
        """-> (oriented, lengths, the seed rows, finalize's entries from
        the kernels' select and extend)."""
        codes = torch.from_numpy(batch.codes[:n]).to(dev)
        lens = torch.from_numpy(batch.lengths[:n].astype(np.int32)).to(dev)
        oriented = aligner.orient_reads(codes, lens)
        cand, valid = cuda_seed.seed_select(oriented, lens, didx, cfg)
        ext = cuda_extend.extend_candidates(oriented, lens, cand, didx,
                                            sprof, cfg)
        entries = aligner.finalize_entries(
            oriented, lens, engine._ms_table[lens.long()], cand, valid,
            *ext, didx, cfg)
        return oriented, lens, aligner.seed_diagonals(oriented, lens, didx,
                                                      cfg), entries

    def finalize_pair(d):
        res, best_idx = cuda_finalize.finalize_select(*d[3], didx, sprof,
                                                      cfg)
        return (*res, best_idx)

    def finalize_plain(d):
        res, best_idx = aligner.finalize_core(*d[3], didx, sprof, cfg)
        return (*res, best_idx)

    out = []
    oriented, lens, diags, entries = stage_inputs(N_PIN)
    cand, valid = cuda_seed.select_candidates(diags, cfg)
    cand_p, valid_p = cuda_seed.select_candidates_plain(diags, cfg)
    seeded = cuda_seed.seed_select(oriented, lens, didx, cfg)
    ext = cuda_extend.extend_candidates(oriented, lens, cand, didx, sprof,
                                        cfg)
    ext_p = cuda_extend.extend_candidates_plain(oriented, lens, cand, didx,
                                                sprof, cfg)
    d16 = (oriented, lens, diags, entries)
    fin, fin_p = finalize_pair(d16), finalize_plain(d16)
    torch.cuda.synchronize()
    checks = {
        "select_candidates": [(cand, cand_p), (valid, valid_p)],
        "extend_candidates": list(zip(ext, ext_p)),
        "seed_select": list(zip(seeded, (cand_p, valid_p))),
        "finalize_select": list(zip(fin, fin_p)),
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
        "seed_select": (
            lambda d: cuda_seed.seed_select(d[0], d[1], didx, cfg),
            lambda d: cuda_seed.seed_select_plain(d[0], d[1], didx, cfg)),
        "finalize_select": (finalize_pair, finalize_plain),
    }
    # what the seeded kernel replaced on the main path: the seed stage's
    # PyTorch kernels, then the select kernel over their rows
    replaced = {"seed_select": lambda d: cuda_seed.select_candidates(
        aligner.seed_diagonals(d[0], d[1], didx, cfg), cfg)}
    sources = {"select_candidates": ("select_candidates.cu",
                                     "parasuite_tpu/ops/pallas_seed.py:40"),
               "extend_candidates": ("extend_candidates.cu",
                                     "parasuite_tpu/ops/pallas_extend.py:56"),
               "seed_select": ("select_candidates.cu",
                               "parasuite_tpu/ops/pallas_seed.py:40 and "
                               "parasuite_tpu/ops/aligner.py seed_diagonals"),
               "finalize_select": ("finalize_select.cu",
                                   "no Pallas kernel: parasuite_tpu/ops/"
                                   "aligner.py:368 finalize_core (XLA)")}
    G = int(didx.ref_seq.shape[0])

    def bounds(n_reads, diags, entries):
        n_diag = int(diags.shape[1])
        res = aligner.finalize_core(*entries, didx, sprof, cfg)[0]
        window = int(torch.minimum(entries[1], torch.tensor(
            cfg.max_read_len, device=dev))[res.mapped].sum())
        return {"select_candidates": select_bound(
                    2 * n_reads, n_diag, cfg.max_candidates),
                "extend_candidates": extend_bound(
                    batch.lengths[:n_reads], cfg.max_candidates,
                    cfg.max_read_len, cfg.band_width, G),
                "seed_select": seed_select_bound(
                    2 * n_reads, cfg.max_read_len, cfg.max_seeds,
                    int((diags != cuda_seed.I32MAX).sum()), n_diag,
                    cfg.max_candidates),
                "finalize_select": finalize_bound(
                    n_reads, 2 * cfg.max_candidates, window)}

    bound16 = bounds(N_PIN, diags, entries)
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
        ms = _median_ms(lambda: kern(d16))
        # library_ms: no single PyTorch call computes either function
        # (select is two sorts, a cummin and elementwise ops; extend is a
        # recurrence over the read)
        out.append({"name": name, "route": "cuda",
                    "source": f"parasuite_tpu_torch/csrc/{sources[name][0]}",
                    "replaces": sources[name][1], "launches": 0,
                    "max_abs_err": err, "reads": int(lens.shape[0]),
                    "diagonals_per_row": int(diags.shape[1]), "ms": ms,
                    "plain_ms": _median_ms(lambda: plain(d16)),
                    **_against_bound(name, ms, bound16[name]),
                    "library_ms": None})
        if name in replaced:
            out[-1]["replaced_ms"] = _median_ms(lambda: replaced[name](d16))
    # the kernels alone at the main path's batch of 65,536 reads
    oriented, lens, diags, entries = stage_inputs(BATCH)
    cand, _ = cuda_seed.select_candidates(diags, cfg)
    d_batch = (oriented, lens, diags, entries)
    kernel_calls = {
        "select_candidates": lambda: cuda_seed.select_candidates(diags, cfg),
        "extend_candidates": lambda: cuda_extend.extend_candidates(
            oriented, lens, cand, didx, sprof, cfg),
        "seed_select": lambda: cuda_seed.seed_select(oriented, lens, didx,
                                                     cfg),
        "finalize_select": lambda: cuda_finalize.finalize_select(
            *entries, didx, sprof, cfg)}
    ms_batch = {name: _median_ms(fn) for name, fn in kernel_calls.items()}
    # the same calls back to back: the card's own time, the host's enqueue
    # of each call hidden behind the one before
    b2b_batch = {name: _median_ms(lambda: [fn() for _ in range(20)],
                                  reps=5) / 20
                 for name, fn in kernel_calls.items()}
    bound_batch = bounds(BATCH, diags, entries)
    plain_batch = {name: _median_ms(lambda: timed[name][1](d_batch), reps=3)
                   for name in kernel_calls}
    for k in out:
        if k["name"] in replaced:
            k["replaced_ms_65536"] = _median_ms(
                lambda: replaced[k["name"]](d_batch))
        k["ms_65536"] = ms_batch[k["name"]]
        k["plain_ms_65536"] = plain_batch[k["name"]]
        k.update(_against_bound(k["name"], k["ms_65536"],
                                bound_batch[k["name"]], "_65536"))
        k["ms_65536_back_to_back"] = b2b_batch[k["name"]]
        k["share_of_bound_65536_back_to_back"] = _against_bound(
            k["name"], b2b_batch[k["name"]], bound_batch[k["name"]])[
                "share_of_bound"]
        if k["name"] == "extend_candidates":
            for n in (N_PIN, BATCH):
                k[f"occupancy_{n}"] = extend_occupancy(cfg, 2 * n)
        phase("kernel", **k, gpu=gpu)
    select_widths_equal_plain(dev, gpu)
    return out


def extend_occupancy(cfg, rows: int) -> dict:
    """The extend kernel's launch at cfg's shape over `rows` oriented reads:
    threads and shared memory a block, blocks resident per SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), and the waves the grid
    takes on this card."""
    import ctypes

    import torch

    from parasuite_tpu_torch.ops import _build

    out = (ctypes.c_int * 3)()
    err = _build.load().ps_extend_occupancy(
        cfg.max_candidates, cfg.max_read_len, cfg.band_width, out)
    if err != 0:
        raise AssertionError(f"ps_extend_occupancy: CUDA error {err}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = -(-rows * cfg.max_candidates // out[0])
    return {"threads": out[0], "smem_bytes": out[1], "blocks_per_sm": out[2],
            "sms": sms, "blocks": blocks,
            "waves": blocks / (out[2] * sms)}


def select_widths_equal_plain(dev, gpu: str) -> None:
    """The select kernel against its plain version at every row width it is
    built for (SELECT_CASES), on select_case_rows; its time there too. The
    widths past 1,024 (the shared-memory path of the kernel) are the
    select_wide line, with the plain version's time beside the kernel's."""
    import torch

    from parasuite_tpu_torch.config import AlignConfig
    from parasuite_tpu_torch.ops import cuda_seed
    from parasuite_tpu_torch.testing import SELECT_CASES, select_case_rows

    widths, wide = [], []
    for n, C in SELECT_CASES:
        cfg = AlignConfig(max_candidates=C)
        d = torch.from_numpy(select_case_rows(n)).to(dev)
        got = cuda_seed.select_candidates(d, cfg)
        want = cuda_seed.select_candidates_plain(d, cfg)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if g.dtype != w.dtype or not torch.equal(g, w):
                bad = (g != w).any(dim=1).nonzero().flatten().tolist()
                raise AssertionError(f"select_candidates differs from plain "
                                     f"at n={n}, C={C}: rows {bad[:8]}")
        # timed on 131,072 rows (the main path's row count) of these rows
        big = d.repeat(-(-2 * BATCH // d.shape[0]), 1)[:2 * BATCH].contiguous()
        ms = _median_ms(lambda: cuda_seed.select_candidates(big, cfg))
        case = {"n": n, "C": C, "max_abs_err": 0, "ms_131072_rows": ms,
                **_against_bound("select_candidates", ms,
                                 select_bound(2 * BATCH, n, C))}
        if n > 1024:
            big_got = cuda_seed.select_candidates(big, cfg)
            big_want = cuda_seed.select_candidates_plain(big, cfg)
            if not all(torch.equal(g, w) for g, w in zip(big_got, big_want)):
                raise AssertionError(f"select_candidates differs from plain "
                                     f"at n={n} on 131,072 rows")
            del big_got, big_want
            case["plain_ms_131072_rows"] = _median_ms(
                lambda: cuda_seed.select_candidates_plain(big, cfg), reps=3)
            wide.append(case)
        else:
            widths.append(case)
        del big
    phase("select_widths", cases=widths, gpu=gpu)
    phase("select_wide", cases=wide, n_pad=[2048, 4096],
          kernel="select_wide_kernel: one block a row, the row in shared "
                 "memory", gpu=gpu)


def _cli_json(argv) -> dict:
    from parasuite_tpu_torch.cli import main as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if cli(argv) != 0:
            raise AssertionError(f"cli failed: {argv}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _reset_counters():
    from parasuite_tpu_torch.ops.compiled import KERNELS

    for mod, counter in KERNELS.values():
        setattr(mod, counter, 0)


def _counters() -> dict:
    from parasuite_tpu_torch.ops.compiled import launch_counts

    return launch_counts()


def _expect_launches(got: dict, want: int, what: str,
                     finalize: int | None = None) -> None:
    """The main path's launches: `want` of the seeded select kernel and of
    the extend kernel, none of the select kernel over rows of diagonals,
    and `finalize` (default `want`: a step launches each once) of the
    finalize kernel."""
    finalize = want if finalize is None else finalize
    if (got["seed_select"], got["extend_candidates"],
            got["select_candidates"], got["finalize_select"]) != \
            (want, want, 0, finalize):
        raise AssertionError(f"{what}: kernel launches {got}, want {want} "
                             f"of seed_select and extend_candidates each "
                             f"(batches x passes), 0 of select_candidates, "
                             f"{finalize} of finalize_select")


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
    from parasuite_tpu_torch.io.bam import bam_to_sam

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

    from parasuite_tpu_torch.io.fastq import read_fastq

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


def xa_phase(gpu: str):
    """-> (launches, the xa genome's GenomeStats)."""
    t0 = time.perf_counter()
    stats = write_xa_world(WORK / "xa")
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
    return launches, stats


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
    G = int(didx.ref_seq.shape[0])
    ms = {"select_candidates": _median_ms(
              lambda: cuda_seed.select_candidates(d, cfg)),
          "extend_candidates": _median_ms(
              lambda: cuda_extend.extend_candidates(o, ln, cand, didx, sprof,
                                                    cfg))}
    bound = {"select_candidates": select_bound(
                 int(d.shape[0]), int(d.shape[1]), cfg.max_candidates),
             "extend_candidates": extend_bound(
                 lengths, cfg.max_candidates, cfg.max_read_len,
                 cfg.band_width, G)}
    plain_ms = {"select_candidates": _median_ms(
                    lambda: cuda_seed.select_candidates_plain(d, cfg), reps=3),
                "extend_candidates": _median_ms(
                    lambda: cuda_extend.extend_candidates_plain(
                        o, ln, cand, didx, sprof, cfg), reps=3)}
    return {"max_abs_err": errs, "diagonals_per_row": int(d.shape[1]),
            "rows": int(d.shape[0]),
            "extend_occupancy": extend_occupancy(cfg, int(d.shape[0])),
            **{name: {"ms": ms[name], "plain_ms": plain_ms[name],
                      **_against_bound(name, ms[name], bound[name])}
               for name in ms}}


def rescue_phase(gpu: str):
    """-> (launches, the truth of the rescue reads)."""
    from parasuite_tpu_torch.config import AlignConfig
    from parasuite_tpu_torch.index import KmerIndex, PackedReference
    from parasuite_tpu_torch.io.bam import bam_to_sam
    from parasuite_tpu_torch.io.fastq import read_fastq
    from parasuite_tpu_torch.pipeline.align import AlignerEngine

    t0 = time.perf_counter()
    truth = write_rescue_reads(WORK)
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
    return launches, truth


def _unprojected_align(comb, out) -> dict:
    """`align` on the combined index through the unprojected step (the
    candidate table to the host, every transcript row in the slow path):
    streaming_align with the CLI's engine and supports_packed turned off.
    -> the CLI's reads and reads_per_second."""
    from parasuite_tpu_torch.config import AlignConfig
    from parasuite_tpu_torch.index import KmerIndex
    from parasuite_tpu_torch.pipeline.combined import (CombinedEngine,
                                                       CombinedReference)
    from parasuite_tpu_torch.pipeline.stream import streaming_align

    cfg = AlignConfig(max_read_len=READ_LEN, kmer_size=12, batch_size=BATCH,
                      max_candidates=8, max_occ=16)
    engine = CombinedEngine(CombinedReference.load(comb / "cidx"),
                            KmerIndex.load(comb / "cidx"), cfg,
                            device="cuda")
    engine.supports_packed = False
    t0 = time.perf_counter()
    n, _, _ = streaming_align(engine, comb / "all.fastq", comb / out,
                              command_line="smoke")
    return {"reads": n,
            "reads_per_second": round(n / (time.perf_counter() - t0), 1)}


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
    # FASTQ->SAM of plain mode, combined mode (projected step) and combined
    # mode on the unprojected step, on the same reads, in turns
    rates = {"plain": [], "combined": [], "combined_unprojected": []}
    packed = dict.fromkeys(PACKED_KEYS, 0)
    for mode in ("plain", "combined", "combined_unprojected",
                 "combined_unprojected", "combined", "plain"):
        if mode == "combined_unprojected":
            r = _unprojected_align(comb, "unprojected.sam")
        else:
            r = align("gidx" if mode == "plain" else "cidx", "all.fastq",
                      f"{mode}.sam")
        if r["reads"] != n_reads:
            raise AssertionError(f"combined: {mode} align wrote {r['reads']} "
                                 f"records for {n_reads} reads")
        rates[mode].append(r["reads_per_second"])
        for k in PACKED_KEYS:
            packed[k] += r.get(k, 0)
    tp = _cli_json(["twopass", str(comb / "cidx"), str(comb / "all.fastq"),
                    str(comb / "tp.sam"), "--learned-gaps", "--pg-cl",
                    "smoke", "--batch-size", str(BATCH), *FLAGS, "--device",
                    "cuda"])
    for k in PACKED_KEYS:
        packed[k] += tp[k]
    xa = align("cidx", "xa.fastq", "xa.sam", "--xa")
    launches = _counters()
    n_b = _n_batches(n_reads, BATCH)
    got = _digests(COMBINED_PINNED)
    for sam in ("combined.sam", "unprojected.sam"):
        if sha256(comb / sam) != got["comb/tp.sam.pass1.sam"]:
            raise AssertionError(f"combined: {sam} differs from the twopass "
                                 f"pass-1 SAM")
    if packed["packed_batches"] != 4 * n_b or packed["packed_junctions"] == 0:
        raise AssertionError(f"combined: the projected step did not run as "
                             f"expected: {packed}")
    n_xa = sum("\tXA:Z:" in line for line in _records(comb / "xa.sam"))
    plain_rate = float(np.median(rates["plain"]))
    per_batch = {k: packed[k] / packed["packed_batches"]
                 for k in ("packed_entries", "packed_junctions")}
    # each overflow re-runs its batch through the unprojected step: one
    # more launch of each kernel
    _finish("combined", COMBINED_PINNED, got, launches,
            6 * n_b + 2 * n_b + _n_batches(N_PIN, BATCH)
            + packed["packed_overflow"],
            seconds=round(time.perf_counter() - t0, 3),
            world_and_index_seconds=round(t_world, 3), reads=n_reads,
            fastq_to_sam_reads_per_s=rates,
            combined_over_plain=float(np.median(rates["combined"]))
            / plain_rate,
            unprojected_over_plain=float(np.median(
                rates["combined_unprojected"])) / plain_rate,
            projected=packed, host_per_batch=per_batch,
            twopass_reads=tp["reads"], gap_open=tp["gap_open"],
            gap_extend=tp["gap_extend"], xa_reads=xa["reads"],
            xa_records=n_xa, xa_dropped=xa["xa_dropped"], gpu=gpu)
    combined_host_split(gpu)
    return launches


class _NullWriter:
    def write(self, line):
        pass

    def write_block(self, data):
        pass


def combined_host_split(gpu: str) -> None:
    """Host split of one 65,536-read batch of the combined world, 3 runs
    each: device step (align + synchronize), fetch + to_host, emit_sam into
    a null writer; ms. Plain engine on the genome index (the wire step),
    combined engine on the projected and on the unprojected step."""
    import torch

    from parasuite_tpu_torch.config import AlignConfig
    from parasuite_tpu_torch.index import KmerIndex, PackedReference
    from parasuite_tpu_torch.io.fastq import read_fastq
    from parasuite_tpu_torch.pipeline.align import AlignerEngine
    from parasuite_tpu_torch.pipeline.combined import (CombinedEngine,
                                                       CombinedReference)

    comb = WORK / "comb"
    cfg = AlignConfig(max_read_len=READ_LEN, kmer_size=12, batch_size=BATCH,
                      max_candidates=8, max_occ=16)
    full = read_fastq(comb / "all.fastq", READ_LEN)
    batch = type(full)(codes=full.codes[:BATCH], lengths=full.lengths[:BATCH],
                       names=full.names[:BATCH], quals=full.quals[:BATCH])
    cref = CombinedReference.load(comb / "cidx")
    cidx = KmerIndex.load(comb / "cidx")
    engines = {
        "plain": AlignerEngine(PackedReference.load(comb / "gidx"),
                               KmerIndex.load(comb / "gidx"), cfg,
                               device="cuda"),
        "combined": CombinedEngine(cref, cidx, cfg, device="cuda"),
        "combined_unprojected": CombinedEngine(cref, cidx, cfg,
                                               device="cuda"),
    }
    split = {}
    for name, eng in engines.items():
        # each mode's streaming step: the wire (plain), the projected step
        # (combined), or the unprojected one
        step = (eng.align_device if name == "combined_unprojected"
                else eng.align_device_packed)
        runs = {"device_step": [], "fetch_to_host": [], "emit": []}
        for _ in range(1 + 3):             # the first run warms up
            t0 = time.perf_counter()
            out = step(batch.codes, batch.lengths)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            host = eng.to_host(batch, out)
            t2 = time.perf_counter()
            eng.emit_sam(batch, host, _NullWriter())
            t3 = time.perf_counter()
            for k, v in zip(runs, (t1 - t0, t2 - t1, t3 - t2)):
                runs[k].append(round(1000 * v, 3))
        split[name] = {k: v[1:] for k, v in runs.items()}
    eng = engines["combined"]
    split["combined"].update(entries=eng.packed_entries / eng.packed_batches,
                             junctions=eng.packed_junctions
                             / eng.packed_batches,
                             overflow=eng.packed_overflow)
    phase("combined_host_split", batch=BATCH, ms=split, gpu=gpu)


def sim_phase(gpu: str) -> None:
    """simulate through the port's CLI (host numpy, no kernel)."""
    _reset_counters()
    runs = {}
    for name, index, extra in (
            ("sim_flat.fastq", "idx", []),
            ("sim_prof.fastq", "idx",
             ["--profile", str(WORK / "pin.sam.errorprofile"),
              "--learned-indels"]),
            ("comb/sim.fastq", "comb/cidx", [])):
        t0 = time.perf_counter()
        res = _cli_json(["simulate", str(WORK / index), str(WORK / name),
                         "--n-reads", str(N_SIM), "--read-len",
                         str(READ_LEN), *extra, *FLAGS])
        dt = time.perf_counter() - t0
        runs[name] = {**res, "seconds": round(dt, 3),
                      "reads_per_s": round(N_SIM / dt, 1)}
    _finish("sim", SIM_PINNED, _digests(SIM_PINNED), _counters(), 0,
            runs=runs, gpu=gpu)


def benchmark_phase(gpu: str) -> dict:
    _reset_counters()
    res = _cli_json(["benchmark", str(WORK / "idx"), "--n-reads",
                     str(N_SIM), "--batch-size", str(BATCH), *FLAGS,
                     "--device", "cuda"])
    launches = _counters()
    # one warm-up batch, then every batch once
    _finish("benchmark", BENCH_PINNED,
            {k: res[k] for k in BENCH_PINNED}, launches,
            1 + _n_batches(N_SIM, BATCH),
            items_per_second=res["items_per_second"],
            sensitivity=res["sensitivity"], precision=res["precision"],
            seconds=res["seconds"], gpu=gpu)
    return launches


def tools_phase(gpu: str) -> None:
    """cluster / sort / convert on phase 6's at-scale SAM and BAM."""
    _reset_counters()
    t0 = time.perf_counter()
    out = {}
    for argv in (["cluster", str(WORK / "idx"), str(WORK / "all.sam"),
                  str(WORK / "clusters_sam.tsv"), *FLAGS],
                 ["cluster", str(WORK / "idx"), str(WORK / "all.bam"),
                  str(WORK / "clusters_bam.tsv"), *FLAGS],
                 ["sort", str(WORK / "all.sam"), str(WORK / "sorted.sam")],
                 ["sort", str(WORK / "all.bam"), str(WORK / "sorted.bam")],
                 ["convert", str(WORK / "sorted.bam"),
                  str(WORK / "sorted_bam.sam")],
                 ["convert", str(WORK / "all.sam"), str(WORK / "all_c.bam")],
                 ["convert", str(WORK / "all_c.bam"),
                  str(WORK / "all_c.sam")]):
        t1 = time.perf_counter()
        res = _cli_json(argv)
        out[f"{argv[0]} {Path(argv[-1 if argv[0] != 'cluster' else 2]).name}"
            ] = {**res, "seconds": round(time.perf_counter() - t1, 3)}
    if sha256(WORK / "all_c.sam") != AT_SCALE["all.sam"]:
        raise AssertionError("tools: SAM -> BAM -> SAM changed the bytes")
    _finish("tools", TOOLS_PINNED, _digests(TOOLS_PINNED), _counters(), 0,
            seconds=round(time.perf_counter() - t0, 3), runs=out, gpu=gpu)


def _add(*runs: dict) -> dict:
    """Launch counts of several runs, summed per kernel."""
    return {k: sum(r[k] for r in runs) for k in runs[0]}


def dist_step_phase(engine, gpu: str) -> dict:
    """make_dist_align_step over the machine's cards and over the first
    card given twice, on one BATCH of the bench reads: AlignResult and the
    int64 counts array-equal to the engine's single-device step; one launch
    of each kernel per mesh device and call."""
    import torch

    from parasuite_tpu_torch.io.fastq import read_fastq
    from parasuite_tpu_torch.ops.device_index import min_scores_host
    from parasuite_tpu_torch.parallel import make_dist_align_step, make_mesh

    batch = read_fastq(WORK / "all.fastq", READ_LEN)
    codes, lengths = batch.codes[:BATCH], batch.lengths[:BATCH]
    ms = min_scores_host(lengths, engine.cfg)
    want = engine.align_device(codes, lengths)
    want_counts = engine.profile_counts_device(codes, lengths, want)
    ms_single = _median_ms(lambda: engine.profile_counts_device(
        codes, lengths, engine.align_device(codes, lengths)), reps=5)
    card0 = torch.device("cuda", 0)
    meshes = {"machine_cards": make_mesh(),
              "card0_twice": make_mesh(devices=[card0] * 2)}
    runs, report = [], {}
    for name, mesh in meshes.items():
        step = make_dist_align_step(engine.cfg, mesh)
        _reset_counters()
        got, counts = step(engine.didx, engine.sprof, codes, lengths, ms)
        torch.cuda.synchronize()
        launches = _counters()
        _expect_launches(launches, mesh.size, f"dist_step {name}")
        if counts.dtype != torch.int64 or not torch.equal(
                counts, want_counts.to(torch.int64)):
            raise AssertionError(f"dist_step {name}: summed counts differ "
                                 f"from the single-device step's")
        for f in want._fields:
            if not torch.equal(getattr(got, f), getattr(want, f)):
                raise AssertionError(f"dist_step {name}: {f} differs from "
                                     f"the single-device step's")
        runs.append(launches)
        report[name] = {
            "devices": [str(d) for d in mesh.devices], "launches": launches,
            "ms_per_call": _median_ms(
                lambda: step(engine.didx, engine.sprof, codes, lengths, ms),
                reps=5)}
    phase("dist_step", reads=BATCH, meshes=report,
          single_device_step_ms=ms_single, mapped=int(want.mapped.sum()),
          counts_total=int(want_counts.sum()), max_abs_err=0,
          launches=_add(*runs), gpu=gpu)
    return _add(*runs)


def _merge_and_pin(label: str, prefix: str, n_hosts: int) -> dict:
    """merge-shards of WORK/prefix -> the digests of the merged SAM and
    .errorprofile, which must be DIST_PINNED's."""
    m = _cli_json(["merge-shards", str(WORK / "idx"), str(WORK / prefix),
                   str(WORK / f"{prefix}.sam"), "--n-hosts", str(n_hosts),
                   "--pg-cl", "smoke", "--profile-out",
                   str(WORK / f"{prefix}.errorprofile"), *FLAGS])
    if m["records"] != N_READS:
        raise AssertionError(f"{label}: merged {m['records']} records for "
                             f"{N_READS} reads")
    got = {ext: sha256(WORK / f"{prefix}.{ext}") for ext in DIST_PINNED}
    bad = {k: {"got": got[k], "jax": DIST_PINNED[k]} for k in got
           if got[k] != DIST_PINNED[k]}
    if bad:
        raise AssertionError(f"{label}: differs from the JAX package's: "
                             f"{bad}")
    return {**got, "profiled": m["profiled"]}


def dist_file_phase(gpu: str) -> dict:
    """File-side multi-host mode in this process: `dist-align --host-index h
    --n-hosts 2` for both hosts on all bench reads, then `merge-shards`."""
    _reset_counters()
    t0 = time.perf_counter()
    hosts = [_cli_json(["dist-align", str(WORK / "idx"),
                        str(WORK / "all.fastq"), str(WORK / "dist"),
                        "--host-index", str(h), "--n-hosts", "2",
                        "--batch-size", str(BATCH), *FLAGS, "--device",
                        "cuda"]) for h in range(2)]
    t_align = time.perf_counter() - t0
    launches = _counters()
    merged = _merge_and_pin("dist_file", "dist", 2)
    phase("dist_file", launches=launches, hosts=hosts, merged=merged,
          align_seconds=round(t_align, 3),
          seconds=round(time.perf_counter() - t0, 3),
          reads_per_s_both_hosts_in_turn=round(N_READS / t_align, 1),
          gpu=gpu)
    if sum(h["records"] for h in hosts) != N_READS:
        raise AssertionError(f"dist_file: hosts wrote {hosts}")
    _expect_launches(launches, _n_batches(N_READS, BATCH), "dist_file")
    return launches


def _coordinator_run(prefix: str, n_proc: int, timeout: int = 600) -> list:
    """n_proc processes of the port's CLI as one torch.distributed group on
    this machine's card(s) -> their JSON lines. A process that fails or
    outlasts the timeout ends the run, and none is left behind."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    try:
        for pid in range(n_proc):
            argv = [sys.executable, "-c", COORD_CHILD, "dist-align",
                    str(WORK / "idx"), str(WORK / "all.fastq"),
                    str(WORK / prefix), "--coordinator", f"127.0.0.1:{port}",
                    "--num-processes", str(n_proc), "--process-id", str(pid),
                    "--batch-size", str(BATCH), *FLAGS, "--device", "cuda"]
            procs.append(subprocess.Popen(argv, cwd=REPO,
                                          stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
        lines = []
        for pid, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise AssertionError(f"dist_coord: process {pid} of {n_proc} "
                                     f"exited {p.returncode}:\n{err[-3000:]}")
            lines.append(json.loads(out.strip().splitlines()[-1]))
        return lines
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def dist_coord_phase(gpu: str) -> dict:
    """torch.distributed mode: two processes of the port's CLI that share
    the card (`--coordinator`, in-step all_reduce of the counts), then one
    process alone on the same code path, each merged and pinned. The two
    processes' reads/s is what it is — two processes on one card, not a
    scaling number."""
    import torch

    n_b = _n_batches(N_READS, BATCH)
    runs, report = [], {}
    for n_proc in (2, 1):
        t0 = time.perf_counter()
        lines = _coordinator_run(f"coord{n_proc}", n_proc)
        wall = time.perf_counter() - t0
        launches = _add(*[ln["launches"] for ln in lines])
        # every process has a card of its own -> NCCL; else they share: gloo
        backend = "nccl" if n_proc <= torch.cuda.device_count() else "gloo"
        for ln in lines:
            if (ln["mode"], ln["backend"]) != ("torch.distributed", backend) \
                    or not ln["device"].startswith("cuda"):
                raise AssertionError(f"dist_coord: {ln}, want {backend} on "
                                     f"the card")
        if sum(ln["records"] for ln in lines) != N_READS:
            raise AssertionError(f"dist_coord: processes wrote {lines}")
        # a step a batch, and each process's lockstep warm-up step on an
        # all-padding batch before its clock
        _expect_launches(launches, n_b + n_proc, f"dist_coord x{n_proc}")
        report[f"processes_{n_proc}"] = {
            "lines": lines, "launches": launches, "backend": backend,
            "merged": _merge_and_pin("dist_coord", f"coord{n_proc}", n_proc),
            "wall_seconds_with_start_up": round(wall, 3),
            "reads_per_s": round(N_READS / max(ln["seconds"]
                                               for ln in lines), 1),
            "slowest_process_reads_per_s": min(ln["reads_per_second"]
                                               for ln in lines)}
        runs.append(launches)
    phase("dist_coord", **report, launches=_add(*runs),
          note="two processes share one card: not a scaling number",
          gpu=gpu)
    return _add(*runs)


def shards_phase(gpu: str, k: int = 12, label: str = "shards",
                 pins: dict | None = None, all_equal: bool = False) -> dict:
    """The chromosome-sharded index at 100 Mbp: build_sharded_index over two
    shards, make_sharded_step on a 1 x 2 grid of the first card given twice,
    N_SHARD_READS reads in one call. Pinned to the JAX package's sharded
    step (SHARDS_PINNED), and held to the port's replicated align_batch on
    the full index by the module's contract: the replicated candidate list
    saturates on this reference (n_candidates == 2C on nearly every read),
    so the sharded step maps a superset of reads; every read the replicated
    path maps has every field equal (position through full.locate).

    With all_equal (the run at k = 15, where the JAX package's replicated
    step on the CPU saturates no read's candidate list; 47,497 reads
    saturate at k = 13 and 4 at k = 14) the two paths must agree on ALL
    reads: no read saturated, the same reads mapped, and the nine fields
    equal on every one of them. The host seconds of the index builds are
    reported (a k = 15 bucket array is 4.3 GB per index)."""
    import torch

    from parasuite_tpu_torch.config import AlignConfig
    from parasuite_tpu_torch.errormodel.scoring import flat_score_tensor
    from parasuite_tpu_torch.index import KmerIndex
    from parasuite_tpu_torch.ops.aligner import align_batch
    from parasuite_tpu_torch.ops.device_index import (DeviceIndex,
                                                      ScoreParams,
                                                      min_scores_host)
    from parasuite_tpu_torch.parallel.mesh import make_mesh2
    from parasuite_tpu_torch.parallel.shards import (build_sharded_index,
                                                     make_sharded_step)

    pins = SHARDS_PINNED if pins is None else pins
    t0 = time.perf_counter()
    cfg = AlignConfig(max_read_len=READ_LEN, kmer_size=k,
                      batch_size=N_SHARD_READS, max_candidates=8, max_occ=16)
    seqs, reads = shards_world()
    t_world = time.perf_counter() - t0
    sharded, full = build_sharded_index(seqs, 2, cfg)
    t_build = time.perf_counter() - t0 - t_world
    card0 = torch.device("cuda", 0)
    sprof = ScoreParams.from_tensor(flat_score_tensor(cfg, READ_LEN), cfg,
                                    card0)
    lengths = np.full(N_SHARD_READS, READ_LEN, dtype=np.int32)
    ms = min_scores_host(lengths, cfg)
    step = make_sharded_step(cfg, make_mesh2(1, 2, devices=[card0] * 2))
    slabs = sharded.slabs(cfg)
    _reset_counters()
    out = step(slabs, sharded.orig_chrom, sprof, reads, lengths, ms)
    torch.cuda.synchronize()
    launches = _counters()
    _expect_launches(launches, 2, "shards: one call of the sharded step")
    got = {k: v.cpu().numpy() for k, v in out.items()}
    digests = {"first_16384": shards_digest(got, N_PIN),
               "all_65536": shards_digest(got, N_SHARD_READS)}

    # the replicated path on the full 100 Mbp index, same reads
    t1 = time.perf_counter()
    full_index = KmerIndex.build(full.seq, cfg.kmer_size)
    t_full_index = time.perf_counter() - t1
    didx = DeviceIndex.from_host(full, full_index, card0)
    del full_index
    args = tuple(torch.from_numpy(x).to(card0) for x in (reads, lengths, ms))
    _reset_counters()
    rep = align_batch(didx, sprof, *args, cfg)
    torch.cuda.synchronize()
    rep_launches = _counters()
    _expect_launches(rep_launches, 1, "shards: the replicated step")
    rep = {f: getattr(rep, f).cpu().numpy() for f in rep._fields}
    m = rep["mapped"]
    ci, local = full.locate(rep["pos"])
    want = {"strand": rep["strand"], "chrom": ci, "local_pos": local,
            "score": rep["score"], "mapq": rep["mapq"], "x0": rep["x0"],
            "x1": rep["x1"], "ug_equal": rep["ug_equal"], "nm": rep["nm"]}
    differing = {k: int((got[k][m] != v[m]).sum()) for k, v in want.items()}
    lost = int((m & ~got["mapped"]).sum())
    ms_sharded = _median_ms(lambda: step(slabs, sharded.orig_chrom, sprof,
                                         reads, lengths, ms), reps=5)
    # timed as the sharded step is: host arrays in, result on the card
    ms_replicated = _median_ms(lambda: align_batch(
        didx, sprof, *(torch.from_numpy(x).to(card0)
                       for x in (reads, lengths, ms)), cfg), reps=5)
    saturated = int((rep["n_candidates"] == 2 * cfg.max_candidates).sum())
    mapped_differ = int((got["mapped"] != m).sum())
    phase(label, reads=N_SHARD_READS, kmer_size=k,
          ref_len=int(full.total_len),
          slab_bytes_per_shard={f: int(getattr(sharded, f)[0].nbytes)
                                for f in ("ref_seq", "bucket_starts",
                                          "positions")},
          world_seconds=round(t_world, 3), build_seconds=round(t_build, 3),
          full_index_build_seconds=round(t_full_index, 3),
          launches=launches, replicated_launches=rep_launches,
          digests=digests, mapped=int(got["mapped"].sum()),
          replicated_mapped=int(m.sum()), lost_vs_replicated=lost,
          mapped_only_by_sharding=int((~m & got["mapped"]).sum()),
          replicated_saturated=saturated,
          reads_whose_mapped_flag_differs=mapped_differ,
          fields_differing_on_replicated_mapped=differing,
          all_reads_equal=(saturated == 0 and mapped_differ == 0
                           and not any(differing.values())),
          winners_by_shard=np.bincount(got["shard"][got["mapped"]],
                                       minlength=2).tolist(),
          ms_per_call_sharded=ms_sharded,
          ms_per_call_replicated=ms_replicated,
          seconds=round(time.perf_counter() - t0, 3), gpu=gpu)
    bad = {f: {"got": digests[f], "jax": pins[f]} for f in digests
           if digests[f] != pins[f]}
    if bad:
        raise AssertionError(f"{label}: differs from the JAX package's "
                             f"sharded step: {bad}")
    if lost or any(differing.values()):
        raise AssertionError(f"{label}: against the replicated path lost "
                             f"{lost} reads, fields differing {differing}")
    if all_equal and (saturated or mapped_differ):
        raise AssertionError(f"{label}: {saturated} reads saturate the "
                             f"replicated candidate list and {mapped_differ} "
                             f"reads are mapped by one path only; want "
                             f"equality on all {N_SHARD_READS} reads")
    return _add(launches, rep_launches)


def scaling_phase(gpu: str) -> dict:
    """`benchmark --scaling` over the machine's cards (on one card the
    efficiency is 1.0 by construction: the only point is its own base), and
    its refusal of one card more than the machine has."""
    import torch

    from parasuite_tpu_torch.cli import main as cli

    n_cards = torch.cuda.device_count()
    asked = ",".join(str(n) for n in range(1, n_cards + 1))
    _reset_counters()
    rep = _cli_json(["benchmark", str(WORK / "idx"), "--scaling", asked,
                     "--n-reads", str(BATCH), "--batch-size", str(BATCH),
                     *FLAGS, "--device", "cuda"])
    launches = _counters()
    # per mesh of n cards: one warm-up call and three timed, n launches each
    _expect_launches(launches, 4 * sum(range(1, n_cards + 1)), "scaling")
    if rep["backend"] != "cuda" or rep["points"][0]["efficiency"] != 1.0 \
            or [p["n_devices"] for p in rep["points"]] != list(
                range(1, n_cards + 1)):
        raise AssertionError(f"scaling: report {rep}")
    err = io.StringIO()
    with contextlib.redirect_stderr(err), \
            contextlib.redirect_stdout(io.StringIO()):
        rc = cli(["benchmark", str(WORK / "idx"), "--scaling",
                  f"1,{n_cards + 1}", "--n-reads", str(BATCH), *FLAGS,
                  "--device", "cuda"])
    phase("scaling", report=rep, launches=launches,
          note=("one card: efficiency 1.0 by construction"
                if n_cards == 1 else f"{n_cards} cards"),
          one_card_too_many={"asked": f"1,{n_cards + 1}", "exit_code": rc,
                             "message": err.getvalue().strip()}, gpu=gpu)
    if rc == 0 or f"have {n_cards}" not in err.getvalue() \
            or _counters() != launches:
        raise AssertionError(f"scaling: --scaling 1,{n_cards + 1} on "
                             f"{n_cards} card(s) exited {rc}: "
                             f"{err.getvalue()!r}")
    return launches


def entry_phase(gpu: str) -> dict:
    """parasuite_tpu_torch.entry on the card: entry()'s step on its example
    arguments, and the 1-D then 2-D dry run over the machine's cards."""
    import torch

    from parasuite_tpu_torch import entry

    _reset_counters()
    fn, args = entry.entry()
    tensors = [t for a in args for t in (
        [a] if isinstance(a, torch.Tensor) else
        [getattr(a, f) for f in a.__dataclass_fields__])]
    if not all(t.is_cuda for t in tensors):
        raise AssertionError("entry: example arguments not on the card")
    res = fn(*args)
    torch.cuda.synchronize()
    n_mapped, n = int(res.mapped.sum()), int(res.mapped.shape[0])
    if not (0.9 * n <= n_mapped <= n):
        raise AssertionError(f"entry: {n_mapped} of {n} reads mapped")
    n_cards = torch.cuda.device_count()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        entry.dryrun_multichip(n_cards)
    launches = _counters()
    # entry's step, the 1-D step on n cards, the 2-D step on all n cards
    _expect_launches(launches, 1 + 2 * n_cards, "entry")
    phase("entry", mapped=n_mapped, reads=n, launches=launches,
          dryrun=buf.getvalue().strip().splitlines(), gpu=gpu)
    return launches


def profile_e2e_phase(gpu: str) -> dict:
    """tools/torch_profile_e2e.py on the smoke's own files: where FASTQ ->
    SAM time goes in plain mode (all bench reads), with --xa (the xa world)
    and in combined mode (the projected step), the device-busy share of
    each run's wall, and every main-thread span found as a range in the
    profiler's trace. The recorded plain SAM must be the at-scale
    phase's."""
    import torch_profile_e2e as prof

    runs = (("plain", WORK / "idx", WORK / "all.fastq", False, 2),
            ("xa", WORK / "xa/idx", WORK / "xa/reads.fastq", True, 1),
            ("combined", WORK / "comb/cidx", WORK / "comb/all.fastq", False,
             2))
    _reset_counters()
    report, want = {}, 0
    for name, index, fastq, xa, rounds in runs:
        engine = prof.load_engine(index, "cuda", xa, BATCH)
        out = WORK / f"profile_{name}.sam"
        rec = prof.profile_stream(engine, fastq, out, rounds=rounds,
                                  command_line="smoke")
        report[name] = rec
        want += rounds * rec["batches"] + getattr(engine, "packed_overflow",
                                                  0)
        if not (0.0 < rec["device_busy_share"] <= 1.0):
            raise AssertionError(f"profile_e2e {name}: device-busy share "
                                 f"{rec['device_busy_share']}")
        if any(t["self_seconds"] < 0 for t in rec["timers"].values()):
            raise AssertionError(f"profile_e2e {name}: a negative timer")
        if rec["main_ranges"] != rec["main_spans"]:
            raise AssertionError(f"profile_e2e {name}: {rec['main_ranges']} "
                                 f"of {rec['main_spans']} main-thread spans "
                                 f"in the profiler's trace")
    launches = _counters()
    phase("profile_e2e", runs=report, launches=launches, gpu=gpu)
    for name, pinned in (("plain", AT_SCALE["all.sam"]),
                         ("xa", XA_PINNED["xa/xa.sam"])):
        if sha256(WORK / f"profile_{name}.sam") != pinned:
            raise AssertionError(f"profile_e2e: the probed {name} run wrote "
                                 f"another SAM than the unprobed one")
    _expect_launches(launches, want, "profile_e2e")
    return launches


def sweep_lengths_phase(gpu: str) -> dict:
    """tools/torch_sweep_lengths.py's adaptive placement at 36 / 50 / 75 /
    100 bp, N_SWEEP_READS reads a length on the bench world, against the
    JAX package's counts on the same reads (SWEEP_PINNED)."""
    import torch_sweep_lengths as sweep

    base = tb.make_cfg(BATCH)
    _reset_counters()
    lines, bad = [], {}
    for L in sweep.LENGTHS:
        line = sweep.sweep_line(base, "adaptive", L, N_SWEEP_READS, REF_LEN,
                                "cuda")
        lines.append(line)
        pin = SWEEP_PINNED[L]
        for f in ("sensitivity", "precision"):
            if abs(line[f] - pin[f]) > ACCURACY_SLACK:
                bad[f"{L}.{f}"] = {"got": line[f], "jax": pin[f]}
        for f in ("stride_eff", "n_mismapped"):
            if line[f] != pin[f]:
                bad[f"{L}.{f}"] = {"got": line[f], "jax": pin[f]}
    launches = _counters()
    phase("sweep_lengths", lines=lines, pinned=SWEEP_PINNED,
          n_unmapped_equal_to_jax=all(
              ln["n_unmapped"] == SWEEP_PINNED[ln["read_len"]]["n_unmapped"]
              for ln in lines),
          reads_per_length=N_SWEEP_READS, launches=launches, gpu=gpu)
    if bad:
        raise AssertionError(f"sweep_lengths: differs from the JAX "
                             f"package's: {bad}")
    # per length one warm-up batch and TIMED_ROUNDS rounds of one batch
    _expect_launches(launches, len(sweep.LENGTHS) * (1 + tb.TIMED_ROUNDS)
                     * _n_batches(N_SWEEP_READS, BATCH), "sweep_lengths")
    return launches


def genome_phase(xa_stats, gpu: str) -> dict:
    """tools/torch_bench_genome.py at full width: the 200 Mbp five-chromosome
    genome at k = 13, batch 65,536 (world, index and index census built
    here; the host seconds of each are reported), and the 51 Mbp chr22-class
    world of the xa phase at k = 12 on its index. Census numbers, the
    seeding-blind read count and the accuracy fractions against the JAX
    package's (GENOME_PINNED)."""
    import torch

    import torch_bench_genome as genome
    from parasuite_tpu_torch.index import KmerIndex, PackedReference
    from parasuite_tpu_torch.sim.genome import multi_chrom

    t0 = time.perf_counter()
    _reset_counters()
    xa_ref = PackedReference.load(WORK / "xa/idx")
    worlds = [genome.run_world(
        "chr22_class_51Mbp", xa_ref, xa_stats, genome.make_cfg(BATCH, 12),
        N_GENOME_READS["chr22_class_51Mbp"], False, "cuda",
        index=KmerIndex.load(WORK / "xa/idx"))]
    del xa_ref
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    seqs, stats = multi_chrom(200_000_000, 5)
    cfg = genome.make_cfg(BATCH, 13)
    ref = PackedReference.from_dict(seqs, spacer=cfg.chrom_spacer)
    t_world = time.perf_counter() - t1
    worlds.append(genome.run_world(
        "multi_chrom_200Mbp", ref, stats, cfg,
        N_GENOME_READS["multi_chrom_200Mbp"], False, "cuda"))
    launches = _counters()
    bad = {}
    for w in worlds:
        pin = GENOME_PINNED[w["world"]]
        for f in GENOME_EXACT:
            if w[f] != pin[f]:
                bad[f"{w['world']}.{f}"] = {"got": w[f], "jax": pin[f]}
        for f in GENOME_FRACTIONS:
            if abs(w[f] - pin[f]) > ACCURACY_SLACK:
                bad[f"{w['world']}.{f}"] = {"got": w[f], "jax": pin[f]}
    phase("genome", worlds=worlds, pinned=GENOME_PINNED,
          world_200Mbp_seconds=round(t_world, 3), launches=launches,
          seconds=round(time.perf_counter() - t0, 3), gpu=gpu)
    if bad:
        raise AssertionError(f"genome: differs from the JAX package's: "
                             f"{bad}")
    if worlds[1]["n_reads"] != 262_144 or worlds[1]["kmer_size"] != 13:
        raise AssertionError(f"genome: the 200 Mbp world ran {worlds[1]}")
    # per world one warm-up batch and three rounds of every batch
    _expect_launches(launches, sum(
        1 + 3 * _n_batches(n, BATCH) for n in N_GENOME_READS.values()),
        "genome")
    return launches


def rescue_sens_phase(truth: dict, gpu: str) -> dict:
    """Sensitivity at 36 bp with rescue_kmer 11 on the rescue phase's reads
    (tools/torch_bench_rescue.py's engine_accuracy against the reads'
    truth), pinned to the JAX engine's on the same reads
    (RESCUE_SENS_PINNED)."""
    from types import SimpleNamespace

    import torch_bench_rescue as rescue
    from parasuite_tpu_torch.config import AlignConfig
    from parasuite_tpu_torch.index import KmerIndex, PackedReference
    from parasuite_tpu_torch.io.fastq import read_fastq
    from parasuite_tpu_torch.pipeline.align import AlignerEngine

    cfg = AlignConfig(max_read_len=RESCUE_LEN, kmer_size=12,
                      batch_size=RESCUE_BATCH, max_candidates=8, max_occ=16,
                      rescue_kmer=11)
    ref = PackedReference.load(WORK / "idx")
    engine = AlignerEngine(ref, KmerIndex.load(WORK / "idx"), cfg,
                           device="cuda")
    batch = read_fastq(WORK / "rescue.fastq", RESCUE_LEN)
    packed = SimpleNamespace(
        strand=truth["reverse"].astype(np.int32),
        packed_pos=truth["start"].astype(np.int64) + int(ref.starts[0]))
    _reset_counters()
    acc, n = rescue.engine_accuracy(engine, batch.codes, batch.lengths,
                                    packed)
    launches = _counters()
    got = {**acc, "n_reads": n, "rescue_mapped": engine.rescue_mapped,
           "rescue_overflow": engine.rescue_overflow}
    phase("rescue_sens", got=got, pinned=RESCUE_SENS_PINNED,
          launches=launches, gpu=gpu)
    bad = {f: {"got": got[f], "jax": v} for f, v in RESCUE_SENS_PINNED.items()
           if (abs(got[f] - v) > ACCURACY_SLACK if isinstance(v, float)
               else got[f] != v)}
    if bad:
        raise AssertionError(f"rescue_sens: differs from the JAX engine's: "
                             f"{bad}")
    # one primary and one rescue step a batch (every batch has all-N reads)
    _expect_launches(launches, 2 * _n_batches(N_MODE_READS, RESCUE_BATCH),
                     "rescue_sens")
    return launches


def scale_phase(gpu: str) -> None:
    """tools/torch_scale_run.py at N_SCALE_READS reads as its own process
    (it runs the port's CLI in subprocesses, so this process counts none of
    its launches): the kill lands mid-run, the resumed BAM and .errorprofile
    equal the control's bytes, the native cluster scan equals the Python
    oracle on the first 131,072 records, and the cluster count is the JAX
    CLI's (SCALE_PINNED)."""
    import os

    env = {**os.environ, "PARASUITE_SCALE_READS": str(N_SCALE_READS),
           "PARASUITE_SCALE_DIR": str(WORK / "scale"),
           "PARASUITE_BENCH_BATCH": str(BATCH),
           "PARASUITE_SCALE_SPOTCHECK": str(2 * BATCH)}
    for var in ("PARASUITE_SCALE_KILL_AFTER", "PARASUITE_SCALE_KILL_BATCHES",
                "PARASUITE_SCALE_REFSCALE", "PARASUITE_SCALE_SITES"):
        env.pop(var, None)
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable,
                        str(REPO / "tools" / "torch_scale_run.py"),
                        "--device", "cuda"], env=env, capture_output=True,
                       text=True, timeout=900)
    if p.returncode != 0:
        raise AssertionError(f"scale: torch_scale_run.py exited "
                             f"{p.returncode}:\n{p.stdout[-2000:]}\n"
                             f"{p.stderr[-3000:]}")
    stats = json.loads(p.stdout.strip().splitlines()[-1])
    got = {"clusters": stats["cluster"]["result"]["clusters"],
           "alignments": stats["cluster"]["result"]["alignments"],
           "fastq_sha256": sha256(WORK / "scale/reads.fastq"),
           "clusters_sha256": sha256(WORK / "scale/clusters.tsv"),
           "errorprofile_sha256": sha256(
               WORK / "scale/run/out.bam.errorprofile")}
    phase("scale", stats=stats, got=got, pinned=SCALE_PINNED,
          seconds=round(time.perf_counter() - t0, 3), gpu=gpu)
    bad = {f: {"got": got[f], "jax": v} for f, v in SCALE_PINNED.items()
           if got[f] != v}
    if bad:
        raise AssertionError(f"scale: differs from the JAX CLI's: {bad}")
    if not stats["resume_byte_identical"] \
            or not stats["cluster_spotcheck"]["parity"] \
            or stats["twopass_resumed"]["result"]["reads"] != N_SCALE_READS:
        raise AssertionError(f"scale: {stats}")


def bench_leg_phase(gpu: str) -> dict:
    """bench_torch.py's main at full size on the card: its line, its
    launches (one warm-up batch and three rounds of 16 batches a device leg,
    one or two device legs; a warm-up run and five timed runs of 16 batches
    end to end), and its accuracy against the JAX package's
    (BENCH_LEG_PINNED)."""
    import bench_torch

    _reset_counters()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench_torch.main(["--device", "cuda"])
    if rc != 0:
        raise AssertionError(f"bench_leg: bench_torch.main exited {rc}")
    out = buf.getvalue().strip().splitlines()
    if len(out) != 1:
        raise AssertionError(f"bench_leg: {len(out)} lines, want one")
    line = json.loads(out[0])
    launches = _counters()
    n_b = _n_batches(bench_torch.N_READS, bench_torch.BATCH)
    legs = 2 if line["rerun_triggered"] else 1
    want = (legs * (1 + bench_torch.TIMED_ROUNDS * n_b)
            + (1 + bench_torch.E2E_ROUNDS) * n_b)
    got = {k: line[k] for k in BENCH_LEG_PINNED}
    phase("bench_leg", line=line, pinned=BENCH_LEG_PINNED,
          launches=launches, seconds=round(time.perf_counter() - t0, 3),
          gpu=gpu)
    if got != BENCH_LEG_PINNED:
        raise AssertionError(f"bench_leg: accuracy {got}, the JAX "
                             f"package's {BENCH_LEG_PINNED}")
    if line["gpu"] != gpu or line["n_reads"] != 1_048_576:
        raise AssertionError(f"bench_leg: ran {line}")
    _expect_launches(launches, want, "bench_leg")
    return launches


def dist_bench_phase(gpu: str) -> dict:
    """tools/torch_bench_distributed.py at N_DIST_BENCH_READS reads and one
    round (more if its efficiency rule remeasures): the tool fails unless
    the records add up and the two-process output has the one-process
    output's bytes; each process's launches come from its JSON line, one a
    batch of 8,192 reads and one for its warm-up step."""
    import torch_bench_distributed as tbd

    t0 = time.perf_counter()
    line = tbd.measure(N_DIST_BENCH_READS, "cuda", rounds=1)
    launches = line["launches"]
    rounds = len(line["rounds_1proc"])
    phase("dist_bench", line=line, launches=launches,
          seconds=round(time.perf_counter() - t0, 3), gpu=gpu)
    if not line["same_output"] or line["gpu"] != gpu:
        raise AssertionError(f"dist_bench: {line}")
    # a round: one and two processes, a step a batch each, and each
    # process's warm-up step (1 + 2)
    _expect_launches(launches, rounds * (2 * _n_batches(
        N_DIST_BENCH_READS, tbd.BATCH) + 3), "dist_bench")
    return launches


def shards_scale_phase(gpu: str) -> dict:
    """tools/torch_bench_shards_scale.py at full size: the 200 Mbp genome on
    a 2 x 2 mesh, 2,048 reads; every count pinned to the JAX tool's record.
    One launch of each kernel for the replicated step, and four (one a mesh
    cell) for each of the sharded step's two calls."""
    import torch

    import torch_bench_shards_scale as tss

    t0 = time.perf_counter()
    _reset_counters()
    line = tss.measure("cuda", tss.FULL_LEN, tss.FULL_READS)
    launches = _counters()
    bad = tss.pin_check(line)
    phase("shards_scale", line=line, pinned=tss.PINNED, launches=launches,
          seconds=round(time.perf_counter() - t0, 3), gpu=gpu)
    torch.cuda.empty_cache()
    if bad or line["total_ref_len"] < tss.FULL_LEN:
        raise AssertionError(f"shards_scale: differs from the JAX tool's "
                             f"record: {bad}")
    _expect_launches(launches, 1 + 2 * tss.N_DATA * tss.N_INDEX,
                     "shards_scale")
    return launches


HOST_FIELDS = ("mapped", "strand", "pos", "score", "mapq", "x0", "x1", "nm",
               "ug_equal", "tc_count")


def _host_equal(want, got, what: str) -> None:
    """An AlignResult of numpy arrays, or a HostAlignments, equal to
    another field by field, in value and dtype."""
    for f in want._fields if hasattr(want, "_fields") else HOST_FIELDS:
        w, g = getattr(want, f), getattr(got, f)
        if w.dtype != g.dtype or not np.array_equal(w, g):
            raise AssertionError(f"{what}: {f} differs")


def _ops_of(fn) -> dict:
    """What one call of fn (a step and its fetch) puts on the device: the
    PyTorch operators it dispatches, the kernel launches of the
    wrappers, the CUDA graphs it replays, and the CUDA kernels and copies
    the profiler records (None where it records none)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    replay = torch.cuda.CUDAGraph.replay
    graphs = []

    def counted(graph):
        graphs.append(graph)
        return replay(graph)

    torch.cuda.synchronize()
    _reset_counters()
    torch.cuda.CUDAGraph.replay = counted
    try:
        with Count():
            fn()
    finally:
        torch.cuda.CUDAGraph.replay = replay
    torch.cuda.synchronize()
    out = {"torch_ops": Count.n, **_counters(), "graph_launches": len(graphs)}
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(1 for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
        out["cuda_events"] = n or None
    except (RuntimeError, AssertionError):   # no CUDA activity to trace
        out["cuda_events"] = None
    return out


def wire_phase(gpu: str) -> dict:
    """The wire step (2-bit codes and N mask up, PackedResult down, the
    profile counts fused) against the unpacked step: equal outputs on every
    batch of the bench world, the rescue tier and the combined world;
    bytes moved; step + fetch ms and what each step launches; "jnp" against
    "auto" on the card; FASTQ -> SAM of `cli align` and `cli twopass` on
    both steps, in turns. -> the kernel launches of the CLI runs on the
    wire step (the main path; the comparisons' launches are not counted)."""
    import torch

    import parasuite_tpu_torch.cli as pcli
    from parasuite_tpu_torch.config import AlignConfig
    from parasuite_tpu_torch.index import KmerIndex, PackedReference
    from parasuite_tpu_torch.io.fastq import read_fastq
    from parasuite_tpu_torch.ops.aligner import (align_batch_packed,
                                                 unpack_result_host)
    from parasuite_tpu_torch.pipeline.align import AlignerEngine, fetch_host
    from parasuite_tpu_torch.pipeline.combined import (CombinedEngine,
                                                       CombinedReference)

    t0 = time.perf_counter()
    cfg = AlignConfig(max_read_len=READ_LEN, kmer_size=12, batch_size=BATCH,
                      max_candidates=8, max_occ=16)
    ref, index = PackedReference.load(WORK / "idx"), KmerIndex.load(
        WORK / "idx")
    engine = AlignerEngine(ref, index, cfg, device="cuda")
    W = cfg.band_width
    full = read_fastq(WORK / "all.fastq", READ_LEN)
    chunks = [(full.codes[i:i + BATCH], full.lengths[i:i + BATCH])
              for i in range(0, N_READS, BATCH)]

    def packed_host(out):
        return unpack_result_host(fetch_host(out)[0], W)

    # (a) every batch: the wire step = the unpacked step; fused counts =
    # profile_counts_device
    for k, (codes, lens) in enumerate(chunks):
        packed, counts = engine.align_device_packed(codes, lens,
                                                    with_counts=True)
        res = engine.align_device(codes, lens)
        want_counts = engine.profile_counts_device(codes, lens, res)
        _host_equal(fetch_host(res)[0], packed_host(packed),
                    f"wire batch {k}")
        if not torch.equal(counts, want_counts):
            raise AssertionError(f"wire batch {k}: fused counts differ")
    # (c) bytes a batch, counted from the tensors each step moves
    moved = {}
    upload = engine._upload
    for name, step in (("wire", engine.align_device_packed),
                       ("unpacked", engine.align_device)):
        up = []
        engine._upload = lambda *a: up.append(upload(*a)) or up[-1]
        out = step(*chunks[0])
        engine._upload = upload
        moved[name] = {
            "up": sum(x.numel() * x.element_size() for x in up[0]),
            "down": sum(x.numel() * x.element_size() for x in out)}
    if moved["wire"]["down"] > 13 * BATCH + 64 or \
            moved["wire"]["up"] > 22 * BATCH:
        raise AssertionError(f"wire: bytes a batch {moved['wire']}")
    # (d) step + fetch, ms, in turns; and as a profile pass (+ counts)
    codes, lens = chunks[0]
    steps = {
        "wire": lambda: fetch_host(engine.align_device_packed(codes,
                                                              lens)),
        "unpacked": lambda: fetch_host(engine.align_device(codes, lens)),
        "wire_counts": lambda: [
            x.cpu() if isinstance(x, torch.Tensor) else fetch_host(x)
            for x in engine.align_device_packed(codes, lens,
                                                with_counts=True)],
        "unpacked_counts": lambda: (
            lambda r: (engine.profile_counts_device(codes, lens, r).cpu(),
                       fetch_host(r)))(engine.align_device(codes, lens)),
    }
    ms = {name: [] for name in steps}
    for turn in range(10):
        order = list(steps) if turn % 2 == 0 else list(steps)[::-1]
        for name in order:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            steps[name]()
            torch.cuda.synchronize()
            ms[name].append(1e3 * (time.perf_counter() - t1))
    packed_fetched = fetch_host(engine.align_device_packed(codes, lens))[0]
    t1 = time.perf_counter()
    unpack_result_host(packed_fetched, W)
    unpack_ms = 1e3 * (time.perf_counter() - t1)
    # (e) what a step (and its fetch) puts on the device
    launches = {name: _ops_of(steps[name]) for name in steps}
    for name, want in (("wire", 1), ("unpacked", 1)):
        if (launches[name]["seed_select"],
                launches[name]["extend_candidates"],
                launches[name]["finalize_select"]) != (want, want, want):
            raise AssertionError(f"wire: {name} launches {launches[name]}")
    # (f) "jnp" on the card = "auto", field by field, on 4,096 reads
    small = [x[:4096] for x in chunks[0]]
    outs = {}
    for impl in ("auto", "jnp"):
        c = cfg.replace(extend_impl=impl, select_impl=impl)
        _reset_counters()
        outs[impl] = packed_host(align_batch_packed(
            engine.didx, engine.sprof, *engine._upload_wire(*small),
            engine._ms_table, c))
        _expect_launches(_counters(), 1 if impl == "auto" else 0,
                         f"wire: {impl}", finalize=1)
    _host_equal(outs["auto"], outs["jnp"], "wire: jnp vs auto on the card")
    del engine
    torch.cuda.empty_cache()

    # (b) the rescue tier on the rescue world, the combined step on the
    # combined world: to_host of the wire step = of the unpacked one
    rcfg = AlignConfig(max_read_len=RESCUE_LEN, kmer_size=12,
                       batch_size=RESCUE_BATCH, max_candidates=8, max_occ=16,
                       rescue_kmer=11)
    reng = AlignerEngine(ref, index, rcfg, device="cuda")
    rb = read_fastq(WORK / "rescue.fastq", RESCUE_LEN)
    rbatch = type(rb)(codes=rb.codes[:RESCUE_BATCH],
                      lengths=rb.lengths[:RESCUE_BATCH],
                      names=rb.names[:RESCUE_BATCH],
                      quals=rb.quals[:RESCUE_BATCH])
    hosts, rescued = [], []
    for packed in (True, False):
        reng.supports_packed = packed
        step = reng.align_device_packed if packed else reng.align_device
        reng.rescue_mapped = reng.rescue_overflow = 0
        hosts.append(reng.to_host(rbatch, step(rbatch.codes,
                                               rbatch.lengths)))
        rescued.append((reng.rescue_mapped, reng.rescue_overflow))
    _host_equal(hosts[1], hosts[0], "wire: rescue tier")
    if rescued[0] != rescued[1] or rescued[0][0] <= 0:
        raise AssertionError(f"wire: rescue counters {rescued}")
    cfg2, didx2, cap = reng._rescue
    r2 = [reng._step_packed(didx2, cfg2, rbatch.codes[:cap],
                            rbatch.lengths[:cap]),
          reng._step(didx2, cfg2, rbatch.codes[:cap], rbatch.lengths[:cap])]
    _host_equal(fetch_host(r2[1])[0], packed_host(r2[0]),
                "wire: rescue step")
    del reng, r2
    comb = WORK / "comb"
    ceng = CombinedEngine(CombinedReference.load(comb / "cidx"),
                          KmerIndex.load(comb / "cidx"), cfg, device="cuda")
    cb = read_fastq(comb / "all.fastq", READ_LEN)
    cbatch = type(cb)(codes=cb.codes[:BATCH], lengths=cb.lengths[:BATCH],
                      names=cb.names[:BATCH], quals=cb.quals[:BATCH])
    cout = ceng.align_device_packed(cbatch.codes, cbatch.lengths)
    moved["combined_wire_down"] = sum(x.numel() * x.element_size()
                                      for p in cout for x in p)
    hc = [ceng.to_host(cbatch, cout),
          ceng.to_host(cbatch, ceng.align_device(cbatch.codes,
                                                 cbatch.lengths))]
    _host_equal(hc[1], hc[0], "wire: combined step")
    if any(hc[0].cigars[i] != hc[1].cigars[i] for i in range(BATCH)):
        raise AssertionError("wire: combined step CIGARs differ")
    if ceng.packed_batches != 1 or ceng.packed_overflow:
        raise AssertionError(f"wire: combined step {ceng.packed_batches}, "
                             f"overflow {ceng.packed_overflow}")
    del ceng
    torch.cuda.empty_cache()

    # FASTQ -> SAM through the CLI on both steps, in turns: the unpacked
    # runs take the CLI's engines with supports_packed turned off
    load = pcli._load_engine

    def unpacked_load(*a, **kw):
        e = load(*a, **kw)
        e.supports_packed = False
        return e

    e2e = {"align": {"wire": [], "unpacked": []},
           "twopass": {"wire": [], "unpacked": []}}
    digests = {}
    wire_launches = []
    for cmd in ("align", "twopass"):
        for mode in ("wire", "unpacked", "unpacked", "wire") * 2:
            out = WORK / f"wire_{cmd}_{mode}.sam"
            extra = ["--learned-gaps"] if cmd == "twopass" else []
            pcli._load_engine = unpacked_load if mode == "unpacked" else load
            _reset_counters()
            t1 = time.perf_counter()
            try:
                res = _cli_json([cmd, str(WORK / "idx"),
                                 str(WORK / "all.fastq"), str(out), *extra,
                                 "--pg-cl", "smoke", "--batch-size",
                                 str(BATCH), *FLAGS, "--device", "cuda"])
            finally:
                pcli._load_engine = load
            dt = time.perf_counter() - t1
            want = (1 if cmd == "align" else 2) * _n_batches(N_READS, BATCH)
            _expect_launches(_counters(), want, f"wire {cmd} {mode}")
            if mode == "wire":
                wire_launches.append(_counters())
            e2e[cmd][mode].append({
                "seconds_in_cli": res.get("seconds"),
                "reads_per_s_in_cli": res.get("reads_per_second"),
                "call_seconds": round(dt, 3),
                "reads_per_s_call": round(res["reads"] / dt, 1)})
            names = [out.name] + ([f"{out.name}.pass1.sam",
                                   f"{out.name}.errorprofile"]
                                  if cmd == "twopass" else [])
            digests.setdefault(cmd, {})[mode] = {
                n: sha256(WORK / n) for n in names}
    if digests["align"]["wire"]["wire_align_wire.sam"] != AT_SCALE["all.sam"]:
        raise AssertionError("wire: align SAM differs from the JAX "
                             "package's")
    for cmd, d in digests.items():
        if list(d["wire"].values()) != list(d["unpacked"].values()):
            raise AssertionError(f"wire: {cmd} outputs differ by step")
    tp = list(digests["twopass"]["wire"].values())
    if tp[1:] != [AT_SCALE["all.bam.pass1.sam"],
                  AT_SCALE["all.bam.errorprofile"]]:
        raise AssertionError("wire: twopass pass 1 differs from the JAX "
                             "package's")
    phase("wire", batch=BATCH, bytes_per_batch=moved,
          step_fetch_ms={k: {"median": float(np.median(v)), "runs": v}
                         for k, v in ms.items()},
          unpack_result_host_ms=unpack_ms, per_step=launches,
          fastq_to_sam_in_turns=e2e,
          rescue_counters=rescued[0],
          seconds=round(time.perf_counter() - t0, 3), gpu=gpu)
    return _add(*wire_launches)


class _Both:
    """Stands in for an engine's CompiledStep: each call runs the graphed
    step and the step's function eagerly on the same inputs, and keeps
    both outputs."""

    def __init__(self, step):
        self.step, self.pairs = step, []

    def __call__(self, *tensors, **static):
        got = self.step(*tensors, **static)
        self.pairs.append((got, self.step.fn(*tensors, **static)))
        return got


def _spy(engine) -> list:
    """Every compiled step of engine -> a _Both; -> the _Both objects."""
    from parasuite_tpu_torch.ops.compiled import CompiledStep

    spies = []
    for steps in engine._steps.values():
        for kind, st in steps.items():
            if isinstance(st, CompiledStep):
                steps[kind] = _Both(st)
                spies.append(steps[kind])
    return spies


def _eager(engine):
    """engine with every compiled step replaced by its function: the
    eager route, op by op, on the same bound parameters."""
    from parasuite_tpu_torch.ops.compiled import CompiledStep

    for steps in engine._steps.values():
        for kind, st in steps.items():
            if isinstance(st, CompiledStep):
                steps[kind] = st.fn
    return engine


def _pairs_equal(spies, what: str) -> dict:
    """Every (graphed, eager) pair of the spies equal at tolerance 0 ->
    {step name: calls compared}."""
    import torch
    from torch.utils._pytree import tree_leaves

    torch.cuda.synchronize()
    seen = {}
    for spy in spies:
        for k, (got, want) in enumerate(spy.pairs):
            for g, w in zip(tree_leaves(got), tree_leaves(want),
                            strict=True):
                if g.dtype != w.dtype or not torch.equal(g, w):
                    raise AssertionError(f"graph: {what} {spy.step.name} "
                                         f"call {k} differs from eager")
        if spy.pairs:
            seen[spy.step.name] = len(spy.pairs)
    return seen


def _fetch_out(out) -> list:
    """A step's output on the host: each record through fetch_host, a bare
    tensor (the fused counts) by .cpu()."""
    from parasuite_tpu_torch.pipeline.align import fetch_host

    parts = out if isinstance(out, tuple) and not hasattr(out, "_fields") \
        else (out,)
    return [x.cpu() if hasattr(x, "cpu") else fetch_host(x) for x in parts]


def _graph_stats(engine) -> dict:
    """{step name: keys, graphs, capture ms} of engine's compiled steps
    that ran (through a _Both too)."""
    from parasuite_tpu_torch.ops.compiled import CompiledStep

    steps = [getattr(st, "step", st) for tier in engine._steps.values()
             for st in tier.values()]
    return {st.name: {"keys": len(st.entries), "graphs": st.graphs,
                      "capture_ms": st.capture_ms}
            for st in steps if isinstance(st, CompiledStep) and st.entries}


def graph_phase(gpu: str) -> dict:
    """The compiled steps (ops/compiled.py: one CUDA graph a step and key,
    replayed), which phases 5-28 stream through, against the eager
    functions: equal outputs at tolerance 0 on every batch of the bench
    world with 8 calls of each step in flight, on one rescue batch and one
    combined batch; keys, graphs and capture ms; operators, kernels and
    graph launches a step; host enqueue ms; step + fetch ms alone and as a
    profile pass; the bench loop and `cli align` / `twopass` FASTQ -> SAM,
    graphed and eager in turns. -> the kernel launches of the graphed CLI
    runs (the main path)."""
    import torch

    import parasuite_tpu_torch.cli as pcli
    from parasuite_tpu_torch.config import AlignConfig
    from parasuite_tpu_torch.index import KmerIndex, PackedReference
    from parasuite_tpu_torch.io.fastq import read_fastq
    from parasuite_tpu_torch.pipeline.align import AlignerEngine
    from parasuite_tpu_torch.pipeline.combined import (CombinedEngine,
                                                       CombinedReference)

    t0 = time.perf_counter()
    cfg = AlignConfig(max_read_len=READ_LEN, kmer_size=12, batch_size=BATCH,
                      max_candidates=8, max_occ=16)
    ref, index = PackedReference.load(WORK / "idx"), KmerIndex.load(
        WORK / "idx")
    full = read_fastq(WORK / "all.fastq", READ_LEN)
    chunks = [(full.codes[i:i + BATCH], full.lengths[i:i + BATCH])
              for i in range(0, N_READS, BATCH)]

    # (a) every step kind = its eager function, 8 calls in flight each
    engine = AlignerEngine(ref, index, cfg, device="cuda")
    spies = _spy(engine)
    for codes, lens in chunks * 2:
        res = engine.align_device(codes, lens)
        engine.profile_counts_device(codes, lens, res)
        engine._step(engine.didx, cfg, codes, lens, with_candidates=True)
        engine.align_device_packed(codes, lens)
        engine.align_device_packed(codes, lens, with_counts=True)
    compared = {"bench": _pairs_equal(spies, "bench")}
    keys = {"bench": _graph_stats(engine)}
    del engine, spies, res
    rcfg = AlignConfig(max_read_len=RESCUE_LEN, kmer_size=12,
                       batch_size=RESCUE_BATCH, max_candidates=8, max_occ=16,
                       rescue_kmer=11)
    reng = AlignerEngine(ref, index, rcfg, device="cuda")
    rb = read_fastq(WORK / "rescue.fastq", RESCUE_LEN)
    rbatch = type(rb)(codes=rb.codes[:RESCUE_BATCH],
                      lengths=rb.lengths[:RESCUE_BATCH],
                      names=rb.names[:RESCUE_BATCH],
                      quals=rb.quals[:RESCUE_BATCH])
    spies = _spy(reng)
    cfg2, didx2, cap = reng._rescue
    for _ in range(2):
        reng.to_host(rbatch, reng.align_device_packed(rbatch.codes,
                                                      rbatch.lengths))
        reng._step(didx2, cfg2, rbatch.codes[:cap], rbatch.lengths[:cap])
    compared["rescue"] = _pairs_equal(spies, "rescue")
    keys["rescue"] = _graph_stats(reng)
    if reng.rescue_mapped <= 0:
        raise AssertionError("graph: the rescue batch rescued nothing")
    del reng, spies
    ceng = CombinedEngine(CombinedReference.load(WORK / "comb/cidx"),
                          KmerIndex.load(WORK / "comb/cidx"), cfg,
                          device="cuda")
    cb = read_fastq(WORK / "comb/all.fastq", READ_LEN)
    spies = _spy(ceng)
    for _ in range(2):
        ceng.align_device_packed(cb.codes[:BATCH], cb.lengths[:BATCH])
        ceng.align_device(cb.codes[:BATCH], cb.lengths[:BATCH])
    compared["combined"] = _pairs_equal(spies, "combined")
    keys["combined"] = _graph_stats(ceng)
    del ceng, spies
    torch.cuda.empty_cache()

    # (b) graphed against eager on one engine each: what a step puts on
    # the device, host enqueue, step + fetch, the bench loop
    graphed = AlignerEngine(ref, index, cfg, device="cuda")
    eager = _eager(AlignerEngine(ref, index, cfg, device="cuda"))
    engines = {"graphed": graphed, "eager": eager}
    codes, lens = chunks[0]
    for e in engines.values():
        for w in (False, True):
            _fetch_out(e.align_device_packed(codes, lens, with_counts=w))
    per_step = {f"{mode}{suffix}": _ops_of(
        lambda e=e, w=bool(suffix): _fetch_out(
            e.align_device_packed(codes, lens, with_counts=w)))
        for mode, e in engines.items() for suffix in ("", "_counts")}
    for name, want in (("graphed", (1, 1, 1, 1)), ("eager", (1, 1, 1, 0))):
        got = per_step[name]
        if (got["seed_select"], got["extend_candidates"],
                got["finalize_select"], got["graph_launches"]) != want:
            raise AssertionError(f"graph: {name} step put {got}")
    wire = {mode: e._upload_wire(codes, lens) for mode, e in engines.items()}
    steps = {"graphed": graphed._steps[cfg]["packed"],
             "eager": eager._steps[cfg]["packed"]}
    enqueue = {f"{m}_{what}": [] for m in engines
               for what in ("call", "step")}
    ms = {f"{m}{suffix}": [] for m in engines for suffix in ("", "_counts")}
    loop = {m: [] for m in engines}
    for turn in range(10):
        order = list(engines) if turn % 2 == 0 else list(engines)[::-1]
        for m in order:
            e = engines[m]
            for what, call in (
                    ("call", lambda: e.align_device_packed(codes, lens)),
                    ("step", lambda: steps[m](*wire[m], with_counts=False))):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                call()
                enqueue[f"{m}_{what}"].append(
                    1e3 * (time.perf_counter() - t1))
                torch.cuda.synchronize()
            for suffix, w in (("", False), ("_counts", True)):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                _fetch_out(e.align_device_packed(codes, lens, with_counts=w))
                torch.cuda.synchronize()
                ms[f"{m}{suffix}"].append(1e3 * (time.perf_counter() - t1))
            if turn < 4:
                loop[m] += tb.device_loop(e, full.codes, full.lengths, BATCH,
                                          rounds=1)[0]
    keys["graphed_engine"] = _graph_stats(graphed)
    del graphed, eager, engines, steps, wire
    torch.cuda.empty_cache()

    # (c) FASTQ -> SAM through the CLI, graphed and eager in turns
    load = pcli._load_engine
    built = []

    def graphed_load(*a, **kw):
        built.append(load(*a, **kw))
        return built[-1]

    e2e = {cmd: {"graphed": [], "eager": []} for cmd in ("align", "twopass")}
    digests, cli_launches, keys["cli"] = {}, [], {}
    for cmd in ("align", "twopass"):
        for mode in ("graphed", "eager", "eager", "graphed"):
            out = WORK / f"graph_{cmd}_{mode}.sam"
            extra = ["--learned-gaps"] if cmd == "twopass" else []
            pcli._load_engine = (graphed_load if mode == "graphed" else
                                 lambda *a, **kw: _eager(load(*a, **kw)))
            _reset_counters()
            t1 = time.perf_counter()
            try:
                res = _cli_json([cmd, str(WORK / "idx"),
                                 str(WORK / "all.fastq"), str(out), *extra,
                                 "--pg-cl", "smoke", "--batch-size",
                                 str(BATCH), *FLAGS, "--device", "cuda"])
            finally:
                pcli._load_engine = load
            dt = time.perf_counter() - t1
            want = (1 if cmd == "align" else 2) * _n_batches(N_READS, BATCH)
            _expect_launches(_counters(), want, f"graph {cmd} {mode}")
            if mode == "graphed":
                cli_launches.append(_counters())
                keys["cli"].setdefault(cmd, [_graph_stats(e) for e in built])
            built.clear()
            e2e[cmd][mode].append({
                "reads_per_s_in_cli": res.get("reads_per_second"),
                "call_seconds": round(dt, 3),
                "reads_per_s_call": round(res["reads"] / dt, 1)})
            names = [out.name] + ([f"{out.name}.pass1.sam",
                                   f"{out.name}.errorprofile"]
                                  if cmd == "twopass" else [])
            digests.setdefault(cmd, {})[mode] = [sha256(WORK / n)
                                                 for n in names]
    for cmd, d in digests.items():
        if d["graphed"] != d["eager"]:
            raise AssertionError(f"graph: {cmd} outputs differ by route")
    if digests["align"]["graphed"][0] != AT_SCALE["all.sam"] or \
            digests["twopass"]["graphed"][1:] != [
                AT_SCALE["all.bam.pass1.sam"],
                AT_SCALE["all.bam.errorprofile"]]:
        raise AssertionError("graph: the CLI outputs differ from the JAX "
                             "package's")
    phase("graph", batch=BATCH, compared_calls=compared, keys=keys,
          per_step=per_step,
          enqueue_ms={k: {"median": float(np.median(v)), "runs": v}
                      for k, v in enqueue.items()},
          step_fetch_ms={k: {"median": float(np.median(v)), "runs": v}
                         for k, v in ms.items()},
          bench_loop_reads_per_s=loop, fastq_to_sam_in_turns=e2e,
          seconds=round(time.perf_counter() - t0, 3), gpu=gpu)
    return _add(*cli_launches)


def _eager_slots(step):
    """A multi-device step, bound, with each slot's CompiledStep (each
    cell's and each row merge's) replaced by its function: the eager route,
    op by op, over the same replicas and slabs."""
    if hasattr(step, "cells"):
        step.cells = [[getattr(c, "fn", c) for c in row]
                      for row in step.cells]
        step.merges = [getattr(m, "fn", m) for m in step.merges]
    else:
        step.slots = [getattr(s, "fn", s) for s in step.slots]
    return step


class _EagerDist:
    """Stands in for the data-parallel step run_distributed_host makes: it
    binds the step on each call and replaces its slots by their
    functions."""

    def __init__(self, step):
        self.step = step

    def __call__(self, didx, sprof, *reads):
        self.step.bind(didx, sprof)
        return _eager_slots(self.step)(didx, sprof, *reads)

    def compiled_steps(self) -> dict:
        return self.step.compiled_steps()


def _slot_stats(step) -> dict:
    """{slot name: keys, graphs, capture ms} of a multi-device step."""
    return {name: {"keys": len(s.entries), "graphs": s.graphs,
                   "capture_ms": s.capture_ms}
            for name, s in step.compiled_steps().items()}


def _multi_in_turns(label: str, routes: dict, batches: list,
                    on_card: tuple, per_call: int, n_graphs: int) -> tuple:
    """One multi-device step, graphed and eager (routes: {"graphed": call,
    "eager": call}, each call(*batch) -> the step's output):
      * every batch twice through each route, all results held until the
        end, then equal at tolerance 0 call by call;
      * what one call puts on the device (_ops_of): PyTorch operators, graph
        launches (n_graphs graphed, none eager), per_call launches of each
        kernel on both routes;
      * 10 turns: host enqueue ms (the batch already on the card, `on_card`)
        and ms per call from host arrays and from `on_card`.
    -> (report, the kernel launches of the graphed route's held calls)."""
    import torch
    from torch.utils._pytree import tree_leaves

    held, launches = {}, None
    for mode, call in routes.items():
        _reset_counters()
        held[mode] = [call(*b) for b in batches * 2]
        torch.cuda.synchronize()
        if mode == "graphed":
            launches = _counters()
            _expect_launches(launches, per_call * len(held[mode]),
                             f"dist_graph {label} graphed")
    for k, (got, want) in enumerate(zip(held["graphed"], held["eager"])):
        for g, w in zip(tree_leaves(got), tree_leaves(want), strict=True):
            if g.dtype != w.dtype or not torch.equal(g, w):
                raise AssertionError(f"dist_graph {label}: call {k} differs "
                                     f"from eager")
    compared = len(held["graphed"])
    del held
    per_step = {mode: _ops_of(lambda c=call: c(*on_card))
                for mode, call in routes.items()}
    for mode, graphs in (("graphed", n_graphs), ("eager", 0)):
        got = per_step[mode]
        if (got["seed_select"], got["extend_candidates"],
                got["finalize_select"], got["graph_launches"]) != \
                (per_call, per_call, per_call, graphs):
            raise AssertionError(f"dist_graph {label}: {mode} call put {got}")
    times = {f"{m}_{what}": [] for m in routes
             for what in ("enqueue", "call_on_card", "call_from_host")}
    for turn in range(10):
        order = list(routes) if turn % 2 == 0 else list(routes)[::-1]
        for m in order:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            routes[m](*on_card)
            t2 = time.perf_counter()
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            routes[m](*batches[0])
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            times[f"{m}_enqueue"].append(1e3 * (t2 - t1))
            times[f"{m}_call_on_card"].append(1e3 * (t3 - t1))
            times[f"{m}_call_from_host"].append(1e3 * (t4 - t3))
    return {"compared_calls": compared, "per_call": per_step,
            "ms": {k: {"median": float(np.median(v)), "runs": v}
                   for k, v in times.items()}}, launches


def _coordinator_in_turns(cfg) -> tuple:
    """`dist-align --coordinator` as one process (this one, NCCL on card 0):
    run_distributed_host on all bench reads at batch BATCH, graphed and
    eager in turns (g e e g g e e g; eager: the step's slots replaced by
    their functions); every shard the same bytes, the graphed one merged to
    the JAX CLI's digests (DIST_PINNED); reads/s over each run's own
    seconds (after its warm-up step and the all_reduce that sets up the
    group's communicator). -> (report, the graphed runs' launches)."""
    import socket

    import torch
    import torch.distributed as dist

    from parasuite_tpu_torch.index import KmerIndex, PackedReference
    from parasuite_tpu_torch.parallel import distributed as pd
    from parasuite_tpu_torch.pipeline.align import AlignerEngine

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dev = pd.initialize(f"127.0.0.1:{port}", 1, 0, "cuda")
    make = pd.make_dist_align_step
    made, runs, shards, graphed_launches = [], [], {}, []
    engine = None
    try:
        engine = AlignerEngine(PackedReference.load(WORK / "idx"),
                               KmerIndex.load(WORK / "idx"), cfg, device=dev)
        for turn, mode in enumerate(("graphed", "eager", "eager", "graphed")
                                    * 2):
            def recorded(*a, _eager=mode == "eager", **kw):
                step = make(*a, **kw)
                made.append(_EagerDist(step) if _eager else step)
                return made[-1]

            prefix = f"dist_graph_{turn}_{mode}"
            pd.make_dist_align_step = recorded
            _reset_counters()
            try:
                n, _counts, _prof, secs = pd.run_distributed_host(
                    engine, WORK / "all.fastq", WORK / prefix)
            finally:
                pd.make_dist_align_step = make
            launches = _counters()
            _expect_launches(launches, _n_batches(N_READS, BATCH) + 1,
                             f"dist_graph coordinator {mode}")
            if n != N_READS:
                raise AssertionError(f"dist_graph coordinator: {n} records")
            if mode == "graphed":
                graphed_launches.append(launches)
            shards[prefix] = sha256(WORK / f"{prefix}.shard0000.sam")
            runs.append({"mode": mode, "seconds": secs,
                         "reads_per_s": N_READS / secs,
                         "graphs": _slot_stats(made[-1])})
        if len(set(shards.values())) != 1:
            raise AssertionError(f"dist_graph coordinator: the shards "
                                 f"differ by route: {shards}")
    finally:
        dist.destroy_process_group()
        del engine
        torch.cuda.empty_cache()
    merged = _merge_and_pin("dist_graph coordinator",
                            "dist_graph_0_graphed", 1)
    return {"runs": runs, "backend": "nccl", "merged": merged,
            "shard_sha256": next(iter(shards.values()))}, \
        _add(*graphed_launches)


def dist_graph_phase(gpu: str) -> dict:
    """The multi-device steps compiled (parallel/dist_align.py,
    parallel/shards.py: a CompiledStep a mesh slot and a row merge) against
    the same steps with each slot run eagerly (its CompiledStep's own
    function), in turns: the data-parallel step at bench.make_cfg() with
    BATCH reads a device on the bench reads, over the machine's cards and
    over card 0 given twice; the sharded step on the shards world (k = 12,
    N_SHARD_READS reads, four rolls of it) on a 1 x 2 grid of card 0 given
    twice, its first output pinned to SHARDS_PINNED; then `dist-align
    --coordinator` as one process. Equal outputs at tolerance 0 with every
    result held; operators and graph launches a call; host enqueue and ms
    per call; keys, graphs and capture ms; the coordinator's reads/s.
    -> the kernel launches of the graphed runs (the main path)."""
    import torch

    from parasuite_tpu_torch.config import AlignConfig
    from parasuite_tpu_torch.errormodel.scoring import flat_score_tensor
    from parasuite_tpu_torch.index import KmerIndex, PackedReference
    from parasuite_tpu_torch.io.fastq import read_fastq
    from parasuite_tpu_torch.ops.device_index import (DeviceIndex,
                                                      ScoreParams,
                                                      min_scores_host)
    from parasuite_tpu_torch.parallel import make_dist_align_step, make_mesh
    from parasuite_tpu_torch.parallel.dist_align import graph_stats
    from parasuite_tpu_torch.parallel.mesh import make_mesh2
    from parasuite_tpu_torch.parallel.shards import (build_sharded_index,
                                                     make_sharded_step)

    t0 = time.perf_counter()
    card0 = torch.device("cuda", 0)
    cfg = AlignConfig(max_read_len=READ_LEN, kmer_size=12, batch_size=BATCH,
                      max_candidates=8, max_occ=16)   # bench.make_cfg()
    report, graphed = {}, []

    # the data-parallel step: BATCH reads a device
    ref, index = PackedReference.load(WORK / "idx"), KmerIndex.load(
        WORK / "idx")
    didx = DeviceIndex.from_host(ref, index, card0)
    sprof = ScoreParams.from_tensor(flat_score_tensor(cfg, READ_LEN), cfg,
                                    card0)
    del index
    full = read_fastq(WORK / "all.fastq", READ_LEN)
    meshes = {"machine_cards": make_mesh(),
              "card0_twice": make_mesh(devices=[card0] * 2)}
    for name, mesh in meshes.items():
        n = BATCH * mesh.size
        batches = [(full.codes[i:i + n], full.lengths[i:i + n],
                    min_scores_host(full.lengths[i:i + n], cfg))
                   for i in range(0, N_READS - n + 1, n)]
        on_card = tuple(torch.from_numpy(x).to(card0) for x in batches[0])
        steps = {"graphed": make_dist_align_step(cfg, mesh),
                 "eager": make_dist_align_step(cfg, mesh)}
        steps["eager"].bind(didx, sprof)
        _eager_slots(steps["eager"])
        rep, launches = _multi_in_turns(
            f"data {name}", {m: (lambda *b, s=s: s(didx, sprof, *b))
                             for m, s in steps.items()},
            batches, on_card, mesh.size, mesh.size)
        report[f"data_{name}"] = {
            "devices": [str(d) for d in mesh.devices], "reads_a_call": n,
            **rep, "graphs": _slot_stats(steps["graphed"]),
            "summed": graph_stats(steps["graphed"])}
        graphed.append(launches)
        del steps, on_card
    del didx, full
    torch.cuda.empty_cache()

    # the sharded step: the shards world at k = 12
    scfg = AlignConfig(max_read_len=READ_LEN, kmer_size=12,
                       batch_size=N_SHARD_READS, max_candidates=8,
                       max_occ=16)
    seqs, reads = shards_world()
    sharded, _full = build_sharded_index(seqs, 2, scfg)
    del seqs
    slabs = sharded.slabs(scfg)
    lengths = np.full(N_SHARD_READS, READ_LEN, dtype=np.int32)
    ms = min_scores_host(lengths, scfg)
    batches = [(np.roll(reads, 997 * k, axis=0), lengths, ms)
               for k in range(4)]
    on_card = tuple(torch.from_numpy(x).to(card0) for x in batches[0])
    mesh = make_mesh2(1, 2, devices=[card0] * 2)
    steps = {"graphed": make_sharded_step(scfg, mesh),
             "eager": make_sharded_step(scfg, mesh)}
    steps["eager"].bind(slabs, sharded.orig_chrom, sprof)
    _eager_slots(steps["eager"])
    routes = {m: (lambda *b, s=s: s(slabs, sharded.orig_chrom, sprof, *b))
              for m, s in steps.items()}
    first = routes["graphed"](*batches[0])
    digest = shards_digest({k: v.cpu().numpy() for k, v in first.items()},
                           N_SHARD_READS)
    if digest != SHARDS_PINNED["all_65536"]:
        raise AssertionError("dist_graph sharded: differs from the JAX "
                             "package's sharded step")
    rep, launches = _multi_in_turns("sharded", routes, batches, on_card, 2,
                                    3)
    report["sharded_card0_twice"] = {
        "devices": [str(d) for d in mesh.devices],
        "reads_a_call": N_SHARD_READS, "digest_pinned": True, **rep,
        "graphs": _slot_stats(steps["graphed"]),
        "summed": graph_stats(steps["graphed"])}
    graphed.append(launches)
    del steps, routes, first, on_card, sharded, slabs, sprof
    torch.cuda.empty_cache()

    # dist-align --coordinator, one process
    report["coordinator"], launches = _coordinator_in_turns(cfg)
    graphed.append(launches)
    phase("dist_graph", **report, launches=_add(*graphed),
          seconds=round(time.perf_counter() - t0, 3), gpu=gpu)
    return _add(*graphed)


def main() -> int:
    gpu = environment()
    build()
    truth = world()

    import torch

    from parasuite_tpu_torch.config import AlignConfig
    from parasuite_tpu_torch.index import KmerIndex, PackedReference
    from parasuite_tpu_torch.pipeline.align import AlignerEngine

    cfg = AlignConfig(max_read_len=READ_LEN, kmer_size=12, batch_size=BATCH,
                      max_candidates=8, max_occ=16)   # bench.make_cfg()
    engine = AlignerEngine(PackedReference.load(WORK / "idx"),
                           KmerIndex.load(WORK / "idx"), cfg, device="cuda")
    kernels = kernels_vs_plain(engine, gpu)
    runs = [pinned_twopass(), at_scale(truth, gpu)]
    device_rate(engine, gpu)
    xa_launches, xa_stats = xa_phase(gpu)
    rescue_launches, rescue_truth = rescue_phase(gpu)
    runs += [xa_launches, rescue_launches, combined_phase(gpu)]
    sim_phase(gpu)
    runs.append(benchmark_phase(gpu))
    tools_phase(gpu)
    runs += [dist_step_phase(engine, gpu), dist_file_phase(gpu),
             dist_coord_phase(gpu), shards_phase(gpu), scaling_phase(gpu),
             entry_phase(gpu)]
    # the measurement scripts beside the package, and the run of the shards
    # world at the k where sharded = replicated on all reads
    runs += [profile_e2e_phase(gpu), sweep_lengths_phase(gpu),
             rescue_sens_phase(rescue_truth, gpu)]
    del engine
    torch.cuda.empty_cache()
    runs.append(genome_phase(xa_stats, gpu))
    scale_phase(gpu)
    runs.append(shards_phase(gpu, k=15, label="shards_k15",
                             pins=SHARDS_K15_PINNED, all_equal=True))
    torch.cuda.empty_cache()
    # the scripts that drive the port as bench.py and the two distributed
    # tools drive the JAX package
    runs += [bench_leg_phase(gpu), dist_bench_phase(gpu),
             shards_scale_phase(gpu)]
    # the wire step against the unpacked one, on the worlds above; the
    # compiled steps against the eager functions
    runs.append(wire_phase(gpu))
    runs.append(graph_phase(gpu))
    runs.append(dist_graph_phase(gpu))
    for k in kernels:
        k["launches"] = sum(r[k["name"]] for r in runs)
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "parasuite_tpu"))
    if foreign:
        raise AssertionError(f"the run imported {foreign[:5]}: the port "
                             f"stands on its own")
    print(gpu, flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
