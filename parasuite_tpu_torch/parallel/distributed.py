"""Real multi-process execution on torch.distributed: one process per
device, the error-profile count matrix summed in-step across processes.

Counterpart of parasuite_tpu/parallel/distributed.py. parallel/multihost.py
simulates hosts with independent processes and merges count matrices
file-side; here the processes form one group, and every step's int64
[L, 4, 4] count matrix goes through all_reduce(SUM), so every process holds
the global matrix (tests/test_torch_distributed.py runs two real processes
and pins the summed counts and the merged SAM to the one-process run and to
the JAX package's).

Where the reference builds one global array of B * n_processes rows over a
mesh of every process's devices, each process here runs the data-parallel
step on its own B rows and its own device. Per-read outputs depend only on
the read and on replicated state, so the shard bytes are the same.

Transport. all_reduce moves 6.4 kB a step; the align step itself stays on
the process's device whatever carries the sum. The backend is NCCL when every
process has a card of its own (device "cuda" and n_processes <= the
machine's CUDA device count; process i then takes cuda:i), and gloo
otherwise: on the CPU, or for processes that share one card, which NCCL
refuses. Under gloo the matrix is staged through host memory.

Lockstep contract: every process must execute the same number of global
steps, so run_distributed_host first counts records (one cheap newline
pass), derives the global batch count, and processes past their last local
batch feed all-padding batches (lengths 0 -> zero counts, zero records). The
all_reduce
of a step is issued by every process, in step order, before anything that
may return early. A peer that dies does not leave the others waiting for
good: the group has a finite timeout (GROUP_TIMEOUT_S).

The step is compiled (dist_align: one CUDA graph a key, replayed). Before
its clock every process runs it once on an all-padding batch and drops the
output, and sums one zero matrix over the group, so a process's seconds
leave out the capture and the communicator's set-up, as the reference's
leave out its compile. The all_reduce stays outside the graph.

Shard files and .done.json manifests use the same layout as
multihost.run_host_shard, so multihost.merge_host_outputs works unchanged.
"""

from __future__ import annotations

import datetime
import json
import math
import time
from pathlib import Path

import numpy as np
import torch

from parasuite_tpu_torch.io.batch import ReadBatch
from parasuite_tpu_torch.io.fastq import (count_fastq_records,
                                          iter_fastq_batches)
from parasuite_tpu_torch.parallel.dist_align import (graph_stats,
                                                     make_dist_align_step)
from parasuite_tpu_torch.parallel.mesh import make_mesh
from parasuite_tpu_torch.utils.runlog import NULL_LOG

# how long a collective waits for a peer before it raises
GROUP_TIMEOUT_S = 600


def initialize(coordinator: str, num_processes: int, process_id: int,
               device: str = "cuda") -> torch.device:
    """torch.distributed.init_process_group over tcp://coordinator (call
    before the engine is made) -> the device this process aligns on.

    NCCL when `device` is cuda and every process has a card of its own,
    gloo otherwise (module docstring); the group's backend is what
    torch.distributed.get_backend() then reports."""
    import torch.distributed as dist

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but "
                           "torch.cuda.is_available() is false")
    own_card = (dev.type == "cuda" and dev.index is None
                and num_processes <= torch.cuda.device_count())
    if own_card:
        dev = torch.device("cuda", process_id)
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend="nccl" if own_card else "gloo",
        init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    return dev


def _all_reduce_counts(counts: torch.Tensor) -> np.ndarray:
    """Sum of one step's int64 count matrix over every process -> numpy.
    NCCL reduces the device tensor; gloo a copy in host memory."""
    import torch.distributed as dist

    if dist.get_backend() != "nccl":
        counts = counts.cpu()
    dist.all_reduce(counts, op=dist.ReduceOp.SUM)
    return counts.cpu().numpy()


def run_distributed_host(engine, fastq, out_prefix, *,
                         with_profile_counts: bool = True,
                         log=NULL_LOG):
    """One process's share of a torch.distributed multi-process run.

    Requires initialize() to have been called, and the engine to live on
    the device it returned. Writes this process's headerless SAM shard +
    .done.json (multihost layout) and returns (n_records, summed counts or
    None, n_profiled, seconds). The counts matrix is identical on every
    process (it is the in-step sum over all of them), so any one process
    can save the profile.
    """
    import torch.distributed as dist

    from parasuite_tpu_torch.ops.device_index import min_score_table
    from parasuite_tpu_torch.parallel.multihost import shard_paths

    nproc = dist.get_world_size()
    pid = dist.get_rank()
    cfg = engine.cfg
    B, L = cfg.batch_size, cfg.max_read_len

    n_total = count_fastq_records(fastq)
    n_batches = max(1, math.ceil(n_total / B))
    n_steps = math.ceil(n_batches / nproc)

    # Combined genome+transcriptome engines re-finalize host-side from the
    # per-candidate table (which rides with the reads) and count profiles
    # from the EMITTED records — no in-step sum.
    combined = bool(getattr(engine, "counts_from_host", False))
    reduce_counts = with_profile_counts and not combined
    step = make_dist_align_step(
        cfg, make_mesh(devices=[engine.device]), with_counts=reduce_counts,
        with_candidates=combined)
    ms_table = min_score_table(cfg)

    shard = shard_paths(out_prefix, nproc)[pid]
    counts = (np.zeros((L, 4, 4), dtype=np.int64)
              if with_profile_counts else None)
    ins = np.zeros(L, dtype=np.int64)
    dels = np.zeros(L, dtype=np.int64)
    gsub = np.zeros((L, 4, 4), dtype=np.int64)  # local gapped M-segment subs
    n_gapped = 0
    n_records = 0
    n_profiled = 0
    batch_records: list[int] = []

    empty = ReadBatch(codes=np.full((B, L), 4, dtype=np.int8),
                      lengths=np.zeros(B, dtype=np.int32))
    # lockstep warm-up: every process runs the step once on an all-padding
    # batch, whose output is dropped (never summed), so the timed loop
    # below leaves out the kernels' build and the step's capture, as the
    # reference's leaves out its compile. The reference's warm-up step holds
    # its psum; here one all_reduce of a zero matrix sets up the group's
    # communicator (NCCL's at its first collective) before the clock too.
    step(engine.didx, engine.sprof, empty.codes, empty.lengths,
         ms_table[np.clip(empty.lengths, 0, L)])
    if reduce_counts:
        _all_reduce_counts(torch.zeros((L, 4, 4), dtype=torch.int64,
                                       device=engine.device))
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    t0 = time.perf_counter()
    it = iter_fastq_batches(fastq, B, L, stride_shards=nproc, shard_index=pid)
    with open(shard, "wb") as fh:
        class _W:
            def write(self, line):
                fh.write(line.encode("ascii") + b"\n")

            def write_block(self, data):
                fh.write(data if isinstance(data, bytes)
                         else data.encode("ascii"))

        writer = _W()

        def drain(pend):
            """Host half of one step: sum the counts over the processes,
            fetch, finalize, count, emit."""
            nonlocal n_records, n_profiled, n_gapped, counts
            batch, out, real, g = pend
            if reduce_counts:
                # every process, every step, before any return: a process
                # on a padding batch still owes the others its (zero) matrix
                out, c = out
                counts += _all_reduce_counts(c)
            if not real:
                return
            # combined: to_host projects/re-finalizes this process's rows of
            # (AlignResult, CandidateTable) exactly like single-process mode
            host = engine.to_host(batch, out)
            if with_profile_counts:
                # the host's share: combined counts every emitted record
                # into the LOCAL `counts`; plain adds what the in-step sum
                # never saw (gapped rows, rescued rows) to gsub, which rides
                # the per-shard indels file (merge_host_outputs sums it),
                # NOT `counts` (global, saved by process 0 alone)
                np_inc, ng_inc = engine.accumulate_profile_host(
                    batch, host, gsub if reduce_counts else counts, ins,
                    dels)
                n_profiled += np_inc
                n_gapped += ng_inc
            engine.emit_sam(batch, host, writer)
            n_records += batch.n_real
            batch_records.append(batch.n_real)
            log.event("dist.batch", step=g, reads=batch.n_real,
                      records=n_records)

        # double-buffered loop: dispatch step g+1 before draining step g so
        # the host half (to_host/emit_sam/counts) overlaps the device step —
        # the order of steps and of their sums stays identical on every
        # process (lockstep contract), only the host work shifts one step
        # later
        pend = None
        for g in range(n_steps):
            batch = next(it, None)
            real = batch is not None
            if not real:
                batch = empty
            out = step(engine.didx, engine.sprof, batch.codes, batch.lengths,
                       ms_table[np.clip(batch.lengths, 0, L)])
            if pend is not None:
                drain(pend)
            pend = (batch, out, real, g)
        if pend is not None:
            drain(pend)

    if with_profile_counts:
        if combined:
            # combined counts are LOCAL (accumulated from this shard's
            # emitted records, gapped subs already folded in): every shard
            # saves its own matrix and merge_host_outputs sums them —
            # exactly the file-side multihost layout
            np.save(shard + ".counts.npy", counts)
            np.savez(shard + ".indels.npz", ins=ins, dels=dels,
                     n_gapped=np.int64(n_gapped))
        else:
            # the in-step sum already folded every process's contribution,
            # so the matrix is GLOBAL and identical on all processes: only
            # process 0 saves it (multihost.merge_host_outputs sums whatever
            # shard count files exist — a per-shard copy would overcount
            # x nproc). Indel counts come from LOCAL host tracebacks, so
            # every shard saves its own and the merge sums them.
            if pid == 0:
                np.save(shard + ".counts.npy", counts)
            # returned counts = the global summed ungapped matrix; each
            # shard's local gapped contributions live in its indels file
            # until the merge
            np.savez(shard + ".indels.npz", ins=ins, dels=dels,
                     n_gapped=np.int64(n_gapped), gsub=gsub)
    elapsed = time.perf_counter() - t0
    Path(shard + ".done.json").write_text(json.dumps(
        {"records": n_records, "profiled": n_profiled,
         "batch_records": batch_records}))
    log.event("dist.done", records=n_records, steps=n_steps,
              seconds=round(elapsed, 3), **graph_stats(step))
    return n_records, counts, n_profiled, elapsed
