"""The system under test, parasuite_tpu_torch, driven as a user drives it:
the engine built from the genome (and annotation) as the configuration's
mode builds it (modes/<mode>.py: `cli index` + `align`, or `combine` + a
combined `align`), and the library streamed FASTQ -> SAM through
pipeline/stream.py::streaming_align by the mode's library call.

The rate counts the reads of every batch the writer thread committed in
the window: streaming_align logs an align.batch event after each commit
(records written, checkpoint saved), and CommitLog stamps it.

Every library call writes its SAM, through the same write(2) calls and
page-cache copies as to any file, into one file in memory (a memfd) whose
path, a link in the run's TMPDIR work directory, each call opens anew and
so truncates. The bytes never reach the machine's disk, so the run
measures the program and not the file system it happens to run on, and a
run writes little. SamTap keeps the bytes the engine hands its writer in
the current library call, which are what the judge reads.
"""

from __future__ import annotations

import time


class CommitLog:
    """The duck-typed run log streaming_align takes: (host time, reads) of
    every committed batch."""

    def __init__(self):
        self.commits: list = []

    def event(self, stage: str, **fields) -> None:
        if stage == "align.batch":
            self.commits.append((time.perf_counter(), fields["reads"]))


class SamTap:
    """Wraps the engine's emit_sam so that every record it writes in the
    current library call is also kept (`blocks`); `lines()` gives them."""

    def __init__(self, engine):
        self.blocks: list = []
        emit, blocks = engine.emit_sam, self.blocks

        class Tee:
            def __init__(self, writer):
                self.writer = writer

            def write(self, line):
                blocks.append(line.encode("ascii") + b"\n")
                self.writer.write(line)

            def write_block(self, data):
                blocks.append(data if isinstance(data, bytes)
                              else data.encode("ascii"))
                self.writer.write_block(data)

            def flush(self):
                self.writer.flush()

        engine.emit_sam = lambda batch, host, writer: emit(batch, host,
                                                           Tee(writer))

    def lines(self) -> list:
        return [ln for ln in b"".join(self.blocks).split(b"\n") if ln]


def sam_output(work):
    """-> (path, fd): a SAM path in `work` that links to a file in memory,
    which stays open (fd) until the caller closes it."""
    import os
    from pathlib import Path

    fd = os.memfd_create("bench_sam")
    out = Path(work) / "out.sam"
    os.symlink(f"/proc/{os.getpid()}/fd/{fd}", out)
    return out, fd


def build_engine(conf: dict, genome: dict, txs: list, device: str):
    """The engine of the configuration's mode (modes/<mode>.py build), for
    the tools and tests that build a cell's engine outside a run."""
    from harness import spec

    return spec.mode(conf["mode"]).build(conf, genome, txs, device)


def stream(engine, fastq, out_sam, tap: SamTap, log=None) -> int:
    """One library call: FASTQ -> SAM -> records; the tap keeps this call's
    records only."""
    from parasuite_tpu_torch.pipeline.stream import streaming_align

    tap.blocks.clear()
    kw = {"log": log} if log is not None else {}
    n, _counts, _profiled = streaming_align(engine, fastq, out_sam, **kw)
    return n


def make_context(device: str) -> None:
    """Make the CUDA context before the program's clock starts: a user
    pays for it, but no change to the program changes it (nothing to make
    on the CPU)."""
    import torch

    if str(device).startswith("cuda"):
        torch.zeros(1, device=device)
        torch.cuda.synchronize()


def sync(device: str) -> None:
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def recording_log():
    """The traced window's run log: a RunLog(record=True), which keeps the
    program's spans and counters (parasuite_tpu_torch/utils/runlog.py), that
    also stamps every committed batch as CommitLog does."""
    from parasuite_tpu_torch.utils.runlog import RunLog

    class CommitRunLog(RunLog):
        live = True            # streaming_align builds align.batch for it

        def __init__(self):
            super().__init__(record=True)
            self.commits: list = []

        event = CommitLog.event

    return CommitRunLog()


def window(engine, fastq, out_sam, tap: SamTap, seconds: float,
           device: str, call=stream, log=None):
    """Library calls (`call`, a mode's) back to back from t0 until t0 +
    seconds; the call in flight at the deadline runs to its end, and none of
    its batches committed after the deadline count. `log` is a CommitLog
    unless given (recording_log in a traced run).
    -> (reads committed in the window, [records of each call])."""
    log = CommitLog() if log is None else log
    sync(device)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    calls = []
    while True:
        calls.append(call(engine, fastq, out_sam, tap, log))
        if time.perf_counter() >= deadline:
            break
    return sum(r for t, r in log.commits if t <= deadline), calls
