"""The program's spans and counters in one cell of the benchmark
(BENCHMARK.json `workloads`): the cell's world built from --seed as
benchmark/run.py builds it, and its library calls made by the mode file its
configuration names (benchmark/modes/<mode>.py), then

1. a window of --seconds, library calls back to back, with the spans
   recorded and the benchmark's stage timers (benchmark/harness/probe.py)
   on at the same time: every span's ms a batch dispatched (inclusive and
   self), the counters a batch and a thousand reads, the per-layer numbers
   a spans-reading benchmark would report (`metrics`), and each span
   against the timer of the same stage (`agreement`);
2. one library call under torch.profiler: the card's busy share of the
   call, and the share of its idle time in which the main thread was
   inside a span other than a wait, from the main thread's spans as
   record_function ranges in the trace (tools/torch_profile_e2e.py
   device_split);
3. with --cost-pairs K, K pairs of untraced windows in turns, recording
   off (the benchmark's own window) and on: reads_per_s of each, the cost
   of recording.

    python tools/torch_trace_cell.py --workload chr22_align.gapless50 \\
        --seed 1234 [--seconds 10] [--cost-pairs 4] [--device cuda] \\
        [--bench DIR]

--bench names another benchmark folder (with its BENCHMARK.json beside
it), such as a copy with tiny configurations for a CPU run.

One JSON line, with the card's name and power limit. A number from
--device cpu is not a device number.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "tools"), str(ROOT / "benchmark"), str(ROOT)]

from parasuite_tpu_torch.utils.runlog import RunLog  # noqa: E402

# per-layer numbers read from the spans: name -> (span, "seconds" or a
# counter over reads)
SPAN_MS = {"stream.wait_reads_ms": "main.wait_reads",
           "stream.wait_writer_ms": "main.wait_writer",
           "step.pack_ms": "step.pack", "step.upload_ms": "step.upload",
           "engine.fetch_ms": "engine.fetch",
           "engine.tb_native_ms": "engine.tracebacks.native",
           "engine.tb_dp_ms": "engine.tracebacks.dp",
           "engine.tb_walk_ms": "engine.tracebacks.walk"}
PER_KREAD = {"engine.gapped_per_kread": "engine.gapped_rows",
             "engine.slow_rows_per_kread": "engine.slow_path_rows"}
# span -> the benchmark probe's timer of the same stage
PROBE = {"reader.parse": "reader.next_batch",
         "step.dispatch": "main.dispatch",
         "engine.to_host": "main.to_host",
         "engine.tracebacks": "main.to_host.host_tracebacks_batch",
         "engine.slow_path": "main.to_host.slow_path",
         "writer.emit": "writer.emit"}


class CommitRunLog(RunLog):
    """A recording run log that also stamps every committed batch, as the
    benchmark's CommitLog does."""

    live = True

    def __init__(self):
        super().__init__(record=True)
        self.commits: list = []

    def event(self, stage: str, **fields) -> None:
        if stage == "align.batch":
            self.commits.append((time.perf_counter(), fields["reads"]))


def window(engine, fastq, out_sam, tap, seconds: float, device: str, log,
           call):
    """benchmark/harness/system.py window with the given log and library
    call -> (reads committed in the window, calls)."""
    from harness import system

    system.sync(device)
    deadline = time.perf_counter() + seconds
    calls = []
    while True:
        calls.append(call(engine, fastq, out_sam, tap, log))
        if time.perf_counter() >= deadline:
            break
    return sum(r for t, r in log.commits if t <= deadline), calls


def span_report(log: RunLog) -> dict:
    summ = log.summary()
    spans, counters = summ["spans"], summ["counters"]
    n_b = spans.get("step.dispatch", {}).get("calls", 0)
    reads = counters.get("reads", 0)
    ms = {k: {"ms": 1e3 * t["seconds"] / n_b,
              "self_ms": 1e3 * t["self_seconds"] / n_b, "calls": t["calls"]}
          for k, t in sorted(spans.items())} if n_b else {}
    metrics = {m: ms.get(s, {"ms": 0.0})["ms"] for m, s in SPAN_MS.items()
               if n_b}
    metrics.update({m: 1e3 * counters.get(c, 0) / reads
                    for m, c in PER_KREAD.items() if reads})
    return {"batches": n_b, "spans_ms_per_batch": ms,
            "counters": counters,
            "counters_per_batch": {k: v / n_b for k, v in counters.items()}
            if n_b else {}, "metrics": metrics}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--cost-pairs", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--bench", default=str(ROOT / "benchmark"))
    args = ap.parse_args(argv)

    import _torch_bench as tb
    import torch_profile_e2e as prof_tool
    from harness import probe as hprobe, system, world
    from harness.spec import Bench

    dev = args.device
    bench = Bench(Path(args.bench))
    cell = bench.cell(args.workload)
    conf = bench.config(cell["config"])
    mode = bench.mode(conf["mode"])
    mix = bench.traffic(cell["traffic"])
    n_lib = int(conf["library_reads"])
    genome = world.make_genome(conf["genome"], args.seed)
    txs = (world.make_annotation(conf["annotation"], genome, args.seed)
           if mode.ANNOTATION else [])
    lib = world.make_library(mix, n_lib, genome, txs, args.seed)
    work = Path(tempfile.mkdtemp(prefix="trace_cell_"))
    sam_fd = None
    out: dict = {"workload": args.workload, "seed": args.seed,
                 "seconds": args.seconds}
    try:
        fastq = work / "reads.fastq"
        out_sam, sam_fd = system.sam_output(work)
        world.write_fastq(fastq, lib)
        engine = mode.build(conf, genome, txs, dev)
        tap = system.SamTap(engine)
        mode.call(engine, fastq, out_sam, tap)              # warm-up

        # 1. recorded window, the probe's timers on as well
        log = CommitRunLog()
        probe = hprobe.Probe(engine)
        try:
            committed, calls = window(engine, fastq, out_sam, tap,
                                      args.seconds, dev, log, mode.call)
        finally:
            probe.restore()
        rep = span_report(log)
        timers = probe.acc.report()
        n_b = timers["main.dispatch"]["calls"]
        spans = log.summary()["spans"]
        rep["agreement"] = {
            s: {"span_ms": 1e3 * spans[s]["seconds"] / n_b,
                "probe_ms": 1e3 * timers[t]["seconds"] / n_b}
            for s, t in PROBE.items() if s in spans and t in timers}
        out["recorded"] = {"reads_per_s": committed / args.seconds,
                           "calls": len(calls), **rep}

        # 2. one library call under the profiler
        one = RunLog(record=True)
        prof = prof_tool.profiled(dev)
        if prof is not None:
            system.sync(dev)
            prof.start()
            t0 = time.perf_counter_ns()
            mode.call(engine, fastq, out_sam, tap, one)
            system.sync(dev)
            t1 = time.perf_counter_ns()
            prof.stop()
            split = prof_tool.device_split(prof_tool.trace_events(prof),
                                           one.spans, t0, t1)
            busy = split["device_busy_ms"]
            split["device_idle_share"] = (
                None if busy is None else 1 - busy / ((t1 - t0) / 1e6))
            split["call_seconds"] = (t1 - t0) / 1e9
            out["profiled"] = split

        # 3. recording off / on in turns, untraced
        if args.cost_pairs:
            off, on = [], []
            for _ in range(args.cost_pairs):
                c, _calls = system.window(engine, fastq, out_sam, tap,
                                          args.seconds, dev, mode.call)
                off.append(c / args.seconds)
                c, _calls = window(engine, fastq, out_sam, tap, args.seconds,
                                   dev, CommitRunLog(), mode.call)
                on.append(c / args.seconds)
            mid = statistics.median(off)
            out["cost"] = {"off_reads_per_s": off, "on_reads_per_s": on,
                           "median_on_over_off": (statistics.median(on) / mid
                                                  if mid else None)}
    finally:
        if sam_fd is not None:
            import os

            os.close(sam_fd)
        shutil.rmtree(work, ignore_errors=True)
    out["gpu"] = tb.gpu_line(dev)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
