"""Where FASTQ -> SAM time goes in the port (counterpart of
tools/profile_e2e.py): the program's own spans and counters
(parasuite_tpu_torch/utils/runlog.py) of a real streaming pass, recorded
through a RunLog(record=True).

Per-span numbers are per-THREAD busy time (the pipeline overlaps its three
threads, so the slowest thread bounds throughput, not the sum):

  reader.parse / reader.wait    FASTQ -> ReadBatch; the put into the full
                                input queue
  main.wait_reads               the main thread waiting for a batch
  step.dispatch                 the engine's step: host packing, upload,
    .pack / .upload / .replay   enqueue (CUDA launches are asynchronous)
  step.capture                  a new key's warm-up and graph capture
  engine.to_host                fetch + host finishing, split into
    engine.fetch                the device -> host copies; they wait for
                                the device, so they absorb its time
    engine.tracebacks           the batched gapped DP (.dp) and the
                                per-read walks (.walk)
    engine.rows                 the per-row T->C count of gapped winners
    engine.rescue / engine.xa   the smaller-k pass; XA:Z tags (--xa)
    engine.junction_cigars      combined mode's junction winners' CIGARs
    engine.slow_path            combined mode's numpy re-finalization
  main.wait_writer              the put into the writer's full queue
  writer.wait / writer.emit / writer.commit   the writer waiting, SAM
                                formatting and writes, flush + checkpoint

Each span has `seconds` (inclusive) and `self_seconds` (without the spans
directly inside it), so the self times of one thread sum to no more than
the wall. `counters` are the runs' totals (reads, step.bytes_up,
engine.bytes_down, engine.gapped_rows, ...); `bytes_up_per_batch` /
`bytes_down_per_batch` are what the uploads and fetches moved (on the wire
step at L = 50: 22 and 13 bytes a read).

On a card every round runs under torch.profiler. `device_busy_ms` is the
union of the card's kernel, copy and set intervals over the round and
`device_busy_share` that over the wall; `idle_main_work_share` is the
share of the card's idle time in which the main thread was inside a span
other than its waits (main.wait_reads, main.wait_writer, main.wait_drain).
The main thread's spans are record_function ranges in the profiler's own
trace, on the card's clock (`main_ranges`, against `main_spans`). The
median of their starts less their perf_counter_ns stamps is the offset
that maps the other threads' spans onto that clock (`idle_work_share` of
each thread), and `clock_offset_mad_us` its error.

    python tools/torch_profile_e2e.py [n_reads] [--device cuda|cpu]
        [--xa] [--combined] [--index PREFIX --fastq FILE] [--batch-size N]

With no --index the world is the bench world (simulate_reads seed 3), or
with --combined the 400-transcript world of tools/torch_bench_combined.py.
One JSON line, with `gpu`.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

import _torch_bench as tb

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WAITS = ("main.wait_reads", "main.wait_writer", "main.wait_drain")


def union(intervals) -> list:
    """Sorted, merged [a, b] intervals."""
    out: list = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap(xs: list, ys: list) -> float:
    """Total length of the intersection of two merged interval lists."""
    i = j = 0
    tot = 0.0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        tot += max(0.0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return tot


def device_split(events: list, spans: list, t0_ns: int, t1_ns: int) -> dict:
    """torch.profiler's trace events of one streaming call and the call's
    spans -> the card's busy time over the call ([t0_ns, t1_ns] on
    perf_counter_ns), and the share of its idle time in which each thread
    worked (was inside a span other than a wait).

    The main thread's spans appear in the trace as record_function ranges
    of the same names (the thread that started the profiler is the one it
    records); `idle_main_work_share` reads those ranges, on the trace's own
    clock. The median of (range start - span start) over them is the offset
    from perf_counter_ns to that clock, and `idle_work_share` maps every
    thread's spans through it (main's from its spans agrees with the
    ranges' to within the offset's error: `clock_offset_mad_us`, the
    median distance of a range's offset from the median)."""
    main = [s for s in spans if s.thread == "main"]
    names = {s.name for s in main}
    ranges = [e for e in events if e.get("ph") == "X"
              and e.get("cat") == "user_annotation"]
    tids = [e["tid"] for e in ranges if e["name"] == "step.dispatch"]
    main_tid = max(set(tids), key=tids.count) if tids else None
    by_name: dict = {}
    for e in ranges:
        if e["tid"] == main_tid:
            by_name.setdefault(e["name"], []).append(e["ts"])
    offs = []          # names whose spans and ranges pair one to one
    for name in names:
        mine = sorted(s.t0 for s in main if s.name == name)
        rs = sorted(by_name.get(name, []))
        if len(rs) == len(mine):
            offs += [r - t / 1e3 for r, t in zip(rs, mine)]
    out = {"main_spans": len(main),
           "main_ranges": sum(min(len(by_name.get(n, [])),
                                  sum(s.name == n for s in main))
                              for n in names),
           "other_thread_ranges": sum(e["tid"] != main_tid for e in ranges
                                      if e["name"] in {s.name for s in spans}),
           "clock_offset_mad_us": None, "device_busy_ms": None,
           "idle_main_work_share": None, "idle_work_share": None}
    if not offs:
        return out
    off = statistics.median(offs)
    out["clock_offset_mad_us"] = statistics.median(abs(o - off)
                                                   for o in offs)
    lo, hi = t0_ns / 1e3 + off, t1_ns / 1e3 + off
    busy = union((max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
                 for e in events if e.get("ph") == "X"
                 and e.get("cat") in DEVICE_CATS)
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    idle = [[edges[i], edges[i + 1]] for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    idle_us = sum(b - a for a, b in idle)
    out["device_busy_ms"] = sum(b - a for a, b in busy) / 1e3
    if not idle_us:
        return out
    work = union((e["ts"], e["ts"] + e["dur"]) for e in ranges
                 if e["tid"] == main_tid and e["name"] in names
                 and e["name"] not in WAITS)
    out["idle_main_work_share"] = overlap(idle, work) / idle_us
    out["idle_work_share"] = {
        th: overlap(idle, union((s.t0 / 1e3 + off, s.t1 / 1e3 + off)
                                for s in spans if s.thread == th
                                and not s.name.endswith("wait")
                                and s.name not in WAITS)) / idle_us
        for th in ("reader", "main", "writer")}
    return out


def profiled(device):
    """A torch.profiler session over the CPU and the card, or None on the
    CPU."""
    if str(device).split(":")[0] != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def trace_events(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            return json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)


def profile_stream(engine, fastq, out_sam, rounds: int = 2, **stream_kw):
    """streaming_align(engine, fastq, out_sam) with its spans recorded,
    `rounds` times (the first warms up; the fastest is reported) -> the
    record."""
    from parasuite_tpu_torch.pipeline.stream import streaming_align
    from parasuite_tpu_torch.utils.runlog import RunLog

    best = None
    for _ in range(rounds):
        for suffix in ("", ".progress.json"):
            Path(str(out_sam) + suffix).unlink(missing_ok=True)
        log = RunLog(record=True)
        prof = profiled(engine.device)
        tb.sync(engine.device)
        if prof is not None:
            prof.start()
        t0 = time.perf_counter_ns()
        n_rec, _c, _p = streaming_align(engine, fastq, out_sam, log=log,
                                        **stream_kw)
        tb.sync(engine.device)
        t1 = time.perf_counter_ns()
        if prof is not None:
            prof.stop()
        wall = (t1 - t0) / 1e9
        if best is None or wall < best["wall_seconds"]:
            summ = log.summary()
            spans, counters = summ["spans"], summ["counters"]
            n_b = max(spans.get("step.dispatch", {}).get("calls", 0), 1)
            dev = (device_split(trace_events(prof), log.spans, t0, t1)
                   if prof is not None else {})
            busy = dev.get("device_busy_ms")
            best = {
                "reads": n_rec, "batches": n_b,
                "wall_seconds": wall,
                "reads_per_s": n_rec / wall,
                "timers": {k: {"seconds": round(t["seconds"], 6),
                               "self_seconds": round(t["self_seconds"], 6),
                               "calls": t["calls"]}
                           for k, t in sorted(spans.items())},
                "counters": counters,
                "device_busy_ms": busy,
                "device_busy_share": (None if busy is None
                                      else busy / 1e3 / wall),
                **{k: v for k, v in dev.items() if k != "device_busy_ms"},
                "bytes_up_per_batch": counters.get("step.bytes_up", 0) / n_b,
                "bytes_down_per_batch": (counters.get("engine.bytes_down", 0)
                                         / n_b),
                "uploads": spans.get("step.upload", {}).get("calls", 0),
                "fetches": spans.get("engine.fetch", {}).get("calls", 0),
            }
    return best


def load_engine(prefix, device, xa: bool, batch_size: int):
    """The engine of an index prefix written by `index` or `combine`, as
    the CLI builds it (the index's own config, this batch size)."""
    from parasuite_tpu_torch.config import AlignConfig
    from parasuite_tpu_torch.index import KmerIndex, PackedReference
    from parasuite_tpu_torch.pipeline.align import AlignerEngine

    cfg = AlignConfig.from_json(
        Path(str(prefix) + ".config.json").read_text()).replace(
            batch_size=batch_size)
    idx = KmerIndex.load(prefix)
    if Path(str(prefix) + ".combined.json").exists():
        from parasuite_tpu_torch.pipeline.combined import (CombinedEngine,
                                                           CombinedReference)

        return CombinedEngine(CombinedReference.load(prefix), idx, cfg,
                              xa_tags=xa, device=device)
    return AlignerEngine(PackedReference.load(prefix), idx, cfg, xa_tags=xa,
                         device=device)


def main(argv=None) -> int:
    from parasuite_tpu_torch.io.fastq import write_fastq

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_reads", nargs="?", type=int, default=16 * 32768)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--xa", action="store_true")
    ap.add_argument("--combined", action="store_true")
    ap.add_argument("--index")
    ap.add_argument("--fastq")
    ap.add_argument("--batch-size", type=int, default=tb.BATCH)
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory(prefix="ps_e2e_prof_") as td:
        td = Path(td)
        fastq = td / "reads.fastq"
        if args.index:
            engine = load_engine(args.index, args.device, args.xa,
                                 args.batch_size)
            fastq = Path(args.fastq)
            mode = "index"
        elif args.combined:
            import torch_bench_combined as bc
            from parasuite_tpu_torch.index import KmerIndex
            from parasuite_tpu_torch.pipeline.combined import CombinedEngine

            cfg = tb.make_cfg(args.batch_size)
            _g, txs, combined = bc.build_world(cfg)
            codes, lengths = bc.make_reads(combined, txs, args.n_reads)
            engine = CombinedEngine(
                combined, KmerIndex.build(combined.ref.seq, cfg.kmer_size),
                cfg, xa_tags=args.xa, device=args.device)
            write_fastq(fastq, [f"b{i}" for i in range(codes.shape[0])],
                        codes, lengths)
            mode = "combined_world"
        else:
            from parasuite_tpu_torch.pipeline.align import AlignerEngine
            from parasuite_tpu_torch.sim.generate import simulate_reads

            cfg = tb.make_cfg(args.batch_size)
            ref, index, engine = tb.build_state(cfg, tb.REF_LEN,
                                                device=args.device)
            if args.xa:
                engine = AlignerEngine(ref, index, cfg, xa_tags=True,
                                       device=args.device)
            codes, lengths, _ = simulate_reads(ref, args.n_reads,
                                               tb.READ_LEN, cfg, seed=3,
                                               tc_rate=0.12)
            write_fastq(fastq, [f"r{i}" for i in range(args.n_reads)],
                        np.asarray(codes), np.asarray(lengths))
            mode = "bench_world"
        rec = profile_stream(engine, fastq, td / "out.sam")
    print(json.dumps({"world": mode, "xa": args.xa,
                      "combined": engine.supports_packed
                      or type(engine).__name__ == "CombinedEngine",
                      "batch_size": engine.cfg.batch_size, **rec,
                      "gpu": tb.gpu_line(args.device)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
