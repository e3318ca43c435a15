"""Where FASTQ -> SAM time goes in the port (counterpart of
tools/profile_e2e.py): accumulating timers around the stage functions of
pipeline.stream.streaming_align on a real streaming pass.

Per-stage numbers are per-THREAD busy time (the pipeline overlaps its three
threads, so the slowest thread bounds throughput, not the sum):

  reader.next_batch            FASTQ -> ReadBatch (iter_fastq_batches)
  main.dispatch                align_device_packed (the wire step: host
                               packing, upload, enqueue) or align_device:
                               CUDA launches are asynchronous, so beyond
                               the upload this is the enqueue only
  main.profile_counts          profile_counts_device (profile passes)
  main.to_host                 fetch + host finishing, split into
    .fetch_host                the one device -> host copy; it waits for the
                               device, so it absorbs the step's device time
    .orient_rows               genome-frame rows of the gapped winners
    .host_tracebacks_batch     the batched banded DP + traceback walks
    .tc_count_from_cigar       the per-row T->C count of gapped winners
    .rescue_dispatch / .rescue_finish   the smaller-k pass (rescue_kmer)
    .xa_strings (.host_traceback inside it)   XA:Z tags (--xa)
    .slow_path                 combined mode's numpy re-finalization
  writer.emit                  emit_sam / emit_bam, split into
    .native                    the C++ batch formatter
    .python                    the per-record Python formatter

Each timer has `seconds` (inclusive) and `self_seconds` (its own time
without the timers nested in it on the same thread), so the self times of
one thread sum to no more than the wall.

The device: every dispatched step (rescue steps too) sits between two CUDA
events; `device_step_ms` is their sum and `device_busy_share` that sum over
the wall — an upper bound of the busy share, since a launch gap inside a
step counts as busy. `bytes_up_per_batch` / `bytes_down_per_batch` are what
_upload and fetch_host moved (on the wire step at L = 50: 22 and 13 bytes a
read).

    python tools/torch_profile_e2e.py [n_reads] [--device cuda|cpu]
        [--xa] [--combined] [--index PREFIX --fastq FILE] [--batch-size N]

With no --index the world is the bench world (simulate_reads seed 3), or
with --combined the 400-transcript world of tools/torch_bench_combined.py.
One JSON line, with `gpu`.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

import _torch_bench as tb


class Acc:
    """Accumulating timers with per-thread nesting: `seconds` inclusive,
    `self_seconds` without the timers entered inside on the same thread."""

    def __init__(self):
        self.seconds: dict = {}
        self.self_seconds: dict = {}
        self.calls: dict = {}
        self._local = threading.local()

    def reset(self) -> None:
        for d in (self.seconds, self.self_seconds, self.calls):
            for k in d:
                d[k] = 0

    def declare(self, name: str) -> None:
        self.seconds.setdefault(name, 0.0)
        self.self_seconds.setdefault(name, 0.0)
        self.calls.setdefault(name, 0)

    def add(self, name: str, dt: float, child: float = 0.0) -> None:
        self.seconds[name] += dt
        self.self_seconds[name] += dt - child
        self.calls[name] += 1

    def wrap(self, name: str, fn):
        self.declare(name)

        def inner(*a, **kw):
            stack = self._local.__dict__.setdefault("stack", [])
            stack.append(0.0)
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                dt = time.perf_counter() - t0
                child = stack.pop()
                if stack:
                    stack[-1] += dt
                self.add(name, dt, child)

        return inner

    def report(self) -> dict:
        return {k: {"seconds": round(self.seconds[k], 6),
                    "self_seconds": round(self.self_seconds[k], 6),
                    "calls": self.calls[k]} for k in sorted(self.seconds)}


# module-level functions of pipeline/align.py that to_host (and, imported by
# name, pipeline/combined.py) calls -> timer name
_HOST_FUNCS = {"fetch_host": "main.to_host.fetch_host",
               "orient_rows": "main.to_host.orient_rows",
               "host_tracebacks_batch": "main.to_host.host_tracebacks_batch",
               "tc_count_from_cigar": "main.to_host.tc_count_from_cigar",
               "host_traceback": "main.to_host.xa_strings.host_traceback"}
# engine methods -> timer name (bound on the instance, so `self.x` finds the
# timed one)
_ENGINE_FUNCS = {"to_host": "main.to_host",
                 "profile_counts_device": "main.profile_counts",
                 "_xa_strings": "main.to_host.xa_strings",
                 "_slow_path": "main.to_host.slow_path",
                 "_finish_rescue": "main.to_host.rescue_finish",
                 "emit_sam": "writer.emit", "emit_bam": "writer.emit",
                 "_format_native_run": "writer.emit.native",
                 "_format_one": "writer.emit.python"}


class Probe:
    """Patches one engine and the stream / align / combined modules with
    timers, CUDA events and byte counters; restore() puts everything back."""

    def __init__(self, engine):
        import parasuite_tpu_torch.pipeline.align as palign
        import parasuite_tpu_torch.pipeline.combined as pcombined
        import parasuite_tpu_torch.pipeline.stream as pstream

        self.engine = engine
        self.acc = Acc()
        self.events: list = []
        self.bytes_up = self.bytes_down = 0
        self.n_uploads = self.n_fetches = 0
        self._undo: list = []
        cuda = engine.device.type == "cuda"
        acc = self.acc

        def patch(obj, attr, new):
            had = attr in vars(obj)
            old = getattr(obj, attr)
            setattr(obj, attr, new)
            self._undo.append((obj, attr, old, had))

        # reader thread: pipeline/stream.py binds iter_fastq_batches by name
        fq_iter = pstream.iter_fastq_batches
        acc.declare("reader.next_batch")

        def timed_iter(*a, **kw):
            it = fq_iter(*a, **kw)
            while True:
                t0 = time.perf_counter()
                try:
                    b = next(it)
                except StopIteration:
                    return
                acc.add("reader.next_batch", time.perf_counter() - t0)
                yield b

        patch(pstream, "iter_fastq_batches", timed_iter)

        # main thread: each dispatched step between two CUDA events
        def evented(fn):
            import torch

            def inner(*a, **kw):
                if not cuda:
                    return fn(*a, **kw)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*a, **kw)
                end.record()
                self.events.append((start, end))
                return out

            return inner

        step = ("align_device_packed" if engine.supports_packed
                else "align_device")
        patch(engine, step, acc.wrap("main.dispatch",
                                     evented(getattr(engine, step))))
        if getattr(engine, "_rescue", None) is not None:
            patch(engine, "_dispatch_rescue",
                  acc.wrap("main.to_host.rescue_dispatch",
                           evented(engine._dispatch_rescue)))
        for attr, name in _ENGINE_FUNCS.items():
            if hasattr(engine, attr):
                patch(engine, attr, acc.wrap(name, getattr(engine, attr)))

        upload = engine._upload

        def counted_upload(*arrays):
            out = upload(*arrays)
            self.bytes_up += sum(x.numel() * x.element_size() for x in out)
            self.n_uploads += 1
            return out

        patch(engine, "_upload", counted_upload)

        fetch = palign.fetch_host

        def counted_fetch(*parts):
            self.bytes_down += sum(x.numel() * x.element_size()
                                   for p in parts if p is not None
                                   for x in p)
            self.n_fetches += 1
            return fetch(*parts)

        timed = {attr: acc.wrap(name, counted_fetch if attr == "fetch_host"
                                else getattr(palign, attr))
                 for attr, name in _HOST_FUNCS.items()}
        for mod in (palign, pcombined):
            for attr, fn in timed.items():
                if hasattr(mod, attr):
                    patch(mod, attr, fn)

    def restore(self) -> None:
        for obj, attr, old, had in reversed(self._undo):
            if had:
                setattr(obj, attr, old)
            else:
                delattr(obj, attr)
        self._undo.clear()

    def reset(self) -> None:
        self.acc.reset()
        self.events.clear()
        self.bytes_up = self.bytes_down = 0
        self.n_uploads = self.n_fetches = 0

    def device_step_ms(self) -> float | None:
        """Sum of the CUDA-event times of every dispatched step (None on the
        CPU)."""
        if self.engine.device.type != "cuda":
            return None
        tb.sync(self.engine.device)
        return float(sum(s.elapsed_time(e) for s, e in self.events))


def profile_stream(engine, fastq, out_sam, rounds: int = 2, **stream_kw):
    """streaming_align(engine, fastq, out_sam) under the probe, `rounds`
    times (the first warms up; the fastest is reported) -> the record."""
    from parasuite_tpu_torch.pipeline.stream import streaming_align

    probe = Probe(engine)
    best = None
    try:
        for _ in range(rounds):
            probe.reset()
            for suffix in ("", ".progress.json"):
                Path(str(out_sam) + suffix).unlink(missing_ok=True)
            tb.sync(engine.device)
            t0 = time.perf_counter()
            n_rec, _c, _p = streaming_align(engine, fastq, out_sam,
                                            **stream_kw)
            tb.sync(engine.device)
            wall = time.perf_counter() - t0
            if best is None or wall < best["wall_seconds"]:
                step_ms = probe.device_step_ms()
                n_b = max(probe.acc.calls["main.dispatch"], 1)
                best = {
                    "reads": n_rec, "batches": n_b,
                    "wall_seconds": wall,
                    "reads_per_s": n_rec / wall,
                    "timers": probe.acc.report(),
                    "device_step_ms": step_ms,
                    "device_busy_share": (None if step_ms is None
                                          else step_ms / 1e3 / wall),
                    "bytes_up_per_batch": probe.bytes_up / n_b,
                    "bytes_down_per_batch": probe.bytes_down / n_b,
                    "uploads": probe.n_uploads, "fetches": probe.n_fetches,
                }
    finally:
        probe.restore()
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
