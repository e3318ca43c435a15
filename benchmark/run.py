"""One run of one cell of the benchmark of parasuite_tpu_torch on NVIDIA GPUs.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout. The cell (BENCHMARK.json `workloads`)
names a configuration (benchmark/configs/<config>.json: the genome, the
annotation, the aligner's settings, the library size, and the pipeline it
runs, its `mode`: benchmark/modes/<mode>.py, harness/spec.py) and a
traffic mix (benchmark/traffic/<traffic>.json: the read model). The run:

1. set-up: makes the genome, annotation (where the mode takes one) and read
   library from --seed, writes the library as FASTQ under TMPDIR, makes
   the CUDA context, builds the mode's engine on the card, and makes one
   library call of the mode over the whole library (kernel build on a
   first run, graph capture, warm caches); setup_s runs from the process's
   start to the end of that call, index_to_sam_s (for a cell whose
   end_to_end lists it) from the build's start: the program's work alone,
   without the inputs' making and the context. Standard error splits it
   into the build and the call;
2. window: the mode's library calls FASTQ -> SAM, back to back, for
   --seconds, each call writing its SAM into a file in memory that the
   next call truncates (harness/system.py); reads_per_s (for a cell
   whose end_to_end lists it; stream.reads_per_s in a traced run) is the
   reads of every batch committed in the window over --seconds, and
   device_mem_peak_mib the card's peak allocated memory by then; with
   --trace 1 the stage timers run and the program records its spans and
   counters instead, and one more library call is traced on the device;
3. judge: frees the engine, draws a sample of the last call's SAM records
   from the seed and holds each to the mode's plain reference (harness/
   reference.py), byte for byte;
4. prints one JSON line: correct, attempted, failed, metrics, device
   (with --trace 1 also breakdown), and last the numbers compared with
   their limits, which also end standard error.

It fails, printing no result, without a CUDA device, without the program,
or if jax, jaxlib, flax or parasuite_tpu was loaded.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "parasuite_tpu")


def since_process_start() -> float:
    """Seconds since this process started (Linux: its start time in clock
    ticks since boot against the boot-time clock)."""
    with open("/proc/self/stat") as fh:
        start = int(fh.read().rsplit(")", 1)[1].split()[19])
    return (time.clock_gettime(time.CLOCK_BOOTTIME)
            - start / os.sysconf("SC_CLK_TCK"))


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def per_layer(bench, cell: str, run) -> dict:
    out = {}
    for m in bench.metrics("per_layer", cell["name"]):
        v = bench.reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def spans_and_counters(log) -> dict:
    """The program's spans and counters that the window's library calls
    recorded (parasuite_tpu_torch/utils/runlog.py), for the readers:
    `spans` {name: {seconds (inclusive), self_seconds, calls}} and
    `counters` {name: total}, and each span and each batch's counter as
    recorded (`span_records`: Span tuples, perf_counter_ns; `counter_records`:
    {(call, batch, name): n})."""
    summary = log.summary()
    return {"spans": summary["spans"], "counters": summary["counters"],
            "span_records": log.spans, "counter_records": log.counters}


def run_cell(bench, cell_name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda") -> dict:
    """Set-up, window and judge of one cell -> the result's fields."""
    import torch

    from harness import bounds, judge, system, world

    cell = bench.cell(cell_name)
    conf = bench.config(cell["config"])
    mode = bench.mode(conf["mode"])
    mix = bench.traffic(cell["traffic"])
    n_lib = int(conf["library_reads"])
    B = int(conf["align"]["batch_size"])
    if n_lib % B:
        raise ValueError("library_reads must be a whole number of batches")

    # --- 1. set-up ---
    genome = world.make_genome(conf["genome"], seed)
    txs = (world.make_annotation(conf["annotation"], genome, seed)
           if mode.ANNOTATION else [])
    lib = world.make_library(mix, n_lib, genome, txs, seed)
    work = Path(tempfile.mkdtemp(prefix="bench_run_"))
    sam_fd = None
    try:
        fastq = work / "reads.fastq"
        out_sam, sam_fd = system.sam_output(work)
        written = world.write_fastq(fastq, lib)
        t_ctx = time.perf_counter()
        system.make_context(device)
        # index_to_sam_s: the inputs on disk and the context made, from the
        # mode's build (index, engine, upload, kernel library) to the end of
        # the first whole library call
        t_build = time.perf_counter()
        engine = mode.build(conf, genome, txs, device)
        t_call = time.perf_counter()
        tap = system.SamTap(engine)
        calls = [mode.call(engine, fastq, out_sam, tap)]
        system.sync(device)
        t_done = time.perf_counter()
        setup_s = since_process_start()
        index_to_sam_s = t_done - t_build

        # --- 2. window ---
        probe = dev = log = None
        if trace:
            from harness.probe import Probe
            from harness.trace import DeviceTrace

            dev = DeviceTrace(*mode.traced(n_lib // B))
            probe = Probe(engine, hook=dev.at)
            probe.acc.reset()
            probe.n_dispatch = -10**9     # the hook fires in the last call
            log = system.recording_log()
        cpu0, t0 = os.times(), time.perf_counter()
        committed, win_calls = system.window(engine, fastq, out_sam, tap,
                                             seconds, device, mode.call, log)
        cpu1, t1 = os.times(), time.perf_counter()
        calls += win_calls
        timers = batches = None
        dev_out = None
        if trace:
            timers = probe.acc.report()
            batches = timers["main.dispatch"]["calls"]
            probe.acc.intervals = []
            probe.n_dispatch = 0
            if device.startswith("cuda"):
                calls.append(mode.call(engine, fastq, out_sam, tap))
                dev_out = dev.reduce(probe.acc.intervals)
            probe.restore()
        system.sync(device)
        counters = {k: getattr(engine, k) for k in (
            "packed_batches", "packed_entries", "packed_junctions",
            "packed_overflow") if hasattr(engine, k)}
        mem_peak = (torch.cuda.max_memory_allocated()
                    if device.startswith("cuda") else 0)
        p = dict(conf["align"])
        recs = tap.lines()
        del engine, probe
        gc.collect()
        if device.startswith("cuda"):
            torch.cuda.empty_cache()

        # --- 3. judge ---
        short = sum(1 for n in calls if n != n_lib) + (len(recs) != n_lib)
        idx = judge.sample(n_lib, int(conf["sample_reads"]), seed)
        t_ref = time.perf_counter()
        ref = mode.reference(genome, p, txs, tap)
        del tap
        want = ref.sam_lines(lib.codes[idx], lib.lengths[idx],
                             [world.read_name(i) for i in idx], lib.qual)
        differ, examples = judge.judge(recs, want, idx)
        t_ref = time.perf_counter() - t_ref
        sam_bytes = os.fstat(sam_fd).st_size
    finally:
        if sam_fd is not None:
            os.close(sam_fd)
        shutil.rmtree(work, ignore_errors=True)
    chk = judge.checks(differ, short)
    print(f"set-up: setup_s {setup_s:.3f} s; index_to_sam_s "
          f"{index_to_sam_s:.3f} s = build {t_call - t_build:.3f} s + first "
          f"call {t_done - t_call:.3f} s; before the build "
          f"{setup_s - index_to_sam_s:.3f} s, the context "
          f"{t_build - t_ctx:.3f} s of it", file=sys.stderr)
    print(f"window: {committed} reads committed in {seconds} s, "
          f"{len(win_calls)} calls over {t1 - t0:.3f} s, process cpu "
          f"user {cpu1.user - cpu0.user:.3f} s system "
          f"{cpu1.system - cpu0.system:.3f} s", file=sys.stderr)
    print(f"library calls {len(calls)}, bytes written to disk {written} "
          f"(the FASTQ), SAM bytes of the last call {sam_bytes} (in "
          f"memory), engine "
          f"counters {counters}, candidate slots filled "
          f"{ref.filled_share:.4f}, reference {t_ref:.3f} s",
          file=sys.stderr)
    for i, got, w in examples:
        print(f"record of read {i} differs:\n  got  {got[:300]!r}\n"
              f"  want {w[:300]!r}", file=sys.stderr)

    res = {"correct": judge.passed(chk),
           "attempted": int(sum(win_calls)),
           "failed": int(differ + sum(abs(n - n_lib) for n in calls)),
           "device": {"platform": "gpu" if device.startswith("cuda")
                      else "cpu",
                      "kind": (torch.cuda.get_device_name(0)
                               if device.startswith("cuda") else "cpu"),
                      "count": 1, "memory_peak_bytes": int(mem_peak),
                      "device_count": (torch.cuda.device_count()
                                       if device.startswith("cuda") else 0)}}
    if not trace:
        units = {m["name"]: m["unit"]
                 for m in bench.metrics("end_to_end", cell["name"])}
        vals = {"reads_per_s": committed / seconds, "setup_s": setup_s,
                "index_to_sam_s": index_to_sam_s}
        if device.startswith("cuda"):
            vals["device_mem_peak_mib"] = mem_peak / 2**20
        res["metrics"] = {k: {"value": vals[k], "unit": units[k]}
                          for k in units if k in vals}
    else:
        W, C, L = (p["band_width"], p["max_candidates"], p["max_read_len"])
        run = SimpleNamespace(
            timers=timers, batches=batches,
            window_cpu_s=(cpu1.user - cpu0.user) + (cpu1.system
                                                    - cpu0.system),
            window_reads=int(sum(win_calls)),
            window_committed=committed, seconds=seconds,
            **spans_and_counters(log),
            kernels=dev_out["kernels"] if dev_out else None,
            busy_s=dev_out["busy_s"] if dev_out else None,
            window_s=dev_out["window_s"] if dev_out else None,
            select_bound_ms=bounds.select_bound(
                2 * B, p["max_seeds"] * p["max_occ"], C)["ms"],
            extend_bound_ms=bounds.extend_bound(
                B, C, L, W, int(ref.packed.seq.shape[0]),
                ref.filled_share)["ms"])
        res["metrics"] = per_layer(bench, cell, run)
        if dev_out:
            res["device"].update(busy_s=dev_out["busy_s"],
                                 window_s=dev_out["window_s"])
            res["breakdown"] = {"device_ops": dev_out["device_ops"],
                                "idle_gaps": dev_out["idle_gaps"]}
    res["checks"] = chk
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache the program or torch keeps, at fixed paths in the checkout
    cache = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path[:0] = [str(BENCH), str(ROOT)]
    from harness.spec import Bench

    bench = Bench(BENCH)
    cell = bench.cell(args.workload)
    try:
        import parasuite_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program is not in this checkout: {e}", file=sys.stderr)
        return 4
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{cell['name']} needs {cell['chips']} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    res = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 3
    res["device"]["power"] = power_limit()
    for k, c in res["checks"].items():
        print(f"{k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(result_line(res))
    return 0


def result_line(res: dict) -> str:
    """The result as one JSON line, its keys in the contract's order and the
    numbers compared last."""
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] * ("breakdown" in res) + ["checks"]
    return json.dumps({k: res[k] for k in keys})


if __name__ == "__main__":
    sys.exit(main())
