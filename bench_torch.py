"""Benchmark of the PyTorch / CUDA port: reads/s on 50 bp PAR-CLIP reads on
one GPU, the port's counterpart of bench.py (which drives the JAX package).

    python bench_torch.py [--device cuda|cpu]

Prints ONE JSON line with every key of bench.py's line ("metric", "value",
"unit", "vs_baseline", "vs_baseline_e2e", "end_to_end_reads_per_s",
"e2e_best_reads_per_s", "e2e_frac", "cpu_reads_per_s", "device_rounds",
"device_spread", "e2e_rounds", "e2e_spread", "rerun_triggered", "suspect",
"baseline_note" and the accuracy extras "sensitivity", "precision",
"n_unmapped", "n_mismapped") and the environment: "device", "gpu" (the
line `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
prints), "torch", "cuda", "nvcc".

The world and the rules are bench.py's: a uniform 20 Mbp reference
(default_rng(1)), bench.make_cfg() (k = 12, 7 seeds at stride 6, max_occ
16, C = 8), batches of 65,536 reads (PARASUITE_BENCH_BATCH overrides) and
16 batches a round. In order:
  1. the device leg, 3 timed rounds on simulate_reads(seed=2), with the
     accuracy extras against the reads' truth;
  2. the end-to-end leg, FASTQ -> SAM through streaming_align on
     simulate_reads(seed=3), the median of 5 runs;
  3. one rerun of the device leg when the device rounds spread over 0.15 or
     the end-to-end median is above the best device round, judged on the
     fresh rounds;
  4. suspect: the spread still over 0.15, or the end-to-end median above
     the device value;
  5. the CPU leg in a subprocess: the same pipeline on 4,096 reads at batch
     1,024 with --device cpu; vs_baseline is value / (10 x its reads/s).

The device loop is bench.py's: each batch's codes packed on the host
(pack_codes_host) inside the timed region, align_batch_packed through
AlignerEngine.align_device_packed, every PackedResult fetched to the host
as its 13 bytes a read inside the region, and unpacked (unpack_result_host)
after it for the accuracy extras.

What differs from bench.py:
  - the CPU leg is the port's own pipeline on the CPU, which runs the plain
    PyTorch versions of the two kernels. If it fails the script exits
    non-zero with its stderr and prints no line (bench.py records 0.0);
  - the end-to-end leg warms up with one whole run, not one batch;
  - --device cuda is the default and has no fallback; --device cpu, with
    the keyword sizes of main(), is for the tests.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "tools"))

import _torch_bench as tb                                    # noqa: E402
from _torch_bench import (E2E_ROUNDS, REF_LEN,               # noqa: E402
                          TIMED_ROUNDS, make_cfg, run_end_to_end,
                          run_throughput, spread_of)

BATCH = tb.BATCH            # bench.BATCH_TPU
N_READS = tb.N_READS        # 16 x BATCH = 1,048,576
N_READS_CPU = 4096
BATCH_CPU = 1024
SPREAD_LIMIT = 0.15
# the CPU leg's process: the same pipeline on the CPU, its best round
CPU_LEG = """
import json, sys
sys.path.insert(0, {tools!r})
import _torch_bench as tb
best, _extras, _rates = tb.run_throughput(
    tb.make_cfg({batch}), {n}, {batch}, {ref_len}, device="cpu",
    rounds={rounds})
print(json.dumps({{"cpu_reads_per_s": best}}))
"""


def variance_guard(best: float, rounds: list, e2e_median: float,
                   rerun) -> dict:
    """bench.py's rerun and suspect rules. rerun() -> (best, rounds) of a
    fresh device leg; it is called once, when the device rounds spread over
    SPREAD_LIMIT or the end-to-end median is above the best device round.
    The spread is then judged on the fresh rounds alone."""
    spread = spread_of(rounds)
    triggered = spread > SPREAD_LIMIT or e2e_median > max(rounds)
    if triggered:
        best2, rounds2 = rerun()
        rounds = rounds + rounds2
        best = max(best, best2)
        spread = spread_of(rounds2)
    return {"value": best, "device_rounds": rounds, "device_spread": spread,
            "rerun_triggered": triggered,
            "suspect": spread > SPREAD_LIMIT or e2e_median > best}


def cpu_leg(n_reads: int, batch: int, ref_len: int,
            rounds: int = TIMED_ROUNDS) -> float:
    """The port's pipeline on the CPU (all its cores) in a subprocess -> its
    best round's reads/s. Raises RuntimeError with the stderr if the
    process fails."""
    code = CPU_LEG.format(tools=str(REPO / "tools"), batch=batch, n=n_reads,
                          ref_len=ref_len, rounds=rounds)
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=1800)
    if p.returncode != 0:
        raise RuntimeError(f"cpu leg exited {p.returncode}:\n"
                           f"{p.stderr[-3000:]}")
    return float(json.loads(p.stdout.strip().splitlines()[-1])
                 ["cpu_reads_per_s"])


def main(argv=None, *, n_reads: int = N_READS, batch: int = BATCH,
         ref_len: int = REF_LEN, cpu_reads: int = N_READS_CPU,
         cpu_batch: int = BATCH_CPU, device_rounds: int = TIMED_ROUNDS,
         e2e_rounds: int = E2E_ROUNDS) -> int:
    device, _rest = tb.device_arg(argv, __doc__.splitlines()[0])
    if device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            sys.stderr.write("bench_torch: --device cuda, but "
                             "torch.cuda.is_available() is false\n")
            return 2
    env = tb.environment(device)
    cfg = make_cfg(batch)
    state = tb.build_state(cfg, ref_len, device=device)

    best, extras, rounds = run_throughput(
        cfg, n_reads, batch, ref_len, check_accuracy=True, state=state,
        device=device, rounds=device_rounds)
    with tempfile.TemporaryDirectory(prefix="parasuite_bench_") as td:
        e2e_best, e2e_med, e2e_rates = run_end_to_end(cfg, state, n_reads,
                                                      td, rounds=e2e_rounds)

    def rerun():
        b, _x, r = run_throughput(cfg, n_reads, batch, ref_len, state=state,
                                  device=device, rounds=device_rounds)
        return b, r

    dev = variance_guard(best, rounds, e2e_med, rerun)
    try:
        cpu_rps = cpu_leg(cpu_reads, cpu_batch, ref_len)
    except (RuntimeError, subprocess.TimeoutExpired) as e:
        sys.stderr.write(f"bench_torch: {e}\n")
        return 1
    denom = 10.0 * cpu_rps
    value = dev["value"]
    print(json.dumps({
        "metric": "reads_per_second_per_chip",
        "value": round(value, 1),
        "unit": "reads/s/chip (50bp PAR-CLIP, 20Mbp ref)",
        "vs_baseline": round(value / denom, 3),
        "vs_baseline_e2e": round(e2e_med / denom, 3),
        "end_to_end_reads_per_s": round(e2e_med, 1),
        "e2e_best_reads_per_s": round(e2e_best, 1),
        "e2e_frac": round(e2e_med / value, 3),
        "cpu_reads_per_s": round(cpu_rps, 1),
        "device_rounds": [round(r, 1) for r in dev["device_rounds"]],
        "device_spread": round(dev["device_spread"], 3),
        "e2e_rounds": [round(r, 1) for r in e2e_rates],
        "e2e_spread": round(spread_of(e2e_rates), 3),
        "rerun_triggered": dev["rerun_triggered"],
        "suspect": dev["suspect"],
        "baseline_note": "port on one GPU (parasuite_tpu_torch); vs_baseline "
                         "= device value / (10x the same pipeline on this "
                         "host's CPU, the kernels' plain PyTorch versions); "
                         "reference binary unavailable (BASELINE.md); device "
                         "value = host packing + align_batch_packed + fetch "
                         "per round (bench.py's loop), best "
                         f"of {device_rounds}; end_to_end = FASTQ->SAM "
                         f"through streaming_align, median of {e2e_rounds} "
                         "runs; suspect=true means device spread >15% or "
                         "e2e>device even after one re-run",
        **extras,
        "device": device, **env,
        "n_reads": n_reads, "batch": batch, "ref_len": ref_len,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
