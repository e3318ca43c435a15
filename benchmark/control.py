"""The control of a cell's comparison: the plain reference put in the
program's place with its DP in int8 (every score saturated to
[-128, 127]), the narrowest integer type a packed kernel would tempt,
judged by the same comparison as a run (harness/judge.py) on the cell's own
inputs and sample. The exact reference is the one the configuration's mode
makes (modes/<mode>.py `reference`, with no library call's records: tap
None), and the control scores with its score tensor. It must come out not
correct.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

Prints one JSON line a seed: records_differ of the control against the
exact reference and its limit. The program is not run, and no card is
needed: the readings are numpy on the host.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH)]

from harness import judge, reference, world  # noqa: E402
from harness.spec import Bench  # noqa: E402


def control_reading(bench: Bench, cell_name: str, seed: int) -> dict:
    cell = bench.cell(cell_name)
    conf = bench.config(cell["config"])
    mode = bench.mode(conf["mode"])
    mix = bench.traffic(cell["traffic"])
    genome = world.make_genome(conf["genome"], seed)
    txs = (world.make_annotation(conf["annotation"], genome, seed)
           if mode.ANNOTATION else [])
    n_lib = int(conf["library_reads"])
    lib = world.make_library(mix, n_lib, genome, txs, seed)
    idx = judge.sample(n_lib, int(conf["sample_reads"]), seed)
    names = [world.read_name(i) for i in idx]
    t0 = time.perf_counter()
    ref = mode.reference(genome, conf["align"], txs, None)
    exact = ref.sam_lines(lib.codes[idx], lib.lengths[idx], names, lib.qual)
    t1 = time.perf_counter()
    ctl = reference.Reference(genome, conf["align"], txs, int_bits=8,
                              s_fwd=ref.s_fwd).sam_lines(
        lib.codes[idx], lib.lengths[idx], names, lib.qual)
    differ, _ex = judge.judge(ctl, exact, range(len(exact)))
    chk = judge.checks(differ, 0)["records_differ"]
    return {"workload": cell_name, "seed": seed, "sample": len(idx),
            "records_differ": chk["value"], "limit": chk["limit"],
            "correct": chk["value"] <= chk["limit"],
            "reference_s": t1 - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    bench = Bench(BENCH)
    for seed in args.seeds:
        print(json.dumps(control_reading(bench, args.workload, seed)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
