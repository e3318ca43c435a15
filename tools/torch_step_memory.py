"""Where the card's memory goes in one cell of the benchmark: the bytes the
engine holds once built, and the peak of one device step above what was
allocated before it, eager and stage by stage.

The cell's world is built from --seed as benchmark/run.py builds it, the
engine by the mode file its configuration names. Then, for each --batches
size, the first reads of the library go through the wire step
(ops/aligner.py::align_batch_packed) three ways:

  * `eager`: the whole step once, run op by op, the peak reset before it;
  * `stages`: the same step cut at its stages (unpack, orient, seed and
    select, extend, finalize, pack), the peak reset before each: the stage
    whose peak is the largest sets the step's. A program whose
    ops/cuda_seed.py has seed_select runs seed and select as that one
    stage (`seed_select`); an older one runs `seed` (seed_diagonals) and
    `select` (select_candidates);
  * `graphed`: the engine's compiled step once (a new key: its eager
    warm-up and the capture), the peak reset before it; with the engine
    build before it this is what the benchmark's device_mem_peak_mib reads.

    python tools/torch_step_memory.py [--workload chr22_align.parclip50] \\
        [--seed 1] [--batches 65536,16384] [--program DIR] [--device cuda]

--program imports parasuite_tpu_torch from another tree (an unpacked
parent commit), so both sides run the same measurement. --bench names
another benchmark folder, such as a tiny copy for a CPU run, where no byte
is counted. One JSON line, with the card's name and power limit (`gpu`,
"cpu" for a CPU run).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MIB = 2 ** 20


class Meter:
    """Peak bytes above a baseline on one device; zeros on the CPU."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.cuda = torch.device(device).type == "cuda"
        self.device = device

    def allocated(self) -> int:
        return (self.torch.cuda.memory_allocated(self.device)
                if self.cuda else 0)

    def start(self) -> int:
        if self.cuda:
            self.torch.cuda.synchronize(self.device)
            self.torch.cuda.reset_peak_memory_stats(self.device)
        return self.allocated()

    def peak(self) -> int:
        if not self.cuda:
            return 0
        self.torch.cuda.synchronize(self.device)
        return self.torch.cuda.max_memory_allocated(self.device)


def staged(eng, two, nmask, lens16, meter: Meter, base: int) -> dict:
    """The wire step cut at its stages -> {stage: {peak_above_step,
    live_after}} in bytes above `base`, the allocation before the step."""
    from parasuite_tpu_torch.ops import aligner as A
    from parasuite_tpu_torch.ops import cuda_seed

    cfg, didx, sprof = eng.cfg, eng.didx, eng.sprof
    out: dict = {}
    held: dict = {}

    def stage(name, fn):
        meter.start()
        held[name] = fn()
        out[name] = {"peak_above_step": meter.peak() - base,
                     "live_after": meter.allocated() - base}
        return held[name]

    codes, lengths, min_scores = stage(
        "unpack", lambda: A._unpack_wire(two, nmask, lens16, eng._ms_table,
                                         cfg))
    oriented = stage("orient", lambda: A.orient_reads(codes, lengths))
    if hasattr(cuda_seed, "seed_select"):
        cand, valid = stage("seed_select", lambda: cuda_seed.seed_select(
            oriented, lengths, didx, cfg))
    else:
        diags = stage("seed", lambda: A.seed_diagonals(oriented, lengths,
                                                       didx, cfg))
        cand, valid = stage("select", lambda: A.resolve_select_fn(cfg)(
            diags, cfg))
        del diags, held["seed"]
    ext = stage("extend", lambda: A.resolve_extend_fn(cfg)(
        oriented, lengths, cand, didx, sprof, cfg))
    res = stage("finalize", lambda: A.finalize(
        oriented, lengths, min_scores, cand, valid, *ext, didx, sprof, cfg))
    stage("pack", lambda: A.pack_result(res, cfg.band_width))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="chr22_align.parclip50")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--batches", default="65536,16384")
    ap.add_argument("--program", default=str(ROOT))
    ap.add_argument("--bench", default=str(ROOT / "benchmark"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(Path(args.program).resolve()), str(args.bench)]

    import torch

    import _torch_bench as tb
    from harness import world
    from harness.spec import Bench
    from parasuite_tpu_torch.ops import aligner as A

    bench = Bench(Path(args.bench))
    cell = bench.cell(args.workload)
    conf = bench.config(cell["config"])
    mode = bench.mode(conf["mode"])
    genome = world.make_genome(conf["genome"], args.seed)
    txs = (world.make_annotation(conf["annotation"], genome, args.seed)
           if mode.ANNOTATION else [])
    meter = Meter(args.device)
    if meter.cuda:
        torch.empty(1, device=args.device)       # the context
    base0 = meter.start()
    eng = mode.build(conf, genome, txs, args.device)
    out = {"workload": args.workload, "seed": args.seed,
           "program": str(Path(args.program).resolve()),
           "gpu": tb.gpu_line(args.device), "torch": torch.__version__,
           "device": str(args.device),
           "engine_allocated": meter.allocated() - base0,
           "engine_build_peak": meter.peak() - base0, "batches": {}}
    sizes = [int(b) for b in args.batches.split(",")]
    lib = world.make_library(bench.traffic(cell["traffic"]), max(sizes),
                             genome, txs, args.seed)
    for b in sizes:
        codes, lengths = lib.codes[:b], lib.lengths[:b]
        two, nmask = A.pack_codes_host(codes)
        wire = [torch.from_numpy(x).to(args.device) for x in
                (two, nmask, lengths.astype("uint16"))]
        two_d, nmask_d, lens_d = wire
        rec: dict = {}
        base = meter.start()
        res = A.align_batch_packed(eng.didx, eng.sprof, two_d, nmask_d,
                                   lens_d, eng._ms_table, eng.cfg)
        rec["eager_peak_above_step"] = meter.peak() - base
        del res
        rec["stages"] = staged(eng, two_d, nmask_d, lens_d, meter, base)
        rec["peak_stage"] = max(rec["stages"], key=lambda s: rec["stages"][
            s]["peak_above_step"])
        del wire, two_d, nmask_d, lens_d
        base = meter.start()
        graphed = eng.align_device_packed(codes, lengths)
        rec["graphed_peak_above_step"] = meter.peak() - base
        rec["graphed_peak_total_mib"] = meter.peak() / MIB
        del graphed
        out["batches"][str(b)] = rec
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
