"""Where the card's memory goes in one cell of the benchmark: the bytes the
engine holds once built, and the peak of one device step above what was
allocated before it, eager and stage by stage.

The cell's world is built from --seed as benchmark/run.py builds it, the
engine by the mode file its configuration names. Then, for each --batches
size, the first reads of the library go through the engine's wire step
(ops/aligner.py::align_batch_packed, or align_batch_combined_packed for a
combined engine) three ways:

  * `eager`: the whole step once, run op by op, the peak reset before it;
  * `stages`: the same step cut at its stages (unpack, orient, seed and
    select, extend, finalize, pack; the combined step's table, project and
    compact around its finalize), the peak reset before each: the stage
    whose peak is the largest sets the step's. A program whose
    ops/cuda_seed.py has seed_select runs seed and select as that one
    stage (`seed_select`); an older one runs `seed` (seed_diagonals) and
    `select` (select_candidates). A program with
    aligner.finalize_entries cuts the plain finalize into its entries'
    preamble (`finalize_entries`) and the selection (`finalize_select`,
    ops/cuda_finalize.py, the finalize kernel on the card); an older one
    runs `finalize` whole. The combined step's finalize stage goes through
    aligner.finalize_select where the program has it, else finalize_core.
    A twopass cell's pass 1 runs the step with its fused profile counts
    (with_counts), cut as one more stage after the pack (`counts`,
    ops/profile_update.py::profile_counts_batch);
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


def staged(eng, two, nmask, lens16, meter: Meter, base: int,
           caps: tuple | None = None, counts: bool = False) -> dict:
    """The wire step cut at its stages -> {stage: {peak_above_step,
    live_after}} in bytes above `base`, the allocation before the step;
    with `caps` (cap_entries, cap_junctions) the combined step's; with
    `counts` its fused profile counts last."""
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
    if caps is not None:
        return _staged_combined(eng, stage, held, oriented, lengths,
                                min_scores, cand, valid, ext, caps, out)
    if hasattr(A, "finalize_entries"):
        entries = stage("finalize_entries", lambda: A.finalize_entries(
            oriented, lengths, min_scores, cand, valid, *ext, didx, cfg))
        del ext, held["extend"]
        res = stage("finalize_select", lambda: A.finalize_select(
            *entries, didx, sprof, cfg)[0])
    else:
        res = stage("finalize", lambda: A.finalize(
            oriented, lengths, min_scores, cand, valid, *ext, didx, sprof,
            cfg))
    stage("pack", lambda: A.pack_result(res, cfg.band_width))
    if counts:
        from parasuite_tpu_torch.ops.profile_update import \
            profile_counts_batch

        stage("counts", lambda: profile_counts_batch(
            didx, codes, lengths, res.mapped, res.strand, res.pos,
            res.ug_equal, cfg))
    return out


def _staged_combined(eng, stage, held, oriented, lengths, min_scores, cand,
                     valid, ext, caps, out) -> dict:
    """The combined step's stages after extend, as
    ops/aligner.py::align_batch_combined_packed runs them: the candidate
    table, the genome projection, finalize (with src, nm_pos, nm_strand),
    then the compactions of the host rows' entries and of the junction
    winners, and the pack."""
    import torch

    from parasuite_tpu_torch.ops import aligner as A

    cfg, didx, sprof = eng.cfg, eng.didx, eng.sprof
    table = stage("table", lambda: A.candidate_table(
        oriented, lengths, min_scores, cand, valid, *ext, cfg,
        didx.ref_seq.shape[0]))
    del ext, held["extend"]
    proj_pos, proj_strand, is_tx, simple, q0, noncontig = stage(
        "project", lambda: A.project_candidates_device(
            table, lengths, didx, eng._txt, eng._n_genome,
            eng._tx_boundary))
    B, n = table.valid.shape
    select = getattr(A, "finalize_select", A.finalize_core)
    res, best_idx = stage("finalize", lambda: select(
        oriented, lengths, table.valid, proj_strand, proj_pos, table.score,
        table.ug_equal, table.diag,
        valid.reshape(B, n).sum(dim=1, dtype=torch.int32), didx, sprof, cfg,
        src=is_tx.to(torch.int32),
        nm_pos=torch.where(noncontig, table.pos, proj_pos),
        nm_strand=torch.where(noncontig, table.strand, proj_strand)))

    def compact():
        any_tx = (table.valid & is_tx).any(dim=1)
        needs_host = any_tx & (table.valid & ~simple).any(dim=1)
        kept = A._compact((table.valid & needs_host[:, None]).reshape(-1),
                          caps[0])
        bi = best_idx[:, None].long()
        win = noncontig.gather(1, bi)[:, 0] & res.mapped & ~needs_host
        return kept, A._compact(win, caps[1])

    stage("compact", compact)
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
    # _torch_bench puts this tree first where it finds it missing, which
    # would shadow --program
    sys.path.append(str(ROOT))

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
           "program": str(Path(A.__file__).resolve().parents[2]),
           "gpu": tb.gpu_line(args.device), "torch": torch.__version__,
           "device": str(args.device),
           "with_counts": conf["mode"] == "twopass",
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
        caps = None
        counts = out["with_counts"]           # a twopass cell's pass 1
        base = meter.start()
        if hasattr(eng, "_txt"):     # a combined engine's projected step
            caps = tuple(max(1, int(round(f * b))) for f in (
                eng.cfg.combined_wire_cap, eng.cfg.combined_wire_jun_cap))
            res = A.align_batch_combined_packed(
                eng.didx, eng.sprof, eng._txt, two_d, nmask_d, lens_d,
                eng._ms_table, eng.cfg, eng._n_genome, eng._tx_boundary,
                *caps)
        else:
            res = A.align_batch_packed(eng.didx, eng.sprof, two_d, nmask_d,
                                       lens_d, eng._ms_table, eng.cfg,
                                       with_counts=counts)
        rec["eager_peak_above_step"] = meter.peak() - base
        del res
        rec["stages"] = staged(eng, two_d, nmask_d, lens_d, meter, base,
                               caps, counts)
        rec["peak_stage"] = max(rec["stages"], key=lambda s: rec["stages"][
            s]["peak_above_step"])
        del wire, two_d, nmask_d, lens_d
        base = meter.start()
        graphed = eng.align_device_packed(codes, lengths,
                                          with_counts=counts)
        rec["graphed_peak_above_step"] = meter.peak() - base
        rec["graphed_peak_total_mib"] = meter.peak() / MIB
        del graphed
        out["batches"][str(b)] = rec
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
