"""Command-line entry of the port: index, align, twopass.

Same subcommands, flags and outputs as parasuite_tpu.cli (the files are
byte-identical for the same inputs), plus --device (default cuda). A device
that is asked for and missing is an error; the CLI never moves to the CPU on
its own. Combined genome+transcriptome indexes and the other subcommands are
not ported yet (ROADMAP Queue 1).

    python -m parasuite_tpu_torch.cli index ref.fa idx --kmer-size 12
    python -m parasuite_tpu_torch.cli twopass idx reads.fastq out.sam \\
        --learned-gaps --device cuda
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

from parasuite_tpu.cli import _add_cfg_flags, _cfg_from_args, cmd_index


def _load_engine(args, cfg):
    from parasuite_tpu.errormodel.infer import ErrorProfile, counts_to_profile
    from parasuite_tpu.index import KmerIndex, PackedReference
    from parasuite_tpu_torch.pipeline.align import AlignerEngine

    if Path(str(args.index_prefix) + ".combined.json").exists():
        raise NotImplementedError("combined genome+transcriptome indexes are "
                                  "not ported yet (ROADMAP Queue 1 item 5)")
    s = None
    if getattr(args, "profile", None):
        s = counts_to_profile(ErrorProfile.load(args.profile), cfg)
    return AlignerEngine(PackedReference.load(args.index_prefix),
                         KmerIndex.load(args.index_prefix), cfg, s_tensor=s,
                         xa_tags=getattr(args, "xa", False),
                         device=args.device)


def _command_line(args) -> str:
    return args.pg_cl if args.pg_cl is not None else " ".join(sys.argv[1:])


def cmd_align(args) -> int:
    from parasuite_tpu.utils.runlog import RunLog
    from parasuite_tpu_torch.pipeline.stream import streaming_align

    cfg = _cfg_from_args(args)
    engine = _load_engine(args, cfg)
    log = RunLog(args.log) if args.log else RunLog()
    t0 = time.perf_counter()
    n, _, _ = streaming_align(engine, args.fastq, args.out,
                              resume=args.resume, log=log,
                              command_line=_command_line(args))
    Path(str(args.out) + ".config.json").write_text(cfg.to_json())
    dt = time.perf_counter() - t0
    print(json.dumps({"tool": "align", "reads": n,
                      "seconds": round(dt, 3),
                      "reads_per_second": round(n / max(dt, 1e-9), 1),
                      "device": str(engine.device)}))
    return 0


def cmd_twopass(args) -> int:
    from parasuite_tpu.errormodel.infer import ErrorProfile, counts_to_profile
    from parasuite_tpu.utils.runlog import RunLog
    from parasuite_tpu_torch.pipeline.stream import streaming_align

    cfg = _cfg_from_args(args)
    engine = _load_engine(args, cfg)
    log = RunLog(args.log) if args.log else RunLog()
    profile_out = args.profile_out or (str(args.out) + ".errorprofile")
    cl = _command_line(args)

    # pass 1: flat scoring, first-pass SAM + on-device profile counts
    pass1_sam = str(args.out) + ".pass1.sam"
    indels: dict = {}
    _n1, counts, n_profiled = streaming_align(
        engine, args.fastq, pass1_sam, resume=args.resume,
        with_profile_counts=True, log=log, command_line=cl,
        indel_out=indels)
    profile = ErrorProfile(counts=counts, n_reads=n_profiled,
                           ins_counts=indels.get("ins"),
                           del_counts=indels.get("dels"),
                           n_gapped=indels.get("n_gapped", 0))
    profile.save(profile_out)
    log.event("twopass.profile", n_reads=profile.n_reads,
              n_gapped=profile.n_gapped)

    # pass 2: learned scoring (optionally learned gap penalties too)
    if args.learned_gaps:
        go, ge = profile.gap_penalties(cfg)
        cfg = dataclasses.replace(cfg, gap_open=go, gap_extend=ge)
        engine = _load_engine(args, cfg)
        log.event("twopass.gaps", gap_open=go, gap_extend=ge)
    engine.set_profile(counts_to_profile(profile, cfg))
    n, _, _ = streaming_align(engine, args.fastq, args.out,
                              resume=args.resume, log=log, command_line=cl)
    Path(str(args.out) + ".config.json").write_text(cfg.to_json())
    out = {"tool": "twopass", "reads": n,
           "profiled_reads": profile.n_reads, "profile": str(profile_out),
           "device": str(engine.device)}
    if args.learned_gaps:
        out["gap_open"], out["gap_extend"] = cfg.gap_open, cfg.gap_extend
    print(json.dumps(out))
    return 0


def _add_run_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--resume", action="store_true",
                   help="resume from <out>.progress.json checkpoint")
    p.add_argument("--log", help="append per-batch JSONL stats here")
    p.add_argument("--pg-cl", dest="pg_cl", default=None,
                   help="override the @PG CL: header value (pin it so "
                        "resumed/merged outputs stay byte-identical)")
    p.add_argument("--device", default="cuda",
                   help="torch device for the align step (default cuda; "
                        "cpu runs the kernels' plain PyTorch versions)")
    _add_cfg_flags(p)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="parasuite_tpu_torch",
        description="PAR-CLIP read alignment on PyTorch / CUDA")
    sub = ap.add_subparsers(dest="tool", required=True)

    p = sub.add_parser("index", help="build reference index")
    p.add_argument("fasta")
    p.add_argument("out_prefix")
    _add_cfg_flags(p)
    p.set_defaults(fn=cmd_index)

    p = sub.add_parser("align", help="align FASTQ -> SAM/BAM")
    p.add_argument("index_prefix")
    p.add_argument("fastq")
    p.add_argument("out")
    p.add_argument("--profile", help=".errorprofile for profile-aware scoring")
    p.add_argument("--xa", action="store_true",
                   help="emit XA:Z alternative-hit tags (not ported yet)")
    _add_run_flags(p)
    p.set_defaults(fn=cmd_align)

    p = sub.add_parser("twopass", help="two-pass profile-aware alignment")
    p.add_argument("index_prefix")
    p.add_argument("fastq")
    p.add_argument("out")
    p.add_argument("--profile-out", dest="profile_out")
    p.add_argument("--learned-gaps", dest="learned_gaps",
                   action="store_true",
                   help="pass 2 also uses gap penalties learned from pass-1 "
                        "indel rates (ErrorProfile.gap_penalties)")
    _add_run_flags(p)
    p.set_defaults(fn=cmd_twopass)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
