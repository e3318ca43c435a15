"""Command-line entry of the port: index, combine, align, twopass,
simulate, benchmark, cluster, dist-align, merge-shards, sort, convert.

Same subcommands, flags, outputs and stdout JSON keys as parasuite_tpu.cli
(parasuite_tpu/cli.py:94-569; the files are byte-identical for the same
inputs, and either package reads the other's index files and merges the
other's shards). align, twopass, benchmark and dist-align take --device
(default cuda); a device that is asked for and missing is an error, and the
CLI never moves to the CPU on its own. align
and twopass take --xa, --rescue-kmer and combined genome+transcriptome
indexes (an index prefix with a .combined.json beside it).

index, sort and convert are numpy and the port's native host library
(native/), no framework. simulate uses the port's simulator
(sim/generate.py, the same reads bit for bit); cluster its copies
of the cluster caller. benchmark --scaling measures the data-parallel step
over 1..N of the machine's cards and fails when asked for more than it has.
dist-align runs one host's shard of a multi-host run, file-side
(--host-index/--n-hosts) or as one process of a torch.distributed group
(--coordinator); merge-shards merges either mode's shards (host-only).

    python -m parasuite_tpu_torch.cli index ref.fa idx --kmer-size 12
    python -m parasuite_tpu_torch.cli simulate idx reads.fastq --n-reads 10000
    python -m parasuite_tpu_torch.cli twopass idx reads.fastq out.sam \\
        --learned-gaps --rescue-kmer 11 --device cuda
    python -m parasuite_tpu_torch.cli benchmark idx --n-reads 262144
    python -m parasuite_tpu_torch.cli cluster idx out.sam clusters.tsv
    python -m parasuite_tpu_torch.cli combine ref.fa exons.tsv cidx
    python -m parasuite_tpu_torch.cli align cidx reads.fastq out.sam --xa
    python -m parasuite_tpu_torch.cli dist-align idx reads.fastq run \\
        --host-index 0 --n-hosts 2
    python -m parasuite_tpu_torch.cli dist-align idx reads.fastq run \\
        --coordinator host0:9876 --num-processes 2 --process-id 0
    python -m parasuite_tpu_torch.cli merge-shards idx run out.sam \\
        --n-hosts 2 --profile-out out.errorprofile
    python -m parasuite_tpu_torch.cli benchmark idx --scaling 1,2,4
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np


def _cfg_from_args(args) -> "AlignConfig":
    from parasuite_tpu_torch.config import AlignConfig

    kw = {}
    for f in ("max_read_len", "kmer_size", "band_width", "max_candidates",
              "max_occ", "max_seeds", "seed_stride", "batch_size",
              "cluster_min_reads", "seed", "rescue_kmer"):
        v = getattr(args, f, None)
        if v is not None:
            kw[f] = v
    return AlignConfig(**kw)


def _add_cfg_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--max-read-len", dest="max_read_len", type=int)
    p.add_argument("--kmer-size", dest="kmer_size", type=int)
    p.add_argument("--band-width", dest="band_width", type=int)
    p.add_argument("--max-candidates", dest="max_candidates", type=int)
    p.add_argument("--max-occ", dest="max_occ", type=int)
    p.add_argument("--max-seeds", dest="max_seeds", type=int)
    p.add_argument("--seed-stride", dest="seed_stride", type=int,
                   help="offset step between seeds (< kmer-size = "
                        "overlapping seeds, higher sensitivity; 0 = "
                        "non-overlapping, the default)")
    p.add_argument("--batch-size", dest="batch_size", type=int)
    p.add_argument("--rescue-kmer", dest="rescue_kmer", type=int,
                   help="two-tier seeding: retry unmapped reads with this "
                        "smaller seed k in a second device pass (36-40bp "
                        "libraries; 0 = off)")
    p.add_argument("--seed", type=int)


def cmd_index(args) -> int:
    from parasuite_tpu_torch.index import KmerIndex, PackedReference
    from parasuite_tpu_torch.io.fasta import read_fasta

    cfg = _cfg_from_args(args)
    seqs = read_fasta(args.fasta)
    ref = PackedReference.from_dict(seqs, spacer=cfg.chrom_spacer)
    idx = KmerIndex.build(ref.seq, cfg.kmer_size)
    ref.save(args.out_prefix)
    idx.save(args.out_prefix)
    Path(str(args.out_prefix) + ".config.json").write_text(cfg.to_json())
    print(json.dumps({"tool": "index", "chroms": len(ref.names),
                      "packed_len": ref.total_len, "kmers": idx.n_kmers}))
    return 0


def cmd_sort(args) -> int:
    from parasuite_tpu_torch.io.bam import coordinate_sort

    n = coordinate_sort(args.infile, args.out, min_mapq=args.min_mapq,
                        mapped_only=args.mapped_only,
                        max_in_memory=args.max_in_memory)
    print(json.dumps({"tool": "sort", "records": n, "out": str(args.out)}))
    return 0


def cmd_convert(args) -> int:
    from parasuite_tpu_torch.io.bam import bam_to_sam, sam_to_bam

    src, dst = str(args.infile), str(args.out)
    if src.endswith(".bam") and not dst.endswith(".bam"):
        n = bam_to_sam(src, dst)
    elif not src.endswith(".bam") and dst.endswith(".bam"):
        n = sam_to_bam(src, dst)
    else:
        raise SystemExit("convert: exactly one of the two paths must end "
                         "in .bam")
    print(json.dumps({"tool": "convert", "records": n, "out": dst}))
    return 0


def _load_engine(args, cfg):
    from parasuite_tpu_torch.errormodel.infer import (ErrorProfile,
                                                      counts_to_profile)
    from parasuite_tpu_torch.index import KmerIndex, PackedReference
    from parasuite_tpu_torch.pipeline.align import AlignerEngine

    s = None
    if getattr(args, "profile", None):
        s = counts_to_profile(ErrorProfile.load(args.profile), cfg)
    idx = KmerIndex.load(args.index_prefix)
    xa = getattr(args, "xa", False)
    if Path(str(args.index_prefix) + ".combined.json").exists():
        from parasuite_tpu_torch.pipeline.combined import (CombinedEngine,
                                                           CombinedReference)

        return CombinedEngine(CombinedReference.load(args.index_prefix), idx,
                              cfg, s_tensor=s, xa_tags=xa,
                              device=args.device)
    return AlignerEngine(PackedReference.load(args.index_prefix), idx, cfg,
                         s_tensor=s, xa_tags=xa, device=args.device)


def _engine_counters(engines) -> dict:
    """XA, rescue and projected-step counters summed over the engines of
    one command (only the ones its options and index turn on)."""
    keys = []
    if engines[0].xa_tags:
        keys.append("xa_dropped")
    if engines[0].cfg.rescue_kmer:
        keys += ["rescue_mapped", "rescue_overflow"]
    # the projected step's counters: the combined engine's alone (the
    # plain engine takes the wire step too, and has none)
    if engines[0].supports_packed and hasattr(engines[0], "packed_batches"):
        keys += ["packed_batches", "packed_entries", "packed_junctions",
                 "packed_overflow"]
    return {k: sum(getattr(e, k) for e in engines) for k in keys}


def _command_line(args) -> str:
    return args.pg_cl if args.pg_cl is not None else " ".join(sys.argv[1:])


def _run_log(args):
    """The run's log: --log's file, where the streaming calls' spans and
    counters are recorded too (written at the end, write_spans); without
    --log one that keeps nothing."""
    from parasuite_tpu_torch.utils.runlog import RunLog

    return RunLog(args.log, record=True) if args.log else RunLog()


def cmd_align(args) -> int:
    from parasuite_tpu_torch.pipeline.stream import streaming_align

    cfg = _cfg_from_args(args)
    engine = _load_engine(args, cfg)
    log = _run_log(args)
    t0 = time.perf_counter()
    n, _, _ = streaming_align(engine, args.fastq, args.out,
                              resume=args.resume, log=log,
                              command_line=_command_line(args))
    log.write_spans()
    Path(str(args.out) + ".config.json").write_text(cfg.to_json())
    dt = time.perf_counter() - t0
    print(json.dumps({"tool": "align", "reads": n,
                      "seconds": round(dt, 3),
                      "reads_per_second": round(n / max(dt, 1e-9), 1),
                      "device": str(engine.device),
                      **_engine_counters([engine])}))
    return 0


def cmd_twopass(args) -> int:
    from parasuite_tpu_torch.pipeline.two_pass import streaming_two_pass

    cfg = _cfg_from_args(args)
    engine = _load_engine(args, cfg)
    log = _run_log(args)
    profile_out = args.profile_out or (str(args.out) + ".errorprofile")
    engines = [engine]

    def learned_gaps(profile):
        """Pass 2's engine with the gap penalties learned in pass 1."""
        go, ge = profile.gap_penalties(cfg)
        engines.append(_load_engine(args, dataclasses.replace(
            cfg, gap_open=go, gap_extend=ge)))
        log.event("twopass.gaps", gap_open=go, gap_extend=ge)
        return engines[-1]

    # pass 1: flat scoring, first-pass SAM + on-device profile counts;
    # pass 2: learned scoring (optionally learned gap penalties too)
    n, profile, _n1 = streaming_two_pass(
        engine, args.fastq, args.out, pass1_out=str(args.out) + ".pass1.sam",
        profile_out=profile_out, resume=args.resume, log=log,
        command_line=_command_line(args),
        pass2_engine=learned_gaps if args.learned_gaps else None)
    log.write_spans()
    cfg = engines[-1].cfg
    Path(str(args.out) + ".config.json").write_text(cfg.to_json())
    out = {"tool": "twopass", "reads": n,
           "profiled_reads": profile.n_reads, "profile": str(profile_out),
           "device": str(engines[-1].device), **_engine_counters(engines)}
    if args.learned_gaps:
        out["gap_open"], out["gap_extend"] = cfg.gap_open, cfg.gap_extend
    print(json.dumps(out))
    return 0


def cmd_simulate(args) -> int:
    from parasuite_tpu_torch.errormodel.infer import ErrorProfile
    from parasuite_tpu_torch.index import PackedReference
    from parasuite_tpu_torch.io.fastq import write_fastq
    from parasuite_tpu_torch.sim.generate import (simulate_quality,
                                                  simulate_reads)

    cfg = _cfg_from_args(args)
    ref = PackedReference.load(args.index_prefix)
    probs = None
    ins_rate, del_rate = args.ins_rate, args.del_rate
    if args.profile:
        prof = ErrorProfile.load(args.profile)
        probs = prof.probs(cfg.profile_pseudocount)
        if args.learned_indels:
            # per-cycle indel rates from the learned profile (SURVEY.md §3.4)
            ins_rate, del_rate = prof.indel_rates()
    codes, lengths, truth = simulate_reads(
        ref, args.n_reads, args.read_len, cfg, seed=cfg.seed,
        profile_probs=probs, tc_rate=args.tc_rate,
        ins_rate=ins_rate, del_rate=del_rate)
    names = truth.names()
    quals = (None if args.flat_qual
             else simulate_quality(len(names), args.read_len, seed=cfg.seed))
    write_fastq(args.out, names, codes, lengths, quals=quals)
    n_indels = (int((truth.indel_kind > 0).sum())
                if truth.indel_kind is not None else 0)
    print(json.dumps({"tool": "simulate", "reads": args.n_reads,
                      "conversions": int(truth.n_conversions.sum()),
                      "errors": int(truth.n_errors.sum()),
                      "indels": n_indels}))
    return 0


def cmd_benchmark(args) -> int:
    """Simulate, align through align_device (warm-up batch excluded from
    the timing), and score against the truth."""
    from parasuite_tpu_torch.benchkit import (ThroughputTimer,
                                              evaluate_against_truth)
    from parasuite_tpu_torch.benchkit.timing import block_until_ready
    from parasuite_tpu_torch.pipeline.align import fetch_host
    from parasuite_tpu_torch.sim.generate import simulate_reads

    cfg = _cfg_from_args(args)
    if args.scaling:
        return _benchmark_scaling(args, cfg)
    engine = _load_engine(args, cfg)
    codes, lengths, truth = simulate_reads(engine.ref, args.n_reads,
                                           args.read_len, cfg, seed=cfg.seed,
                                           tc_rate=args.tc_rate)
    B = cfg.batch_size
    pad = (-len(codes)) % B
    if pad:
        codes = np.concatenate([codes, np.full((pad, args.read_len), 4,
                                               dtype=np.int8)])
        lengths = np.concatenate([lengths, np.zeros(pad, dtype=np.int32)])
    # warm-up on the first batch (kernel build and first launches)
    block_until_ready(engine.align_device(codes[:B], lengths[:B]))
    timer = ThroughputTimer("align")
    results = []
    for i in range(0, len(codes), B):
        timer.start()
        r = engine.align_device(codes[i : i + B], lengths[i : i + B])
        timer.stop(int((lengths[i : i + B] > 0).sum()), r)
        results.append(r)
    host = [fetch_host(r)[0] for r in results]
    mapped = np.concatenate([r.mapped for r in host])
    strand = np.concatenate([r.strand for r in host])
    pos = np.concatenate([r.pos for r in host])
    rep = evaluate_against_truth(truth, mapped, strand, pos)
    print(json.dumps(timer.report(**rep.to_dict(), tool="benchmark")))
    return 0


def _benchmark_scaling(args, cfg) -> int:
    """benchmark --scaling: the weak-scaling report of the data-parallel
    step over the first n of the machine's devices of --device's type, for
    each n asked, and each mesh's compiled graphs (keys, graphs, capture
    ms). Asking for more devices than there are is an error (exit 2) before
    anything is measured."""
    from parasuite_tpu_torch.benchkit.scaling import scaling_run
    from parasuite_tpu_torch.parallel.mesh import make_mesh
    from parasuite_tpu_torch.pipeline.align import resolve_device
    from parasuite_tpu_torch.sim.generate import simulate_reads

    counts = [int(x) for x in args.scaling.split(",")]
    dev = resolve_device(args.device)
    # the CPU is one device; the machine's CUDA devices are make_mesh's own
    # default
    devices = None if dev.type == "cuda" and dev.index is None else [dev]
    try:
        make_mesh(max(counts), devices=devices)
    except ValueError as e:
        print(f"benchmark --scaling {args.scaling}: {e}", file=sys.stderr)
        return 2
    engine = _load_engine(args, cfg)
    codes, lengths, _ = simulate_reads(engine.ref, max(counts) * args.n_reads,
                                       args.read_len, cfg, seed=cfg.seed,
                                       tc_rate=args.tc_rate)
    rep, graphs = scaling_run(engine.didx, engine.sprof, codes, lengths,
                              cfg, counts, per_device_reads=args.n_reads,
                              devices=devices)
    print(json.dumps({"tool": "benchmark", **rep, "graphs": graphs}))
    return 0


def cluster_columns_python(sam_path, ref):
    """Per-record SAM ingestion for cluster calling (fallback without the
    native library; a copy of parasuite_tpu.cli.cluster_columns_python,
    whose module-level imports pull in jax). -> (pos, span, tc)."""
    from parasuite_tpu_torch.io.sam import cigar_ref_span, read_sam
    from parasuite_tpu_torch.utils.dna import encode_seq
    from parasuite_tpu_torch.pipeline.clusters import tc_count_from_cigar

    name_to_idx = {n: i for i, n in enumerate(ref.names)}
    _, records = read_sam(sam_path)
    pos_l, span_l, tc_l = [], [], []
    for r in records:
        if r["flag"] & 0x4 or r["rname"] not in name_to_idx:
            continue
        ci = name_to_idx[r["rname"]]
        packed = int(ref.starts[ci]) + r["pos"] - 1
        span = cigar_ref_span(r["cigar"])
        # SAM SEQ is genome-oriented; walk the CIGAR so I/D/N (gapped and
        # junction records) keep the machine-frame T->C comparison in frame
        seq = encode_seq(r["seq"])
        tc = tc_count_from_cigar(ref.seq, packed, seq,
                                 1 if r["flag"] & 0x10 else 0, r["cigar"])
        pos_l.append(packed)
        span_l.append(span)
        tc_l.append(tc)
    return (np.asarray(pos_l, dtype=np.int64),
            np.asarray(span_l, dtype=np.int32),
            np.asarray(tc_l, dtype=np.int32))


def cmd_cluster(args) -> int:
    from parasuite_tpu_torch import native
    from parasuite_tpu_torch.index import PackedReference
    from parasuite_tpu_torch.pipeline.clusters import (call_clusters,
                                                       write_clusters)

    cfg = _cfg_from_args(args)
    ref = PackedReference.load(args.index_prefix)
    sam = args.sam
    is_bam = str(sam).endswith(".bam")
    if native.available():
        # streaming C++ scan; BAM input streams BGZF-decompressed records
        # straight into the scanner
        if is_bam:
            pos, span, tc, _skipped = native.bam_cluster_columns(sam, ref)
        else:
            pos, span, tc, _skipped = native.sam_cluster_columns(sam, ref)
    elif is_bam:
        # fallback: decode to a temp SAM in a writable dir, always cleaned
        import tempfile

        from parasuite_tpu_torch.io.bam import bam_to_sam

        with tempfile.NamedTemporaryFile(suffix=".sam", delete=False) as tf:
            tmp = tf.name
        try:
            bam_to_sam(sam, tmp)
            pos, span, tc = cluster_columns_python(tmp, ref)
        finally:
            Path(tmp).unlink(missing_ok=True)
    else:
        pos, span, tc = cluster_columns_python(sam, ref)
    clusters = call_clusters(ref, pos, span, tc, cfg)
    write_clusters(args.out, clusters)
    print(json.dumps({"tool": "cluster", "alignments": int(pos.shape[0]),
                      "clusters": len(clusters)}))
    return 0


def cmd_dist_align(args) -> int:
    """One host's shard of a multi-host run.

    Two modes:
      * file-side (default): independent per-host process, count matrices
        merged by merge-shards (parallel.multihost);
      * --coordinator HOST:PORT --num-processes N --process-id I: one
        process of a torch.distributed group, profile counts summed in-step
        across processes by all_reduce (parallel.distributed; NCCL when
        every process has a card of its own, gloo otherwise). Shard and
        manifest layout is identical, so merge-shards works on either
        mode's output.
    """
    cfg = _cfg_from_args(args)
    log = _run_log(args)
    if args.coordinator:
        if args.num_processes is None or args.process_id is None:
            print("dist-align: --coordinator needs --num-processes and "
                  "--process-id", file=sys.stderr)
            return 2
        import torch.distributed as dist

        from parasuite_tpu_torch.ops.compiled import launch_counts
        from parasuite_tpu_torch.parallel.distributed import (
            initialize, run_distributed_host)

        args.device = str(initialize(args.coordinator, args.num_processes,
                                     args.process_id, args.device))
        engine = _load_engine(args, cfg)
        n, _counts, n_prof, secs = run_distributed_host(
            engine, args.fastq, args.out_prefix, log=log)
        backend = dist.get_backend()
        dist.destroy_process_group()
        print(json.dumps({"tool": "dist-align", "host": args.process_id,
                          "n_hosts": args.num_processes, "records": n,
                          "profiled": n_prof, "mode": "torch.distributed",
                          "backend": backend, "device": str(engine.device),
                          "launches": launch_counts(),
                          "seconds": round(secs, 3),
                          "reads_per_second": round(n / max(secs, 1e-9), 1)}))
        return 0
    if args.host_index is None or args.n_hosts is None:
        print("dist-align: --host-index/--n-hosts required (or --coordinator "
              "--num-processes --process-id for torch.distributed mode)",
              file=sys.stderr)
        return 2
    from parasuite_tpu_torch.parallel.multihost import run_host_shard

    engine = _load_engine(args, cfg)
    n, _counts, n_prof = run_host_shard(
        engine, args.fastq, args.out_prefix, args.host_index, args.n_hosts,
        resume=args.resume, log=log)
    log.write_spans()
    print(json.dumps({"tool": "dist-align", "host": args.host_index,
                      "n_hosts": args.n_hosts, "records": n,
                      "profiled": n_prof, "device": str(engine.device)}))
    return 0


def cmd_merge_shards(args) -> int:
    from parasuite_tpu_torch.index import PackedReference
    from parasuite_tpu_torch.parallel.multihost import merge_host_outputs

    ref = PackedReference.load(args.index_prefix)
    n, profile = merge_host_outputs(
        ref, args.out_prefix, args.out, args.n_hosts,
        profile_out=args.profile_out, command_line=_command_line(args))
    print(json.dumps({"tool": "merge-shards", "records": n,
                      "profiled": profile.n_reads if profile else 0}))
    return 0


def cmd_combine(args) -> int:
    from parasuite_tpu_torch.pipeline.combined import build_combined_index

    cfg = _cfg_from_args(args)
    meta = build_combined_index(args.fasta, args.annotation, args.out_prefix,
                                cfg)
    print(json.dumps({"tool": "combine", **meta}))
    return 0


def _add_run_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--resume", action="store_true",
                   help="resume from <out>.progress.json checkpoint")
    p.add_argument("--log", help="append per-batch JSONL stats here, and "
                   "at the end each stage's span of each batch")
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

    p = sub.add_parser("combine",
                       help="build combined genome+transcriptome index")
    p.add_argument("fasta")
    p.add_argument("annotation", help="exon table (BED12-like TSV) or GTF")
    p.add_argument("out_prefix")
    _add_cfg_flags(p)
    p.set_defaults(fn=cmd_combine)

    p = sub.add_parser("align", help="align FASTQ -> SAM/BAM")
    p.add_argument("index_prefix")
    p.add_argument("fastq")
    p.add_argument("out")
    p.add_argument("--profile", help=".errorprofile for profile-aware scoring")
    p.add_argument("--xa", action="store_true",
                   help="emit XA:Z alternative-hit tags (slower)")
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

    p = sub.add_parser("simulate", help="simulate PAR-CLIP reads")
    p.add_argument("index_prefix")
    p.add_argument("out")
    p.add_argument("--n-reads", dest="n_reads", type=int, default=10000)
    p.add_argument("--read-len", dest="read_len", type=int, default=50)
    p.add_argument("--tc-rate", dest="tc_rate", type=float, default=None)
    p.add_argument("--profile", help="errorprofile for error injection")
    p.add_argument("--ins-rate", dest="ins_rate", type=float, default=None,
                   help="per-cycle insertion probability (one event max/read)")
    p.add_argument("--del-rate", dest="del_rate", type=float, default=None,
                   help="per-cycle deletion probability (one event max/read)")
    p.add_argument("--learned-indels", dest="learned_indels",
                   action="store_true",
                   help="with --profile: draw indels from its learned "
                        "per-cycle rates")
    p.add_argument("--flat-qual", dest="flat_qual", action="store_true",
                   help="emit constant 'I' quality strings instead of the "
                        "decay-model per-cycle qualities")
    _add_cfg_flags(p)
    p.set_defaults(fn=cmd_simulate)

    p = sub.add_parser("benchmark",
                       help="simulate+align, report accuracy & speed")
    p.add_argument("index_prefix")
    p.add_argument("--scaling", help="comma-separated device counts for a "
                   "weak-scaling efficiency report (config 5); more than "
                   "the machine has is an error")
    p.add_argument("--n-reads", dest="n_reads", type=int, default=10000)
    p.add_argument("--read-len", dest="read_len", type=int, default=50)
    p.add_argument("--tc-rate", dest="tc_rate", type=float, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device for the align step (default cuda; "
                        "cpu runs the kernels' plain PyTorch versions)")
    _add_cfg_flags(p)
    p.set_defaults(fn=cmd_benchmark)

    p = sub.add_parser("cluster", help="call binding-site clusters from SAM")
    p.add_argument("index_prefix")
    p.add_argument("sam")
    p.add_argument("out")
    p.add_argument("--cluster-min-reads", dest="cluster_min_reads", type=int)
    _add_cfg_flags(p)
    p.set_defaults(fn=cmd_cluster)

    p = sub.add_parser("dist-align", help="align one host's shard "
                       "(multi-host round-robin batches)")
    p.add_argument("index_prefix")
    p.add_argument("fastq")
    p.add_argument("out_prefix")
    p.add_argument("--host-index", dest="host_index", type=int)
    p.add_argument("--n-hosts", dest="n_hosts", type=int)
    p.add_argument("--coordinator", help="torch.distributed coordinator "
                   "HOST:PORT (one process per device, counts summed "
                   "in-step)")
    p.add_argument("--num-processes", dest="num_processes", type=int)
    p.add_argument("--process-id", dest="process_id", type=int)
    p.add_argument("--profile", help=".errorprofile for profile-aware scoring")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--log")
    p.add_argument("--device", default="cuda",
                   help="torch device for the align step (default cuda; "
                        "cpu runs the kernels' plain PyTorch versions)")
    _add_cfg_flags(p)
    p.set_defaults(fn=cmd_dist_align)

    p = sub.add_parser("merge-shards", help="merge per-host SAM shards + "
                       "profile counts deterministically")
    p.add_argument("index_prefix")
    p.add_argument("out_prefix")
    p.add_argument("out")
    p.add_argument("--n-hosts", dest="n_hosts", type=int, required=True)
    p.add_argument("--profile-out", dest="profile_out")
    p.add_argument("--pg-cl", dest="pg_cl", default=None,
                   help="override the @PG CL: value (pin it so merges at "
                   "different host counts are byte-identical)")
    _add_cfg_flags(p)
    p.set_defaults(fn=cmd_merge_shards)

    p = sub.add_parser("sort", help="coordinate-sort SAM/BAM (unmapped last)")
    p.add_argument("infile")
    p.add_argument("out")
    p.add_argument("--min-mapq", dest="min_mapq", type=int, default=0,
                   help="drop mapped records with MAPQ below this")
    p.add_argument("--mapped-only", dest="mapped_only", action="store_true",
                   help="drop unmapped records")
    p.add_argument("--max-in-memory", dest="max_in_memory", type=int,
                   default=4_000_000,
                   help="records sorted in RAM before spilling runs to "
                        "disk (the C++ path holds ~130 B/record; raise on "
                        "big-RAM hosts to skip the spill/merge pass)")
    p.set_defaults(fn=cmd_sort)

    p = sub.add_parser("convert", help="SAM <-> BAM (direction by extension)")
    p.add_argument("infile")
    p.add_argument("out")
    p.set_defaults(fn=cmd_convert)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
