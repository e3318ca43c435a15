#!/usr/bin/env python3
"""The extend kernel against another source of the same C entry point, in
turns on one card, at the three shapes the main path gives it.

    python tools/torch_extend_turns.py --other OTHER.cu [--reps 20]

OTHER.cu is a source with csrc/extend_candidates.cu's C interface
(ps_extend_candidates), for example an earlier design of it. It is built
with the repo's nvcc flags into a temporary library beside the repo's own
(parasuite_tpu_torch/build/), and both are called through the same ctypes
call on the same inputs. The inputs are the main path's, made from the
bench world's seeds (tools/_torch_bench.py): the first 16,384 and all
65,536 reads of draw_reads(seed 2) at 50 bp on the bench reference, and the
rescue pass's shape, the first 2,048 of the 36 bp reads of chip_smoke.py's
rescue phase (seed 3, 3% substitutions) through the k = 11 rescue index.
Candidates come from the select kernel.

Per shape, both kernels must equal the plain version (tolerance 0); then,
in the order other, repo, repo, other: the median ms of `reps` calls timed
one by one by CUDA events, as chip_smoke.py times a kernel (the host's
enqueue of the call, its allocations and the ctypes call, falls inside the
events when the card is idle), and the median of 5 runs of BACK_TO_BACK
calls in a row, per call (the card's own time: the host enqueues ahead),
beside chip_smoke.py's extend_bound. One JSON line a shape, after the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

import _torch_bench as tb

sys.path.insert(0, str(tb.REPO))
import chip_smoke  # noqa: E402

BACK_TO_BACK = 20


def build_other(src: Path, out_dir: Path) -> ctypes.CDLL:
    from parasuite_tpu_torch.ops import _build

    lib = out_dir / "other.so"
    subprocess.run([_build.nvcc_path(), *_build.FLAGS, "-shared", "-o",
                    str(lib), str(src)], check=True, capture_output=True,
                   timeout=900)
    dll = ctypes.CDLL(str(lib))
    dll.ps_extend_candidates.restype = ctypes.c_int
    dll.ps_extend_candidates.argtypes = ([ctypes.c_void_p] * 6
                                         + [ctypes.c_int] * 7
                                         + [ctypes.c_void_p] * 5)
    return dll


def call(lib, oriented, lengths, cand, didx, sprof, cfg):
    """ps_extend_candidates of `lib` as ops/cuda_extend.py calls it."""
    import torch

    B2, C = cand.shape
    outs = [torch.empty((B2, C), dtype=torch.int32, device=oriented.device)
            for _ in range(4)]
    ptr = [ctypes.c_void_p(x.data_ptr())
           for x in (oriented, lengths, cand, didx.ref_seq, sprof.s_fwd,
                     sprof.s_comp, *outs)]
    err = lib.ps_extend_candidates(
        *ptr[:6], didx.ref_seq.shape[0], B2, C, oriented.shape[2],
        cfg.band_width, cfg.gap_open, cfg.gap_extend, *ptr[6:],
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"ps_extend_candidates: CUDA error {err}")
    return outs


def stage_inputs(engine_parts, codes, lengths):
    """-> (oriented, lengths, candidates) on the card, as the step makes
    them."""
    import torch

    from parasuite_tpu_torch.ops import aligner, cuda_seed

    didx, cfg = engine_parts
    c = torch.from_numpy(codes).cuda()
    ln = torch.from_numpy(lengths.astype(np.int32)).cuda()
    o = aligner.orient_reads(c, ln)
    cand, _ = cuda_seed.select_candidates(
        aligner.seed_diagonals(o, ln, didx, cfg), cfg)
    return o, ln, cand


def main(argv=None) -> int:
    import torch

    from parasuite_tpu_torch.ops import _build, cuda_extend
    from parasuite_tpu_torch.pipeline.align import AlignerEngine

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_extend_turns: needs an NVIDIA GPU")
    gpu = tb.gpu_line()
    print(gpu, flush=True)
    repo_lib = _build.load()
    tmp = tempfile.TemporaryDirectory(dir=_build.BUILD)
    other_lib = build_other(args.other, Path(tmp.name))

    cfg = tb.make_cfg()
    ref, index, engine = tb.build_state(cfg, tb.REF_LEN)
    chrom = tb.bench_chrom()
    reads, _, _ = tb.draw_reads(chrom, tb.BATCH, tb.READ_LEN, 2)
    full = np.full(tb.BATCH, tb.READ_LEN, dtype=np.int32)
    rcfg = cfg.replace(max_read_len=chip_smoke.RESCUE_LEN,
                       batch_size=chip_smoke.RESCUE_BATCH, rescue_kmer=11)
    reng = AlignerEngine(ref, index, rcfg, device="cuda")
    cfg2, didx2, cap = reng._rescue
    rreads, _, _ = tb.draw_reads(chrom, chip_smoke.N_MODE_READS,
                                 chip_smoke.RESCUE_LEN, 3, sub_rate=0.03)
    shapes = {
        "16384": (engine.didx, engine.sprof, cfg, reads[:chip_smoke.N_PIN],
                  full[:chip_smoke.N_PIN]),
        "65536": (engine.didx, engine.sprof, cfg, reads, full),
        "rescue": (didx2, reng.sprof, cfg2, rreads[:cap],
                   np.full(cap, chip_smoke.RESCUE_LEN, dtype=np.int32)),
    }
    libs = {"other": other_lib, "repo": repo_lib}
    for name, (didx, sprof, c, codes, lengths) in shapes.items():
        o, ln, cand = stage_inputs((didx, c), codes, lengths)
        want = cuda_extend.extend_candidates_plain(o, ln, cand, didx, sprof,
                                                   c)
        for who, lib in libs.items():
            got = call(lib, o, ln, cand, didx, sprof, c)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{who} differs from plain at {name}")
        del want
        turns, b2b = [], []
        for who in ("other", "repo", "repo", "other"):
            def one():
                return call(libs[who], o, ln, cand, didx, sprof, c)
            turns.append([who, chip_smoke._median_ms(one, reps=args.reps)])
            b2b.append([who, chip_smoke._median_ms(
                lambda: [one() for _ in range(BACK_TO_BACK)], reps=5)
                / BACK_TO_BACK])
        mean = {w: float(np.mean([ms for x, ms in turns if x == w]))
                for w in libs}
        mean_b2b = {w: float(np.mean([ms for x, ms in b2b if x == w]))
                    for w in libs}
        bound = chip_smoke.extend_bound(lengths, c.max_candidates,
                                        c.max_read_len, c.band_width,
                                        int(didx.ref_seq.shape[0]))
        print(json.dumps({
            "shape": name, "reads": int(codes.shape[0]),
            "pairs": int(cand.numel()), "max_abs_err": 0, "turns": turns,
            "other_ms": mean["other"], "repo_ms": mean["repo"],
            "other_over_repo": mean["other"] / mean["repo"],
            "back_to_back_turns": b2b,
            "other_ms_back_to_back": mean_b2b["other"],
            "repo_ms_back_to_back": mean_b2b["repo"],
            **{f"share_{w}": bound["bound_ms"] / mean[w] for w in libs},
            **{f"share_back_to_back_{w}": bound["bound_ms"] / mean_b2b[w]
               for w in libs},
            **{f"share_10_ops_{w}": bound["bound_ms_10_ops"] / mean[w]
               for w in libs},
            **bound, "gpu": gpu}), flush=True)
    tmp.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
