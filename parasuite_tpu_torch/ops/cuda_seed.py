"""Candidate selection: the plain PyTorch version and the Hopper kernel.

Replaces parasuite_tpu/ops/pallas_seed.py::_select_kernel (launched by
select_candidates_pallas). Contract: parasuite_tpu/ops/aligner.py
select_candidates — per oriented read, the top C unique diagonals by
(votes desc, diag asc), votes = number of seeds on the same diagonal.

Kernel (csrc/select_candidates.cu): one warp per oriented read, the row in
registers. The row's n diagonals are padded with I32MAX to n_pad, a power of
two from 32 to 1,024, and each lane holds E = n_pad / 32 of them (the kernel
is a template on E). A bitonic network whose compare-exchanges are all
ascending sorts the row: pairs inside a lane are a min and a max between two
registers, pairs across lanes one warp shuffle per entry, every index a
constant after unrolling. Run starts come from neighbour compares, run
lengths (the votes) from a suffix minimum of run-start positions inside the
lane and over lanes, as in the plain version below. Each of the C rounds is
one warp-wide minimum of every lane's best -votes; the lowest lane that
holds it owns the smallest such diagonal (the row is in diagonal order), and
only that lane rescans its registers. Rows wider than 1,024 (n_pad 2,048 and
4,096, e.g. 17 seeds x 64 occurrences) take a second template of the same
source: one block per row, the row in shared memory, the same network with
a barrier between stages, votes by a binary search for each run's end, and
the top C by C block-wide minima of one int32 key per entry. Past 4,096 the
wrapper raises, and AlignerEngine refuses such a config when it is built
(check_row_width).

What bounds it on the H100: the function is bound by bytes — a row is
n * 4 bytes (448 B at 7 seeds x 16 occurrences) read once and 5 * C bytes
written, 64 MB at 65,536 reads, and a comparison sort of the row needs only
about n * log2(n) compares. The kernel spends more than that in
instructions: n_pad/2 * log2(n_pad) * (log2(n_pad) + 1) / 2
compare-exchanges per row (1,792 at n_pad = 128) on the int32 pipe and the
shuffle unit. The design keeps them cheap: no shared memory, no barrier, no
division, no 64-bit key.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from parasuite_tpu_torch.config import AlignConfig

I32MAX = int(np.iinfo(np.int32).max)
MAX_PAD = 4096   # widest row the kernel is built for (shared-memory path)

launches = 0     # kernel launches through select_candidates


def select_candidates_plain(diags: torch.Tensor, cfg: AlignConfig):
    """Transcription of aligner.py select_candidates.

    The 2-key lax.sort becomes one sort of the packed int64 key
    (negv << 32) + (diag + 2^31), which orders exactly like the
    lexicographic (negv, diag) pair; equal keys are equal pairs, so no tie
    order is relied upon."""
    n = diags.shape[1]
    d = torch.sort(diags, dim=1).values
    t = torch.arange(n, dtype=torch.int32, device=diags.device)
    first = torch.cat([torch.ones_like(d[:, :1], dtype=torch.bool),
                       d[:, 1:] != d[:, :-1]], dim=1)
    fidx = torch.where(first, t[None, :], n)
    suffix_min = torch.flip(
        torch.cummin(torch.flip(fidx[:, 1:], [1]), dim=1).values, [1])
    next_first = torch.cat([suffix_min, torch.full_like(d[:, :1], n)], dim=1)
    votes = next_first - t[None, :]
    firstv = first & (d != I32MAX)
    negv = torch.where(firstv, -votes, 1)
    dd = torch.where(firstv, d, I32MAX)
    key = (negv.to(torch.int64) << 32) + (dd.to(torch.int64) + (1 << 31))
    ks = torch.sort(key, dim=1).values
    C = cfg.max_candidates
    negv_s = (ks >> 32)[:, :C]
    dd_s = ((ks & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)[:, :C]
    return dd_s, negv_s < 1


def row_width(cfg: AlignConfig) -> int:
    """Diagonals per row that seeding hands to select_candidates under cfg:
    max_seeds * max_occ, and in the rescue pass max(rescue_seeds,
    max_seeds) * max_occ."""
    seeds = (max(cfg.rescue_seeds, cfg.max_seeds) if cfg.rescue_kmer
             else cfg.max_seeds)
    return seeds * cfg.max_occ


def check_row_width(cfg: AlignConfig) -> None:
    """Raise ValueError, naming the flags, when cfg's rows are wider than
    the select kernel is built for."""
    n = row_width(cfg)
    if n > MAX_PAD:
        seeds = ("max(--rescue-seeds, --max-seeds)" if cfg.rescue_kmer
                 else "--max-seeds")
        raise ValueError(
            f"{seeds} x --max-occ = {n} diagonals per row; the select "
            f"kernel is built for rows of up to {MAX_PAD}: lower --max-occ "
            f"(now {cfg.max_occ}), --max-seeds (now {cfg.max_seeds})"
            + (f" or --rescue-seeds (now {cfg.rescue_seeds})"
               if cfg.rescue_kmer else ""))


def select_candidates(diags: torch.Tensor, cfg: AlignConfig):
    """-> (cand_diag int32 [B2, C], cand_valid bool [B2, C]).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if diags.device.type == "cpu":
        return select_candidates_plain(diags, cfg)
    if diags.device.type != "cuda":
        raise ValueError(f"select_candidates: unsupported device "
                         f"{diags.device}")
    if diags.dtype != torch.int32 or diags.dim() != 2:
        raise ValueError("select_candidates: diags must be int32 [B2, n]")
    if not diags.is_contiguous():
        raise ValueError("select_candidates: diags must be contiguous")
    rows, n = diags.shape
    C = cfg.max_candidates
    if n < C:
        raise ValueError(f"select_candidates: n={n} diagonals per row is "
                         f"fewer than max_candidates={C}")
    n_pad = 32
    while n_pad < n:
        n_pad *= 2
    if n_pad > MAX_PAD:
        raise ValueError(f"select_candidates: n={n} exceeds the kernel's "
                         f"widest row of {MAX_PAD} entries")
    cand = torch.empty((rows, C), dtype=torch.int32, device=diags.device)
    valid = torch.empty((rows, C), dtype=torch.bool, device=diags.device)
    if rows == 0:
        return cand, valid
    from parasuite_tpu_torch.ops._build import load

    err = load().ps_select_candidates(
        ctypes.c_void_p(diags.data_ptr()), rows, n, n_pad, C,
        ctypes.c_void_p(cand.data_ptr()), ctypes.c_void_p(valid.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream(diags.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"select_candidates kernel launch failed: CUDA "
                           f"error {err}")
    global launches
    launches += 1
    return cand, valid
