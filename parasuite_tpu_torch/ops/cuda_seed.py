"""Seeding and candidate selection: the plain PyTorch versions and the
Hopper kernel.

Replaces parasuite_tpu/ops/pallas_seed.py::_select_kernel (launched by
select_candidates_pallas) and, on the main path, the seeding before it.
Contract: parasuite_tpu/ops/aligner.py seed_diagonals, then select_candidates
— per oriented read, the top C unique diagonals by (votes desc, diag asc),
votes = number of seeds on the same diagonal.

The main path calls seed_select (through aligner.resolve_select_fn): on CUDA
tensors one launch of the kernel, which builds each oriented read's row of
S * M diagonals itself from the read's codes, its length and the k-mer
index (DeviceIndex.bucket_starts, .positions) and selects from it, so the
row never exists in device memory; on CPU tensors seed_select_plain, the
plain seed_diagonals and select_candidates_plain. select_candidates takes
rows of diagonals made elsewhere (chip_smoke.py's kernel table, the width
tests) into the same kernel.

Kernel (csrc/select_candidates.cu): one warp per oriented read, the row in
registers. The row's n diagonals are padded with I32MAX to n_pad, a power of
two from 32 to 1,024, and each lane holds E = n_pad / 32 of them (the kernel
is a template on E and on where the row comes from). Seeded, lane s makes
seed s (its offset, the k-mer's code, the bucket's start and count) and the
lanes take each seed's occurrences from the index by warp shuffles. A
bitonic network whose compare-exchanges are all ascending sorts the row:
pairs inside a lane are a min and a max between two registers, pairs across
lanes one warp shuffle per entry, every index a constant after unrolling.
Run starts come from neighbour compares, run lengths (the votes) from a
suffix minimum of run-start positions inside the lane and over lanes, as in
the plain version below. Each of the C rounds is one warp-wide minimum of
every lane's best -votes; the lowest lane that holds it owns the smallest
such diagonal (the row is in diagonal order), and only that lane rescans its
registers. Rows wider than 1,024 (n_pad 2,048 and 4,096, e.g. 17 seeds x 64
occurrences) take a second template of the same source: one block per row,
the row in shared memory, the same network with a barrier between stages,
votes by a binary search for each run's end, and the top C by C block-wide
minima of one int32 key per entry. Past 4,096 the wrapper raises, and
AlignerEngine refuses such a config when it is built (check_row_width).

What bounds it on the H100: the function is bound by bytes — seeded, a row
is the read's codes (4 * L bytes), S bucket pairs and the filled positions
(at most 4 * S * M bytes) read and 5 * C bytes written; from a row of
diagonals, n * 4 bytes (448 B at 7 seeds x 16 occurrences) read once. A
comparison sort of the row needs only about n * log2(n) compares. The
kernel spends more than that in instructions: n_pad/2 * log2(n_pad) *
(log2(n_pad) + 1) / 2 compare-exchanges per row (1,792 at n_pad = 128) on
the int32 pipe and the shuffle unit. The design keeps them cheap: no shared
memory, no barrier, no 64-bit key.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from parasuite_tpu_torch.config import AlignConfig
from parasuite_tpu_torch.ops.device_index import DeviceIndex

I32MAX = int(np.iinfo(np.int32).max)
MAX_PAD = 4096   # widest row the kernel is built for (shared-memory path)

launches = 0         # kernel launches through select_candidates
seeded_launches = 0  # kernel launches through seed_select


def seed_diagonals(oriented: torch.Tensor, lengths: torch.Tensor,
                   didx: DeviceIndex, cfg: AlignConfig) -> torch.Tensor:
    """[B, 2, L] -> candidate diagonals int32 [B*2, max_seeds*max_occ]
    (I32MAX = invalid). Seeds sit at offsets s * seed_stride_for(len) per
    read (adaptive) or s * stride (fixed); k-mers containing N, absent from
    the index, or with more than max_occ occurrences are skipped."""
    B, _, L = oriented.shape
    dev = oriented.device
    k, S, M = cfg.kmer_size, cfg.max_seeds, cfg.max_occ
    reads2 = oriented.reshape(B * 2, L)
    len2 = lengths[:, None].expand(B, 2).reshape(-1)
    # 4^(k-1-q) for q < k, from arange on the device (no host data)
    pow4 = torch.ones(k, dtype=torch.int32, device=dev) << (
        2 * torch.arange(k - 1, -1, -1, dtype=torch.int32, device=dev))
    j = torch.arange(M, dtype=torch.int32, device=dev)
    n_pos = didx.positions.shape[0]

    adaptive = cfg.seed_placement == "adaptive" and S > 1
    if adaptive:
        stride2 = torch.clamp(
            torch.div(len2 - k, S - 1, rounding_mode="floor"), min=1)
        r32 = torch.nn.functional.pad(reads2, (0, k), value=4)
        code_all = torch.zeros_like(reads2)
        nflag_all = torch.zeros_like(reads2, dtype=torch.bool)
        for q in range(k):
            c = r32[:, q : q + L]
            nflag_all = nflag_all | (c == 4)
            code_all = code_all + torch.where(c == 4, 0, c) * pow4[q]

    chunks = []
    for s in range(S):
        if adaptive:
            off = torch.clamp(s * stride2, max=L - 1)
            oc = off[:, None].long()
            code = code_all.gather(1, oc)[:, 0]
            has_n = nflag_all.gather(1, oc)[:, 0]
        else:
            off = s * cfg.stride
            win = reads2[:, off : off + k]
            has_n = (win == 4).any(dim=1)
            code = (torch.where(win == 4, 0, win) * pow4[None, :]).sum(
                dim=1, dtype=torch.int32)
        fits = (off + k) <= len2
        code = torch.where(has_n, 0, code).long()
        lo = didx.bucket_starts[code]
        cnt = didx.bucket_starts[code + 1] - lo
        ok = fits & ~has_n & (cnt > 0) & (cnt <= M)
        valid = ok[:, None] & (j[None, :] < cnt[:, None])
        idx = torch.clamp(lo[:, None] + j[None, :], 0, max(n_pos - 1, 0))
        pos = didx.positions[idx.long()]
        off_b = off[:, None] if adaptive else off
        chunks.append(torch.where(valid, pos - off_b, I32MAX))
    return torch.cat(chunks, dim=1)


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


def _padded_width(fn: str, n: int, cfg: AlignConfig) -> int:
    """The kernel's row width for rows of n entries: the power of two from
    32 up that holds them. Raises where the kernel takes no such row."""
    C = cfg.max_candidates
    if n < C:
        raise ValueError(f"{fn}: n={n} diagonals per row is fewer than "
                         f"max_candidates={C}")
    n_pad = 32
    while n_pad < n:
        n_pad *= 2
    if n_pad > MAX_PAD:
        raise ValueError(f"{fn}: n={n} exceeds the kernel's widest row of "
                         f"{MAX_PAD} entries")
    return n_pad


def _outputs(rows: int, cfg: AlignConfig, device):
    C = cfg.max_candidates
    return (torch.empty((rows, C), dtype=torch.int32, device=device),
            torch.empty((rows, C), dtype=torch.bool, device=device))


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
    n_pad = _padded_width("select_candidates", n, cfg)
    cand, valid = _outputs(rows, cfg, diags.device)
    if rows == 0:
        return cand, valid
    from parasuite_tpu_torch.ops._build import load

    err = load().ps_select_candidates(
        ctypes.c_void_p(diags.data_ptr()), rows, n, n_pad,
        cfg.max_candidates,
        ctypes.c_void_p(cand.data_ptr()), ctypes.c_void_p(valid.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream(diags.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"select_candidates kernel launch failed: CUDA "
                           f"error {err}")
    global launches
    launches += 1
    return cand, valid


def seed_select_plain(oriented: torch.Tensor, lengths: torch.Tensor,
                      didx: DeviceIndex, cfg: AlignConfig):
    """seed_diagonals, then select_candidates_plain: the plain version of
    seed_select, on any device."""
    return select_candidates_plain(
        seed_diagonals(oriented, lengths, didx, cfg), cfg)


def seed_select(oriented: torch.Tensor, lengths: torch.Tensor,
                didx: DeviceIndex, cfg: AlignConfig):
    """Oriented reads int32 [B, 2, L] and their lengths int32 [B] ->
    (cand_diag int32 [2B, C], cand_valid bool [2B, C]), equal to
    select_candidates(seed_diagonals(...)).

    CPU tensors take the plain version; CUDA tensors launch the kernel with
    the row source that seeds, so the step allocates the outputs alone."""
    dev = oriented.device
    if dev.type == "cpu":
        return seed_select_plain(oriented, lengths, didx, cfg)
    if dev.type != "cuda":
        raise ValueError(f"seed_select: unsupported device {dev}")
    if oriented.dtype != torch.int32 or oriented.dim() != 3 or \
            oriented.shape[1] != 2:
        raise ValueError("seed_select: oriented must be int32 [B, 2, L]")
    B, _, L = oriented.shape
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,):
        raise ValueError("seed_select: lengths must be int32 [B]")
    k, S, M = cfg.kmer_size, cfg.max_seeds, cfg.max_occ
    bucket_starts, positions = didx.bucket_starts, didx.positions
    if bucket_starts.dtype != torch.int32 or positions.dtype != torch.int32:
        raise ValueError("seed_select: the index must be int32")
    if not 1 <= k <= 15 or bucket_starts.shape != (4 ** k + 1,):
        raise ValueError(f"seed_select: bucket_starts must be int32 "
                         f"[4^k + 1] for k={k} (k-mer codes in int32)")
    if positions.numel() > I32MAX:
        raise ValueError("seed_select: more k-mer positions than int32 "
                         "indexes")
    tensors = (oriented, lengths, bucket_starts, positions)
    if any(t.device != dev for t in tensors):
        raise ValueError("seed_select: inputs on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("seed_select: inputs must be contiguous")
    n_pad = _padded_width("seed_select", S * M, cfg)
    rows = 2 * B
    cand, valid = _outputs(rows, cfg, dev)
    if rows == 0:
        return cand, valid
    from parasuite_tpu_torch.ops._build import load

    adaptive = cfg.seed_placement == "adaptive" and S > 1
    err = load().ps_seed_select(
        *(ctypes.c_void_p(t.data_ptr()) for t in tensors), rows, L, k, S, M,
        cfg.stride, int(adaptive), n_pad, cfg.max_candidates,
        ctypes.c_void_p(cand.data_ptr()), ctypes.c_void_p(valid.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"seed_select kernel launch failed: CUDA error "
                           f"{err}")
    global seeded_launches
    seeded_launches += 1
    return cand, valid
