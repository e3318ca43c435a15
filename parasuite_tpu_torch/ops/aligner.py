"""Batch aligner on tensors: orient -> seed -> select -> extend -> finalize.

Counterpart of parasuite_tpu/ops/aligner.py (align_batch and its stages),
bit-equal to it on the same inputs: integer-only scoring, identical clips and
tie-breaks. The TPU-specific formulations of the reference (3-bit funnel
shift for the reverse complement, 16-wide row gathers for seed positions,
3-bit packed reference words for the NM window) are plain gathers here; they
give the same values.

Candidate selection and extension go through the wrappers in cuda_seed.py
and cuda_extend.py: the Hopper kernels for CUDA tensors, the plain PyTorch
versions for CPU tensors. Nothing here synchronises with the device, so a
caller can keep several batches in flight.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from parasuite_tpu.config import AlignConfig
from parasuite_tpu_torch.ops.cuda_extend import NEG, extend_candidates
from parasuite_tpu_torch.ops.cuda_seed import I32MAX, select_candidates
from parasuite_tpu_torch.ops.device_index import DeviceIndex, ScoreParams

_COMP = (3, 2, 1, 0, 4)


class AlignResult(NamedTuple):
    """Per-read alignment outputs (all [B])."""

    mapped: torch.Tensor      # bool
    strand: torch.Tensor      # int32 0/1
    pos: torch.Tensor         # int32 packed start (ungapped key position)
    score: torch.Tensor       # int32 DP score
    mapq: torch.Tensor        # int32
    x0: torch.Tensor          # int32 best-score hit count
    x1: torch.Tensor          # int32 suboptimal hit count
    ug_equal: torch.Tensor    # bool: gapless fast path valid
    nm: torch.Tensor          # int32 ungapped NM (valid iff ug_equal)
    diag: torch.Tensor        # int32 winning candidate diagonal
    n_candidates: torch.Tensor  # int32 candidates extended
    tc_count: torch.Tensor    # int32 machine-frame T->C (valid iff ug_equal)


def comp_table(device) -> torch.Tensor:
    return torch.tensor(_COMP, dtype=torch.int32, device=device)


def repeat_each(x: torch.Tensor, n: int) -> torch.Tensor:
    """[B] -> [B*n], each element n times in a row (jnp.repeat)."""
    return x[:, None].expand(x.shape[0], n).reshape(-1)


# ---------------------------------------------------------------------------
# stage 1: orientation
# ---------------------------------------------------------------------------

def orient_reads(codes: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """[B, L] machine-frame codes -> int32 [B, 2, L] (forward, revcomp).

    rc[i] = comp(fwd[len-1-i]) for i < len, else N (4)."""
    c32 = codes.to(torch.int32)
    B, L = c32.shape
    i = torch.arange(L, dtype=torch.int32, device=codes.device)
    src = torch.clamp(lengths[:, None] - 1 - i[None, :], 0, L - 1)
    rc = comp_table(codes.device)[c32.gather(1, src.long()).long()]
    rc = torch.where(i[None, :] < lengths[:, None], rc, 4)
    return torch.stack([c32, rc], dim=1)


# ---------------------------------------------------------------------------
# stage 2: seeding
# ---------------------------------------------------------------------------

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
    len2 = repeat_each(lengths, 2)
    pow4 = torch.tensor([4 ** (k - 1 - q) for q in range(k)],
                        dtype=torch.int32, device=dev)
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


# ---------------------------------------------------------------------------
# stage 5: finalize
# ---------------------------------------------------------------------------

def finalize(oriented, lengths, min_scores, cand_diag, cand_valid,
             dp_score, dp_j, ug_score, ug_j, didx: DeviceIndex,
             sprof: ScoreParams, cfg: AlignConfig) -> AlignResult:
    """Dedupe, select, count hits, MAPQ, boundary policy, ungapped NM.
    Inputs at [B2, C]; outputs at [B]."""
    B = oriented.shape[0]
    L = oriented.shape[2]
    C = cand_diag.shape[1]
    n = 2 * C
    W = cfg.band_width
    G = didx.ref_seq.shape[0]

    def per_read(x):
        return x.reshape(B, n)

    diag = per_read(torch.clamp(cand_diag, -(L + 2 * W + 1), G))
    valid0 = per_read(cand_valid)
    dps = per_read(dp_score)
    dpj = per_read(dp_j)
    ugs = per_read(ug_score)
    ugj = per_read(ug_j)
    strand = repeat_each(torch.arange(2, dtype=torch.int32,
                                      device=oriented.device), C)
    strand = strand[None, :].expand(B, n)

    ug_eq = ugs == dps
    j_sel = torch.where(ug_eq, ugj, dpj)
    pos_key = diag - W + j_sel
    valid = valid0 & (dps >= min_scores[:, None])
    n_candidates = valid0.sum(dim=1, dtype=torch.int32)
    return finalize_core(oriented, lengths, valid, strand, pos_key, dps,
                         ug_eq, diag, n_candidates, didx, sprof, cfg)[0]


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True per row, 0 for an all-False row (argmax)."""
    n = mask.shape[1]
    idx = torch.arange(n, dtype=torch.int32, device=mask.device)
    first = torch.where(mask, idx[None, :], n).amin(dim=1)
    return torch.where(first == n, 0, first)


def finalize_core(oriented, lengths, valid, strand, pos_key, dps, ug_eq,
                  diag, n_candidates, didx: DeviceIndex, sprof: ScoreParams,
                  cfg: AlignConfig):
    """Selection half of finalize over per-entry [B, n] arrays.
    -> (AlignResult, best_idx [B] int32)."""
    B, n = valid.shape
    L = oriented.shape[2]
    G = didx.ref_seq.shape[0]
    dev = oriented.device

    # dedupe by (strand, pos_key): an entry is a duplicate if a strictly
    # better twin exists — higher score, or equal score and lower index
    same = (strand[:, :, None] == strand[:, None, :]) & \
           (pos_key[:, :, None] == pos_key[:, None, :])
    ar = torch.arange(n, device=dev)
    tie = (ar[None, :] < ar[:, None])[None]
    better = (dps[:, None, :] > dps[:, :, None]) | \
             ((dps[:, None, :] == dps[:, :, None]) & tie)
    dup = (same & better & valid[:, None, :]).any(dim=2)
    uv = valid & ~dup

    best_score = torch.where(uv, dps, NEG).amax(dim=1)
    at_best = uv & (dps == best_score[:, None])
    best_strand = torch.where(at_best, strand, 2).amin(dim=1)
    at_bs = at_best & (strand == best_strand[:, None])
    best_pos = torch.where(at_bs, pos_key, I32MAX).amin(dim=1)
    chosen = at_bs & (pos_key == best_pos[:, None])
    best_idx = _first_true(chosen)

    has = uv.any(dim=1)
    x0 = at_best.sum(dim=1, dtype=torch.int32)
    x1 = (uv & (dps < best_score[:, None])).sum(dim=1, dtype=torch.int32)
    mapq = torch.where(
        x0 > 1, 0,
        torch.where(x1 == 0, 37,
                    torch.clamp(23 - sprof.mapq_sub[
                        torch.clamp(x1, 0, 255).long()], min=0)))

    bi = best_idx[:, None].long()

    def pick(x):
        return x.gather(1, bi)[:, 0]

    sel_strand = pick(strand)
    sel_pos = pick(pos_key)
    sel_diag = pick(diag)
    sel_ug_eq = pick(ug_eq)
    sel_score = pick(dps)

    # chromosome-boundary policy (oracle: whole ungapped span in one chrom)
    ci = torch.clamp(
        torch.searchsorted(didx.chrom_starts, sel_pos.contiguous(),
                           right=True) - 1,
        0, didx.chrom_starts.shape[0] - 1)
    within = (sel_pos >= didx.chrom_starts[ci]) & \
             (sel_pos + lengths - 1 < didx.chrom_ends[ci]) & (lengths > 0)
    mapped = has & within

    # ungapped NM and machine-frame T->C over the selected window
    i = torch.arange(L, dtype=torch.int32, device=dev)
    ridx = sel_pos[:, None] + i[None, :]
    inr = (ridx >= 0) & (ridx < G)
    rb = torch.where(inr, didx.ref_seq[torch.clamp(ridx, 0, G - 1).long()]
                     .to(torch.int32), 4)
    sel_read = oriented.gather(
        1, sel_strand.long()[:, None, None].expand(B, 1, L))[:, 0]
    mm = (rb != sel_read) | (rb == 4) | (sel_read == 4)
    in_len = i[None, :] < lengths[:, None]
    nm = (in_len & mm).sum(dim=1, dtype=torch.int32)
    tc_hit = torch.where(sel_strand[:, None] == 1,
                         (rb == 0) & (sel_read == 2),
                         (rb == 3) & (sel_read == 1))
    tc = (in_len & tc_hit).sum(dim=1, dtype=torch.int32)

    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return AlignResult(
        mapped=mapped,
        strand=torch.where(mapped, sel_strand, zero),
        pos=torch.where(mapped, sel_pos, -1),
        score=torch.where(mapped, sel_score, NEG),
        mapq=torch.where(mapped, mapq, zero).to(torch.int32),
        x0=torch.where(mapped, x0, zero),
        x1=torch.where(mapped, x1, zero),
        ug_equal=torch.where(mapped, sel_ug_eq, True),
        nm=torch.where(mapped, nm, zero),
        diag=torch.where(mapped, sel_diag, zero),
        n_candidates=n_candidates,
        tc_count=torch.where(mapped & sel_ug_eq, tc, zero),
    ), best_idx


# ---------------------------------------------------------------------------
# full pipeline
# ---------------------------------------------------------------------------

def align_batch(didx: DeviceIndex, sprof: ScoreParams, codes: torch.Tensor,
                lengths: torch.Tensor, min_scores: torch.Tensor,
                cfg: AlignConfig) -> AlignResult:
    """End-to-end batch alignment; every input on didx's device."""
    oriented = orient_reads(codes, lengths)
    diags = seed_diagonals(oriented, lengths, didx, cfg)
    cand_diag, cand_valid = select_candidates(diags, cfg)
    dp_score, dp_j, ug_score, ug_j = extend_candidates(
        oriented, lengths, cand_diag, didx, sprof, cfg)
    return finalize(oriented, lengths, min_scores, cand_diag, cand_valid,
                    dp_score, dp_j, ug_score, ug_j, didx, sprof, cfg)
