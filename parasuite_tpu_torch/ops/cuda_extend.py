"""Banded affine-gap extension: the plain PyTorch version and the kernel.

Replaces parasuite_tpu/ops/pallas_extend.py::_extend_kernel (launched by
extend_candidates_pallas). Contract: parasuite_tpu/ops/aligner.py
extend_candidates = oracle.banded_dp — banded glocal M/Ix/Iy DP over every
(oriented read, candidate diagonal) pair plus the running ungapped diagonal
sum; per pair (dp_score, dp_j, ug_score, ug_j), smallest j on ties.

Kernel (csrc/extend_candidates.cu, redesigned for the H100): one thread
per pair, the band width a template parameter, so every band index is
static. Iy is the sequential band walk Iy[j] = max(M[j-1] - go,
Iy[j-1] - ge), which in exact int32 equals the cummax form of the
reference.

What bounds it on the H100: integer instructions. With Hopper's DPX
instructions a cell takes six int32 operations: M = s + T, ug += s,
mg = M - go, Iy and the next row's Ix each one add-then-max
(__viaddmax_s32) on the same mg, and the next row's T = max(M, Ix, Iy) one
three-way max (__vimax3_s32) (chip_smoke.py extend_bound: 50 * 11 * 6 =
3,300 a pair at the bench config, 1,048,576 pairs per 65,536-read batch). Memory traffic is small:
L + 2W reference bytes a pair and one read row per oriented read.

What the design does about it: each input is staged once per block in
shared memory (a score row int32 [L, 5] per oriented read, built from its
read and the strand's table, so the C candidates share it and the DP loop
has no prof arithmetic; each pair's reference window copied by cp.async,
a warp's 32 windows in flight at once while the rows are built, with N
written outside [0, G), so the loop has no bounds test and no global
load); a register window of shared-memory offsets makes each substitution
one load with an immediate offset; the read loop is unrolled band-width
times, so the window's slide and the row-to-row state are register
renaming; each thread stops at its read's length, since steps past it
change neither M nor the ungapped sum.
"""

from __future__ import annotations

import ctypes

import torch

from parasuite_tpu_torch.config import AlignConfig
from parasuite_tpu_torch.ops.device_index import DeviceIndex, ScoreParams

NEG = -(1 << 28)

launches = 0     # kernel launches through extend_candidates


def _min_index(x: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """Smallest column index where x equals its row's best (explicit, so no
    reliance on argmax tie order)."""
    j = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    return torch.where(x == best[:, None], j[None, :], x.shape[1]).amin(1)


def extend_candidates_plain(oriented: torch.Tensor, lengths: torch.Tensor,
                            cand_diag: torch.Tensor, didx: DeviceIndex,
                            sprof: ScoreParams, cfg: AlignConfig):
    """Transcription of aligner.py extend_candidates (lax.scan -> loop).
    Holds [P, L, band] temporaries: size batches accordingly."""
    B, _, L = oriented.shape
    C = cand_diag.shape[1]
    W = cfg.band_width
    BAND = 2 * W + 1
    WIN = L + 2 * W
    G = didx.ref_seq.shape[0]
    B2 = B * 2
    P = B2 * C
    dev = oriented.device

    diag = torch.clamp(cand_diag, -(WIN + 1), G).reshape(P)
    base = diag - W
    t = torch.arange(WIN, dtype=torch.int32, device=dev)
    widx = base[:, None] + t[None, :]
    inr = (widx >= 0) & (widx < G)
    refwin = torch.where(inr, didx.ref_seq[torch.clamp(widx, 0, G - 1).long()]
                         .to(torch.int32), 4)

    reads2 = oriented.reshape(B2, L)
    pair = torch.arange(P, device=dev)
    pair_read = reads2[pair // C]                                   # [P, L]
    strand = ((pair // C) % 2).to(torch.int32)                      # [P]
    Lr = lengths[pair // (2 * C)]                                   # [P]

    i = torch.arange(L, dtype=torch.int32, device=dev)
    prof = torch.where(strand[:, None] == 0, i[None, :],
                       torch.clamp(Lr[:, None] - 1 - i[None, :], 0, L - 1))
    s_all = torch.stack([sprof.s_fwd, sprof.s_comp]).reshape(-1)
    jwin = (i[:, None] + torch.arange(BAND, dtype=torch.int32,
                                      device=dev)[None, :]).long()  # [L, BAND]
    rb = refwin[:, jwin]                                      # [P, L, BAND]
    flat = ((strand[:, None].long() * L + prof)[:, :, None] * 5 + rb) * 5 \
        + pair_read[:, :, None]
    sub = s_all[flat]                                         # [P, L, BAND]
    act = i[None, :] < Lr[:, None]                                  # [P, L]
    sub = torch.where(act[:, :, None], sub, 0)
    del flat, rb

    go, ge = cfg.gap_open, cfg.gap_extend
    tj = torch.arange(BAND, dtype=torch.int32, device=dev)
    neg_col = torch.full((P, 1), NEG, dtype=torch.int32, device=dev)
    m = torch.full((P, BAND), NEG, dtype=torch.int32, device=dev)
    ix = m.clone()
    iy = m.clone()
    ug = torch.zeros((P, BAND), dtype=torch.int32, device=dev)
    for step in range(L):
        sub_i = sub[:, step]
        actb = act[:, step, None]
        best_prev = torch.maximum(m, torch.maximum(ix, iy))
        m_new = sub_i + (0 if step == 0 else best_prev)
        if step == 0:
            ix_new = torch.full_like(m, NEG)
        else:
            m_shift = torch.cat([m[:, 1:], neg_col], dim=1)
            ix_shift = torch.cat([ix[:, 1:], neg_col], dim=1)
            ix_new = torch.maximum(m_shift - go, ix_shift - ge)
        a = m_new - go + tj[None, :] * ge
        cm = torch.cummax(a, dim=1).values
        iy_new = torch.cat([neg_col, cm[:, :-1] - tj[None, :-1] * ge], dim=1)
        m = torch.where(actb, m_new, m)
        ix = torch.where(actb, ix_new, NEG)
        iy = torch.where(actb, iy_new, NEG)
        ug = ug + sub_i

    dp_score = m.amax(1)
    ug_score = ug.amax(1)
    shape = (B2, C)
    return (dp_score.reshape(shape), _min_index(m, dp_score).reshape(shape),
            ug_score.reshape(shape), _min_index(ug, ug_score).reshape(shape))


def extend_candidates(oriented: torch.Tensor, lengths: torch.Tensor,
                      cand_diag: torch.Tensor, didx: DeviceIndex,
                      sprof: ScoreParams, cfg: AlignConfig):
    """-> dp_score, dp_j, ug_score, ug_j, each int32 [B2, C].

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if oriented.device.type == "cpu":
        return extend_candidates_plain(oriented, lengths, cand_diag, didx,
                                       sprof, cfg)
    if oriented.device.type != "cuda":
        raise ValueError(f"extend_candidates: unsupported device "
                         f"{oriented.device}")
    B, two, L = oriented.shape
    B2, C = cand_diag.shape
    checks = [
        (two == 2 and B2 == 2 * B, "oriented [B, 2, L] / cand_diag [2B, C]"),
        (oriented.dtype == torch.int32, "oriented int32"),
        (lengths.dtype == torch.int32 and lengths.shape == (B,),
         "lengths int32 [B]"),
        (cand_diag.dtype == torch.int32, "cand_diag int32"),
        (didx.ref_seq.dtype == torch.int8, "ref_seq int8"),
        (all(s.dtype == torch.int32 and s.shape == (L, 5, 5)
             for s in (sprof.s_fwd, sprof.s_comp)),
         "s_fwd/s_comp int32 [L, 5, 5]"),
        (L > 0, "max_read_len > 0"),
        (B2 * C < 2 ** 31, "fewer than 2^31 pairs"),
    ]
    for ok, what in checks:
        if not ok:
            raise ValueError(f"extend_candidates: kernel needs {what}")
    tensors = (oriented, lengths, cand_diag, didx.ref_seq, sprof.s_fwd,
               sprof.s_comp)
    for x in tensors:
        if x.device != oriented.device:
            raise ValueError("extend_candidates: inputs on different devices")
        if not x.is_contiguous():
            raise ValueError("extend_candidates: inputs must be contiguous")
    outs = [torch.empty((B2, C), dtype=torch.int32, device=oriented.device)
            for _ in range(4)]
    if B2 * C == 0:
        return tuple(outs)
    from parasuite_tpu_torch.ops._build import load

    ptr = [ctypes.c_void_p(x.data_ptr()) for x in (*tensors, *outs)]
    err = load().ps_extend_candidates(
        *ptr[:6], didx.ref_seq.shape[0], B2, C, L, cfg.band_width,
        cfg.gap_open, cfg.gap_extend, *ptr[6:],
        ctypes.c_void_p(torch.cuda.current_stream(
            oriented.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"extend_candidates kernel launch failed: CUDA "
                           f"error {err}")
    global launches
    launches += 1
    return tuple(outs)
