"""Batch aligner on tensors: orient -> seed -> select -> extend -> finalize.

Counterpart of parasuite_tpu/ops/aligner.py (align_batch and its stages),
bit-equal to it on the same inputs: integer-only scoring, identical clips and
tie-breaks. The TPU-specific formulations of the reference (3-bit funnel
shift for the reverse complement, 16-wide row gathers for seed positions)
are plain gathers here; they give the same values.

align_batch_with_candidates (XA tags, combined mode) adds the per-candidate
table of parasuite_tpu/ops/aligner.py::candidate_table to the same step.

The wire step is ported as the reference has it (:491-601): 2-bit codes, an
N bitmask and uint16 lengths go up (pack_codes_host), align_batch_packed
unpacks them on the device, aligns, and packs the AlignResult into a
13 B/read PackedResult (pack_result; unpack_result_host restores it on the
host), with the profile counts fused into the same step on request.
align_batch_combined_packed is combined mode's projected step on the same
wire (:604-812, with finalize_core's src, nm_pos and nm_strand at :368-488).
Pack and unpack are plain torch ops inside the step, as the reference
computes them in XLA outside its Pallas kernels.

parasuite_tpu/ops/packed_ref.py is not ported: the reference recomputes its
3-bit reference words inside every step only to fetch the ungapped NM window
(finalize_core) and the extension windows (pallas_extend.py). Here the NM
window is one byte gather of ref_seq and the extension kernel copies its
windows raw, so the words would be used by nothing.

Seeding with candidate selection, and extension, go through
resolve_select_fn and resolve_extend_fn (cfg.select_impl /
cfg.extend_impl): by default the wrappers in cuda_seed.py and
cuda_extend.py, which launch the Hopper kernels for CUDA tensors and take
the plain PyTorch versions for CPU tensors. The select kernel reads the
oriented reads and the k-mer index and builds each row of seed diagonals
itself, so the step never holds the rows (seed_diagonals runs only in the
plain version).
The selection half of finalize goes through cuda_finalize.finalize_select,
in finalize and in the combined step alike: on CUDA tensors one launch of
the finalize kernel, which never holds finalize_core's [B, n, n] dedupe
masks nor its [B, L] window; on CPU tensors finalize_core below.
Nothing here synchronises with the device, so a caller can keep several
batches in flight.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from parasuite_tpu_torch.config import AlignConfig
from parasuite_tpu_torch.ops.cuda_extend import (NEG, extend_candidates,
                                                 extend_candidates_plain)
from parasuite_tpu_torch.ops.cuda_finalize import finalize_select
from parasuite_tpu_torch.ops.cuda_seed import (  # noqa: F401
    I32MAX, seed_diagonals, seed_select, seed_select_plain)
from parasuite_tpu_torch.ops.device_index import DeviceIndex, ScoreParams

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


def complement(codes: torch.Tensor) -> torch.Tensor:
    """The complement of base codes 0..4 (A<->T, C<->G, N stays N): the
    table (3, 2, 1, 0, 4) as arithmetic on the codes' device, so a step
    builds no tensor from host data."""
    return torch.where(codes == 4, codes, 3 - codes)


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
    rc = complement(c32.gather(1, src.long()))
    rc = torch.where(i[None, :] < lengths[:, None], rc, 4)
    return torch.stack([c32, rc], dim=1)


# ---------------------------------------------------------------------------
# stages 2-3: seeding and candidate selection
# ---------------------------------------------------------------------------

# cuda_seed.py: seed_diagonals makes the rows of diagonals that
# select_candidates ranks; on the card one kernel does both (seed_select).


# ---------------------------------------------------------------------------
# stage 5: finalize
# ---------------------------------------------------------------------------

def finalize(oriented, lengths, min_scores, cand_diag, cand_valid,
             dp_score, dp_j, ug_score, ug_j, didx: DeviceIndex,
             sprof: ScoreParams, cfg: AlignConfig) -> AlignResult:
    """Dedupe, select, count hits, MAPQ, boundary policy, ungapped NM.
    Inputs at [B2, C]; outputs at [B]."""
    return finalize_select(*finalize_entries(
        oriented, lengths, min_scores, cand_diag, cand_valid, dp_score, dp_j,
        ug_score, ug_j, didx, cfg), didx, sprof, cfg)[0]


def finalize_entries(oriented, lengths, min_scores, cand_diag, cand_valid,
                     dp_score, dp_j, ug_score, ug_j, didx: DeviceIndex,
                     cfg: AlignConfig) -> tuple:
    """finalize's per-read entries from the stages' [B2, C] outputs ->
    (oriented, lengths, valid, strand, pos_key, dps, ug_eq, diag,
    n_candidates), the leading arguments of finalize_core and
    finalize_select, each per-entry array [B, n]; strand is one row
    broadcast to every read."""
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
    return (oriented, lengths, valid, strand, pos_key, dps, ug_eq, diag,
            n_candidates)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True per row, 0 for an all-False row (argmax)."""
    n = mask.shape[1]
    idx = torch.arange(n, dtype=torch.int32, device=mask.device)
    first = torch.where(mask, idx[None, :], n).amin(dim=1)
    return torch.where(first == n, 0, first)


def finalize_core(oriented, lengths, valid, strand, pos_key, dps, ug_eq,
                  diag, n_candidates, didx: DeviceIndex, sprof: ScoreParams,
                  cfg: AlignConfig, src=None, nm_pos=None, nm_strand=None):
    """Selection half of finalize over per-entry [B, n] arrays.
    -> (AlignResult, best_idx [B] int32).

    Combined mode re-runs the same selection on genome-projected (strand,
    pos_key) entries (align_batch_combined_packed):

      * src (optional, [B, n] int32 0/1): dedupe tie-break tier between
        equal-score same-key twins — genome-source (0) entries survive over
        transcript (1) ones, as in the host slow path;
      * nm_pos / nm_strand (optional): the window of the winner's NM and
        T->C counts. A junction winner's genome window is discontiguous, so
        its counts read the combined-space (transcript) window, the same
        bases its genome M segments cover.

    With all three None the selection is finalize's."""
    B, n = valid.shape
    L = oriented.shape[2]
    G = didx.ref_seq.shape[0]
    dev = oriented.device
    if nm_pos is None:
        nm_pos = pos_key
    if nm_strand is None:
        nm_strand = strand

    # dedupe by (strand, pos_key): an entry is a duplicate if a strictly
    # better twin exists — higher score, or equal score and lower (src,
    # index) tier
    same = (strand[:, :, None] == strand[:, None, :]) & \
           (pos_key[:, :, None] == pos_key[:, None, :])
    ar = torch.arange(n, device=dev)
    tie = (ar[None, :] < ar[:, None])[None]
    if src is not None:
        tie = (src[:, None, :] < src[:, :, None]) | \
              ((src[:, None, :] == src[:, :, None]) & tie)
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
    sel_nm_pos = pick(nm_pos)
    sel_nm_strand = pick(nm_strand)

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
    ridx = sel_nm_pos[:, None] + i[None, :]
    inr = (ridx >= 0) & (ridx < G)
    rb = torch.where(inr, didx.ref_seq[torch.clamp(ridx, 0, G - 1).long()]
                     .to(torch.int32), 4)
    sel_read = oriented.gather(
        1, sel_nm_strand.long()[:, None, None].expand(B, 1, L))[:, 0]
    mm = (rb != sel_read) | (rb == 4) | (sel_read == 4)
    in_len = i[None, :] < lengths[:, None]
    nm = (in_len & mm).sum(dim=1, dtype=torch.int32)
    tc_hit = torch.where(sel_nm_strand[:, None] == 1,
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


class CandidateTable(NamedTuple):
    """Per-candidate outputs [B, 2C] for host-side work on every candidate:
    XA alternates, and the genome-space re-finalization of combined
    genome+transcriptome mode (pipeline/combined.py)."""

    valid: torch.Tensor     # bool: passed min-score (pre-dedupe)
    strand: torch.Tensor    # int32
    pos: torch.Tensor       # int32 packed ungapped-key position
    score: torch.Tensor     # int32 DP score
    ug_equal: torch.Tensor  # bool
    diag: torch.Tensor      # int32


def candidate_table(oriented, lengths, min_scores, cand_diag, cand_valid,
                    dp_score, dp_j, ug_score, ug_j, cfg: AlignConfig,
                    G: int) -> CandidateTable:
    B = oriented.shape[0]
    L = oriented.shape[2]
    C = cand_diag.shape[1]
    n = 2 * C
    W = cfg.band_width

    def per_read(x):
        return x.reshape(B, n)

    diag = per_read(torch.clamp(cand_diag, -(L + 2 * W + 1), G))
    dps = per_read(dp_score)
    ug_eq = per_read(ug_score) == dps
    j_sel = torch.where(ug_eq, per_read(ug_j), per_read(dp_j))
    strand = repeat_each(torch.arange(2, dtype=torch.int32,
                                      device=oriented.device), C)
    return CandidateTable(
        valid=per_read(cand_valid) & (dps >= min_scores[:, None]),
        strand=strand[None, :].expand(B, n),
        pos=diag - W + j_sel,
        score=dps,
        ug_equal=ug_eq,
        diag=diag,
    )


# ---------------------------------------------------------------------------
# full pipeline
# ---------------------------------------------------------------------------

def _kernel_only(fn, field: str):
    """fn for a config that names the kernel ("pallas"): inputs off the
    card raise, as the reference's pallas_call does off the TPU, instead of
    taking the plain version."""

    def kernel(x: torch.Tensor, *args, **kwargs):
        if x.device.type != "cuda":
            raise ValueError(f"{field}='pallas' needs the CUDA kernel on an "
                             f"NVIDIA GPU, and the inputs are on {x.device} "
                             f"(use 'auto' or 'jnp' there)")
        return fn(x, *args, **kwargs)

    return kernel


def _resolve(impl: str, field: str, wrapper, plain):
    """The reference's mapping (parasuite_tpu/ops/aligner.py:858-879) with
    the card in the TPU's place: "auto" the wrapper (the kernel on CUDA
    tensors, the plain version on CPU tensors), "pallas" the kernel alone,
    anything else the plain version on every device."""
    if impl == "auto":
        return wrapper
    if impl == "pallas":
        return _kernel_only(wrapper, field)
    return plain


def resolve_extend_fn(cfg: AlignConfig):
    """cfg.extend_impl -> the extension stage (see _resolve)."""
    return _resolve(cfg.extend_impl, "extend_impl", extend_candidates,
                    extend_candidates_plain)


def resolve_select_fn(cfg: AlignConfig):
    """cfg.select_impl -> the seed-and-select stage, (oriented, lengths,
    didx, cfg) -> (cand_diag, cand_valid) (see _resolve): the kernel reads
    each oriented read's codes and the k-mer index and builds its row of
    diagonals itself (cuda_seed.seed_select); the plain version is
    seed_diagonals, then select_candidates_plain."""
    return _resolve(cfg.select_impl, "select_impl", seed_select,
                    seed_select_plain)


def _extend_stages(didx: DeviceIndex, sprof: ScoreParams,
                   codes: torch.Tensor, lengths: torch.Tensor,
                   cfg: AlignConfig):
    """orient -> seed and select -> extend:
    (oriented, cand_diag, cand_valid, (dp_score, dp_j, ug_score, ug_j))."""
    oriented = orient_reads(codes, lengths)
    cand_diag, cand_valid = resolve_select_fn(cfg)(oriented, lengths, didx,
                                                   cfg)
    ext = resolve_extend_fn(cfg)(oriented, lengths, cand_diag, didx, sprof,
                                 cfg)
    return oriented, cand_diag, cand_valid, ext


def align_batch(didx: DeviceIndex, sprof: ScoreParams, codes: torch.Tensor,
                lengths: torch.Tensor, min_scores: torch.Tensor,
                cfg: AlignConfig) -> AlignResult:
    """End-to-end batch alignment; every input on didx's device."""
    oriented, cand_diag, cand_valid, ext = _extend_stages(
        didx, sprof, codes, lengths, cfg)
    return finalize(oriented, lengths, min_scores, cand_diag, cand_valid,
                    *ext, didx, sprof, cfg)


def align_batch_with_candidates(didx: DeviceIndex, sprof: ScoreParams,
                                codes: torch.Tensor, lengths: torch.Tensor,
                                min_scores: torch.Tensor, cfg: AlignConfig):
    """align_batch + the per-candidate table -> (AlignResult,
    CandidateTable), both left on the device."""
    oriented, cand_diag, cand_valid, ext = _extend_stages(
        didx, sprof, codes, lengths, cfg)
    res = finalize(oriented, lengths, min_scores, cand_diag, cand_valid,
                   *ext, didx, sprof, cfg)
    table = candidate_table(oriented, lengths, min_scores, cand_diag,
                            cand_valid, *ext, cfg, didx.ref_seq.shape[0])
    return res, table


# ---------------------------------------------------------------------------
# the wire: packed codes up, PackedResult down
# ---------------------------------------------------------------------------

class PackedResult(NamedTuple):
    """AlignResult packed for the wire, layout v2 of the reference
    (parasuite_tpu/ops/aligner.py:491-515), 13 B/read against the 42 of
    the AlignResult's own fields:

      u8  [B, 7]  col0 = mapped | strand<<1 | ug_equal<<2 | (diag-pos+W)<<3
                  cols 1..6 = mapq, nm, x0, x1, n_candidates, tc_count
      i16 [B, 1]  score (|score| <= 127/base * 255 bases = 32385 < 2^15;
                  unmapped rows store 0 and unpack to NEG via the flag)
      i32 [B, 1]  pos

    diag rides as its band offset: pos = diag - W + j with j in [0, 2W],
    so diag - pos + W fits 5 bits for W <= 15. unpack_result_host restores
    the AlignResult bit for bit within the bounds AlignerEngine's
    supports_packed checks (L <= 255, 2 * max_candidates <= 255,
    band_width <= 15)."""

    u8: torch.Tensor    # uint8 [B, 7]
    i16: torch.Tensor   # int16 [B, 1] score
    i32: torch.Tensor   # int32 [B, 1] pos


def pack_codes_host(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """[B, L] int8 codes (0..4) -> (two-bit [B, ceil(L/4)] uint8, N mask
    [B, ceil(L/8)] uint8, little bit order): 20 B/read at L = 50."""
    B, L = codes.shape
    u = codes.astype(np.uint8)
    isn = u >= 4
    v = np.where(isn, 0, u)
    pad = (-L) % 4
    if pad:
        v = np.concatenate([v, np.zeros((B, pad), np.uint8)], axis=1)
    two = (v[:, 0::4] | (v[:, 1::4] << 2) | (v[:, 2::4] << 4)
           | (v[:, 3::4] << 6))
    nmask = np.packbits(isn, axis=1, bitorder="little")
    return two, nmask


def unpack_codes(two: torch.Tensor, nmask: torch.Tensor,
                 L: int) -> torch.Tensor:
    """The inverse of pack_codes_host, on the tensors' device: int8
    [B, L]."""
    B = two.shape[0]
    sh2 = torch.arange(0, 8, 2, dtype=torch.uint8, device=two.device)
    bases = ((two[:, :, None] >> sh2) & 3).reshape(B, -1)[:, :L]
    sh1 = torch.arange(8, dtype=torch.uint8, device=two.device)
    bits = ((nmask[:, :, None] >> sh1) & 1).reshape(B, -1)[:, :L]
    return torch.where(bits == 1, 4, bases).to(torch.int8)


def pack_result(res: AlignResult, band_width: int) -> PackedResult:
    """AlignResult -> PackedResult, on the device. Every narrowing keeps the
    low bits, as the reference's astype does."""
    u8 = torch.uint8
    dposw = torch.where(res.mapped, res.diag - res.pos + band_width, 0)
    flags = (res.mapped.to(u8) | (res.strand << 1).to(u8)
             | (res.ug_equal.to(u8) << 2) | (dposw << 3).to(u8))
    cols = torch.stack([flags, *(x.to(u8) for x in (
        res.mapq, res.nm, res.x0, res.x1, res.n_candidates,
        res.tc_count))], dim=1)
    i16 = torch.where(res.mapped, res.score, 0).to(torch.int16)[:, None]
    return PackedResult(u8=cols, i16=i16, i32=res.pos[:, None])


def unpack_result_host(packed: PackedResult,
                       band_width: int) -> AlignResult:
    """PackedResult of numpy arrays -> AlignResult of numpy arrays, with the
    dtypes fetch_host gives an AlignResult (bool mapped and ug_equal, int32
    elsewhere)."""
    i = np.asarray(packed.u8).astype(np.int32)
    flags = i[:, 0]
    mapped = (flags & 1).astype(bool)
    pos = np.asarray(packed.i32)[:, 0]
    score = np.where(mapped, np.asarray(packed.i16)[:, 0].astype(np.int32),
                     np.int32(NEG))
    diag = np.where(mapped, pos + (flags >> 3) - band_width, np.int32(0))
    return AlignResult(
        mapped=mapped, strand=(flags >> 1) & 1, pos=pos, score=score,
        mapq=i[:, 1], x0=i[:, 3], x1=i[:, 4],
        ug_equal=((flags >> 2) & 1).astype(bool), nm=i[:, 2], diag=diag,
        n_candidates=i[:, 5], tc_count=i[:, 6])


def _unpack_wire(two, nmask, lengths_u16, ms_table, cfg: AlignConfig):
    """The step's inputs from the wire -> (codes int8 [B, L], lengths int32,
    min_scores int32). The lengths are read through int16 (PyTorch has few
    CUDA kernels for uint16); they are below 2^15 (L <= 255)."""
    codes = unpack_codes(two, nmask, cfg.max_read_len)
    lengths = lengths_u16.view(torch.int16).to(torch.int32) & 0xFFFF
    min_scores = ms_table[torch.clamp(lengths, 0,
                                      ms_table.shape[0] - 1).long()]
    return codes, lengths, min_scores


def align_batch_packed(didx: DeviceIndex, sprof: ScoreParams,
                       packed_codes: torch.Tensor, nmask: torch.Tensor,
                       lengths_u16: torch.Tensor, ms_table: torch.Tensor,
                       cfg: AlignConfig, with_counts: bool = False):
    """Wire step: 2-bit codes + N mask + uint16 lengths in, PackedResult
    out -- and with with_counts the [L, 4, 4] profile count matrix from the
    codes already on the device, so a profile pass uploads once."""
    from parasuite_tpu_torch.ops.profile_update import profile_counts_batch

    codes, lengths, min_scores = _unpack_wire(packed_codes, nmask,
                                              lengths_u16, ms_table, cfg)
    res = align_batch(didx, sprof, codes, lengths, min_scores, cfg)
    out = pack_result(res, cfg.band_width)
    if not with_counts:
        return out
    return out, profile_counts_batch(didx, codes, lengths, res.mapped,
                                     res.strand, res.pos, res.ug_equal, cfg)


# ---------------------------------------------------------------------------
# combined genome+transcriptome step: device projection + re-finalization
# ---------------------------------------------------------------------------

class TxDeviceTables(NamedTuple):
    """Transcript lookup tables on the engine's device for the in-step
    genome projection of transcript candidates (combined mode).

    The reference (parasuite_tpu/ops/aligner.py::TxDeviceTables) also
    carries a page table, page_lut[pos >> page_shift] + one compare, because
    jnp.searchsorted over [B, 2C] queries measured 70-108 ms per batch on
    v5e. Here the chromosome index is torch.searchsorted over the
    DeviceIndex's chromosome starts: one binary-search kernel over a few
    hundred starts, and exact for any layout (the page table is exact only
    under its one-boundary-per-page invariant, under which both give the
    same index — tests/test_torch_combined.py holds the projection equal
    field by field). So page_lut and starts_ext are left out.

    gpos_tab[sp_off[t] + s] is the chrom-local genomic position of spliced
    base s of transcript t (spliced-plus frame), so single-exon-ness is a
    contiguity check of a window's two ends. int32 throughout: the engine
    keeps a transcriptome of 2**31 spliced bases or more off this path."""

    minus: torch.Tensor         # bool  [T]  '-' strand transcript
    tlen: torch.Tensor          # int32 [T]  spliced length
    gchrom_start: torch.Tensor  # int32 [T]  packed start of the genome chrom
    sp_off: torch.Tensor        # int32 [T]  offset into gpos_tab
    gpos_tab: torch.Tensor      # int32 [S]  spliced-plus -> chrom-local gpos


class PackedCandidates(NamedTuple):
    """The valid candidate entries of the rows that need the host, in the
    reference's wire layout (parasuite_tpu/ops/aligner.py:616-646).

    The rows with a junction-spanning, gapped or out-of-bounds candidate
    ship their valid entries, compacted front-first in flat (row,
    candidate) order — the order the host slow path dedupes and ranks in —
    into a buffer of K = round(combined_wire_cap * B) entries, 11 B each:

      row    i32 [K]  batch row of the entry
      pos    i32 [K]  ungapped-key packed position
      score  i16 [K]  DP score (a valid entry passed min_score >= 0, and
                       max <= 127 * 255 < 2^15, PackedResult's bound)
      flags  u8  [K]  bit0 = 1 (valid), bit1 strand, bit2 ug_equal,
                       bits 3..7 diag - pos + band_width (in [0, 2W])
      n_sel  i32 []   the true count; past K the host re-runs the batch
                       through the unprojected step

    Slots past n_sel hold entry 0, as in the reference."""

    n_sel: torch.Tensor      # int32 []
    row: torch.Tensor        # int32 [K]
    pos: torch.Tensor        # int32 [K]
    score: torch.Tensor      # int16 [K]
    flags: torch.Tensor      # uint8 [K]


class PackedJunctions(NamedTuple):
    """Junction winners of device-finalized rows (the reference's
    parasuite_tpu/ops/aligner.py:604): row and spliced-table offset q0, from
    which the host assembles the N CIGAR; every other field of the record
    is final in the AlignResult. Compacted like PackedCandidates into
    round(combined_wire_jun_cap * B) slots; n_jun past that re-runs the
    batch unprojected."""

    n_jun: torch.Tensor      # int32 []
    row: torch.Tensor        # int32 [K]
    q0: torch.Tensor         # int32 [K]


def project_candidates_device(table: CandidateTable, lengths: torch.Tensor,
                              didx: DeviceIndex, txt: TxDeviceTables,
                              n_genome: int, tx_boundary: int):
    """Per-entry genome projection for the combined step.

    -> (proj_pos, proj_strand, is_tx, simple, q0, noncontig), all [B, n].
    An entry is `simple` when the device can finalize its selection exactly
    as the host slow path would: genome-direct ungapped entries inside one
    chromosome, or transcript ungapped entries fully inside their
    transcript — junction-spanning ones included, whose genomic start is
    gpos_tab[q0] and whose only host-side need is the N CIGAR. noncontig
    marks that junction case; q0 is the entry's offset into gpos_tab."""
    pos = table.pos
    L = lengths[:, None]
    G = didx.ref_seq.shape[0]
    T = txt.tlen.shape[0]
    S = txt.gpos_tab.shape[0]
    nc = didx.chrom_starts.shape[0]
    ci = torch.clamp(torch.searchsorted(
        didx.chrom_starts, torch.clamp(pos, 0, G - 1).contiguous(),
        right=True) - 1, 0, nc - 1)
    is_tx = pos >= tx_boundary
    txi = torch.clamp(ci - n_genome, 0, max(T - 1, 0))
    local = pos - didx.chrom_starts[ci]
    tl = txt.tlen[txi]
    minus = txt.minus[txi]
    s0 = torch.where(minus, tl - (local + L), local)
    ok_p = (local >= 0) & (local + L <= tl) & (s0 >= 0)
    q0 = torch.clamp(s0, min=0) + txt.sp_off[txi]
    gpos = txt.gpos_tab[torch.clamp(q0, 0, S - 1)]
    gend = txt.gpos_tab[torch.clamp(q0 + L - 1, 0, S - 1)]
    contig = gend == gpos + L - 1
    proj_pos = torch.where(is_tx, txt.gchrom_start[txi] + gpos, pos)
    proj_strand = torch.where(is_tx & minus, 1 - table.strand, table.strand)
    g_inb = (local >= 0) & (pos + L - 1 < didx.chrom_ends[ci])
    simple = table.ug_equal & torch.where(is_tx, ok_p, g_inb)
    noncontig = is_tx & table.ug_equal & ok_p & ~contig
    return proj_pos, proj_strand, is_tx, simple, q0, noncontig


def _compact(mask: torch.Tensor, cap: int) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Stable compaction without a host sync: -> (count int32 [], flat
    indices int64 [cap] of the first `cap` True entries of mask, in order,
    0 in the slots past the count). Each True entry scatters its index to
    its rank (cumsum); entries past the cap and False entries go to a
    discard slot."""
    rank = torch.cumsum(mask, 0) - 1
    slot = torch.where(mask & (rank < cap), rank, cap)
    buf = torch.zeros(cap + 1, dtype=torch.int64, device=mask.device)
    buf.scatter_(0, slot, torch.arange(mask.shape[0], device=mask.device))
    return mask.sum(dtype=torch.int32), buf[:cap]


def align_batch_combined_packed(didx: DeviceIndex, sprof: ScoreParams,
                                txt: TxDeviceTables,
                                packed_codes: torch.Tensor,
                                nmask: torch.Tensor,
                                lengths_u16: torch.Tensor,
                                ms_table: torch.Tensor, cfg: AlignConfig,
                                n_genome: int, tx_boundary: int,
                                cap_entries: int, cap_junctions: int):
    """Combined-mode wire step with the genome projection on the device
    (the reference's align_batch_combined_packed): the wire of
    align_batch_packed in, a PackedResult out.

    Every single-exon or junction-spanning ungapped transcript candidate is
    projected to genome coordinates and the finalize selection re-runs on
    the projected (strand, pos), so a typical exonic read (transcript hit
    plus its genomic twin) is deduped, ranked and MAPQ'd on the device,
    exactly as the host slow path would. Only rows with a gapped or
    out-of-bounds candidate ship their entries (PackedCandidates); junction
    winners of the other rows ship (row, q0) (PackedJunctions).
    -> (PackedResult, PackedCandidates, PackedJunctions), on the device;
    nothing here waits for it."""
    codes, lengths, min_scores = _unpack_wire(packed_codes, nmask,
                                              lengths_u16, ms_table, cfg)
    oriented, cand_diag, cand_valid, ext = _extend_stages(
        didx, sprof, codes, lengths, cfg)
    table = candidate_table(oriented, lengths, min_scores, cand_diag,
                            cand_valid, *ext, cfg, didx.ref_seq.shape[0])
    B, n = table.valid.shape
    proj_pos, proj_strand, is_tx, simple, q0, noncontig = \
        project_candidates_device(table, lengths, didx, txt, n_genome,
                                  tx_boundary)
    n_cands = cand_valid.reshape(B, n).sum(dim=1, dtype=torch.int32)
    # junction winners' NM/T->C windows read the combined-space frame
    nm_pos = torch.where(noncontig, table.pos, proj_pos)
    nm_strand = torch.where(noncontig, table.strand, proj_strand)
    res, best_idx = finalize_select(
        oriented, lengths, table.valid, proj_strand, proj_pos, table.score,
        table.ug_equal, table.diag, n_cands, didx, sprof, cfg,
        src=is_tx.to(torch.int32), nm_pos=nm_pos, nm_strand=nm_strand)

    any_tx = (table.valid & is_tx).any(dim=1)
    row_simple = ~(table.valid & ~simple).any(dim=1)
    needs_host = any_tx & ~row_simple
    n_sel, sel = _compact((table.valid & needs_host[:, None]).reshape(-1),
                          cap_entries)

    def entries(x):
        return x.reshape(-1)[sel]

    e_pos = entries(table.pos)
    dposw = entries(table.diag) - e_pos + cfg.band_width
    flags = (1 | (entries(table.strand) << 1)
             | (entries(table.ug_equal).to(torch.int32) << 2)
             | (dposw << 3)).to(torch.uint8)
    pc = PackedCandidates(
        n_sel=n_sel, row=(sel // n).to(torch.int32), pos=e_pos,
        score=entries(table.score).to(torch.int16), flags=flags)

    bi = best_idx[:, None].long()
    win_nc = noncontig.gather(1, bi)[:, 0] & res.mapped & ~needs_host
    n_jun, jsel = _compact(win_nc, cap_junctions)
    pj = PackedJunctions(n_jun=n_jun, row=jsel.to(torch.int32),
                         q0=q0.gather(1, bi)[:, 0][jsel])
    return pack_result(res, cfg.band_width), pc, pj
