"""Finalize's selection half: the Hopper kernel beside its plain version.

The plain version is ops/aligner.py::finalize_core (dedupe, selection,
X0 / X1, MAPQ, the chromosome-boundary policy, the ungapped NM and T->C),
which both callers of the selection reach through finalize_select here:
aligner.finalize (every step of AlignerEngine, the XA, sharded and
distributed steps and the rescue tier) and
aligner.align_batch_combined_packed (with src, nm_pos and nm_strand).
CPU tensors take finalize_core; CUDA tensors launch the kernel, with no
fallback.

Kernel (csrc/finalize_select.cu): one warp per read, the read's n = 2C
entries in registers (E = 1, 2, 4 or 8 a lane: n up to 256). Each valid
entry is broadcast to the warp by shuffles and each lane dedupes its own
entries against it; the selection is four warp reductions, X0 and X1
ballots, and the ungapped window a strided loop of ballots. Nothing of
shape [B, n, n] or [B, L] is written: at 65,536 reads finalize_core's
dedupe masks (16.8 MB each) and its window's index and base tensors held
the step's memory peak, ~184 MB above the step. No Pallas kernel is
replaced: the JAX package leaves finalize_core to XLA, whose fusions hold
none of them either.

What bounds it on the H100: bytes. A read's n entries' fields, one
oriented strand's and the reference's bases of its window, its length and
42 bytes out (~450 bytes at n = 16, L = 50); its compares cost less. The
design reads each field once, coalesced, and writes each output once; the
latency of each read's chain of dependent steps keeps it at about a tenth
of that bound (csrc/finalize_select.cu).
"""

from __future__ import annotations

import ctypes

import torch

from parasuite_tpu_torch.config import AlignConfig
from parasuite_tpu_torch.ops.device_index import DeviceIndex, ScoreParams

MAX_ENTRIES = 256   # 2C a read the kernel is built for (E = 8 registers)

launches = 0     # kernel launches through finalize_select


def check_entry_width(cfg: AlignConfig) -> None:
    """Raise ValueError, naming the flag, when cfg's reads have more
    candidate entries (2 * max_candidates) than the kernel takes."""
    n = 2 * cfg.max_candidates
    if n > MAX_ENTRIES:
        raise ValueError(
            f"--max-candidates {cfg.max_candidates} gives {n} candidate "
            f"entries a read; the finalize kernel takes up to {MAX_ENTRIES}: "
            f"lower --max-candidates to {MAX_ENTRIES // 2} or less")


def _row_stride(x: torch.Tensor, B: int, n: int, name: str) -> int:
    """Row stride of an int32 [B, n] input whose rows are contiguous: n, or
    0 for one row broadcast to every read (expand)."""
    if x.dtype != torch.int32 or tuple(x.shape) != (B, n):
        raise ValueError(f"finalize_select: {name} must be int32 [B, n]")
    if (n > 1 and x.stride(1) != 1) or x.stride(0) not in (0, n):
        raise ValueError(f"finalize_select: {name} must be contiguous or "
                         f"one row broadcast")
    return x.stride(0)


def finalize_select(oriented, lengths, valid, strand, pos_key, dps, ug_eq,
                    diag, n_candidates, didx: DeviceIndex, sprof: ScoreParams,
                    cfg: AlignConfig, src=None, nm_pos=None, nm_strand=None):
    """aligner.finalize_core's arguments -> (AlignResult, best_idx int32
    [B]), equal to finalize_core on the same inputs.

    CPU tensors take finalize_core; CUDA tensors launch the kernel, which
    allocates nothing: the outputs are made here, n_candidates is passed
    through."""
    from parasuite_tpu_torch.ops import aligner

    dev = oriented.device
    if dev.type == "cpu":
        return aligner.finalize_core(
            oriented, lengths, valid, strand, pos_key, dps, ug_eq, diag,
            n_candidates, didx, sprof, cfg, src=src, nm_pos=nm_pos,
            nm_strand=nm_strand)
    if dev.type != "cuda":
        raise ValueError(f"finalize_select: unsupported device {dev}")
    if oriented.dtype != torch.int32 or oriented.dim() != 3 or \
            oriented.shape[1] != 2:
        raise ValueError("finalize_select: oriented must be int32 [B, 2, L]")
    B, _, L = oriented.shape
    n = valid.shape[1] if valid.dim() == 2 else -1
    if not 1 <= n <= MAX_ENTRIES:
        raise ValueError(f"finalize_select: n={n} entries a read; the kernel "
                         f"takes 1 to {MAX_ENTRIES}")
    strand_stride = _row_stride(strand, B, n, "strand")
    nm_strand_stride = (strand_stride if nm_strand is None else
                        _row_stride(nm_strand, B, n, "nm_strand"))
    rows = {"valid": (valid, torch.bool), "pos_key": (pos_key, torch.int32),
            "dps": (dps, torch.int32), "ug_eq": (ug_eq, torch.bool),
            "diag": (diag, torch.int32), "src": (src, torch.int32),
            "nm_pos": (nm_pos, torch.int32)}
    for name, (x, dtype) in rows.items():
        if x is not None and (x.dtype != dtype or tuple(x.shape) != (B, n)):
            raise ValueError(f"finalize_select: {name} must be {dtype} "
                             f"[B, n]")
    checks = [
        (lengths.dtype == torch.int32 and tuple(lengths.shape) == (B,),
         "lengths int32 [B]"),
        (didx.ref_seq.dtype == torch.int8, "ref_seq int8"),
        (all(x.dtype == torch.int32 for x in (didx.chrom_starts,
                                              didx.chrom_ends))
         and didx.chrom_starts.shape == didx.chrom_ends.shape
         and didx.chrom_starts.shape[0] >= 1,
         "chrom_starts / chrom_ends int32 [n_chroms >= 1]"),
        (sprof.mapq_sub.dtype == torch.int32
         and tuple(sprof.mapq_sub.shape) == (256,), "mapq_sub int32 [256]"),
        (L > 0, "max_read_len > 0"),
        (didx.ref_seq.shape[0] < 2 ** 31, "a reference under 2^31 bases"),
    ]
    for ok, what in checks:
        if not ok:
            raise ValueError(f"finalize_select: kernel needs {what}")
    ins = (oriented, lengths, valid, strand, pos_key, dps, ug_eq, diag, src,
           nm_pos, nm_strand, didx.ref_seq, didx.chrom_starts,
           didx.chrom_ends, sprof.mapq_sub)
    for x in ins:
        if x is None:
            continue
        if x.device != dev:
            raise ValueError("finalize_select: inputs on different devices")
        if not x.is_contiguous() and x is not strand and x is not nm_strand:
            raise ValueError("finalize_select: inputs must be contiguous")

    def empty(dtype):
        return torch.empty(B, dtype=dtype, device=dev)

    i32 = torch.int32
    res = aligner.AlignResult(
        mapped=empty(torch.bool), strand=empty(i32), pos=empty(i32),
        score=empty(i32), mapq=empty(i32), x0=empty(i32), x1=empty(i32),
        ug_equal=empty(torch.bool), nm=empty(i32), diag=empty(i32),
        n_candidates=n_candidates, tc_count=empty(i32))
    best_idx = empty(i32)
    if B == 0:
        return res, best_idx
    from parasuite_tpu_torch.ops._build import load

    outs = [x for f, x in zip(res._fields, res) if f != "n_candidates"]
    in_ptrs = (ctypes.c_void_p * len(ins))(
        *(None if x is None else x.data_ptr() for x in ins))
    out_ptrs = (ctypes.c_void_p * 12)(
        *(x.data_ptr() for x in (*outs, best_idx)))
    err = load().ps_finalize_select(
        in_ptrs, out_ptrs, B, n, L, didx.ref_seq.shape[0],
        didx.chrom_starts.shape[0], strand_stride, nm_strand_stride,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"finalize_select kernel launch failed: CUDA "
                           f"error {err}")
    global launches
    launches += 1
    return res, best_idx
