"""Single-pass alignment pipeline of the port: ReadBatch in, SAM/BAM
records out.

Counterpart of parasuite_tpu/pipeline/align.py. The device step is
ops/aligner.py::align_batch (align_batch_with_candidates with XA tags) on the
engine's device, and the streaming step is its wire form align_batch_packed
(2-bit codes and N mask up, PackedResult down, the profile counts of a
profile pass fused in) wherever the reference's engine takes it
(supports_packed); the two-tier rescue pass (config.rescue_kmer) is a second
step of the same form at the smaller k. The engine runs every one of these
steps as an ops/compiled.py::CompiledStep, built in __init__ where the
reference builds its jax.jit steps: captured once per shape as a CUDA graph
and replayed (on the CPU, called directly). Host tracebacks for the rare gapped
winners, XA strings and SAM/BAM emission are numpy and C++ (native/).
host_traceback, host_tracebacks_batch, LazyCigars, HostAlignments, the XA,
rescue and emit paths are copies of the reference's (its pipeline package
imports jax when it is imported), pinned to it by tests/test_torch_*.py.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, fields

import numpy as np
import torch

from parasuite_tpu_torch import native
from parasuite_tpu_torch.config import AlignConfig
from parasuite_tpu_torch.errormodel.scoring import (complement_score_tensor,
                                                    flat_score_tensor)
from parasuite_tpu_torch.index.kmer import KmerIndex
from parasuite_tpu_torch.index.reference import PackedReference
from parasuite_tpu_torch.io.batch import ReadBatch
from parasuite_tpu_torch.io.sam import format_record
from parasuite_tpu_torch.oracle.align import (_ref_window, _score_rows,
                                              banded_dp, traceback_alignment)
from parasuite_tpu_torch.utils.dna import N, revcomp_codes
from parasuite_tpu_torch.ops.aligner import (AlignResult, CandidateTable,
                                             PackedResult, align_batch,
                                             align_batch_packed,
                                             align_batch_with_candidates,
                                             pack_codes_host,
                                             unpack_result_host)
from parasuite_tpu_torch.ops.compiled import CompiledStep
from parasuite_tpu_torch.ops.cuda_finalize import check_entry_width
from parasuite_tpu_torch.ops.cuda_seed import check_row_width
from parasuite_tpu_torch.ops.device_index import (DeviceIndex, ScoreParams,
                                                  min_score_table)
from parasuite_tpu_torch.ops.profile_update import profile_counts_batch
from parasuite_tpu_torch.pipeline.clusters import tc_count_from_cigar
from parasuite_tpu_torch.utils.runlog import count, span


def host_traceback(ref_seq: np.ndarray, s_tensor: np.ndarray,
                   s_comp: np.ndarray, cfg: AlignConfig,
                   oriented_read: np.ndarray, read_len: int, strand: int,
                   diag: int) -> tuple[int, list, int]:
    """Re-run the banded DP on host for one gapped read and trace it back.

    -> (packed_start_pos, cigar, nm). Shared by the plain and combined
    engines; gapped reads are <<1% so this never dominates (gapless fast
    path, SURVEY.md §7)."""
    w = cfg.band_width
    s_eff = s_tensor if strand == 0 else s_comp
    rows = _score_rows(s_eff, oriented_read, read_len, strand)
    refwin = _ref_window(ref_seq, diag, read_len, w)
    _score, dp_j, _u, _uj, tables = banded_dp(rows, refwin, read_len, cfg,
                                              keep_tables=True)
    start_j, cigar, gap_nm = traceback_alignment(tables, rows, refwin,
                                                 read_len, dp_j, cfg)
    pos = diag - w + start_j
    nm = gap_nm
    ri, qi = pos, 0
    for op, oln in cigar:
        if op == "M":
            rb = ref_seq[ri : ri + oln]
            cb = oriented_read[qi : qi + oln]
            nm += int(np.sum((rb != cb) | (rb == N) | (cb == N)))
            ri += oln
            qi += oln
        elif op == "I":
            qi += oln
        else:
            ri += oln
    return pos, cigar, nm


def host_tracebacks_batch(ref_seq: np.ndarray, s_tensor: np.ndarray,
                          s_comp: np.ndarray, cfg: AlignConfig,
                          oriented: np.ndarray, lens: np.ndarray,
                          strands: np.ndarray, diags: np.ndarray
                          ) -> list[tuple[int, list, int]]:
    """host_traceback for MANY gapped reads at once, bit-identical to it
    (tests/test_torch_native_traceback.py). Every row's score rows,
    reference window, banded DP, walk back and NM run in one call of the
    native library (native.tracebacks_batch, single-threaded, the GIL
    released, so the stream's reader and writer run meanwhile); Python
    builds the CIGAR lists from its runs. Without the library, or
    when it leaves a row to numpy (a window that crosses an end of the
    reference), the batch takes the numpy path: the tables of all G reads in
    one vectorised DP (_banded_dp_batch), then the oracle's
    traceback_alignment row by row, so tie-break semantics are the
    oracle's by construction.

    oriented: int8 [G, L] genome-frame reads (N-padded past each length).
    -> [(packed_start_pos, cigar, nm)] per read.

    Spans (utils/runlog.py): engine.tracebacks, with engine.tracebacks.native
    (the C call and the CIGAR lists) inside, or with
    engine.tracebacks.dp (the tables) and engine.tracebacks.walk (the
    per-read walks) on the numpy path; the counter engine.gapped_rows adds
    G, engine.tracebacks_native the rows the native library finished.
    """
    from parasuite_tpu_torch.oracle.align import traceback_alignment

    G = oriented.shape[0]
    if G == 0:
        return []
    count("engine.gapped_rows", G)
    w = cfg.band_width
    lens = lens.astype(np.int64)
    diags = diags.astype(np.int64)
    with span("engine.tracebacks"):
        if native.available():
            with span("engine.tracebacks.native"):
                out = _native_tracebacks(ref_seq, s_tensor, s_comp, cfg,
                                         oriented, lens, strands, diags)
            if out is not None:
                count("engine.tracebacks_native", G)
                return out
        with span("engine.tracebacks.dp"):
            M, Ix, Iy, rows, refwin = _banded_dp_batch(
                ref_seq, s_tensor, s_comp, cfg, oriented, lens, strands,
                diags)
        with span("engine.tracebacks.walk"):
            out = []
            for g in range(G):
                ln = int(lens[g])
                last = M[g, ln - 1]
                dp_j = int(np.argmax(last))
                tables = (M[g], Ix[g], Iy[g])
                start_j, cigar, gap_nm = traceback_alignment(
                    tables, rows[g], refwin[g], ln, dp_j, cfg)
                pos = int(diags[g]) - w + start_j
                nm = gap_nm
                ri, qi = pos, 0
                rd_g = oriented[g]
                for op, oln in cigar:
                    if op == "M":
                        rb = ref_seq[ri : ri + oln]
                        cb = rd_g[qi : qi + oln]
                        nm += int(np.sum((rb != cb) | (rb == N) | (cb == N)))
                        ri += oln
                        qi += oln
                    elif op == "I":
                        qi += oln
                    else:
                        ri += oln
                out.append((pos, cigar, nm))
    return out


_CIGAR_OPS = np.array(["M", "I", "D"])


def _native_tracebacks(ref_seq, s_tensor, s_comp, cfg, oriented, lens,
                       strands, diags):
    """host_tracebacks_batch's native path -> its list, or None when the
    library left a row to numpy."""
    pos, nm, n_runs, run_ops, run_lens = native.tracebacks_batch(
        s_tensor, s_comp, oriented, lens, strands, diags, ref_seq,
        cfg.band_width, cfg.gap_open, cfg.gap_extend)
    if (n_runs < 0).any():
        return None
    ends = np.cumsum(n_runs).tolist()
    runs = list(zip(_CIGAR_OPS[run_ops[:ends[-1]]].tolist(),
                    run_lens[:ends[-1]].tolist()))
    return [(p, runs[b:e], n) for p, b, e, n in
            zip(pos.tolist(), [0] + ends[:-1], ends, nm.tolist())]


def _banded_dp_batch(ref_seq, s_tensor, s_comp, cfg, oriented, lens,
                     strands, diags):
    """host_tracebacks_batch's tables: the banded DP of all G reads at
    once (lens and diags int64) -> (M, Ix, Iy [G, L, band], score rows
    [G, L, 5], reference windows [G, L + 2w])."""
    from parasuite_tpu_torch.oracle.align import NEG

    G = oriented.shape[0]
    L = int(lens.max())
    w = cfg.band_width
    band = 2 * w + 1
    go, ge = cfg.gap_open, cfg.gap_extend
    Rn = ref_seq.shape[0]

    # score rows for every read: rows[g, i, r] = s_eff[prof, r, read[g, i]]
    i_ax = np.arange(L)
    prof = np.where(strands[:, None] == 0, i_ax[None, :],
                    np.clip(lens[:, None] - 1 - i_ax[None, :], 0, None))
    s_stack = np.stack([s_tensor, s_comp])            # [2, Lmax, 5, 5]
    rd = np.clip(oriented[:, :L].astype(np.int64), 0, 4)
    rows = s_stack[strands[:, None, None],
                   prof[:, :, None],
                   np.arange(5)[None, None, :],
                   rd[:, :, None]].astype(np.int64)    # [G, L, 5]

    # reference windows: refwin[g, t] = ref[diag - w + t], N out of range
    win = L + 2 * w
    widx = (diags - w)[:, None] + np.arange(win)[None, :]
    inb = (widx >= 0) & (widx < Rn)
    refwin = np.where(inb, ref_seq[np.clip(widx, 0, Rn - 1)],
                      np.int8(N)).astype(np.int64)     # [G, win]

    # banded DP, all reads at once (int64, semantics = oracle.banded_dp)
    M = np.full((G, L, band), NEG, dtype=np.int64)
    Ix = np.full((G, L, band), NEG, dtype=np.int64)
    Iy = np.full((G, L, band), NEG, dtype=np.int64)
    g_ax = np.arange(G)[:, None]
    jge = np.arange(band, dtype=np.int64) * ge

    def iy_prefix(m_i, iy_row):
        # Iy[j] = max_{u<j} (M[u] - go - (j-1-u)*ge), NEG at j=0: the
        # (j-1-u)*ge term telescopes — cummax over (M[u] + u*ge), then
        # subtract (j-1)*ge. NEG-region values can differ from the oracle's
        # recurrence by O(go) but stay far below NEG//2, so every real
        # comparison/threshold decides identically (parity-tested).
        cm = np.maximum.accumulate(m_i + jge[None, :], axis=1)
        iy_row[:, 1:] = cm[:, :-1] - go - \
            (np.arange(1, band, dtype=np.int64) - 1)[None, :] * ge
        return iy_row

    sub0 = rows[g_ax, 0, refwin[:, 0:band]]
    M[:, 0] = sub0
    Iy[:, 0] = iy_prefix(M[:, 0], Iy[:, 0].copy())
    for i in range(1, L):
        act = (i < lens)
        if not act.any():
            break
        sub = rows[g_ax, i, refwin[:, i : i + band]]
        m_p, ix_p, iy_p = M[:, i - 1], Ix[:, i - 1], Iy[:, i - 1]
        best_prev = np.maximum(m_p, np.maximum(ix_p, iy_p))
        m_new = np.where(best_prev > NEG // 2, sub + best_prev, NEG)
        ix_new = np.full((G, band), NEG, dtype=np.int64)
        ix_new[:, :-1] = np.maximum(m_p[:, 1:] - go, ix_p[:, 1:] - ge)
        iy_new = iy_prefix(m_new, np.full((G, band), NEG, dtype=np.int64))
        upd = act[:, None]
        M[:, i] = np.where(upd, m_new, M[:, i])
        Ix[:, i] = np.where(upd, ix_new, Ix[:, i])
        Iy[:, i] = np.where(upd, iy_new, Iy[:, i])
    return M, Ix, Iy, rows, refwin


class LazyCigars:
    """List-like CIGAR store: gapped/junction overrides live in a sparse
    dict; ungapped mapped reads synthesize [("M", length)] on access.
    Building 32k trivial [("M", 50)] lists per batch measured ~14 ms of
    GIL-held Python per batch — pure waste when the native SAM formatter
    never looks at them."""

    __slots__ = ("_over", "_mapped", "_lengths")

    def __init__(self, mapped, lengths):
        self._over: dict = {}
        self._mapped = mapped
        self._lengths = lengths

    def __getitem__(self, b):
        c = self._over.get(int(b))
        if c is not None:
            return c
        return ([("M", int(self._lengths[b]))] if self._mapped[b] else [])

    def __setitem__(self, b, cigar):
        self._over[int(b)] = cigar

    def __len__(self):
        return len(self._lengths)

    def overrides_in(self, b: int, e: int):
        """(index, cigar) pairs with a non-default CIGAR in [b, e) — what
        the native formatters need, without touching default rows."""
        return [(i, c) for i, c in self._over.items() if b <= i < e]


@dataclass
class HostAlignments:
    """Alignment results pulled to host for one batch (numpy, [B])."""

    mapped: np.ndarray
    strand: np.ndarray
    pos: np.ndarray          # packed start (exact for ungapped; gapped reads
                             # carry the traceback-corrected value)
    score: np.ndarray
    mapq: np.ndarray
    x0: np.ndarray
    x1: np.ndarray
    nm: np.ndarray
    ug_equal: np.ndarray
    cigars: LazyCigars       # [(op, len)] per read
    tc_count: np.ndarray     # machine-frame T->C conversions per read
    xa: list = None          # per-read XA:Z alternative-hit strings (or None)


def _widest_first(itemsizes) -> list[int]:
    """The order of the parts of one byte buffer: widest elements first, so
    each part starts at a multiple of its own element size (sizes are
    powers of two, and every part holds whole elements)."""
    return sorted(range(len(itemsizes)), key=lambda i: -itemsizes[i])


def fetch_host(*parts):
    """Device namedtuples of tensors (AlignResult, PackedResult,
    CandidateTable, the combined step's PackedCandidates / PackedJunctions)
    -> the same namedtuples of numpy arrays in ONE device->host transfer:
    the bytes of every field go into one uint8 buffer, so a batch
    synchronises once, not once per field, and moves the bytes its fields
    hold (13 a read for a PackedResult, not 4 a field). Shapes and dtypes
    come back as they were; a None part comes back None."""
    tensors = [x for p in parts if p is not None for x in p]
    order = _widest_first([x.element_size() for x in tensors])
    flat = torch.cat([tensors[i].reshape(-1).view(torch.uint8)
                      for i in order]).cpu().numpy() if tensors else None
    count("engine.bytes_down", flat.nbytes if tensors else 0)
    arrays, off = [None] * len(tensors), 0
    for i in order:
        x = tensors[i]
        nbytes = x.numel() * x.element_size()
        dtype = torch.empty((), dtype=x.dtype).numpy().dtype
        arrays[i] = flat[off:off + nbytes].view(dtype).reshape(
            tuple(x.shape))
        off += nbytes
    out, k = [], 0
    for p in parts:
        if p is None:
            out.append(None)
            continue
        out.append(type(p)(*arrays[k:k + len(p)]))
        k += len(p)
    return tuple(out)


def orient_rows(codes: np.ndarray, lengths: np.ndarray, rows: np.ndarray,
                strand: np.ndarray) -> np.ndarray:
    """int8 [len(rows), L] genome-frame reads for host_tracebacks_batch:
    row b as is on strand 0, reverse-complemented on strand 1, N-padded
    past its length."""
    om = np.full((rows.shape[0], codes.shape[1]), 4, dtype=np.int8)
    for k, b in enumerate(rows):
        ln = int(lengths[b])
        om[k, :ln] = (codes[b, :ln] if strand[b] == 0
                      else revcomp_codes(codes[b, :ln]))
    return om


def unpacked_step(didx: DeviceIndex, sprof: ScoreParams,
                  ms_table: torch.Tensor, codes: torch.Tensor,
                  lengths: torch.Tensor, *, cfg: AlignConfig,
                  with_candidates: bool):
    """The unpacked step with its min-score lookup: align_batch, or
    align_batch_with_candidates with the candidate table beside it."""
    ms = ms_table[torch.clamp(lengths, 0, cfg.max_read_len).long()]
    step = align_batch_with_candidates if with_candidates else align_batch
    return step(didx, sprof, codes, lengths, ms, cfg)


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and absent
    (never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but "
                           "torch.cuda.is_available() is false")
    return dev


class AlignerEngine:
    """Holds device state and the align step for one reference+profile.

    Duck-typed for streaming_align: cfg, sam_ref, supports_packed,
    align_device, align_device_packed, profile_counts_device, to_host,
    accumulate_profile_host, emit_sam, emit_bam."""

    def __init__(self, ref: PackedReference, index: KmerIndex,
                 cfg: AlignConfig, s_tensor: np.ndarray | None = None,
                 xa_tags: bool = False, xa_limit: int = 10, device="cuda"):
        self.device = resolve_device(device)
        # a row wider than the select kernel takes, or more candidate
        # entries a read than the finalize kernel takes, is refused here,
        # on every device, before any index is uploaded
        check_row_width(cfg)
        check_entry_width(cfg)
        self.ref = ref
        self.sam_ref = ref  # reference used for SAM emission
        self.cfg = cfg
        self.xa_tags = xa_tags
        self.xa_limit = xa_limit
        self.xa_dropped = 0  # alternates over xa_limit (counted, not silent)
        self.didx = DeviceIndex.from_host(ref, index, self.device)
        self._ms_table = torch.from_numpy(min_score_table(cfg)).to(
            self.device)
        # the wire step (ops/aligner.PackedResult) where the reference's
        # engine takes it: its uint8 fields hold only under these bounds
        # (band_width <= 15: the diag band offset rides in 5 bits)
        self.supports_packed = (not xa_tags and cfg.max_read_len <= 255
                                and 2 * cfg.max_candidates <= 255
                                and cfg.band_width <= 15)
        s_tensor = (s_tensor if s_tensor is not None
                    else flat_score_tensor(cfg, cfg.max_read_len))
        first = ScoreParams.from_tensor(s_tensor, cfg, self.device)
        # the engine's own score tensors, which set_profile updates in
        # place (on the CPU from_tensor shares the caller's numpy memory)
        self.sprof = ScoreParams(*(getattr(first, f.name).clone()
                                   for f in fields(ScoreParams)))
        self.set_profile(s_tensor)
        # the compiled steps (ops/compiled.py), one set a seeding tier,
        # keyed by the tier's cfg; one graph memory pool for all of them
        self._pool = (torch.cuda.graph_pool_handle()
                      if self.device.type == "cuda" else None)
        self._steps: dict = {}
        self._build_steps(self.didx, cfg)
        # two-tier seeding rescue (config.rescue_kmer): a second k-mer index
        # at the smaller k; unmapped reads retry through it in to_host. The
        # rescue step takes its min scores from _ms_table (built from cfg):
        # cfg2 differs only in seeding fields, so the thresholds are equal
        # (tests/test_torch_modes.py).
        self._rescue = None
        self.rescue_overflow = 0   # unmapped rows beyond the rescue batch
        self.rescue_mapped = 0     # reads the rescue pass recovered
        self.last_rescue_rows = None  # the rows rescued in to_host's batch
        if cfg.rescue_kmer:
            cfg2 = cfg.replace(kmer_size=cfg.rescue_kmer, rescue_kmer=0,
                               max_seeds=max(cfg.rescue_seeds,
                                             cfg.max_seeds))
            didx2 = DeviceIndex.from_host(
                ref, KmerIndex.build(ref.seq, cfg2.kmer_size), self.device)
            self._rescue = (cfg2, didx2, max(256, cfg.batch_size // 8))
            self._build_steps(didx2, cfg2)

    def _build_steps(self, didx: DeviceIndex, cfg: AlignConfig) -> None:
        """The compiled steps of one seeding tier, over didx under cfg: the
        unpacked step, the wire step and the profile counts (the reference's
        jitted _align / _align_cand, _align_packed, _counts, and the rescue
        tier's step2)."""
        self._steps[cfg] = {"didx": didx}
        self._compile("unpacked", cfg, functools.partial(
            unpacked_step, didx, self.sprof, self._ms_table, cfg=cfg),
            static=("with_candidates",))
        self._compile("packed", cfg, functools.partial(
            align_batch_packed, didx, self.sprof, ms_table=self._ms_table,
            cfg=cfg), static=("with_counts",))
        self._compile("counts", cfg, functools.partial(
            profile_counts_batch, didx, cfg=cfg))

    def _compile(self, kind: str, cfg: AlignConfig, fn, static=()) -> None:
        """fn as the tier's compiled step of `kind`, in the engine's graph
        memory pool."""
        self._steps[cfg][kind] = CompiledStep(
            fn, self.device, f"{kind} k={cfg.kmer_size}", static=static,
            pool=self._pool)

    def _compiled(self, didx: DeviceIndex, cfg: AlignConfig,
                  kind: str) -> CompiledStep:
        """The tier's compiled step of `kind`; didx must be the index the
        tier's steps were built over, since a graph reads it by address."""
        steps = self._steps[cfg]
        if steps["didx"] is not didx:
            raise ValueError(f"no compiled steps over this index under "
                             f"k={cfg.kmer_size}")
        return steps[kind]

    def compiled_steps(self) -> dict:
        """{step name: CompiledStep} of every tier."""
        return {s.name: s for steps in self._steps.values()
                for s in steps.values() if isinstance(s, CompiledStep)}

    def set_profile(self, s_tensor: np.ndarray) -> None:
        """Swap in a learned score tensor (pass 2). It is copied into the
        tensors of self.sprof, which the compiled steps read by address (the
        reference passes it as a runtime argument, not a constant)."""
        self.s_tensor = s_tensor
        self.s_comp = complement_score_tensor(s_tensor)
        new = ScoreParams.from_tensor(s_tensor, self.cfg, self.device)
        for f in fields(ScoreParams):
            getattr(self.sprof, f.name).copy_(getattr(new, f.name))

    # --- device steps ---
    def _upload(self, *arrays: np.ndarray) -> tuple[torch.Tensor, ...]:
        """Host arrays -> tensors of the same dtypes and shapes on the
        engine's device, in ONE host->device copy (their bytes in one
        buffer, widest elements first, as fetch_host)."""
        with span("step.upload"):
            arrays = [np.ascontiguousarray(a) for a in arrays]
            order = _widest_first([a.itemsize for a in arrays])
            buf = torch.from_numpy(np.concatenate(
                [arrays[i].reshape(-1).view(np.uint8) for i in order]
            )).to(self.device)
            count("step.bytes_up", buf.numel())
            out, off = [None] * len(arrays), 0
            for i in order:
                a = arrays[i]
                dtype = torch.from_numpy(a[:0].reshape(-1)).dtype
                out[i] = buf[off:off + a.nbytes].view(dtype).reshape(
                    a.shape)
                off += a.nbytes
            return tuple(out)

    def _upload_reads(self, codes: np.ndarray, lengths: np.ndarray):
        """int8 codes and int32 lengths on the device (the unpacked step)."""
        return self._upload(codes, np.asarray(lengths, dtype=np.int32))

    def _upload_wire(self, codes: np.ndarray, lengths: np.ndarray):
        """The wire of the packed steps on the device: 2-bit codes, N mask
        and uint16 lengths, packed on the host (pack_codes_host)."""
        with span("step.pack"):
            two, nmask = pack_codes_host(codes)
        return self._upload(two, nmask, np.asarray(lengths, dtype=np.uint16))

    def _step(self, didx: DeviceIndex, cfg: AlignConfig, codes: np.ndarray,
              lengths: np.ndarray, with_candidates: bool = False):
        return self._compiled(didx, cfg, "unpacked")(
            *self._upload_reads(codes, lengths),
            with_candidates=with_candidates)

    def _step_packed(self, didx: DeviceIndex, cfg: AlignConfig,
                     codes: np.ndarray, lengths: np.ndarray,
                     with_counts: bool = False):
        return self._compiled(didx, cfg, "packed")(
            *self._upload_wire(codes, lengths), with_counts=with_counts)

    def align_device(self, codes: np.ndarray, lengths: np.ndarray):
        """-> AlignResult, or (AlignResult, CandidateTable) with xa_tags,
        left on the device. Enqueues work only: nothing here waits for the
        device, so streaming_align keeps `depth` batches in flight."""
        return self._step(self.didx, self.cfg, codes, lengths, self.xa_tags)

    def align_device_packed(self, codes: np.ndarray, lengths: np.ndarray,
                            with_counts: bool = False):
        """The wire step (streaming_align's step when supports_packed):
        codes packed on the host, 2-bit codes + N mask + uint16 lengths up
        (22 B/read at L = 50, against 54 for align_device), PackedResult
        left on the device (13 B/read to fetch, against 42).
        -> PackedResult, or (PackedResult, counts [L, 4, 4]) with the
        profile counts computed in the same step from the same upload."""
        return self._step_packed(self.didx, self.cfg, codes, lengths,
                                 with_counts)

    def profile_counts_device(self, codes, lengths, res):
        if not hasattr(res, "mapped"):
            res = res[0]
        return self._compiled(self.didx, self.cfg, "counts")(
            *self._upload_reads(codes, lengths), res.mapped, res.strand,
            res.pos, res.ug_equal)

    def _fetch(self, res):
        """A step's output on the device -> (AlignResult, CandidateTable or
        None), numpy, in one transfer; a PackedResult is unpacked here into
        the same AlignResult."""
        with span("engine.fetch"):
            if isinstance(res, PackedResult):
                (packed,) = fetch_host(res)
                return unpack_result_host(packed, self.cfg.band_width), None
            table = None
            if not hasattr(res, "mapped"):
                res, table = res
            return fetch_host(res, table)

    # --- host finishing ---
    def to_host(self, batch: ReadBatch, res) -> HostAlignments:
        """Pull a step's results (AlignResult, PackedResult, or with XA the
        candidate table beside the AlignResult) to host in ONE transfer;
        run tracebacks for the rare gapped reads."""
        res, table = self._fetch(res)
        # the fetched arrays are this call's own host memory: the gapped
        # rows and the rescue tier's rows are written into them in place
        mapped, strand, pos, score = res.mapped, res.strand, res.pos, res.score
        mapq, x0, x1, nm = res.mapq, res.x0, res.x1, res.nm
        ug_eq, diag, tc = res.ug_equal, res.diag, res.tc_count
        lens = np.asarray(batch.lengths)
        self.last_rescue_rows = None
        # rescue dispatches NOW and merges after the primary host work, so
        # its device step overlaps the gapped tracebacks
        pend_rescue = None
        if self._rescue is not None:
            with span("engine.rescue"):
                pend_rescue = self._dispatch_rescue(batch, mapped)
        cigars = LazyCigars(mapped, lens)
        self._finish_gapped(batch.codes, lens, np.nonzero(mapped & ~ug_eq)[0],
                            strand, diag, pos, cigars, nm, tc)
        if pend_rescue is not None:
            with span("engine.rescue"):
                self._finish_rescue(pend_rescue, batch, cigars, mapped,
                                    strand, pos, score, mapq, x0, x1, nm,
                                    ug_eq, diag, tc)
        xa = None
        if table is not None:
            with span("engine.xa"):
                xa = self._xa_strings(batch, table, mapped, strand, pos,
                                      score)
        return HostAlignments(mapped=mapped, strand=strand, pos=pos,
                              score=score, mapq=mapq, x0=x0, x1=x1,
                              nm=nm, ug_equal=ug_eq, cigars=cigars,
                              tc_count=tc, xa=xa)

    def _finish_gapped(self, codes, lengths, rows, strand, diag, pos, cigars,
                       nm, tc) -> None:
        """Finish the gapped `rows` of one batch on the host: orient them,
        trace them back in one host_tracebacks_batch call, and write each
        row's start, CIGAR, NM and T->C count into pos, cigars, nm and tc
        (strand and diag: the batch's, by row). host_tracebacks_batch is
        the module's name, looked up at each call, so a timer patched over
        it sees every call."""
        if rows.shape[0] == 0:
            return
        seq = self.ref.seq
        om = orient_rows(codes, lengths, rows, strand)
        tbs = host_tracebacks_batch(seq, self.s_tensor, self.s_comp,
                                    self.cfg, om, lengths[rows],
                                    strand[rows], diag[rows])
        with span("engine.rows"):
            for k, b in enumerate(rows):
                p, cigar, total_nm = tbs[k]
                pos[b] = p
                cigars[b] = cigar
                nm[b] = total_nm
                tc[b] = tc_count_from_cigar(seq, p, om[k, : int(lengths[b])],
                                            int(strand[b]), cigar)

    def _dispatch_rescue(self, batch, mapped):
        """Two-tier seeding (config.rescue_kmer), dispatch half: enqueue the
        smaller-k device step over this batch's unmapped reads and return
        the pending handle; _finish_rescue merges after the primary host
        work.

        Rescued rows carry the cfg2 result wholesale. Profile counts: the
        device count matrix is keyed on the primary pass, so
        accumulate_profile_host counts rescued rows host-side from
        self.last_rescue_rows. XA alternates are not emitted for rescued
        rows. Unmapped rows beyond the rescue batch cap stay unmapped and
        are counted in self.rescue_overflow (no silent cap)."""
        cfg2, didx2, cap = self._rescue
        lens = np.asarray(batch.lengths)
        # n_total, not n_real (len(names)): padding rows are excluded by
        # their zero length, and nameless library-level batches still rescue
        n = batch.codes.shape[0]
        rows = np.nonzero(~mapped[:n] & (lens[:n] > 0))[0]
        if rows.shape[0] == 0:
            return None
        if rows.shape[0] > cap:
            self.rescue_overflow += int(rows.shape[0] - cap)
            rows = rows[:cap]
        L = batch.codes.shape[1]
        codes2 = np.full((cap, L), 4, dtype=np.int8)
        lens2 = np.zeros(cap, dtype=np.int32)
        codes2[: rows.shape[0]] = batch.codes[rows]
        lens2[: rows.shape[0]] = lens[rows]
        step = self._step_packed if self.supports_packed else self._step
        return rows, step(didx2, cfg2, codes2, lens2)

    def _finish_rescue(self, pend, batch, cigars, *arrays) -> None:
        """Merge half of the rescue pass: fetch the small-k results, write
        rescued rows into the batch's result arrays in place (so `cigars`,
        built on their `mapped`, gives them their "{L}M" default), and
        finish the gapped rescued rows. Band and gap parameters are equal
        between tiers, so host_tracebacks_batch under self.cfg is exact for
        the rescue tier too."""
        rows, out2 = pend
        r2, _ = self._fetch(out2)
        m2 = r2.mapped[: rows.shape[0]]
        if not m2.any():
            return
        hit = rows[m2]
        src = np.nonzero(m2)[0]
        self.rescue_mapped += int(hit.shape[0])
        self.last_rescue_rows = hit
        for o, f in zip(arrays, ("mapped", "strand", "pos", "score", "mapq",
                                 "x0", "x1", "nm", "ug_equal", "diag",
                                 "tc_count")):
            o[hit] = getattr(r2, f)[src]
        (_mapped, strand, pos, _score, _mapq, _x0, _x1, nm, ug_eq, diag,
         tc) = arrays
        self._finish_gapped(batch.codes, np.asarray(batch.lengths),
                            hit[~ug_eq[hit]], strand, diag, pos, cigars, nm,
                            tc)

    def _xa_strings(self, batch, table, mapped, strand, pos, score,
                    rows=None):
        """Per-read XA:Z alternative-hit tags (BWA samse convention:
        chrom,(+/-)pos1,CIGAR,NM). Gapped alternates get a host DP traceback
        for a real CIGAR. At most xa_limit alternates are emitted per read;
        overflow alternates are COUNTED in self.xa_dropped rather than
        silently discarded. rows optionally restricts emission to a subset
        of batch rows (combined mode handles transcript-candidate rows in
        its slow path)."""
        from parasuite_tpu_torch.io.sam import cigar_string

        t_valid = np.asarray(table.valid)
        t_strand = np.asarray(table.strand)
        t_pos = np.asarray(table.pos)
        t_score = np.asarray(table.score)
        t_ug = np.asarray(table.ug_equal)
        t_diag = np.asarray(table.diag)
        B, n = t_valid.shape
        xa: list = [None] * B
        G = self.sam_ref.seq.shape[0]
        for b in (range(B) if rows is None else rows):
            b = int(b)
            if not mapped[b] or not t_valid[b].any():
                continue
            ln = int(batch.lengths[b])
            # unique alternates != the chosen hit (seen keys are final
            # positions: gapped alternates dedupe AFTER traceback so a
            # traceback-shifted winner is never re-emitted as an alternate).
            # xa_dropped is an approximate upper bound — post-cap uniques
            # are keyed by ungapped t_pos (no traceback).
            seen = {(int(strand[b]), int(pos[b]))}
            alts = []  # (strand, packed_pos, cigar_str, nm)
            oriented_cache = {}
            tb_cache = {}  # (strand, diag) -> traceback: one DP per diagonal

            def oriented_for(st):
                if st not in oriented_cache:
                    oriented_cache[st] = (batch.codes[b, :ln] if st == 0
                                          else revcomp_codes(
                                              batch.codes[b, :ln]))
                return oriented_cache[st]

            order = np.lexsort((t_pos[b], t_strand[b], -t_score[b]))
            for t in order:
                if not t_valid[b, t]:
                    continue
                st = int(t_strand[b, t])
                if len(alts) >= self.xa_limit:
                    # over the cap: count uniques by ungapped key (cheap,
                    # no traceback) instead of dropping silently
                    if (st, int(t_pos[b, t])) not in seen:
                        seen.add((st, int(t_pos[b, t])))
                        self.xa_dropped += 1
                    continue
                if t_ug[b, t]:
                    p = int(t_pos[b, t])
                    key = (st, p)
                    if key in seen:
                        continue
                    seen.add(key)
                    alts.append((st, p, f"{ln}M", None))
                else:
                    dkey = (st, int(t_diag[b, t]))
                    if dkey not in tb_cache:
                        tb_cache[dkey] = host_traceback(
                            self.sam_ref.seq, self.s_tensor, self.s_comp,
                            self.cfg, oriented_for(st), ln, st, dkey[1])
                    p, cigar, nm_alt = tb_cache[dkey]
                    key = (st, p)
                    if key in seen:
                        continue
                    seen.add(key)
                    alts.append((st, p, cigar_string(cigar), nm_alt))
            if not alts:
                continue
            parts = []
            for st, p, cig, nm_alt in alts:
                ci, local = self.sam_ref.locate(np.asarray([p]))
                if ci[0] < 0 or p + ln > G:
                    continue
                if nm_alt is None:
                    oriented = oriented_for(st)
                    rb = self.sam_ref.seq[p : p + ln]
                    nm_alt = int(np.sum((rb != oriented) | (rb == N)
                                        | (oriented == N)))
                parts.append(f"{self.sam_ref.names[int(ci[0])]},"
                             f"{'+' if st == 0 else '-'}{int(local[0]) + 1},"
                             f"{cig},{nm_alt}")
            if parts:
                xa[b] = "XA:Z:" + ";".join(parts) + ";"
        return xa

    def gapped_indel_counts(self, batch: ReadBatch, res, ins_counts,
                            del_counts, sub_counts=None) -> int:
        """Accumulate indel events — and, when sub_counts is given, the
        M-segment substitution counts — from this batch's gapped alignments
        (host tracebacks). Feeds ErrorProfile during pass-1 inference so
        every aligned read contributes. Returns the number of gapped
        reads."""
        if not isinstance(res, PackedResult) and not hasattr(res, "mapped"):
            res = res[0]
        res, _ = self._fetch(res)
        n = batch.n_real
        lens = np.asarray(batch.lengths)
        grows = np.nonzero(res.mapped[:n] & ~res.ug_equal[:n])[0]
        cigars = LazyCigars(res.mapped, lens)
        self._finish_gapped(batch.codes, lens, grows, res.strand, res.diag,
                            res.pos, cigars, res.nm, res.tc_count)
        if sub_counts is None:
            sub_counts = np.zeros((self.cfg.max_read_len, 4, 4), np.int64)
        self._count_cigars(batch, grows, res.strand, res.pos, cigars,
                           sub_counts, ins_counts, del_counts)
        return int(grows.shape[0])

    def accumulate_profile_host(self, batch: ReadBatch, host: HostAlignments,
                                subs: np.ndarray, ins: np.ndarray,
                                dels: np.ndarray) -> tuple[int, int]:
        """The host's share of one batch's profile, after to_host: what
        the step's fused counts did not see. Those hold the primary tier's
        ungapped rows; this adds the gapped rows' substitutions and indels
        from their CIGARs, and the substitutions of the rows the rescue
        tier mapped ungapped in this batch (last_rescue_rows), so every
        emitted mapped record counts once (SURVEY.md §3.3).
        -> (reads profiled, gapped rows counted)."""
        lens = np.asarray(batch.lengths)
        n = batch.n_real
        mapped, ug = host.mapped, host.ug_equal
        gapped = np.nonzero(mapped[:n] & ~ug[:n])[0]
        rows = gapped
        r = self.last_rescue_rows
        if r is not None:
            # an ungapped row's CIGAR is one M run: no indel events
            rows = np.concatenate([gapped, r[mapped[r] & ug[r]]])
        self._count_cigars(batch, rows, host.strand, host.pos, host.cigars,
                           subs, ins, dels)
        return (int((mapped & (lens[:mapped.shape[0]] > 0)).sum()),
                int(gapped.shape[0]))

    def _count_cigars(self, batch, rows, strand, pos, cigars, subs, ins,
                      dels) -> None:
        """Count `rows` of one batch as the record loop writes them: the
        substitutions over each CIGAR's M segments into subs, its indel
        events into ins and dels. The counters are errormodel.infer's
        names, looked up at each call."""
        from parasuite_tpu_torch.errormodel.infer import (
            count_indels_from_cigar, count_substitutions_from_cigar)

        lens = np.asarray(batch.lengths)
        om = orient_rows(batch.codes, lens, rows, strand)
        for k, b in enumerate(rows):
            ln, st, cigar = int(lens[b]), int(strand[b]), cigars[b]
            count_substitutions_from_cigar(self.sam_ref.seq, int(pos[b]),
                                           om[k, :ln], ln, st, cigar, subs)
            count_indels_from_cigar(cigar, ln, st, ins, dels)

    # --- one-call convenience ---
    def align_to_host(self, batch: ReadBatch) -> HostAlignments:
        return self.to_host(batch, self.align_device(batch.codes,
                                                     batch.lengths))

    def emit_sam(self, batch: ReadBatch, host: HostAlignments, writer) -> None:
        """Emit records in read order.

        Every record without an XA tag — ungapped, unmapped, gapped and
        junction CIGARs — goes through the native C++ batch formatter, one
        call per run of such records (bytes identical to format_record —
        tests/test_native.py); XA-tagged records use the Python path."""
        self._emit(batch, host, writer, bam=False)

    def emit_bam(self, batch: ReadBatch, host: HostAlignments, writer) -> None:
        """emit_sam's binary twin: the C++ BAM-record formatter (bytes
        identical to encode_bam_record over the SAM text —
        tests/test_native.py); XA records go to writer.write as SAM text
        and the BAM sink encodes them."""
        self._emit(batch, host, writer, bam=True)

    def _emit(self, batch, host, writer, bam: bool) -> None:
        from parasuite_tpu_torch import native

        n = batch.n_real
        use_native = (native.available()
                      and hasattr(writer, "write_block"))
        if not use_native:
            for b in range(n):
                writer.write(self._format_one(batch, host, b))
            return
        fmt = native.bam_format_batch if bam else native.sam_format_batch

        def emit_run(b: int, e: int) -> None:
            # A record the C++ formatter cannot represent (name+NUL > 255
            # bytes, MD text past its fixed buffer — possible with raised
            # max_read_len) returns -1 and the wrapper raises; that must not
            # abort the stream. Fall back to the per-record Python formatter
            # for this run.
            try:
                writer.write_block(self._format_native_run(batch, host, b, e,
                                                           fmt))
            except RuntimeError:
                for i in range(b, e):
                    writer.write(self._format_one(batch, host, i))

        if host.xa is None:
            emit_run(0, n)
            return
        elig = np.asarray([host.xa[b] is None for b in range(n)])
        bounds = np.flatnonzero(elig[1:] != elig[:-1]) + 1
        edges = np.concatenate(([0], bounds, [n]))
        for b, e in zip(edges[:-1], edges[1:]):
            b, e = int(b), int(e)
            if elig[b]:
                emit_run(b, e)
            else:
                for i in range(b, e):
                    writer.write(self._format_one(batch, host, i))

    _OP_CODE = {"M": 0, "I": 1, "D": 2, "N": 3}

    def _cigar_arrays(self, host, b, e):
        """Flat (cig_off, ops, lens) arrays for records [b, e) with
        non-default CIGARs (None when every record is default)."""
        items = host.cigars.overrides_in(b, e)
        if not items:
            return None
        counts = np.zeros(e - b, dtype=np.int64)
        for i, c in items:
            counts[i - b] = len(c)
        off = np.zeros(e - b + 1, dtype=np.int64)
        np.cumsum(counts, out=off[1:])
        total = int(off[-1])
        ops = np.zeros(total, dtype=np.uint8)
        lens = np.zeros(total, dtype=np.int32)
        code = self._OP_CODE
        for i, c in items:
            o = int(off[i - b])
            for k, (op, ln) in enumerate(c):
                ops[o + k] = code[op]
                lens[o + k] = ln
        return off, ops, lens

    def _format_one(self, batch, host, b) -> str:
        extra = None
        if host.xa is not None and host.xa[b]:
            extra = [host.xa[b]]
        return format_record(
            batch.names[b], batch.codes[b], int(batch.lengths[b]),
            batch.qual_bytes(b), self.sam_ref,
            mapped=bool(host.mapped[b]), strand=int(host.strand[b]),
            packed_pos=int(host.pos[b]), mapq=int(host.mapq[b]),
            cigar=host.cigars[b], score=int(host.score[b]),
            nm=int(host.nm[b]), x0=int(host.x0[b]), x1=int(host.x1[b]),
            extra_tags=extra)

    def _format_native_run(self, batch, host, b, e, fmt) -> bytes:
        """Records [b, e) through one native formatter call."""
        from parasuite_tpu_torch.io.batch import NameBlock

        sl = slice(b, e)
        mapped = host.mapped[sl]
        strand = host.strand[sl]
        flag = np.where(mapped, np.where(strand == 1, 16, 0), 4)
        pos = host.pos[sl].astype(np.int64)
        ci, local = self.sam_ref.locate(np.where(mapped, pos, 0))
        # NameBlock.raw: (blob, offsets) pass-through, zero per-record work;
        # list[str] batches (tests/tools) join inside sam_format_batch
        names = (batch.names.raw(b, e)
                 if isinstance(batch.names, NameBlock) else batch.names[sl])
        return fmt(
            self.sam_ref.seq, batch.codes[sl], batch.lengths[sl],
            names, batch.quals[sl], self.sam_ref.names,
            flag, np.maximum(ci, 0), (local + 1).astype(np.int32),
            pos, host.mapq[sl], host.nm[sl], host.x0[sl], host.x1[sl],
            host.score[sl], cigars=self._cigar_arrays(host, b, e))
