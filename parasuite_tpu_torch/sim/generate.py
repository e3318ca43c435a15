"""PAR-CLIP read simulator of the port (SURVEY.md §2 component 8, §3.4).

A twin of parasuite_tpu/sim/generate.py:30-260 (that package imports jax
when it is imported): SimTruth, _valid_starts, _indel_rate_vec, simulate_reads,
simulate_quality and simulate_binding_sites give the same reads, truth and
qualities bit for bit for the same (seed, n, read_len, options), pinned by
tests/test_torch_sim.py.

The reference draws with jax.random on the CPU on purpose: simulation is
benchmark set-up, not device work (generate.py:98-112). The port does the
same on the host, in numpy, through sim/threefry.py, the same threefry2x32
stream; every array keeps the dtype the reference's x32 mode gives it
(int32 positions, float32 uniforms compared against float32 rates).

Error model: conversions first (every machine-frame T converts i.i.d. with
tc_rate, or only inside a crosslink window in site mode), then sequencing
errors: a learned profile's conditional table P(obs | true, cycle) or a
flat uniform error rate.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from parasuite_tpu_torch.config import AlignConfig
from parasuite_tpu_torch.index.reference import PackedReference
from parasuite_tpu_torch.utils.dna import C, N, T
from parasuite_tpu_torch.sim import threefry as tf


@dataclass
class SimTruth:
    """Ground truth for simulated reads (all [n])."""

    packed_pos: np.ndarray   # int64 packed start of the source fragment
    chrom_idx: np.ndarray    # int32
    local_pos: np.ndarray    # int64 0-based within chromosome
    strand: np.ndarray       # int8
    n_conversions: np.ndarray  # int32 injected T->C count
    n_errors: np.ndarray     # int32 injected sequencing errors
    indel_kind: np.ndarray | None = None  # int8: 0 none, 1 ins, 2 del
    indel_pos: np.ndarray | None = None   # int32 machine cycle of the event

    def names(self, prefix: str = "sim") -> list[str]:
        return [f"{prefix}_{i}:{int(self.chrom_idx[i])}:"
                f"{int(self.local_pos[i])}:{int(self.strand[i])}"
                for i in range(self.packed_pos.shape[0])]

    @staticmethod
    def parse_name(name: str) -> tuple[int, int, int]:
        """-> (chrom_idx, local_pos, strand)."""
        _, ci, pos, strand = name.rsplit(":", 3)
        return int(ci), int(pos), int(strand)


def _valid_starts(ref: PackedReference, read_len: int) -> np.ndarray:
    """Packed positions whose read_len window contains no N (host, once)."""
    is_n = (ref.seq == N).astype(np.int64)
    cum = np.concatenate([[0], np.cumsum(is_n)])
    ok = (cum[read_len:] - cum[:-read_len]) == 0
    return np.nonzero(ok)[0].astype(np.int64)


def _indel_rate_vec(rate, read_len: int, lo: int, hi: int) -> np.ndarray:
    """Scalar-or-per-cycle rate -> per-cycle vector masked to the interior."""
    out = np.zeros(read_len, dtype=np.float64)
    if rate is None:
        return out
    r = np.asarray(rate, dtype=np.float64)
    v = np.full(read_len, float(r)) if r.ndim == 0 else np.pad(
        r[:read_len], (0, max(0, read_len - r.shape[0])))
    out[lo:hi] = v[lo:hi]
    return out


def simulate_reads(ref: PackedReference, n: int, read_len: int,
                   cfg: AlignConfig, seed: int | None = None,
                   profile_probs: np.ndarray | None = None,
                   tc_rate: float | None = None,
                   site_positions: np.ndarray | None = None,
                   ins_rate=None, del_rate=None
                   ) -> tuple[np.ndarray, np.ndarray, SimTruth]:
    """-> (codes int8 [n, read_len], lengths int32 [n], SimTruth).

    site_positions: optional packed coordinates of crosslink sites; when
    given, reads are sampled to overlap a site and conversions only occur at
    machine-frame Ts within +-2 of the site (binding-site mode); otherwise
    positions are uniform over N-free windows and every T converts i.i.d.

    ins_rate/del_rate: scalar per-cycle probability or a per-cycle array
    (ErrorProfile.indel_rates()). At most one indel per read, drawn over
    interior cycles [4, L-4) so the alignment's genome start is unchanged
    by the event.
    """
    tc_rate = cfg.sim_tc_rate if tc_rate is None else tc_rate
    seed = cfg.seed if seed is None else seed
    key = tf.prng_key(seed)
    k_pos, k_strand, k_tc, k_err, k_errbase = tf.split(key, 5)
    # fold_in (not a 6-way split): keeps the no-indel stream unchanged
    k_indel = tf.fold_in(key, 0x1D3)

    L = read_len
    lo = min(4, max(1, L // 4))
    hi = max(L - lo, lo + 1)
    ins_v = _indel_rate_vec(ins_rate, L, lo, hi)
    del_v = _indel_rate_vec(del_rate, L, lo, hi)
    p_ins, p_del = float(ins_v.sum()), float(del_v.sum())
    if p_ins + p_del > 0.9:
        raise ValueError(
            f"per-read indel probability {p_ins + p_del:.3f} too high for "
            "the one-event model (sum of per-cycle rates must be << 1)")
    # a deletion reads one base past the window: size the N-free window for it
    win = read_len + (1 if p_del > 0 else 0)

    if site_positions is not None:
        sites = np.asarray(site_positions, dtype=np.int64).astype(np.int32)
        k_site, k_off = tf.split(k_pos, 2)
        si = tf.randint(k_site, (n,), 0, sites.shape[0])
        # read must cover the site: offset of site within read in [2, L-3]
        off = tf.randint(k_off, (n,), 2, read_len - 2)
        pos = sites[si] - off
        site_off = off
    else:
        starts = _valid_starts(ref, win).astype(np.int32)
        pos = starts[tf.randint(k_pos, (n,), 0, starts.shape[0])]
        site_off = None

    strand = tf.bernoulli(k_strand, 0.5, (n,)).astype(np.int8)

    G = ref.total_len
    i = np.arange(L, dtype=np.int32)
    if p_ins + p_del > 0:
        k_kind, k_ipos, k_dpos, k_ibase = tf.split(k_indel, 4)
        u = tf.uniform(k_kind, (n,))
        kind = np.where(u < np.float32(p_ins), 1,
                        np.where(u < np.float32(p_ins + p_del), 2,
                                 0)).astype(np.int32)
        log_i = tf.log_f32(ins_v.astype(np.float32) + np.float32(1e-30))
        log_d = tf.log_f32(del_v.astype(np.float32) + np.float32(1e-30))
        jpos = np.where(kind == 1, tf.categorical(k_ipos, log_i, (n,)),
                        tf.categorical(k_dpos, log_d, (n,))).astype(np.int32)
        ibase = tf.randint(k_ibase, (n,), 0, 4)
    else:
        kind = np.zeros(n, dtype=np.int32)
        jpos = np.zeros(n, dtype=np.int32)
        ibase = np.zeros(n, dtype=np.int32)

    # machine cycle i -> genome offset within the source window. A deletion
    # skips one genome base after cycle j; an insertion repeats none (cycle j
    # is a random base); reverse-strand reads walk the window top-down.
    after_d = (i[None, :] >= jpos[:, None]).astype(np.int32)
    after_i = (i[None, :] > jpos[:, None]).astype(np.int32)
    g_fwd = np.where(kind[:, None] == 2, i[None, :] + after_d,
                     np.where(kind[:, None] == 1, i[None, :] - after_i,
                              i[None, :]))
    span = (L + (kind == 2).astype(np.int32)
            - (kind == 1).astype(np.int32))
    g = np.where(strand[:, None] == 1, span[:, None] - 1 - g_fwd, g_fwd)
    ridx = np.clip(pos[:, None] + g, 0, G - 1)
    frag = ref.seq[ridx].astype(np.int32)
    comp = np.asarray([3, 2, 1, 0, 4], dtype=np.int32)
    machine = np.where(strand[:, None] == 1, comp[frag], frag)
    machine = np.where((kind[:, None] == 1) & (i[None, :] == jpos[:, None]),
                       ibase[:, None], machine)

    # T->C conversions (machine frame: PAR-CLIP conversions always read T->C)
    u_tc = tf.uniform(k_tc, (n, read_len))
    conv_ok = (machine == T) & (u_tc < np.float32(tc_rate))
    if site_off is not None:
        # restrict to +-2 around the crosslink site, in machine coordinates
        m_off = np.where(strand == 1, read_len - 1 - site_off, site_off)
        conv_ok = conv_ok & (np.abs(i[None, :] - m_off[:, None]) <= 2)
    converted = np.where(conv_ok, C, machine)

    # sequencing errors
    if profile_probs is not None:
        p = np.asarray(profile_probs, dtype=np.float64)[:read_len]
        logits = tf.log_f32(p.astype(np.float32) + np.float32(1e-12))
        # jnp gathers clamp out-of-range indices (cycles past the profile,
        # an N base) to the last row/column
        row = logits[np.minimum(i, logits.shape[0] - 1)[None, :],
                     np.minimum(converted, logits.shape[1] - 1)]
        final = tf.categorical(k_err, row).astype(np.int32)
    else:
        u_err = tf.uniform(k_err, (n, read_len))
        shift = tf.randint(k_errbase, (n, read_len), 1, 4)
        err = u_err < np.float32(cfg.sim_error_rate)
        final = np.where(err, (converted + shift) % 4, converted)

    n_conv = conv_ok.sum(axis=1).astype(np.int32)
    n_err = (final != converted).sum(axis=1).astype(np.int32)

    codes = final.astype(np.int8)
    pos_np = pos.astype(np.int64)
    ci, local = ref.locate(pos_np)
    truth = SimTruth(packed_pos=pos_np, chrom_idx=ci.astype(np.int32),
                     local_pos=local, strand=strand,
                     n_conversions=n_conv, n_errors=n_err,
                     indel_kind=kind.astype(np.int8),
                     indel_pos=jpos.astype(np.int32))
    lengths = np.full(n, read_len, dtype=np.int32)
    return codes, lengths, truth


def simulate_quality(n: int, read_len: int, seed: int = 0) -> np.ndarray:
    """Plausible per-cycle phred+33 quality strings.

    Model: Illumina-shaped decay — mean quality starts ~Q38 and falls ~Q12
    by the last cycle, with per-base Gaussian jitter (sigma 3), clipped to
    [2, 40]. Deterministic in (n, read_len, seed); the aligner ignores
    QUAL for scoring (as bwa aln does), so this only shapes I/O surfaces.

    -> uint8 [n, read_len] ASCII (phred+33).
    """
    rng = np.random.default_rng(seed + 0x51AC)
    i = np.arange(read_len, dtype=np.float64)
    mean = 38.0 - 12.0 * i / max(read_len - 1, 1)
    q = mean[None, :] + rng.normal(0.0, 3.0, size=(n, read_len))
    q = np.clip(np.rint(q), 2, 40).astype(np.uint8)
    return q + 33


def simulate_binding_sites(ref: PackedReference, n_sites: int, read_len: int,
                           seed: int = 0) -> np.ndarray:
    """Sample crosslink-site packed coordinates (machine-frame T positions
    are not enforced; conversion masking handles that)."""
    rng = np.random.default_rng(seed)
    starts = _valid_starts(ref, read_len)
    # keep sites far enough from window edges for any offset
    ok = starts[(starts > read_len) & (starts < ref.total_len - 2 * read_len)]
    return np.sort(rng.choice(ok, size=n_sites, replace=False))
