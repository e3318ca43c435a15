"""The extension kernel's arithmetic, emulated in numpy int32 on the CPU.

csrc/extend_candidates.cu cannot run here, so this file repeats what one of
its threads computes, in the kernel's own order: the staged score rows and
reference windows of its block, the substitution of cell (i, j) read at the
shared-memory byte offset w(i + j) - 20 j, T = max3(M, Ix, Iy) carried from
row to row, mg = M - go computed once a cell and used by both gap states,
viaddmax(a, b, c) = max(a + b, c), and the stop at the read's length. The
emulation is held, at tolerance 0, to the port's plain version
(cuda_extend.extend_candidates_plain) and to the JAX package's
aligner.extend_candidates on the same numpy inputs (testing.extend_case):
every band width the kernel is built for, at L = 36 and 50.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parasuite_tpu.config import AlignConfig as JAlignConfig
from parasuite_tpu.ops import aligner as jx
from parasuite_tpu.ops.device_index import DeviceIndex as JDeviceIndex
from parasuite_tpu.ops.device_index import ScoreParams as JScoreParams
from parasuite_tpu_torch.config import AlignConfig
from parasuite_tpu_torch.ops import cuda_extend
from parasuite_tpu_torch.ops.device_index import DeviceIndex, ScoreParams
from parasuite_tpu_torch.testing import EXTEND_CASES, extend_case

torch.set_num_threads(1)

NEG = np.int32(-(1 << 28))
THREADS = 128        # kThreads: pairs of a block


def row_words(L):
    """Words of one staged score row (>= 5 L, = 8 mod 32)."""
    return (5 * L + 23) // 32 * 32 + 8


def viaddmax(a, b, c):
    return np.maximum(a + b, c)


def vimax3(a, b, c):
    return np.maximum(np.maximum(a, b), c)


def emulate_kernel(ref, oriented, lengths, cand, s_fwd, s_comp, W, go, ge):
    """Every thread of every block of extend_kernel<2W + 1>, vectorised
    over the pairs; int32 throughout -> (dp_score, dp_j, ug_score, ug_j)."""
    B, _, L = oriented.shape
    C = cand.shape[1]
    BAND, win, G = 2 * W + 1, L + 2 * W, ref.shape[0]
    P = 2 * B * C
    rs = row_words(L)
    reads2 = oriented.reshape(2 * B, L)
    p = np.arange(P)
    b2 = p // C
    b2_first = (p // THREADS) * THREADS // C
    row = ((b2 - b2_first) * rs * 4).astype(np.int32)    # byte offset
    # shared memory of each pair's block: its score rows, as int32 words
    n_blocks = -(-P // THREADS)
    rows = np.zeros((n_blocks, rs * (THREADS // C + 2)), dtype=np.int32)
    for q in range(2 * B):
        blk = (q * C) // THREADS
        r = q - blk * THREADS // C
        n = int(lengths[q >> 1])
        tab = s_comp if q & 1 else s_fwd
        for i in range(min(n, L)):
            prof = i if q % 2 == 0 else min(max(n - 1 - i, 0), L - 1)
            rows[blk, r * rs + 5 * i:r * rs + 5 * i + 5] = \
                tab[prof, :, reads2[q, i]]
    # reference windows, 4 * code, N outside [0, G); w(t) = row + 20 t + 4c
    base = np.clip(cand.reshape(P), -(win + 1), G) - W
    t = np.arange(win)
    pos = base[:, None] + t[None, :]
    code = np.where((pos >= 0) & (pos < G), ref[np.clip(pos, 0, G - 1)], 4)
    w = (row[:, None] + 20 * t[None, :] + 4 * code).astype(np.int32)
    blk = p // THREADS

    def sub(i, j):
        off = w[:, i + j] - 20 * j
        assert (off % 4 == 0).all()
        return rows[blk, off // 4]

    steps = np.minimum(lengths[b2 >> 1], L)
    nge, go = np.int32(-ge), np.int32(go)
    ix_last = viaddmax(NEG, nge, NEG - go)
    tt = np.zeros((P, BAND), dtype=np.int32)
    ix = np.full((P, BAND), NEG, dtype=np.int32)
    ug = np.zeros((P, BAND), dtype=np.int32)
    m_out = np.full((P, BAND), NEG, dtype=np.int32)
    ug_out = np.zeros((P, BAND), dtype=np.int32)
    for i in range(L):
        live = i < steps
        if not live.any():
            break
        s = np.stack([sub(i, j) for j in range(BAND)], axis=1)
        m = s + tt
        ug = ug + s
        last = live & (i + 1 == steps)
        m_out[last], ug_out[last] = m[last], ug[last]
        mg = m - go
        iy = np.empty_like(m)
        iy[:, 0] = NEG
        if BAND > 1:
            iy[:, 1] = mg[:, 0]
        for j in range(2, BAND):
            iy[:, j] = viaddmax(iy[:, j - 1], nge, mg[:, j - 1])
        tt = vimax3(m, ix, iy)
        ix = np.concatenate([viaddmax(ix[:, 1:], nge, mg[:, 1:]),
                             np.full((P, 1), ix_last, dtype=np.int32)],
                            axis=1)
        assert min(tt.min(), ix.min(), m.min()) > -(1 << 29)  # no wrap
    # the smallest j of the best, as the kernel's strict > scan gives it
    shape = (2 * B, C)
    return (m_out.max(1).reshape(shape), m_out.argmax(1).reshape(shape),
            ug_out.max(1).reshape(shape),
            ug_out.argmax(1).reshape(shape)), (m_out, ug_out)


@pytest.mark.parametrize("W,L", EXTEND_CASES)
def test_kernel_arithmetic_equals_plain_and_jax(W, L):
    """Tolerance 0 against both references: learned tables that differ by
    strand, go == ge at even W, reads of length 0 and shorter than L, an
    all-N read, diagonals off both ends, ties for the best j."""
    c = extend_case(W, L)
    C = c["cand"].shape[1]
    kw = dict(max_read_len=L, band_width=W, max_candidates=C,
              gap_open=c["go"], gap_extend=c["ge"], chrom_spacer=L + 2 * W)
    got, (m_fin, ug_fin) = emulate_kernel(
        c["ref"], c["oriented"], c["lengths"], c["cand"], c["s_fwd"],
        c["s_comp"], W, c["go"], c["ge"])

    zeros = np.zeros(1, dtype=np.int32)
    didx = DeviceIndex.from_numpy(c["ref"], zeros, zeros, zeros, zeros,
                                  device="cpu")
    sprof = ScoreParams.from_numpy(c["s_fwd"], c["s_comp"],
                                   np.zeros(256, dtype=np.int32),
                                   device="cpu")
    plain = cuda_extend.extend_candidates_plain(
        torch.from_numpy(c["oriented"]), torch.from_numpy(c["lengths"]),
        torch.from_numpy(c["cand"]), didx, sprof, AlignConfig(**kw))

    jd = JDeviceIndex(jnp.asarray(c["ref"]), *(jnp.asarray(zeros),) * 4)
    js = JScoreParams(jnp.asarray(c["s_fwd"]), jnp.asarray(c["s_comp"]),
                      jnp.zeros(256, dtype=jnp.int32))
    jcfg = JAlignConfig(**kw)
    jax_out = jax.jit(lambda o, n, d, di, sp: jx.extend_candidates(
        o, n, d, di, sp, jcfg))(c["oriented"], c["lengths"], c["cand"], jd,
                                js)
    names = ("dp_score", "dp_j", "ug_score", "ug_j")
    for name, g, pl, jo in zip(names, got, plain, jax_out):
        np.testing.assert_array_equal(g, pl.numpy(), err_msg=name)
        np.testing.assert_array_equal(g, np.asarray(jo), err_msg=name)
    # the edges the case is built to reach are reached
    dp_score, dp_j, ug_score, ug_j = got
    assert (dp_score[8:10] == NEG).all()         # the read of length 0
    if W == 0:                                   # one diagonal: no j, no gap
        return
    assert (dp_j > 0).any() and (ug_j > 0).any()
    for fin in (m_fin, ug_fin):                  # ties for the best j
        assert ((fin == fin.max(1, keepdims=True)).sum(1) > 1).any()
    assert (dp_score > ug_score).any()           # a gapped path wins
