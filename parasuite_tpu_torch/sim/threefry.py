"""jax.random's threefry2x32 stream in numpy, bit for bit.

The JAX simulator (parasuite_tpu/sim/generate.py) draws with jax.random on
the CPU; this module gives the same bits for the same key without jax, so
the port's simulator writes the same reads. It follows jax 0.9.0 with
jax_threefry_partitionable = True (the default there), whose counters are
the 64-bit row-major index of each element (prng.iota_2x32_shape):

  PRNGKey(seed)      (0, seed mod 2**32) for a seed in the int32 range
                     (prng.threefry_seed of jnp.asarray(np.int64(seed)),
                     which x32 mode makes an int32)
  split(key, num)    key i = threefry2x32(key, (0, i))
  fold_in(key, d)    threefry2x32(key, (0, d))
  random_bits        threefry2x32(key, (hi, lo) of the index), y0 ^ y1
  uniform            mantissa bits (bits >> 9) | 0x3F800000, minus 1.0,
                     then * (maxval - minval) + minval, max with minval
  bernoulli          uniform < p in float32
  randint            jax's two-draw method: split in two, span modulus
                     with the multiplier (2**16 mod span)**2 mod span,
                     all in wrapping uint32
  categorical        argmax(gumbel + logits), gumbel = -log(-log(u)),
                     u ~ uniform(tiny, 1) in float32

The logs are XLA:CPU's float32 log, not numpy's: jnp.log on the CPU is the
Cephes polynomial (xla/service/cpu polynomial_approximations) with every
multiply-add fused by LLVM, and it differs from numpy's float32 log in
about one value in ten. log_f32 reproduces it; the FMAs are exact (an
exact float32 product in float64, one rounding of the sum there, and the
rare double-rounding midpoint settled by the sum's exact error).

Draws over many elements run in chunks of CHUNK counters, so the
temporaries of the 20 rounds stay small, on a pool of threads (numpy
releases the GIL inside its loops); each chunk writes its own slice of the
output, so the result does not depend on the pool.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

CHUNK = 1 << 20
WORKERS = min(8, os.cpu_count() or 1)
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_U32 = np.uint32


def threefry2x32(key, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 (20 rounds) of the counter pairs (x0, x1) under key
    -> (y0, y1), uint32 arrays of the counters' shape."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, _U32(k0 ^ k1 ^ _U32(0x1BD11BDA)))
    a = np.asarray(x0, dtype=_U32) + ks[0]
    b = np.asarray(x1, dtype=_U32) + ks[1]
    for i in range(5):
        for r in _ROT[i % 2]:
            a += b
            b = (b << _U32(r)) | (b >> _U32(32 - r))
            b ^= a
        a += ks[(i + 1) % 3]
        b += ks[(i + 2) % 3]
        b += _U32(i + 1)
    return a, b


def prng_key(seed: int) -> np.ndarray:
    """jax.random.PRNGKey(seed) -> uint32 [2]."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed {seed} is outside the int32 range that "
                         "jax's x32 mode keeps")
    return np.asarray([0, seed & 0xFFFFFFFF], dtype=_U32)


def split(key, num: int) -> np.ndarray:
    """jax.random.split(key, num) -> uint32 [num, 2]."""
    y0, y1 = threefry2x32(key, np.zeros(num, _U32),
                          np.arange(num, dtype=_U32))
    return np.stack([y0, y1], axis=1)


def fold_in(key, data: int) -> np.ndarray:
    """jax.random.fold_in(key, data) -> uint32 [2]."""
    y0, y1 = threefry2x32(key, np.zeros(1, _U32),
                          np.asarray([data & 0xFFFFFFFF], dtype=_U32))
    return np.asarray([y0[0], y1[0]], dtype=_U32)


def _bits_range(key, start: int, stop: int) -> np.ndarray:
    """32-bit random_bits of the flat counters [start, stop)."""
    idx = np.arange(start, stop, dtype=np.uint64)
    y0, y1 = threefry2x32(key, (idx >> np.uint64(32)).astype(_U32),
                          idx.astype(_U32))
    return y0 ^ y1


def _in_chunks(fn, total: int, step: int) -> None:
    """fn(lo, hi) over [0, total) in steps, on the thread pool."""
    spans = [(lo, min(lo + step, total)) for lo in range(0, total, step)]
    if len(spans) <= 1 or WORKERS == 1:
        for lo, hi in spans:
            fn(lo, hi)
        return
    with ThreadPoolExecutor(max_workers=WORKERS) as pool:
        for f in [pool.submit(fn, lo, hi) for lo, hi in spans]:
            f.result()


def random_bits(key, shape) -> np.ndarray:
    """jax.random.bits(key, shape) for 32-bit words -> uint32 [shape]."""
    shape = tuple(shape)
    size = int(np.prod(shape, dtype=np.int64))
    out = np.empty(size, dtype=_U32)

    def fill(lo, hi):
        out[lo:hi] = _bits_range(key, lo, hi)

    _in_chunks(fill, size, CHUNK)
    return out.reshape(shape)


_MID_MASK = np.uint64((1 << 29) - 1)   # float64 bits below float32's
_MID = np.uint64(1 << 28)


def _fma32(a, b, c) -> np.ndarray:
    """Fused a * b + c of float32 operands, rounded once to float32.

    The product is exact in float64 and the sum rounds once there; the
    cast to float32 is then correct unless that sum sits exactly on a
    float32 rounding midpoint (29 low bits 100...0, about one value in
    2**28), where the sum's own rounding error decides the direction."""
    p = np.multiply(a, b, dtype=np.float64)                 # exact
    s = np.asarray(p + c)
    mid = (s.view(np.uint64) & _MID_MASK) == _MID
    if mid.any():
        pm = np.broadcast_to(p, s.shape)[mid]
        cm = np.broadcast_to(np.asarray(c, np.float64), s.shape)[mid]
        sm = s[mid]
        bb = sm - pm
        err = (pm - (sm - bb)) + (cm - bb)      # pm + cm - sm, exactly
        s[mid] = np.where(err == 0, sm,
                          np.nextafter(sm, np.where(err > 0, np.inf,
                                                    -np.inf)))
    return s.astype(np.float32)


def _f32(hex64: str) -> np.float32:
    return np.float32(np.frombuffer(bytes.fromhex(hex64)[::-1],
                                    dtype=np.float64)[0])


# Cephes logf coefficients as XLA:CPU emits them (float32)
_P = [_f32(h) for h in ("3FB2043760000000", "BFBD7A3700000000",
                        "3FBDE4A340000000", "BFBFCBA9E0000000",
                        "3FC23D37E0000000", "BFC555CA00000000",
                        "3FC999D580000000", "BFCFFFFF80000000",
                        "3FD5555540000000")]
_Q1 = _f32("BF2BD01060000000")
_Q2 = _f32("3FE6300000000000")
_SQRTHF = _f32("3FE6A09E60000000")
_MIN_NORMAL = np.float32(np.finfo(np.float32).tiny)


def log_f32(x) -> np.ndarray:
    """jnp.log of float32 values on XLA:CPU, bit for bit: log(0) and of a
    subnormal (flushed to zero) is -inf, log(inf) inf, log(x < 0) NaN."""
    x = np.asarray(x, dtype=np.float32)
    one = np.float32(1)
    t = np.where(x > _MIN_NORMAL, x, _MIN_NORMAL).astype(np.float32)
    bits = t.view(_U32)
    e = one + ((bits >> _U32(23)).astype(np.int32) - 127).astype(np.float32)
    t = ((bits & _U32(0x807FFFFF)) | _U32(0x3F000000)).view(np.float32)
    small = t < _SQRTHF
    t = (t - one) + np.where(small, t, np.float32(0))
    e = e - np.where(small, one, np.float32(0))
    x2 = t * t
    x3 = x2 * t
    y = _fma32(t, _P[0], _P[1])
    y1 = _fma32(t, _P[3], _P[4])
    y2 = _fma32(t, _P[6], _P[7])
    y = _fma32(y, t, _P[2])
    y1 = _fma32(y1, t, _P[5])
    y2 = _fma32(y2, t, _P[8])
    y = _fma32(y, x3, y1)
    y = _fma32(y, x3, y2)
    y = _fma32(y, x3, _Q1 * e)
    t = _fma32(np.float32(-0.5), x2, t)
    t = _fma32(_Q2, e, t + y)
    out = np.where(x < _MIN_NORMAL, np.float32(-np.inf), t)
    out = np.where(x == np.inf, np.float32(np.inf), out)
    return np.where((x < 0) | np.isnan(x), np.float32(np.nan),
                    out).astype(np.float32)


def _unit_floats(bits: np.ndarray) -> np.ndarray:
    """uint32 bits -> float32 in [0, 1) from the 23 mantissa bits."""
    return ((bits >> _U32(9)) | _U32(0x3F800000)).view(np.float32) \
        - np.float32(1)


def uniform(key, shape, minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """jax.random.uniform(key, shape, float32, minval, maxval)."""
    lo, hi = np.float32(minval), np.float32(maxval)
    f = _unit_floats(random_bits(key, shape))
    return np.maximum(lo, _fma32(f, hi - lo, lo))


def bernoulli(key, p: float, shape) -> np.ndarray:
    """jax.random.bernoulli(key, p, shape) for a scalar p -> bool."""
    return uniform(key, shape) < np.float32(p)


def randint(key, shape, minval: int, maxval: int) -> np.ndarray:
    """jax.random.randint(key, shape, minval, maxval) for int32 scalars
    -> int32."""
    k1, k2 = split(key, 2)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = _U32(1 if maxval <= minval else (maxval - minval) & 0xFFFFFFFF)
    # 2**32 mod span as jax computes it, in uint32: (2**16 mod span)**2
    # wraps to 0 for span > 2**16
    mult = (1 << 16) % int(span)
    mult = _U32(((mult * mult) & 0xFFFFFFFF) % int(span))
    off = (higher % span) * mult + (lower % span)      # uint32, wraps
    return (np.int32(minval) + (off % span).astype(np.int32)).astype(
        np.int32)


def _gumbel(key, start: int, stop: int) -> np.ndarray:
    """Gumbel draws ("low" mode, float32) of the flat counters
    [start, stop)."""
    tiny = np.float32(np.finfo(np.float32).tiny)
    u = np.maximum(tiny, _fma32(_unit_floats(_bits_range(key, start, stop)),
                                np.float32(1) - tiny, tiny))
    return -log_f32(-log_f32(u))


def categorical(key, logits: np.ndarray, shape=None) -> np.ndarray:
    """jax.random.categorical(key, logits, axis=-1, shape) -> int32.

    logits: float32 [..., K]. The Gumbel draws have shape (*shape, K) and
    logits broadcast against them from the right, as in jax."""
    logits = np.asarray(logits, dtype=np.float32)
    K = logits.shape[-1]
    batch = logits.shape[:-1]
    shape = batch if shape is None else tuple(shape)
    full = np.broadcast_to(logits, (*shape, K))
    n_rows = int(np.prod(shape, dtype=np.int64))
    flat = full.reshape(n_rows, K)
    out = np.empty(n_rows, dtype=np.int32)

    def draw(r0, r1):
        g = _gumbel(key, r0 * K, r1 * K).reshape(r1 - r0, K)
        out[r0:r1] = np.argmax(g + flat[r0:r1], axis=1)

    _in_chunks(draw, n_rows, max(1, CHUNK // K))
    return out.reshape(shape)
