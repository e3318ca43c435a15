"""The port's simulator against jax.random and parasuite_tpu.sim, tolerance 0:
every threefry primitive (sim/threefry.py) at several seeds and shapes, the
XLA:CPU float32 log, and simulate_reads in every mode at n in {1, 37, 1000}
— codes, lengths and every SimTruth field — plus simulate_quality and
simulate_binding_sites. Runs with jax_threefry_partitionable at jax's
default (True in the installed jax 0.9.0)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from parasuite_tpu.sim import generate as jg
from parasuite_tpu_torch.sim import generate as tg
from parasuite_tpu_torch.sim import threefry as tf

from _torch_helpers import to_port

SEEDS = [0, 7, -5, 123456]
SHAPES = [(1,), (7,), (1000,), (13, 50)]


def _eq(got, want, what):
    want = np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(np.asarray(got).astype(want.dtype), want,
                                  err_msg=what)


def test_partitionable_threefry_is_on():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_primitives_equal_jax(seed, shape):
    key, k = jax.random.PRNGKey(seed), tf.prng_key(seed)
    _eq(k, key, "PRNGKey")
    _eq(tf.split(k, 5), jax.random.split(key, 5), "split")
    _eq(tf.fold_in(k, 0x1D3), jax.random.fold_in(key, 0x1D3), "fold_in")
    _eq(tf.random_bits(k, shape), jax.random.bits(key, shape), "bits")
    _eq(tf.uniform(k, shape), jax.random.uniform(key, shape), "uniform")
    _eq(tf.uniform(k, shape, -3.5, 7.25),
        jax.random.uniform(key, shape, minval=-3.5, maxval=7.25),
        "uniform range")
    _eq(tf.bernoulli(k, 0.3, shape), jax.random.bernoulli(key, 0.3, shape),
        "bernoulli")
    for lo, hi in ((0, 4), (1, 4), (2, 48), (0, 12_345_677), (5, 5)):
        _eq(tf.randint(k, shape, lo, hi),
            jax.random.randint(key, shape, lo, hi), f"randint {lo},{hi}")
    logits = np.log(np.random.default_rng(1).random((*shape, 4))
                    .astype(np.float32))
    _eq(tf.categorical(k, logits), jax.random.categorical(key, logits),
        "categorical")
    row = np.asarray(jnp.log(jnp.arange(1, 51, dtype=jnp.float32)))
    _eq(tf.categorical(k, row, shape), jax.random.categorical(
        key, row, shape=shape), "categorical with a shape")


def test_log_f32_equals_xla():
    """log_f32 == jnp.log on XLA:CPU for uniforms, the simulator's logit
    ranges, subnormals, 0, inf and negatives (NaN where jnp gives NaN)."""
    u = np.random.default_rng(2).random(1 << 18, dtype=np.float32)
    x = np.concatenate([u, u * 100, np.float32(1e-12) + u * 1e-3,
                        np.float32(1e-30) + u * 1e-20,
                        np.asarray([0, 1, np.inf, 1e-38, 1e-45, -1,
                                    np.finfo(np.float32).tiny], np.float32)])
    want = np.asarray(jnp.log(x.astype(np.float32)))
    with np.errstate(invalid="ignore", divide="ignore"):
        got = tf.log_f32(x)
    np.testing.assert_array_equal(got, want)
    assert np.mean(np.log(u) != np.asarray(jnp.log(u))) > 0.01


@pytest.fixture(scope="module")
def sim_world():
    from parasuite_tpu.config import AlignConfig
    from parasuite_tpu.index.reference import PackedReference

    rng = np.random.default_rng(1234)
    seqs = {"chrA": rng.integers(0, 4, 5000).astype(np.int8),
            "chrB": rng.integers(0, 4, 3000).astype(np.int8)}
    seqs["chrA"][1000:1010] = 4
    ref = PackedReference.from_dict(seqs, spacer=64)
    probs = np.random.default_rng(3).dirichlet(np.ones(4) * 3, size=(60, 4))
    probs[:, np.arange(4), np.arange(4)] += 5
    probs /= probs.sum(-1, keepdims=True)
    return ref, AlignConfig(max_read_len=50, kmer_size=8), probs


def _mode_kwargs(mode, ref, probs):
    vec = np.linspace(0.001, 0.004, 50)
    return {
        "flat": {},
        "tc_rate": {"tc_rate": 0.3},
        "profile": {"profile_probs": probs},
        "sites": {"site_positions": jg.simulate_binding_sites(ref, 20, 50,
                                                              seed=3)},
        "indel_scalar": {"ins_rate": 0.002, "del_rate": 0.003},
        # per-cycle vectors, and a profile shorter than the reads (jnp
        # clamps the cycle index)
        "indel_vector": {"ins_rate": vec, "del_rate": vec[::-1],
                         "profile_probs": probs[:40]},
    }[mode]


TRUTH_FIELDS = ("packed_pos", "chrom_idx", "local_pos", "strand",
                "n_conversions", "n_errors", "indel_kind", "indel_pos")


@pytest.mark.parametrize("n", [1, 37, 1000])
@pytest.mark.parametrize("mode", ["flat", "tc_rate", "profile", "sites",
                                  "indel_scalar", "indel_vector"])
def test_simulate_reads_equals_jax(mode, n, sim_world):
    ref, cfg, probs = sim_world
    kw = _mode_kwargs(mode, ref, probs)
    want = jg.simulate_reads(ref, n, 50, cfg, seed=11, **kw)
    got = tg.simulate_reads(to_port(ref), n, 50, to_port(cfg), seed=11, **kw)
    for w, g, name in zip(want[:2], got[:2], ("codes", "lengths")):
        assert g.dtype == w.dtype, name
        _eq(g, w, name)
    for f in TRUTH_FIELDS:
        w, g = getattr(want[2], f), getattr(got[2], f)
        assert g.dtype == w.dtype, f
        _eq(g, w, f)
    assert got[2].names() == want[2].names()
    if n == 1000:
        t = got[2]
        assert t.n_conversions.sum() > 0
        assert (t.indel_kind > 0).any() == mode.startswith("indel")
        assert (t.n_errors.sum() > 1000) == ("profile_probs" in kw)


def test_simulate_quality_and_binding_sites_equal_jax(sim_world):
    ref = sim_world[0]
    t_ref = to_port(ref)
    for n, L, seed in ((1, 50, 0), (37, 36, 5), (1000, 100, 11)):
        _eq(tg.simulate_quality(n, L, seed=seed),
            jg.simulate_quality(n, L, seed=seed), "simulate_quality")
    for n_sites, seed in ((1, 0), (20, 3), (200, 9)):
        _eq(tg.simulate_binding_sites(t_ref, n_sites, 50, seed=seed),
            jg.simulate_binding_sites(ref, n_sites, 50, seed=seed),
            "simulate_binding_sites")
    for L in (36, 51):
        _eq(tg._valid_starts(t_ref, L), jg._valid_starts(ref, L),
            "_valid_starts")
    for rate in (None, 0.01, np.linspace(0, 0.01, 30),
                 np.linspace(0, 0.01, 80)):
        _eq(tg._indel_rate_vec(rate, 50, 4, 46),
            jg._indel_rate_vec(rate, 50, 4, 46), "_indel_rate_vec")
    assert tg.SimTruth.parse_name("sim_3:1:250:0") == \
        jg.SimTruth.parse_name("sim_3:1:250:0") == (1, 250, 0)
