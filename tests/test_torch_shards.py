"""The port's chromosome-sharded index and 2-D (data x index) step vs the
JAX package, the cases of tests/test_shards.py. Tolerance 0: the slabs are
integer arrays and every output field of the step is an integer or bool
array.

build_sharded_index is held to the JAX one slab by slab; make_sharded_step,
on a grid of CPU devices (the kernels' plain PyTorch versions), to the JAX
sharded step on the virtual CPU mesh field by field over ALL reads, and to
the port's own replicated align_batch on the full index where the
reference's test holds the JAX step to its replicated path. The same seeded
numpy reads go through both; configs reach the port only through to_port."""

import dataclasses

import numpy as np
import pytest
import torch

from parasuite_tpu.errormodel import flat_score_tensor
from parasuite_tpu.ops import device_index as jdi
from parasuite_tpu.parallel import mesh as jmesh
from parasuite_tpu.parallel import shards as jshards
from parasuite_tpu_torch.index import KmerIndex
from parasuite_tpu_torch.ops.aligner import align_batch
from parasuite_tpu_torch.ops.device_index import DeviceIndex, ScoreParams
from parasuite_tpu_torch.parallel import shards as tshards
from parasuite_tpu_torch.parallel.mesh import make_mesh, make_mesh2

from conftest import sample_reads
from _torch_helpers import to_port

torch.set_num_threads(1)
CPU = torch.device("cpu")
SLAB_FIELDS = ("ref_seq", "bucket_starts", "positions", "chrom_starts",
               "chrom_ends", "orig_chrom", "n_chroms")


def _repeat_chrom(seed, unit, copies):
    r = np.random.default_rng(seed)
    parts = []
    for _ in range(copies):
        parts += [r.integers(0, 4, 300).astype(np.int8), unit]
    parts.append(r.integers(0, 4, 300).astype(np.int8))
    return np.concatenate(parts)


def _world(case, cfg):
    """(seqs, n_shards, (n_data, n_index), reads of the case) — the three
    worlds of tests/test_shards.py, from the same seeds."""
    if case == "five_chroms":
        rng = np.random.default_rng(600)
        seqs = {f"chr{i}": rng.integers(0, 4, 1500 + 700 * i).astype(np.int8)
                for i in range(5)}
        return seqs, 4, (2, 4), None
    if case == "duplicate":
        rng = np.random.default_rng(602)
        core = rng.integers(0, 4, 400).astype(np.int8)
        seqs = {"chrA": np.concatenate(
                    [rng.integers(0, 4, 500).astype(np.int8), core]),
                "chrB": np.concatenate(
                    [core, rng.integers(0, 4, 800).astype(np.int8)])}
        return seqs, 2, (1, 2), core[100:150][None, :].astype(np.int8)
    rng = np.random.default_rng(603)
    unit = rng.integers(0, 4, 60).astype(np.int8)   # repeat unit > read len
    copies = cfg.max_occ // 2 + 1                   # per chrom: under max_occ
    seqs = {"chrA": _repeat_chrom(604, unit, copies),
            "chrB": _repeat_chrom(605, unit, copies)}
    # read 0: pure repeat (every seed k-mer globally over max_occ);
    # reads 1-8: unique flanking sequence
    codes = [unit[5:55]] + [seqs["chrA"][30 + 11 * i:80 + 11 * i]
                            for i in range(8)]
    return seqs, 2, (1, 2), np.stack(codes).astype(np.int8)


def _both_steps(case, small_cfg):
    """Build both packages' sharded indexes of the case's world, check the
    slabs, and run both steps on the same reads -> (port out, JAX out, port
    full reference, reads, port sprof, port cfg, port ShardedIndex)."""
    t_cfg = to_port(small_cfg)
    seqs, n_shards, (n_data, n_index), codes = _world(case, small_cfg)
    j_sh, j_full = jshards.build_sharded_index(seqs, n_shards, small_cfg)
    t_sh, t_full = tshards.build_sharded_index(seqs, n_shards, t_cfg)
    for f in SLAB_FIELDS:
        g, w = getattr(t_sh, f), getattr(j_sh, f)
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert (t_sh.n_shards, t_sh.max_occ) == (j_sh.n_shards, j_sh.max_occ)
    np.testing.assert_array_equal(t_full.seq, j_full.seq)
    assert t_full.names == j_full.names

    if codes is None:
        codes, lengths, _ = sample_reads(np.random.default_rng(601), j_full,
                                         32, 50, mutate=2)
    else:
        lengths = np.full(codes.shape[0], 50, dtype=np.int32)
    ms = jdi.min_scores_host(lengths, small_cfg)
    s = flat_score_tensor(small_cfg, small_cfg.max_read_len)
    j_out = jshards.make_sharded_step(
        small_cfg, jmesh.make_mesh2(n_data, n_index))(
            j_sh.slabs(small_cfg), j_sh.orig_chrom,
            jdi.ScoreParams.from_tensor(s, small_cfg), codes, lengths, ms)
    t_sprof = ScoreParams.from_tensor(s, t_cfg, CPU)
    step = tshards.make_sharded_step(
        t_cfg, make_mesh2(n_data, n_index, devices=[CPU] * 8))
    slabs = t_sh.slabs(t_cfg)
    t_out = step(slabs, t_sh.orig_chrom, t_sprof, codes, lengths, ms)
    assert sorted(t_out) == sorted(j_out)
    for k in j_out:
        g, w = t_out[k].numpy(), np.asarray(j_out[k])
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=f"{k} ({case})")
    # determinism, and the slabs already on the devices are used again
    again = step(slabs, t_sh.orig_chrom, t_sprof, codes, lengths, ms)
    for k in t_out:
        assert torch.equal(again[k], t_out[k]), k
    return t_out, t_full, (codes, lengths, ms), t_sprof, t_cfg, t_sh


def _replicated(t_full, reads, t_sprof, t_cfg):
    """The port's single-device step on the full index -> (AlignResult,
    chrom index, local position), as numpy."""
    didx = DeviceIndex.from_host(
        t_full, KmerIndex.build(t_full.seq, t_cfg.kmer_size), CPU)
    rep = align_batch(didx, t_sprof, *(torch.from_numpy(x) for x in reads),
                      t_cfg)
    ci, local = t_full.locate(rep.pos.numpy())
    return rep, ci, local


def test_assign_chroms_balanced():
    sizes = [100, 90, 50, 40, 10, 5]
    owner = tshards.assign_chroms(sizes, 2)
    assert owner == jshards.assign_chroms(sizes, 2)
    loads = [sum(s for s, o in zip(sizes, owner) if o == w) for w in (0, 1)]
    assert abs(loads[0] - loads[1]) <= 15
    assert tshards.assign_chroms(sizes, 2) == owner  # deterministic
    assert tshards.assign_chroms([7, 7, 7], 5) == \
        jshards.assign_chroms([7, 7, 7], 5)


def test_sharded_matches_reference_and_replicated(small_cfg):
    """Five chromosomes over four shards on a 2x4 grid: the JAX sharded step
    on every read, the replicated path on every uniquely mapping read."""
    out, t_full, reads, t_sprof, t_cfg, t_sh = _both_steps("five_chroms",
                                                           small_cfg)
    rep, rep_ci, rep_local = _replicated(t_full, reads, t_sprof, t_cfg)
    rep_mapped = rep.mapped.numpy()
    np.testing.assert_array_equal(out["mapped"].numpy(), rep_mapped)
    uniq = rep_mapped & (rep.x0.numpy() == 1)
    assert uniq.sum() >= 28
    for f, r in [("chrom", rep_ci), ("local_pos", rep_local),
                 ("strand", rep.strand.numpy()), ("score", rep.score.numpy()),
                 ("nm", rep.nm.numpy()), ("x0", rep.x0.numpy()),
                 ("mapq", rep.mapq.numpy())]:
        np.testing.assert_array_equal(out[f].numpy()[uniq], r[uniq],
                                      err_msg=f)
    # the single-shard view is cut to the shard's own chromosomes
    for s in range(4):
        view = t_sh.local_device_index(s, CPU)
        nc = int(t_sh.n_chroms[s])
        assert view.chrom_starts.shape[0] == nc
        np.testing.assert_array_equal(view.ref_seq.numpy(), t_sh.ref_seq[s])
        np.testing.assert_array_equal(view.chrom_ends.numpy(),
                                      t_sh.chrom_ends[s, :nc])


def test_duplicate_across_shards_x0_merge(small_cfg):
    """A sequence duplicated on chromosomes living on DIFFERENT shards must
    merge to x0=2 / mapq=0, winner on the lower original chrom index."""
    out, _full, _reads, _sp, _cfg, t_sh = _both_steps("duplicate", small_cfg)
    # chroms must land on different shards for this test to bite
    assert t_sh.orig_chrom[0, 0] != t_sh.orig_chrom[1, 0]
    assert bool(out["mapped"][0])
    assert int(out["x0"][0]) == 2
    assert int(out["mapq"][0]) == 0
    assert int(out["chrom"][0]) == 0        # chrA (lower original index) wins
    assert int(out["local_pos"][0]) == 600  # 500 + 100


def test_global_repeat_filter_matches_replicated(small_cfg):
    """A k-mer repetitive GLOBALLY (count > max_occ) but rare on each shard
    must be filtered in the sharded index exactly as in the replicated
    path; a mismatched align-time max_occ fails loudly."""
    out, t_full, reads, t_sprof, t_cfg, t_sh = _both_steps("repeats",
                                                           small_cfg)
    assert t_sh.orig_chrom[0, 0] != t_sh.orig_chrom[1, 0]
    assert t_sh.max_occ == t_cfg.max_occ
    with pytest.raises(ValueError, match="max_occ"):
        t_sh.slabs(dataclasses.replace(t_cfg, max_occ=t_cfg.max_occ // 2))

    rep, rep_ci, rep_local = _replicated(t_full, reads, t_sprof, t_cfg)
    m = rep.mapped.numpy()
    # the repeat read is seed-filtered in the replicated path, and so it is
    # in the sharded one
    assert not m[0]
    np.testing.assert_array_equal(out["mapped"].numpy(), m)
    for f, r in [("chrom", rep_ci), ("local_pos", rep_local),
                 ("strand", rep.strand.numpy()), ("score", rep.score.numpy()),
                 ("x0", rep.x0.numpy()), ("mapq", rep.mapq.numpy())]:
        np.testing.assert_array_equal(out[f].numpy()[m], r[m], err_msg=f)


def test_sharded_step_refusals(small_cfg):
    """A 1-D mesh, a shard count that is not the mesh's index width and a
    batch that does not divide over the data axis are refused; an index too
    large for int32 points at build_sharded_index."""
    t_cfg = to_port(small_cfg)
    seqs, n_shards, _grid, codes = _world("duplicate", small_cfg)
    t_sh, _full = tshards.build_sharded_index(seqs, n_shards, t_cfg)
    sprof = ScoreParams.from_tensor(
        flat_score_tensor(small_cfg, small_cfg.max_read_len), t_cfg, CPU)
    lengths = np.full(1, 50, dtype=np.int32)
    ms = jdi.min_scores_host(lengths, small_cfg)
    with pytest.raises(ValueError, match="mesh"):
        tshards.make_sharded_step(t_cfg, make_mesh(2, devices=[CPU] * 2))
    wide = tshards.make_sharded_step(t_cfg,
                                     make_mesh2(1, 4, devices=[CPU] * 4))
    with pytest.raises(ValueError, match="2 index shards on a mesh with 4"):
        wide(t_sh.slabs(t_cfg), t_sh.orig_chrom, sprof, codes, lengths, ms)
    tall = tshards.make_sharded_step(t_cfg,
                                     make_mesh2(2, 2, devices=[CPU] * 4))
    with pytest.raises(ValueError, match="do not divide"):
        tall(t_sh.slabs(t_cfg), t_sh.orig_chrom, sprof, codes, lengths, ms)

    class _Huge:
        total_len = 2 ** 31
    with pytest.raises(ValueError, match="build_sharded_index"):
        DeviceIndex.from_host(_Huge(), None, CPU)
