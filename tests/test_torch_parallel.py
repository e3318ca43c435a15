"""The port's data-parallel step, meshes and scaling report vs the JAX
package (tests/test_parallel.py case for case), tolerance 0: every output is
an integer or bool array.

The JAX step runs over the virtual CPU mesh conftest sets up; the port's
over an explicit list of CPU devices (`[cpu] * n`), on the kernels' plain
PyTorch versions. The same seeded numpy reads go through both; fixtures reach
the port only through to_port."""

import functools

import jax
import numpy as np
import pytest
import torch

from parasuite_tpu.errormodel import flat_score_tensor
from parasuite_tpu.ops import device_index as jdi
from parasuite_tpu.ops.aligner import \
    align_batch_with_candidates as j_align_cands
from parasuite_tpu import parallel as jpar
from parasuite_tpu.benchkit.scaling import measure_scaling as j_scaling
from parasuite_tpu_torch import parallel as tpar
from parasuite_tpu_torch.benchkit.scaling import measure_scaling
from parasuite_tpu_torch.ops.aligner import align_batch
from parasuite_tpu_torch.ops.device_index import DeviceIndex, ScoreParams
from parasuite_tpu_torch.ops.profile_update import profile_counts_batch
from parasuite_tpu_torch.parallel.mesh import Mesh, make_mesh2

from conftest import sample_reads
from _torch_helpers import to_port

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def states(tiny_ref, tiny_index, small_cfg):
    """((JAX didx, sprof), (port didx, sprof) on the CPU, port cfg)."""
    s = flat_score_tensor(small_cfg, small_cfg.max_read_len)
    j = (jdi.DeviceIndex.from_host(tiny_ref, tiny_index),
         jdi.ScoreParams.from_tensor(s, small_cfg))
    t_cfg = to_port(small_cfg)
    t = (DeviceIndex.from_host(to_port(tiny_ref), to_port(tiny_index), CPU),
         ScoreParams.from_tensor(s, t_cfg, CPU))
    return j, t, t_cfg


def _eq_fields(got, want, what):
    assert got._fields == want._fields
    for f in want._fields:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, (what, f)
        np.testing.assert_array_equal(g, w, err_msg=f"{f} {what}")


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_dist_matches_reference(states, tiny_ref, small_cfg, n_dev):
    """The step on [cpu] * n equals the JAX step on the n-device virtual
    mesh (all 12 AlignResult fields and the summed counts), and the port's
    own single-device step."""
    (jd, js), (td, ts), t_cfg = states
    rng = np.random.default_rng(200 + n_dev)
    codes, lengths, _ = sample_reads(rng, tiny_ref, 64, 50, mutate=3)
    ms = jdi.min_scores_host(lengths, small_cfg)

    want, want_counts = jpar.make_dist_align_step(
        small_cfg, jpar.make_mesh(n_dev))(jd, js, codes, lengths, ms)
    step = tpar.make_dist_align_step(
        t_cfg, tpar.make_mesh(n_dev, devices=[CPU] * 8))
    got, got_counts = step(td, ts, codes, lengths, ms)
    _eq_fields(got, want, f"@ {n_dev} devices")
    assert got_counts.dtype == torch.int64
    np.testing.assert_array_equal(got_counts.numpy(),
                                  np.asarray(want_counts))

    c, ln, m = (torch.from_numpy(x) for x in (codes, lengths, ms))
    single = align_batch(td, ts, c, ln, m, t_cfg)
    for f in single._fields:
        assert torch.equal(getattr(got, f), getattr(single, f)), f
    counts_s = profile_counts_batch(td, c, ln, single.mapped, single.strand,
                                    single.pos, single.ug_equal, t_cfg)
    assert torch.equal(got_counts, counts_s.to(torch.int64))
    # a second call reuses the replicas and gives the same result
    again, again_counts = step(td, ts, codes, lengths, ms)
    assert torch.equal(again_counts, got_counts)
    assert torch.equal(again.pos, got.pos)


def test_counts_identical_across_shard_counts(states, tiny_ref, small_cfg):
    """Profile matrices bit-identical at any shard count, and equal to the
    JAX step's."""
    (jd, js), (td, ts), t_cfg = states
    rng = np.random.default_rng(300)
    codes, lengths, _ = sample_reads(rng, tiny_ref, 48, 50, mutate=2)
    ms = jdi.min_scores_host(lengths, small_cfg)
    outs = []
    for n_dev in (2, 8):
        step = tpar.make_dist_align_step(
            t_cfg, tpar.make_mesh(n_dev, devices=[CPU] * n_dev))
        c, l, m = tpar.shard_batch(codes, lengths, ms, n_dev)
        _res, counts = step(td, ts, c, l, m)
        outs.append(counts.numpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    c, l, m = jpar.shard_batch(codes, lengths, ms, 8)
    _res, want = jpar.make_dist_align_step(small_cfg, jpar.make_mesh(8))(
        jd, js, c, l, m)
    np.testing.assert_array_equal(outs[1], np.asarray(want))
    assert outs[1].sum() > 0


def test_shard_batch_padding():
    codes = np.zeros((10, 50), dtype=np.int8)
    lengths = np.full(10, 50, dtype=np.int32)
    ms = np.full(10, 1, dtype=np.int32)
    got = tpar.shard_batch(codes, lengths, ms, 8)
    c, l, m = got
    assert c.shape[0] == 16
    assert (l[10:] == 0).all()
    assert (c[10:] == 4).all()
    for g, w in zip(got, jpar.shard_batch(codes, lengths, ms, 8)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    same = tpar.shard_batch(codes, lengths, ms, 5)
    assert same[0] is codes


def test_scaling_report(states, tiny_ref, small_cfg):
    """The weak-scaling harness over [cpu] * 8: the JAX report's shape
    (keys, device counts, efficiency 1.0 at the first point); the backend
    names the torch device type."""
    (jd, js), (td, ts), t_cfg = states
    rng = np.random.default_rng(800)
    codes, lengths, _ = sample_reads(rng, tiny_ref, 8 * 16, 50, mutate=1)
    kw = dict(device_counts=[1, 2, 8], per_device_reads=16, rounds=1)
    rep = measure_scaling(td, ts, codes, lengths, t_cfg, devices=[CPU] * 8,
                          **kw)
    want = j_scaling(jd, js, codes, lengths, small_cfg, **kw)
    assert sorted(rep) == sorted(want)
    assert rep["backend"] == "cpu" and rep["mode"] == want["mode"]
    assert rep["per_device_reads"] == 16
    assert [p["n_devices"] for p in rep["points"]] == [1, 2, 8]
    assert rep["points"][0]["efficiency"] == 1.0
    for p, w in zip(rep["points"], want["points"]):
        assert sorted(p) == sorted(w)
        assert p["reads_per_s"] > 0
    # more devices than the list holds: refused before anything is timed
    with pytest.raises(ValueError, match="requested 8 devices, have 2"):
        measure_scaling(td, ts, codes, lengths, t_cfg, devices=[CPU] * 2,
                        **kw)


def test_mesh_never_substitutes_devices():
    """An explicit list is cut to size or refused; the default is the
    machine's CUDA devices, so with none a mesh cannot be made."""
    mesh = tpar.make_mesh(3, devices=[CPU] * 4)
    assert mesh.devices == (CPU,) * 3 and mesh.shape == (3,)
    assert mesh.axis_names == ("data",)
    assert tpar.make_mesh(devices=["cpu", "cpu"]).size == 2
    with pytest.raises(ValueError, match="requested 3 devices, have 2"):
        tpar.make_mesh(3, devices=[CPU] * 2)
    grid = make_mesh2(2, 3, devices=[CPU] * 6)
    assert grid.shape == (2, 3) and len(grid.rows()) == 2
    assert grid.axis_names == ("data", "index")
    with pytest.raises(ValueError, match="mesh 2x4 needs 8 devices, have 6"):
        make_mesh2(2, 4, devices=[CPU] * 6)
    n_cuda = torch.cuda.device_count()
    assert tpar.local_device_count() == n_cuda
    with pytest.raises(ValueError, match=f"have {n_cuda}"):
        tpar.make_mesh(n_cuda + 1)
    with pytest.raises(ValueError, match=f"have {n_cuda}"):
        make_mesh2(n_cuda + 1, 1)


def test_step_with_candidates_and_refusals(states, tiny_ref, small_cfg):
    """with_candidates gives the JAX step's (AlignResult, CandidateTable);
    counts with candidates, a 2-D mesh and a batch that does not divide are
    refused."""
    (jd, js), (td, ts), t_cfg = states
    rng = np.random.default_rng(400)
    codes, lengths, _ = sample_reads(rng, tiny_ref, 32, 50, mutate=2,
                                     indel=True)
    ms = jdi.min_scores_host(lengths, small_cfg)
    mesh = tpar.make_mesh(4, devices=[CPU] * 4)
    step = tpar.make_dist_align_step(t_cfg, mesh, with_counts=False,
                                     with_candidates=True)
    res, table = step(td, ts, codes, lengths, ms)
    j_res, j_table = jpar.make_dist_align_step(
        small_cfg, jpar.make_mesh(4), with_counts=False,
        with_candidates=True)(jd, js, codes, lengths, ms)
    _eq_fields(res, j_res, "result with candidates")
    _eq_fields(table, j_table, "candidate table")
    want = jax.jit(functools.partial(j_align_cands, cfg=small_cfg))(
        jd, js, codes, lengths, ms)[1]
    _eq_fields(table, want, "candidate table vs single device")

    res_only = tpar.make_dist_align_step(t_cfg, mesh, with_counts=False)(
        td, ts, codes, lengths, ms)
    _eq_fields(res_only, j_res, "result without counts")
    with pytest.raises(ValueError, match="with_counts"):
        tpar.make_dist_align_step(t_cfg, mesh, with_candidates=True)
    with pytest.raises(ValueError, match="1-D mesh"):
        tpar.make_dist_align_step(t_cfg, make_mesh2(2, 2, devices=[CPU] * 4))
    with pytest.raises(ValueError, match="do not divide"):
        tpar.make_dist_align_step(t_cfg, mesh)(td, ts, codes[:30],
                                               lengths[:30], ms[:30])
    assert isinstance(mesh, Mesh)
