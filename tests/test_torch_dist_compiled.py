"""The port's compiled multi-device steps on the CPU: make_dist_align_step
and make_sharded_step run each mesh slot's alignment, and each data row's
merge, as an ops/compiled.py::CompiledStep (the counterpart of the JAX
package's jax.jit over its shard_maps). On the CPU nothing is captured and
the discipline is the graphs': inputs copied in, outputs written into the
entry's own and returned as clones.

  * the fault this slice repaired: Replicas refreshes a copy in place when
    its source's contents change (set_profile copies pass 2's scores into
    the same object), keeping the copy's storage;
  (a) the capture audit of tests/test_torch_compiled.py over every slot
      function: the data-parallel slot with counts, without, with
      candidates, the sharded cell (_shard_align) and the row merge;
  (b) a result held across 2 and 8 more calls of each multi-device step
      still equals the JAX step's on its own batch;
  (c) set_profile between calls of a data-parallel step reaches every slot,
      against the JAX step called with the new scores;
  (d) one entry per key per slot;
  * run_distributed_host's lockstep warm-up before its clock.

The same seeded numpy inputs go through the JAX package (virtual CPU
devices) and the port ([cpu] * n, the kernels' plain versions). Tolerance
0: every compared value is an integer or bool array."""

import dataclasses
import socket

import jax
import numpy as np
import pytest
import torch

from parasuite_tpu.errormodel import flat_score_tensor
from parasuite_tpu.ops import device_index as jdi
from parasuite_tpu import parallel as jpar
from parasuite_tpu.parallel import mesh as jmesh
from parasuite_tpu.parallel import shards as jshards
from parasuite_tpu.pipeline import align as jalign
from parasuite_tpu_torch import parallel as tpar
from parasuite_tpu_torch.io.fastq import write_fastq
from parasuite_tpu_torch.ops.compiled import CompiledStep
from parasuite_tpu_torch.ops.device_index import ScoreParams
from parasuite_tpu_torch.parallel import dist_align as tdist
from parasuite_tpu_torch.parallel import distributed as tdistributed
from parasuite_tpu_torch.parallel import shards as tshards
from parasuite_tpu_torch.parallel.mesh import make_mesh2
from parasuite_tpu_torch.parallel.multihost import (merge_host_outputs,
                                                    run_host_shard)
from parasuite_tpu_torch.pipeline import align as talign

from conftest import sample_reads
from _torch_helpers import to_port
from test_torch_compiled import HostAudit, _pass2_tensor
from test_torch_shards import _world

torch.set_num_threads(1)
CPU = torch.device("cpu")
N_DEV = 4
# the data-parallel step's kinds: (with_counts, with_candidates)
DIST_KINDS = {"counts": (True, False), "no_counts": (False, False),
              "candidates": (False, True)}


def _fields(state) -> dict:
    return {f.name: getattr(state, f.name)
            for f in dataclasses.fields(state)}


def _separate_copies(monkeypatch):
    """Make every replica a separate copy, as on a second card: on the CPU
    replicate() returns the source object itself."""
    def clone(state, device):
        return type(state)(**{k: t.clone() for k, t in
                              _fields(state).items()})

    monkeypatch.setattr(tdist, "replicate", clone)


def _engines(tiny_ref, tiny_index, small_cfg):
    return (jalign.AlignerEngine(tiny_ref, tiny_index, small_cfg),
            talign.AlignerEngine(to_port(tiny_ref), to_port(tiny_index),
                                 to_port(small_cfg), device="cpu"))


def _batches(ref, cfg, n_batches, seed, n=32):
    """[(codes, lengths, min_scores)] of seeded reads with indels."""
    out = []
    for k in range(n_batches):
        codes, lengths, _ = sample_reads(np.random.default_rng(seed + k),
                                         ref, n, 50, mutate=3, indel=True)
        out.append((codes, lengths, jdi.min_scores_host(lengths, cfg)))
    return out


def _eq(got, want, what):
    """A multi-device step's output against the JAX step's: the same tree
    of records (namedtuples, a dict, a bare counts tensor), each leaf equal
    in dtype, shape and bytes."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        pairs = [(k, got[k], want[k]) for k in want]
    elif hasattr(want, "_fields"):
        assert got._fields == want._fields, what
        pairs = [(f, getattr(got, f), getattr(want, f)) for f in want._fields]
    elif isinstance(want, tuple):
        for k, (g, w) in enumerate(zip(got, want, strict=True)):
            _eq(g, w, f"{what} part {k}")
        return
    else:
        # the counts: summed in int64 by the port, as int32 by the psum
        g, w = got.numpy(), np.asarray(jax.device_get(want))
        assert g.dtype == np.int64 and w.dtype == np.int32, what
        np.testing.assert_array_equal(g, w, err_msg=what)
        return
    for f, g, w in pairs:
        g, w = g.numpy(), np.asarray(jax.device_get(w))
        assert g.dtype == w.dtype and g.shape == w.shape, (what, f)
        assert g.tobytes() == w.tobytes(), (what, f)


def _dist_steps(kind, small_cfg, jeng, teng):
    """-> (port step, JAX step), each (codes, lengths, ms) -> output."""
    with_counts, with_candidates = DIST_KINDS[kind]
    port = tpar.make_dist_align_step(
        to_port(small_cfg), tpar.make_mesh(devices=[CPU] * N_DEV),
        with_counts=with_counts, with_candidates=with_candidates)
    ref = jpar.make_dist_align_step(
        small_cfg, jpar.make_mesh(N_DEV), with_counts=with_counts,
        with_candidates=with_candidates)
    return (port, lambda *b: port(teng.didx, teng.sprof, *b),
            lambda *b: ref(jeng.didx, jeng.sprof, *b))


def _sharded_steps(small_cfg):
    """The five-chromosome world of tests/test_shards.py on a 2 x 4 grid ->
    (port step, port call, JAX call, the full packing, the port step's
    bind to the call's state)."""
    t_cfg = to_port(small_cfg)
    seqs, n_shards, (n_data, n_index), _codes = _world("five_chroms",
                                                       small_cfg)
    j_sh, j_full = jshards.build_sharded_index(seqs, n_shards, small_cfg)
    t_sh, _t_full = tshards.build_sharded_index(seqs, n_shards, t_cfg)
    s = flat_score_tensor(small_cfg, small_cfg.max_read_len)
    j_sprof = jdi.ScoreParams.from_tensor(s, small_cfg)
    t_sprof = ScoreParams.from_tensor(s, t_cfg, CPU)
    ref = jshards.make_sharded_step(small_cfg,
                                    jmesh.make_mesh2(n_data, n_index))
    port = tshards.make_sharded_step(
        t_cfg, make_mesh2(n_data, n_index, devices=[CPU] * 8))
    t_slabs, j_slabs = t_sh.slabs(t_cfg), j_sh.slabs(small_cfg)
    return (port,
            lambda *b: port(t_slabs, t_sh.orig_chrom, t_sprof, *b),
            lambda *b: ref(j_slabs, j_sh.orig_chrom, j_sprof, *b), j_full,
            lambda: port.bind(t_slabs, t_sh.orig_chrom, t_sprof))


# ---------------------------------------------------------------------------
# the fault: replicas refreshed in place
# ---------------------------------------------------------------------------

def test_replicas_refresh_a_copy_in_place(monkeypatch, small_cfg):
    """New contents copied into the source (as set_profile does) reach every
    copy on the next of(), in the copy's own storage; the same contents
    copy nothing; another object rebuilds the slot."""
    _separate_copies(monkeypatch)
    t_cfg = to_port(small_cfg)
    flat = flat_score_tensor(small_cfg, small_cfg.max_read_len)
    source = ScoreParams.from_tensor(flat, t_cfg, CPU)
    source = ScoreParams(*(t.clone() for t in _fields(source).values()))
    replicas = tdist.Replicas([CPU, torch.device("cpu", 0)])
    copies = replicas.of("sprof", source)
    assert len(copies) == 2 and copies[0] is not source
    ptrs = [(c.s_fwd.data_ptr(), c.mapq_sub.data_ptr()) for c in copies]
    versions = [c.s_fwd._version for c in copies]
    assert replicas.of("sprof", source) is copies
    assert [c.s_fwd._version for c in copies] == versions

    new = ScoreParams.from_tensor(_pass2_tensor(small_cfg), t_cfg, CPU)
    assert not torch.equal(new.s_fwd, source.s_fwd)
    for name, t in _fields(new).items():
        getattr(source, name).copy_(t)
    again = replicas.of("sprof", source)
    assert again is copies
    for c, ptr in zip(again, ptrs):
        assert (c.s_fwd.data_ptr(), c.mapq_sub.data_ptr()) == ptr
        for name, t in _fields(new).items():
            assert torch.equal(getattr(c, name), t), name

    other = ScoreParams(*(t.clone() for t in _fields(new).values()))
    rebuilt = replicas.of("sprof", other)
    assert rebuilt is not copies
    assert all(c.s_fwd.data_ptr() not in (p for p, _ in ptrs)
               for c in rebuilt)


# ---------------------------------------------------------------------------
# (a) the capture audit
# ---------------------------------------------------------------------------

def _audited(steps) -> tuple[list, list]:
    """Run each CompiledStep's function under HostAudit from now on ->
    (ops found, names of the steps that ran)."""
    found, ran = [], []
    for step in steps:
        def audited(*a, _fn=step.fn, _name=step.name, **kw):
            ran.append(_name)
            with HostAudit() as mode:
                out = _fn(*a, **kw)
            found.extend(mode.found)
            return out

        step.fn = audited
    return found, ran


@pytest.mark.parametrize("kind", [*DIST_KINDS, "sharded"])
def test_slot_functions_hold_no_host_op(kind, small_cfg, tiny_ref,
                                        tiny_index):
    """Each slot function of both multi-device steps, on the first call of
    its key and on a later one, does nothing a CUDA graph cannot hold: no
    sync, no host read, no copy from another device, no bool-mask
    indexing."""
    if kind == "sharded":
        step, call, _ref, full, bind = _sharded_steps(small_cfg)
        (batch,) = _batches(full, small_cfg, 1, seed=701)
        cells, merges = bind()
        steps = [*sum(cells, []), *merges]
        want = {f"shard {r},{c} cpu" for r in range(2) for c in range(4)} \
            | {"merge 0 cpu", "merge 1 cpu"}
        assert set(step.compiled_steps()) == want
    else:
        jeng, teng = _engines(tiny_ref, tiny_index, small_cfg)
        step, call, _ref = _dist_steps(kind, small_cfg, jeng, teng)
        (batch,) = _batches(tiny_ref, small_cfg, 1, seed=700)
        steps = step.bind(teng.didx, teng.sprof)
        assert [s.name for s in steps] == [f"data {i} cpu"
                                           for i in range(N_DEV)]
    found, ran = _audited(steps)
    call(*batch)
    call(*batch)
    assert not found, found
    assert sorted(ran) == sorted([s.name for s in steps] * 2)


# ---------------------------------------------------------------------------
# (b) results held in flight
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_more", [2, 8])
@pytest.mark.parametrize("kind", [*DIST_KINDS, "sharded"])
def test_held_results_survive_later_calls(kind, n_more, small_cfg, tiny_ref,
                                          tiny_index):
    """Results held while n_more batches of the same key run through the
    step (each writes every entry's outputs, as a replay does) still equal
    the JAX step's on their own batches."""
    if kind == "sharded":
        _step, port, ref, full, _bind = _sharded_steps(small_cfg)
        batches = _batches(full, small_cfg, n_more + 1, seed=710)
    else:
        jeng, teng = _engines(tiny_ref, tiny_index, small_cfg)
        _step, port, ref = _dist_steps(kind, small_cfg, jeng, teng)
        batches = _batches(tiny_ref, small_cfg, n_more + 1, seed=720)
    held = [port(*b) for b in batches]
    for k, (out, b) in enumerate(zip(held, batches)):
        _eq(out, ref(*b), f"{kind} batch {k} of {n_more + 1}")


# ---------------------------------------------------------------------------
# (c) set_profile reaches every slot
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["counts", "no_counts"])
def test_set_profile_reaches_every_slot(kind, monkeypatch, small_cfg,
                                        tiny_ref, tiny_index):
    """Each slot holds a separate copy of the engine's scores; set_profile
    between calls gives the JAX step called with the new scores, on the
    batch run again through the same entries and on a new one, and differs
    from pass 1 on every slot's share."""
    _separate_copies(monkeypatch)
    jeng, teng = _engines(tiny_ref, tiny_index, small_cfg)
    step, port, ref = _dist_steps(kind, small_cfg, jeng, teng)
    rng = np.random.default_rng(61)
    first, second = [], []
    for out in (first, second):
        codes, lengths, _ = sample_reads(rng, tiny_ref, 64, 50, mutate=4)
        codes[:, ::7] = np.where(codes[:, ::7] == 3, 1, codes[:, ::7])
        out += [codes, lengths, jdi.min_scores_host(lengths, small_cfg)]
    pass1 = port(*first)
    _eq(pass1, ref(*first), "pass 1")
    s2 = _pass2_tensor(small_cfg)
    jeng.set_profile(s2)
    teng.set_profile(s2)
    for b in (first, second):
        _eq(port(*b), ref(*b), "pass 2")
    res1 = pass1[0] if kind == "counts" else pass1
    res2 = port(*first)
    res2 = res2[0] if kind == "counts" else res2
    per = 64 // N_DEV
    for i in range(N_DEV):
        rows = slice(i * per, (i + 1) * per)
        assert not torch.equal(res1.score[rows], res2.score[rows]), \
            f"the pass-2 profile changed nothing on slot {i}"
    for st in step.slots:
        assert st.fn.args[1] is not teng.sprof
        assert torch.equal(st.fn.args[1].s_fwd, teng.sprof.s_fwd)


# ---------------------------------------------------------------------------
# (d) the cache
# ---------------------------------------------------------------------------

def test_one_entry_per_key_per_slot(small_cfg, tiny_ref, tiny_index):
    """Each slot makes one entry for a batch shape; a second batch of the
    same shape adds none, a shorter one adds one per slot; the sharded
    step's cells and merges likewise; outputs equal the JAX steps'."""
    jeng, teng = _engines(tiny_ref, tiny_index, small_cfg)
    step, port, ref = _dist_steps("counts", small_cfg, jeng, teng)
    a, b = _batches(tiny_ref, small_cfg, 2, seed=730)
    short = tuple(x[:16] for x in a)
    seen = []
    for batch in (a, b, short, short, a):
        _eq(port(*batch), ref(*batch), f"{len(batch[0])} reads")
        seen.append([len(s.entries) for s in step.slots])
    assert seen == [[1] * N_DEV] * 2 + [[2] * N_DEV] * 3
    for s in step.slots:
        assert sorted(k[2][0][0][0] for k in s.entries) == [4, 8]
        assert s.graphs == 0 and s.capture_ms == 0.0
    stats = tdist.graph_stats(step)
    assert stats == {"compiled_steps": N_DEV, "keys": 2 * N_DEV, "graphs": 0,
                     "capture_ms": 0.0}

    sharded, port_s, ref_s, full, _bind = _sharded_steps(small_cfg)
    a, b = _batches(full, small_cfg, 2, seed=740)
    for batch in (a, b):
        _eq(port_s(*batch), ref_s(*batch), "sharded")
    steps = sharded.compiled_steps()
    assert len(steps) == 8 + 2
    assert all(len(s.entries) == 1 for s in steps.values())


def test_bind_follows_the_objects(small_cfg, tiny_ref, tiny_index):
    """The slots are made once per (index, scores) pair of objects: the same
    objects keep them, another index object makes new ones."""
    _jeng, teng = _engines(tiny_ref, tiny_index, small_cfg)
    step = tpar.make_dist_align_step(to_port(small_cfg),
                                     tpar.make_mesh(devices=[CPU] * 2))
    slots = step.bind(teng.didx, teng.sprof)
    assert all(isinstance(s, CompiledStep) for s in slots)
    assert step.bind(teng.didx, teng.sprof) is slots
    other = type(teng.didx)(**_fields(teng.didx))
    new = step.bind(other, teng.sprof)
    assert new is not slots and all(s.fn.args[0] is other for s in new)


# ---------------------------------------------------------------------------
# run_distributed_host's warm-up
# ---------------------------------------------------------------------------

def test_distributed_host_warms_up_before_its_clock(tmp_path, monkeypatch,
                                                    small_cfg, tiny_ref,
                                                    tiny_index):
    """One process of the torch.distributed mode (gloo, in this process):
    the step's first call is the all-padding batch, before the loop; its
    counts are never all_reduced, and one zero matrix is, before the first
    step of the loop; the merged SAM and .errorprofile are the file-side
    host run's."""
    import torch.distributed as dist

    rng = np.random.default_rng(750)
    codes, lengths, _ = sample_reads(rng, tiny_ref, 150, 50, mutate=2)
    fastq = tmp_path / "r.fastq"
    write_fastq(fastq, [f"r{i}" for i in range(150)], codes, lengths)
    _jeng, teng = _engines(tiny_ref, tiny_index, small_cfg)
    calls, outs, reduced, order = [], [], [], []
    make = tdistributed.make_dist_align_step

    def recording(*a, **kw):
        step = make(*a, **kw)

        def call(didx, sprof, c, ln, ms):
            calls.append((c.copy(), ln.copy()))
            order.append("step")
            outs.append(step(didx, sprof, c, ln, ms))
            return outs[-1]

        call.compiled_steps = step.compiled_steps
        return call

    reduce = tdistributed._all_reduce_counts

    def counted(c):
        reduced.append(c)
        order.append("reduce")
        return reduce(c)

    monkeypatch.setattr(tdistributed, "make_dist_align_step", recording)
    monkeypatch.setattr(tdistributed, "_all_reduce_counts", counted)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tdistributed.initialize(f"127.0.0.1:{port}", 1, 0, "cpu")
    try:
        n, counts, _n_prof, secs = tdistributed.run_distributed_host(
            teng, fastq, tmp_path / "grp")
    finally:
        dist.destroy_process_group()
    n_steps = -(-150 // small_cfg.batch_size)
    assert n == 150 and secs > 0
    assert len(calls) == n_steps + 1 and len(reduced) == n_steps + 1
    assert order[:3] == ["step", "reduce", "step"]
    assert all(r is not outs[0][1] for r in reduced)
    assert not reduced[0].any() and reduced[0].dtype == torch.int64
    warm_codes, warm_lengths = calls[0]
    assert (warm_codes == 4).all() and (warm_lengths == 0).all()
    assert warm_codes.shape == (small_cfg.batch_size,
                                small_cfg.max_read_len)

    assert int(counts.sum()) > 0
    assert run_host_shard(teng, fastq, tmp_path / "file", 0, 1)[0] == 150
    for run in ("grp", "file"):
        merge_host_outputs(to_port(tiny_ref), tmp_path / run,
                           tmp_path / f"{run}.sam", 1,
                           profile_out=tmp_path / f"{run}.errorprofile")
    for ext in ("sam", "errorprofile"):
        assert (tmp_path / f"grp.{ext}").read_bytes() == \
            (tmp_path / f"file.{ext}").read_bytes(), ext
