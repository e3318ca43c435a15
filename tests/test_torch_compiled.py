"""The port's compiled steps (parasuite_tpu_torch/ops/compiled.py) on the
CPU, where CompiledStep keeps the discipline of its CUDA graphs without
capturing: a call's tensors are copied into the entry's inputs, the outputs
are written into the entry's own and returned as clones.

  (a) the capture audit: every step kind the engines compile runs under a
      TorchDispatchMode that fails on any op that would make the host wait
      for the device or read host data inside the step, which a CUDA graph
      cannot hold;
  (b) in-flight safety: a result held across 2 or 8 more calls still
      equals the JAX engine's on its batch;
  (c) parameters: set_profile between batches gives the JAX engine's
      pass-2 results through the steps built with pass 1's scores;
  (d) the cache: one entry per key (shapes, dtypes, static arguments).

The same seeded numpy inputs go through the JAX engine (jnp path, CPU) and
the port's engine (plain versions on CPU tensors), built from its own
objects (to_port). Tolerance 0: every compared value is an integer array
or bytes."""

import traceback
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from parasuite_tpu.errormodel import flat_score_tensor
from parasuite_tpu.io.batch import ReadBatch
from parasuite_tpu.pipeline import align as jalign
from parasuite_tpu_torch.ops.compiled import CompiledStep
from parasuite_tpu_torch.pipeline import align as talign

from conftest import sample_reads
from _torch_helpers import to_port
from test_torch_modes import _rescue_reads
from test_torch_wire import _combined_engines, _packed_reads

torch.set_num_threads(1)

# ops that make the host wait for the device or read host data
HOST_OPS = {"_local_scalar_dense", "item", "nonzero", "nonzero_static",
            "masked_select", "unique", "_unique", "_unique2", "unique_dim",
            "unique_consecutive", "unique_dim_consecutive", "bincount",
            "lift_fresh", "lift_fresh_copy"}
INDEX_OPS = {"index", "index_put", "index_put_", "_index_put_impl_"}


def _port_frame() -> str:
    """The innermost line of the port on the stack: file:line and code."""
    for fr in reversed(traceback.extract_stack()):
        if "parasuite_tpu_torch" in fr.filename:
            return f"{Path(fr.filename).name}:{fr.lineno}: {fr.line}"
    return "?"


class HostAudit(TorchDispatchMode):
    """Records each op a CUDA graph cannot hold: a sync or a host read
    (HOST_OPS), a copy from another device, and indexing by a bool mask."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        why = None
        if name in HOST_OPS:
            why = name
        elif name in ("copy_", "copy") and args[1].device != args[0].device:
            why = f"{name} from {args[1].device}"
        elif name == "_to_copy" and kwargs.get("device") not in (
                None, args[0].device):
            why = f"_to_copy from {args[0].device}"
        elif name in INDEX_OPS and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in args[1]):
            why = f"{name} by a bool mask"
        if why:
            self.found.append(f"{why} at {_port_frame()}")
        return func(*args, **kwargs)


def _audit(engine) -> tuple[list, list]:
    """Run every compiled step of engine under HostAudit from now on.
    -> (ops found, names of the steps that ran)."""
    found, ran = [], []
    for step in engine.compiled_steps().values():
        def audited(*a, _fn=step.fn, _name=step.name, **kw):
            ran.append(_name)
            with HostAudit() as mode:
                out = _fn(*a, **kw)
            found.extend(mode.found)
            return out

        step.fn = audited
    return found, ran


def _engines(ref, index, cfg, **kw):
    return (jalign.AlignerEngine(ref, index, cfg, **kw),
            talign.AlignerEngine(to_port(ref), to_port(index), to_port(cfg),
                                 device="cpu", **kw))


def _batches(ref, n_batches, seed=300, n=64):
    out = []
    for k in range(n_batches):
        rng = np.random.default_rng(seed + k)
        codes, lengths, _ = sample_reads(rng, ref, n, 50, mutate=3,
                                         indel=True)
        out.append((codes, lengths))
    return out


def _parts(out) -> tuple:
    """A step's output as a tuple of its records."""
    return out if isinstance(out, tuple) and not hasattr(out, "_fields") \
        else (out,)


def _eq_records(got, want, what=""):
    """A step's output on the port's device against the JAX engine's:
    equal bytes, dtypes and shapes, record by record and field by field (a
    bare tensor, the fused counts, is a record of one field)."""
    want = jax.device_get(_parts(want))
    got = _parts(got)
    assert len(got) == len(want), what
    for g_rec, w_rec in zip(got, want):
        if isinstance(g_rec, torch.Tensor):
            pairs = [("counts", g_rec.numpy(), w_rec)]
        else:
            (g_rec,) = talign.fetch_host(g_rec)
            pairs = zip(w_rec._fields, g_rec, w_rec)
        for f, g, w in pairs:
            w = np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape, (what, f)
            assert g.tobytes() == w.tobytes(), (what, f)


# ---------------------------------------------------------------------------
# (a) the capture audit
# ---------------------------------------------------------------------------

KINDS = ["align_batch", "with_candidates", "packed", "packed_counts",
         "profile_counts", "rescue_cfg2", "combined_packed"]


def _port_step(kind, small_cfg, tiny_ref, tiny_index):
    """-> (the port's engine, the name of the step of `kind`, a call of the
    engine that runs it)."""
    if kind == "combined_packed":
        _genome, (_jeng, eng) = _combined_engines(small_cfg)
        codes, lengths = _packed_reads(tiny_ref)
        return eng, "combined k=8", lambda: eng.align_device_packed(
            codes, lengths)
    if kind == "rescue_cfg2":
        cfg = to_port(small_cfg.replace(rescue_kmer=6))
        eng = talign.AlignerEngine(to_port(tiny_ref), to_port(tiny_index),
                                   cfg, device="cpu")
        codes, lengths = _rescue_reads("unmapped_36bp", tiny_ref)
        batch = to_port(ReadBatch(codes=codes, lengths=lengths))
        return eng, "packed k=6", lambda: eng.to_host(
            batch, eng.align_device_packed(codes, lengths))
    eng = talign.AlignerEngine(to_port(tiny_ref), to_port(tiny_index),
                               to_port(small_cfg), device="cpu",
                               xa_tags=kind == "with_candidates")
    codes, lengths = _packed_reads(tiny_ref)
    if kind in ("align_batch", "with_candidates"):
        return eng, "unpacked k=8", lambda: eng.align_device(codes, lengths)
    if kind == "profile_counts":
        return eng, "counts k=8", lambda: eng.profile_counts_device(
            codes, lengths, eng.align_device(codes, lengths))
    return eng, "packed k=8", lambda: eng.align_device_packed(
        codes, lengths, with_counts=kind == "packed_counts")


@pytest.mark.parametrize("kind", KINDS)
def test_steps_hold_no_host_op(kind, small_cfg, tiny_ref, tiny_index):
    """Each step kind, on its first call of a key and on a replay, does
    nothing a CUDA graph cannot hold: no sync (.item(), nonzero,
    masked_select, unique, bincount), no tensor from host data
    (lift_fresh), no copy from another device, no bool-mask indexing."""
    eng, name, call = _port_step(kind, small_cfg, tiny_ref, tiny_index)
    found, ran = _audit(eng)
    call()
    call()
    assert not found, found
    assert ran.count(name) == 2, ran


# ---------------------------------------------------------------------------
# (b) in-flight safety
# ---------------------------------------------------------------------------

def _calls(kind, small_cfg, tiny_ref, tiny_index):
    """-> (port call, JAX call), each (codes, lengths) -> the step's device
    output."""
    if kind == "combined":
        _genome, (jeng, teng) = _combined_engines(small_cfg)
        return teng.align_device_packed, jeng.align_device_packed
    jeng, teng = _engines(tiny_ref, tiny_index, small_cfg)
    if kind == "unpacked":
        return teng.align_device, jeng.align_device

    def with_counts(eng):
        return lambda c, ln: eng.align_device_packed(c, ln,
                                                     with_counts=True)

    if kind == "packed_counts":
        return with_counts(teng), with_counts(jeng)
    return teng.align_device_packed, jeng.align_device_packed


@pytest.mark.parametrize("n_more", [2, 8])
@pytest.mark.parametrize("kind", ["packed", "packed_counts", "unpacked",
                                  "combined"])
def test_held_output_survives_later_calls(kind, n_more, small_cfg, tiny_ref,
                                          tiny_index):
    """An output held while n_more batches of the same key run through the
    step (each writes the entry's outputs, as a replay does) still equals
    the JAX engine's on its own batch, and so do the later ones."""
    port, jax_step = _calls(kind, small_cfg, tiny_ref, tiny_index)
    batches = _batches(tiny_ref, n_more + 1)
    held = [port(*b) for b in batches]
    for k, (out, b) in enumerate(zip(held, batches)):
        _eq_records(out, jax_step(*b), f"{kind} batch {k}")


# ---------------------------------------------------------------------------
# (c) parameters are runtime arguments
# ---------------------------------------------------------------------------

def _pass2_tensor(cfg) -> np.ndarray:
    """A learned-looking profile: T->C (ref T, read C) scored as a match,
    and every other mismatch one point dearer over the first half of the
    read."""
    s = flat_score_tensor(cfg, cfg.max_read_len).copy()
    s[:, 3, 1] = s[:, 3, 3]
    half = cfg.max_read_len // 2
    off = ~np.eye(5, dtype=bool)
    off[3, 1] = False
    s[:half][:, off] -= 1
    return s


@pytest.mark.parametrize("kind", ["packed", "unpacked", "combined"])
def test_set_profile_reaches_the_compiled_steps(kind, small_cfg, tiny_ref,
                                                tiny_index):
    """set_profile between batches: the batch run again through the same
    entry, and a new one, give the JAX engine's pass-2 results (which
    differ from pass 1's), not pass 1's."""
    ref = tiny_ref
    if kind == "combined":
        _genome, (jeng, teng) = _combined_engines(small_cfg)
        steps = (teng.align_device_packed, jeng.align_device_packed)
        ref = jeng.genome_ref
    else:
        jeng, teng = _engines(tiny_ref, tiny_index, small_cfg)
        name = "align_device" + ("_packed" if kind == "packed" else "")
        steps = (getattr(teng, name), getattr(jeng, name))
    rng = np.random.default_rng(61)
    first, second = [], []
    for out in (first, second):
        codes, lengths, _ = sample_reads(rng, ref, 64, 50, mutate=4)
        codes[:, ::7] = np.where(codes[:, ::7] == 3, 1, codes[:, ::7])
        out.append((codes, lengths))
    pass1 = steps[0](*first[0])
    _eq_records(pass1, steps[1](*first[0]), "pass 1")
    s2 = _pass2_tensor(small_cfg)
    jeng.set_profile(s2)
    teng.set_profile(s2)
    for b in (first[0], second[0]):
        _eq_records(steps[0](*b), steps[1](*b), "pass 2")
    before = talign.fetch_host(*_parts(pass1))[0]
    after = talign.fetch_host(*_parts(steps[0](*first[0])))[0]
    assert any(a.tobytes() != b.tobytes() for a, b in zip(before, after)), \
        "the pass-2 profile changed nothing on this batch"


# ---------------------------------------------------------------------------
# (d) the cache
# ---------------------------------------------------------------------------

def test_one_entry_per_key(small_cfg, tiny_ref, tiny_index):
    """A repeated call makes no entry; a short final batch and with_counts
    on and off make one each; each output equals the JAX engine's."""
    jeng, teng = _engines(tiny_ref, tiny_index, small_cfg)
    step = teng.compiled_steps()["packed k=8"]
    full, other = _batches(tiny_ref, 2, seed=500)
    short = (full[0][:40], full[1][:40])
    seen = []
    for b, counts in ((full, False), (other, False), (short, False),
                      (short, False), (full, True), (other, True),
                      (full, False)):
        _eq_records(teng.align_device_packed(*b, with_counts=counts),
                    jeng.align_device_packed(*b, with_counts=counts),
                    f"{len(b[0])} rows, counts {counts}")
        seen.append(len(step.entries))
    assert seen == [1, 1, 2, 2, 3, 3, 3]
    shapes = sorted(k[2][0][0][0] for k in step.entries)
    assert shapes == [40, 64, 64]
    assert step.graphs == 0 and step.capture_ms == 0.0


def test_static_arguments_are_declared():
    """A keyword the step does not declare static is refused; the cfg of
    the partial is part of every key."""
    import functools

    from parasuite_tpu_torch.config import AlignConfig

    cfg = AlignConfig(max_read_len=50, kmer_size=8)
    step = CompiledStep(functools.partial(
        lambda x, *, cfg, scale: x * scale, cfg=cfg), "cpu", "scale",
        static=("scale",))
    x = torch.arange(4)
    assert torch.equal(step(x, scale=3), x * 3)
    with pytest.raises(TypeError, match="not static"):
        step(x, shift=1)
    ((key_cfg, static, shapes),) = step.entries
    assert key_cfg is cfg and static == (("scale", 3),)
    assert shapes == (((4,), torch.int64),)
