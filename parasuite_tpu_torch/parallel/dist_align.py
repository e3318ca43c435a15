"""Data-parallel alignment step over a mesh of devices.

Counterpart of parasuite_tpu/parallel/dist_align.py. The read axis is split
evenly over the mesh's devices, DeviceIndex and ScoreParams are replicated
(once per index and mesh, kept by the step), each device runs the same
align_batch as the single-device engine (so on CUDA tensors both Hopper
kernels launch once per device and call), the results come back
concatenated in read order on the mesh's first device, and the error-profile
count matrices are summed over devices in int64. Where the reference's
shard_map leaves the result sharded and psums the counts, this is one
process moving tensors between its devices; across processes the same sum is
an all_reduce (parallel/distributed.py).

Compiled, as the reference jits its shard_map: each mesh slot runs its
align step as an ops/compiled.py::CompiledStep over that slot's replicas,
one CUDA graph per key, replayed. The split of the reads, the uploads, the
gather to the first device and the int64 sum of the counts stay outside the
graphs. Slots on one card share a graph memory pool (they replay on its one
stream, and every replay's outputs are cloned); each card has its own.

Determinism at any device count falls out of the design: per-read outputs
depend only on that read and replicated state, and the count sum adds
integer matrices, whose sum is order-independent.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import torch

from parasuite_tpu_torch.config import AlignConfig
from parasuite_tpu_torch.ops.aligner import (align_batch,
                                             align_batch_with_candidates)
from parasuite_tpu_torch.ops.compiled import CompiledStep
from parasuite_tpu_torch.ops.profile_update import profile_counts_batch
from parasuite_tpu_torch.parallel.mesh import Mesh


def on_device(device: torch.device):
    """Context in which CUDA work goes to `device` (the kernels launch on
    the current device's stream); nothing to set for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _fields(state) -> dict:
    return {f.name: getattr(state, f.name)
            for f in dataclasses.fields(state)}


def replicate(state, device: torch.device):
    """A dataclass of tensors (DeviceIndex, ScoreParams) on `device`; the
    same object when it already lives there."""
    fields = _fields(state)
    if all(t.device == device for t in fields.values()):
        return state
    return type(state)(**{k: t.to(device) for k, t in fields.items()})


def _mark(state) -> tuple:
    """What the contents of state's tensors are up to: their version
    counters, which every in-place write (copy_, fill_, ...) bumps."""
    return tuple(t._version for t in _fields(state).values())


class Replicas:
    """Per-device copies of the state objects a step is called with, one
    copy a distinct device, kept until another object takes the slot: an
    engine's index never changes, its score tensors change once per pass,
    in place (AlignerEngine.set_profile). A slot is keyed by the object and
    by the mark of its contents (_mark): when the same object comes back
    with new contents, they are copied into the copies' own tensors, which
    keep their addresses, as the compiled steps read them there."""

    def __init__(self, devices):
        self.devices = tuple(devices)
        self._slots: dict = {}

    def of(self, slot: str, state) -> list:
        """-> the copies of state, one per device of the list."""
        held = self._slots.get(slot)
        if held is None or held["state"] is not state:
            copies = {d: replicate(state, d) for d in dict.fromkeys(
                self.devices)}
            held = {"state": state, "mark": _mark(state),
                    "copies": [copies[d] for d in self.devices]}
            self._slots[slot] = held
        elif _mark(state) != held["mark"]:
            src = _fields(state)
            for copy in {id(c): c for c in held["copies"]}.values():
                if copy is not state:
                    for name, t in _fields(copy).items():
                        t.copy_(src[name])
            held["mark"] = _mark(state)
        return held["copies"]


def graph_pools(devices) -> dict:
    """{device: graph memory pool}: one pool a distinct CUDA device, None
    for the CPU."""
    return {d: (torch.cuda.graph_pool_handle() if d.type == "cuda" else None)
            for d in dict.fromkeys(devices)}


def graph_stats(step) -> dict:
    """The compiled steps of a multi-device step, summed: slots, keys,
    graphs and capture ms."""
    steps = step.compiled_steps().values()
    return {"compiled_steps": len(steps),
            "keys": sum(len(s.entries) for s in steps),
            "graphs": sum(s.graphs for s in steps),
            "capture_ms": sum(s.capture_ms for s in steps)}


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))


def split_reads(arrays, n_shards: int) -> list[tuple]:
    """Each array cut into n_shards equal runs along the read axis ->
    [(codes_i, lengths_i, min_scores_i)]."""
    tensors = [_as_tensor(a) for a in arrays]
    n = tensors[0].shape[0]
    if n % n_shards:
        raise ValueError(f"{n} reads do not divide over {n_shards} devices "
                         f"(pad with shard_batch)")
    per = n // n_shards
    return [tuple(t[i * per:(i + 1) * per] for t in tensors)
            for i in range(n_shards)]


def concat_fields(parts: list, device: torch.device):
    """Namedtuples of tensors, one per shard -> one namedtuple on `device`
    with every field concatenated in shard order."""
    return type(parts[0])(*[
        torch.cat([getattr(p, f).to(device) for p in parts])
        for f in parts[0]._fields])


def local_step(didx, sprof, codes, lengths, min_scores, cfg: AlignConfig,
               with_counts: bool, with_candidates: bool):
    """One mesh slot's share of the data-parallel step: the single-device
    align step (+ its profile counts, or its candidate table)."""
    if with_candidates:
        return align_batch_with_candidates(didx, sprof, codes, lengths,
                                           min_scores, cfg)
    res = align_batch(didx, sprof, codes, lengths, min_scores, cfg)
    if not with_counts:
        return res
    return res, profile_counts_batch(didx, codes, lengths, res.mapped,
                                     res.strand, res.pos, res.ug_equal, cfg)


class DistAlignStep:
    """The data-parallel step (make_dist_align_step): one CompiledStep a
    mesh slot, over the slot's replicas of the state it is called with."""

    def __init__(self, cfg: AlignConfig, mesh: Mesh, with_counts: bool,
                 with_candidates: bool):
        self.cfg, self.mesh = cfg, mesh
        self.with_counts, self.with_candidates = with_counts, with_candidates
        self.devices = mesh.devices
        self._replicas = Replicas(self.devices)
        self._pools = graph_pools(self.devices)
        self._bound = (None, None)
        # the slots' steps, in mesh order: CompiledSteps, or any callable
        # of (codes, lengths, min_scores) put in their place (the eager
        # route of a comparison: each one's .fn)
        self.slots: list = []

    def bind(self, didx, sprof) -> list:
        """The slots' steps over the replicas of (didx, sprof), made anew
        when another object takes either replica slot."""
        didxs = self._replicas.of("didx", didx)
        sprofs = self._replicas.of("sprof", sprof)
        if self._bound[0] is not didxs or self._bound[1] is not sprofs:
            self.slots = [CompiledStep(
                functools.partial(local_step, d, s, cfg=self.cfg,
                                  with_counts=self.with_counts,
                                  with_candidates=self.with_candidates),
                dev, f"data {i} {dev}", pool=self._pools[dev])
                for i, (dev, d, s) in enumerate(zip(self.devices, didxs,
                                                    sprofs))]
            self._bound = (didxs, sprofs)
        return self.slots

    def compiled_steps(self) -> dict:
        """{slot name: CompiledStep} of the slots bound so far."""
        return {s.name: s for s in self.slots
                if isinstance(s, CompiledStep)}

    def __call__(self, didx, sprof, codes, lengths, min_scores):
        slots = self.bind(didx, sprof)
        shards = split_reads((codes, lengths, min_scores), len(self.devices))
        # enqueue every slot's work before anything is gathered, so the
        # devices run side by side
        outs = []
        for dev, slot, (c, ln, ms) in zip(self.devices, slots, shards):
            with on_device(dev):
                outs.append(slot(c.to(dev), ln.to(dev, torch.int32),
                                 ms.to(dev, torch.int32)))
        home = self.devices[0]
        if self.with_candidates:
            return (concat_fields([o[0] for o in outs], home),
                    concat_fields([o[1] for o in outs], home))
        if not self.with_counts:
            return concat_fields(outs, home)
        counts = sum(o[1].to(home).to(torch.int64) for o in outs)
        return concat_fields([o[0] for o in outs], home), counts


def make_dist_align_step(cfg: AlignConfig, mesh: Mesh,
                         axis_name: str = "data", with_counts: bool = True,
                         with_candidates: bool = False) -> DistAlignStep:
    """-> step(didx, sprof, codes, lengths, min_scores).

    codes/lengths/min_scores (numpy arrays or tensors) are split on their
    leading (read) axis; it must be divisible by the mesh size. Returns
    (AlignResult in read order, counts int64 [L, 4, 4] summed over the
    mesh), both on the mesh's first device — or just the AlignResult when
    with_counts=False.

    with_candidates=True (combined genome+transcriptome mode): the step
    returns (AlignResult, CandidateTable), both in read order. Every
    per-candidate row belongs to its read, so the caller re-finalizes and
    projects its own reads on the host exactly like the single-process
    CombinedEngine.to_host. Profile counts in combined mode accumulate from
    the emitted records on the host (CombinedEngine.counts_from_host), so
    with_counts must stay False here.

    Each slot's work is a CompiledStep (module docstring); the step's
    compiled_steps() names them.
    """
    if with_candidates and with_counts:
        raise ValueError("combined mode counts profiles host-side; "
                         "with_counts+with_candidates unsupported")
    if axis_name not in mesh.axis_names or len(mesh.shape) != 1:
        raise ValueError(f"the data-parallel step needs a 1-D mesh with "
                         f"axis {axis_name!r}, got {mesh.axis_names}")
    return DistAlignStep(cfg, mesh, with_counts, with_candidates)


def shard_batch(codes, lengths, min_scores, n_shards: int):
    """Pad the read axis to a multiple of n_shards (length-0 N rows)."""
    n = codes.shape[0]
    pad = (-n) % n_shards
    if pad:
        codes = np.concatenate(
            [codes, np.full((pad, codes.shape[1]), 4, dtype=codes.dtype)])
        lengths = np.concatenate([lengths, np.zeros(pad, dtype=lengths.dtype)])
        min_scores = np.concatenate(
            [min_scores, np.zeros(pad, dtype=min_scores.dtype)])
    return codes, lengths, min_scores
