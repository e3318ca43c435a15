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

Determinism at any device count falls out of the design: per-read outputs
depend only on that read and replicated state, and the count sum adds
integer matrices, whose sum is order-independent.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from parasuite_tpu_torch.config import AlignConfig
from parasuite_tpu_torch.ops.aligner import (align_batch,
                                             align_batch_with_candidates)
from parasuite_tpu_torch.ops.profile_update import profile_counts_batch
from parasuite_tpu_torch.parallel.mesh import Mesh


def on_device(device: torch.device):
    """Context in which CUDA work goes to `device` (the kernels launch on
    the current device's stream); nothing to set for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def replicate(state, device: torch.device):
    """A dataclass of tensors (DeviceIndex, ScoreParams) on `device`; the
    same object when it already lives there."""
    fields = {f.name: getattr(state, f.name)
              for f in dataclasses.fields(state)}
    if all(t.device == device for t in fields.values()):
        return state
    return type(state)(**{k: t.to(device) for k, t in fields.items()})


class Replicas:
    """Per-device copies of the state objects a step was last called with,
    made once per object (by identity) and kept until another object takes
    the slot: an engine's index never changes, its score tensors change
    once per pass."""

    def __init__(self, devices):
        self.devices = tuple(devices)
        self._slots: dict = {}

    def of(self, slot: str, state) -> list:
        held = self._slots.get(slot)
        if held is None or held[0] is not state:
            held = (state, [replicate(state, d) for d in self.devices])
            self._slots[slot] = held
        return held[1]


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


def make_dist_align_step(cfg: AlignConfig, mesh: Mesh,
                         axis_name: str = "data", with_counts: bool = True,
                         with_candidates: bool = False):
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
    """
    if with_candidates and with_counts:
        raise ValueError("combined mode counts profiles host-side; "
                         "with_counts+with_candidates unsupported")
    if axis_name not in mesh.axis_names or len(mesh.shape) != 1:
        raise ValueError(f"the data-parallel step needs a 1-D mesh with "
                         f"axis {axis_name!r}, got {mesh.axis_names}")
    devices = mesh.devices
    home = devices[0]
    replicas = Replicas(devices)

    def local_step(didx, sprof, codes, lengths, min_scores):
        if with_candidates:
            return align_batch_with_candidates(didx, sprof, codes, lengths,
                                               min_scores, cfg)
        res = align_batch(didx, sprof, codes, lengths, min_scores, cfg)
        if not with_counts:
            return res
        return res, profile_counts_batch(didx, codes, lengths, res.mapped,
                                         res.strand, res.pos, res.ug_equal,
                                         cfg)

    def step(didx, sprof, codes, lengths, min_scores):
        shards = split_reads((codes, lengths, min_scores), len(devices))
        didxs = replicas.of("didx", didx)
        sprofs = replicas.of("sprof", sprof)
        # enqueue every device's work before anything is gathered, so the
        # devices run side by side
        outs = []
        for dev, d, s, (c, ln, ms) in zip(devices, didxs, sprofs, shards):
            with on_device(dev):
                outs.append(local_step(d, s, c.to(dev),
                                       ln.to(dev, torch.int32),
                                       ms.to(dev, torch.int32)))
        if with_candidates:
            return (concat_fields([o[0] for o in outs], home),
                    concat_fields([o[1] for o in outs], home))
        if not with_counts:
            return concat_fields(outs, home)
        counts = sum(o[1].to(home).to(torch.int64) for o in outs)
        return concat_fields([o[0] for o in outs], home), counts

    return step


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
