"""Entry points of the port for a quick check of a machine: the single-device
step and a multi-device dry run.

Counterpart of the repository's __graft_entry__.py (which drives the JAX
package). entry() returns the flagship step — the full batch aligner (seed
-> select -> banded DP -> finalize) on a synthetic reference — with example
arguments on the device. dryrun_multichip(n) runs the full distributed
pipeline step on an n-device mesh: the data-parallel step with summed
error-profile counts, then the 2-D data x index step over a
chromosome-sharded index.

    python -m parasuite_tpu_torch.entry 1          # the machine's first card
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _toy_state(cfg, device, ref_len=120_000, seed=42):
    from parasuite_tpu_torch.errormodel.scoring import flat_score_tensor
    from parasuite_tpu_torch.index import KmerIndex, PackedReference
    from parasuite_tpu_torch.ops.device_index import DeviceIndex, ScoreParams

    rng = np.random.default_rng(seed)
    seqs = {"chr_toy": rng.integers(0, 4, ref_len).astype(np.int8)}
    ref = PackedReference.from_dict(seqs, spacer=cfg.chrom_spacer)
    index = KmerIndex.build(ref.seq, cfg.kmer_size)
    didx = DeviceIndex.from_host(ref, index, device)
    sprof = ScoreParams.from_tensor(
        flat_score_tensor(cfg, cfg.max_read_len), cfg, device)
    return ref, didx, sprof


def _toy_reads(cfg, ref, n, seed=43):
    from parasuite_tpu_torch.ops.device_index import min_scores_host
    from parasuite_tpu_torch.utils.dna import revcomp_codes

    rng = np.random.default_rng(seed)
    L = cfg.max_read_len
    codes = np.zeros((n, L), dtype=np.int8)
    for i in range(n):
        p = int(rng.integers(ref.starts[0], ref.ends[0] - L))
        frag = ref.seq[p : p + L].copy()
        nmut = int(rng.integers(0, 4))
        for _ in range(nmut):
            q = int(rng.integers(0, L))
            frag[q] = (frag[q] + 1 + rng.integers(0, 3)) % 4
        if rng.random() < 0.5:
            frag = revcomp_codes(frag)
        codes[i] = frag
    lengths = np.full(n, L, dtype=np.int32)
    return codes, lengths, min_scores_host(lengths, cfg)


def entry(device="cuda"):
    """-> (fn, example_args) for the flagship align step; every argument is
    a tensor (or a dataclass of tensors) on `device`."""
    from parasuite_tpu_torch.config import AlignConfig
    from parasuite_tpu_torch.ops.aligner import align_batch
    from parasuite_tpu_torch.pipeline.align import resolve_device

    dev = resolve_device(device)
    cfg = AlignConfig(max_read_len=50, kmer_size=10, batch_size=256,
                      max_candidates=8)
    ref, didx, sprof = _toy_state(cfg, dev)
    reads = _toy_reads(cfg, ref, cfg.batch_size)
    fn = functools.partial(align_batch, cfg=cfg)
    return fn, (didx, sprof, *(torch.from_numpy(x).to(dev) for x in reads))


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Run the full distributed pipeline step on an n-device mesh: first the
    1-D data-parallel step (replicated index + summed profile counts), then
    the 2-D data x index mesh (chromosome-sharded index with the cross-shard
    winner merge — parallel/shards.py). The meshes are cut from `devices`
    (default: the machine's CUDA devices)."""
    from parasuite_tpu_torch.config import AlignConfig
    from parasuite_tpu_torch.parallel import (make_dist_align_step, make_mesh,
                                              shard_batch)

    cfg = AlignConfig(max_read_len=50, kmer_size=8, batch_size=16 * n_devices,
                      max_candidates=4, max_occ=16)
    mesh = make_mesh(n_devices, devices=devices)
    ref, didx, sprof = _toy_state(cfg, mesh.devices[0], ref_len=20_000)
    codes, lengths, min_scores = _toy_reads(cfg, ref, cfg.batch_size)
    codes, lengths, min_scores = shard_batch(codes, lengths, min_scores,
                                             n_devices)
    step = make_dist_align_step(cfg, mesh)
    res, counts = step(didx, sprof, codes, lengths, min_scores)
    if tuple(counts.shape) != (cfg.max_read_len, 4, 4):
        raise AssertionError(f"profile counts of shape {tuple(counts.shape)}")
    n_mapped = int(res.mapped.sum())
    if n_mapped <= 0:
        raise AssertionError("dry run aligned nothing")
    print(f"dryrun_multichip({n_devices}): 1-D data ok — "
          f"{n_mapped}/{codes.shape[0]} reads mapped, "
          f"profile counts total={int(counts.sum())}, "
          f"compiled {_graphs(step)}")

    # 2-D (data x index) mesh: chromosome-sharded index + cross-shard merge
    n_index = 2 if n_devices % 2 == 0 else 1
    n_data = n_devices // n_index
    _dryrun_2d(n_data, n_index, devices)


def _dryrun_2d(n_data: int, n_index: int, devices=None) -> None:
    from parasuite_tpu_torch.config import AlignConfig
    from parasuite_tpu_torch.errormodel.scoring import flat_score_tensor
    from parasuite_tpu_torch.ops.device_index import ScoreParams
    from parasuite_tpu_torch.parallel.mesh import make_mesh2
    from parasuite_tpu_torch.parallel.shards import (build_sharded_index,
                                                     make_sharded_step)

    cfg = AlignConfig(max_read_len=50, kmer_size=8,
                      batch_size=16 * n_data, max_candidates=4, max_occ=16)
    rng = np.random.default_rng(44)
    seqs = {f"chr{i}": rng.integers(0, 4, 4000 + 1000 * i).astype(np.int8)
            for i in range(max(3, n_index + 1))}
    sharded, full = build_sharded_index(seqs, n_index, cfg)
    mesh = make_mesh2(n_data, n_index, devices=devices)
    sprof = ScoreParams.from_tensor(
        flat_score_tensor(cfg, cfg.max_read_len), cfg, mesh.devices[0])
    codes, lengths, min_scores = _toy_reads(cfg, full, cfg.batch_size,
                                            seed=45)
    step = make_sharded_step(cfg, mesh)
    out = step(sharded.slabs(cfg), sharded.orig_chrom, sprof, codes, lengths,
               min_scores)
    n_mapped = int(out["mapped"].sum())
    if n_mapped <= 0:
        raise AssertionError("2-D dry run aligned nothing")
    print(f"dryrun_multichip 2-D ({n_data}x{n_index} data x index): ok — "
          f"{n_mapped}/{codes.shape[0]} reads mapped across "
          f"{n_index} index shards, compiled {_graphs(step)}")


def _graphs(step) -> str:
    """A multi-device step's compiled steps, keys, graphs and capture ms."""
    from parasuite_tpu_torch.parallel.dist_align import graph_stats

    g = graph_stats(step)
    return (f"{g['compiled_steps']} steps, {g['keys']} keys, {g['graphs']} "
            f"graphs, capture {g['capture_ms']:.1f} ms")


if __name__ == "__main__":
    import sys

    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1
                     else torch.cuda.device_count())
