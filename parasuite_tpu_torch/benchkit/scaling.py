"""Scaling-efficiency measurement (BASELINE.json config 5: reads/s at
1 device / N devices, efficiency = rps(N) / (N * rps(1))).

Counterpart of parasuite_tpu/benchkit/scaling.py: runs the data-parallel
align step (parallel.dist_align) over meshes of increasing size with a fixed
per-device batch (weak scaling, the production regime for a bounded
read-sharding job) and reports the same table. Each round is timed on the
host clock around a step that ends in a synchronize of every mesh device;
the first call of each mesh is a warm-up (on CUDA it captures each slot's
graph) and is not timed.

The meshes are cut from `devices` (default: the machine's CUDA devices), so
a count above what the machine has raises in make_mesh: replicas that share
one card are never reported as if they were cards.
"""

from __future__ import annotations

import time

import torch

from parasuite_tpu_torch.config import AlignConfig
from parasuite_tpu_torch.ops.device_index import min_scores_host
from parasuite_tpu_torch.parallel.dist_align import (graph_stats,
                                                     make_dist_align_step,
                                                     shard_batch)
from parasuite_tpu_torch.parallel.mesh import make_mesh


def _wait(mesh) -> None:
    for dev in set(mesh.devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def measure_scaling(didx, sprof, codes, lengths, cfg: AlignConfig,
                    device_counts: list[int], per_device_reads: int,
                    rounds: int = 3, devices=None) -> dict:
    """-> {"points": [{n_devices, reads_per_s, efficiency}], ...}.

    codes/lengths must hold at least max(device_counts) * per_device_reads
    reads (weak scaling: every device processes per_device_reads each step).
    """
    return scaling_run(didx, sprof, codes, lengths, cfg, device_counts,
                       per_device_reads, rounds, devices)[0]


def scaling_run(didx, sprof, codes, lengths, cfg: AlignConfig,
                device_counts: list[int], per_device_reads: int,
                rounds: int = 3, devices=None) -> tuple[dict, list]:
    """-> (measure_scaling's report, each mesh's compiled graphs: its
    graph_stats). The warm-up call of a mesh captures its slots."""
    meshes = [make_mesh(n, devices=devices) for n in device_counts]
    ms_all = min_scores_host(lengths, cfg)
    points, graphs = [], []
    base_rps = None
    for n, mesh in zip(device_counts, meshes):
        step = make_dist_align_step(cfg, mesh, with_counts=True)
        n_reads = per_device_reads * n
        c, l, m = shard_batch(codes[:n_reads], lengths[:n_reads],
                              ms_all[:n_reads], n)
        step(didx, sprof, c, l, m)
        _wait(mesh)
        best = 0.0
        for _ in range(rounds):
            t0 = time.perf_counter()
            step(didx, sprof, c, l, m)
            _wait(mesh)
            best = max(best, n_reads / (time.perf_counter() - t0))
        if base_rps is None:
            base_rps = best / n  # per-device at the first (smallest) count
        eff = best / (n * base_rps)
        points.append({"n_devices": n, "reads_per_s": round(best, 1),
                       "per_device": round(best / n, 1),
                       "efficiency": round(eff, 4)})
        graphs.append({"n_devices": n, **graph_stats(step)})
    return ({"mode": "weak", "per_device_reads": per_device_reads,
             "backend": meshes[0].devices[0].type, "points": points},
            graphs)
