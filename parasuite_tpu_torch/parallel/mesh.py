"""Device meshes of the port: a list, or an n_data x n_index grid, of
torch devices.

Counterpart of parasuite_tpu/parallel/mesh.py. The workload's parallel
structure is the reference's: reads are data-parallel, the index is
replicated (or chromosome-sharded, parallel/shards.py), and the only
cross-device traffic is the sum of the [L, 4, 4] profile count matrix plus
the gathers of per-read results. A mesh here holds no framework state: the
steps built on it (dist_align.py, shards.py) move tensors between its
devices themselves.

With no device list given a mesh is made of the machine's CUDA devices, and
asking for more than it has raises ValueError. A caller that wants
something else says so with an explicit list (`[torch.device("cpu")] * 8`
in the CPU tests, the same card twice to check a two-replica step on one
card); a missing card is never replaced by another device silently.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Mesh:
    """devices in row-major order, shape (n,) or (n_data, n_index)."""

    devices: tuple
    shape: tuple
    axis_names: tuple

    @property
    def size(self) -> int:
        return len(self.devices)

    def rows(self) -> list[tuple]:
        """The device rows of a 2-D mesh (one row per data shard)."""
        n_data, n_index = self.shape
        return [self.devices[r * n_index:(r + 1) * n_index]
                for r in range(n_data)]


def _machine_devices() -> list[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def local_device_count() -> int:
    return torch.cuda.device_count()


def make_mesh2(n_data: int, n_index: int, data_axis: str = "data",
               index_axis: str = "index", devices=None) -> Mesh:
    """2-D mesh: read-batch parallelism x chromosome-sharded index
    (parallel/shards.py). The index axis varies fastest: the per-read
    cross-shard merge gathers small tuples from a row's devices every
    batch."""
    devs = _machine_devices() if devices is None else list(devices)
    need = n_data * n_index
    if need > len(devs):
        raise ValueError(f"mesh {n_data}x{n_index} needs {need} devices, "
                         f"have {len(devs)}")
    return Mesh(tuple(torch.device(d) for d in devs[:need]),
                (n_data, n_index), (data_axis, index_axis))


def make_mesh(n_devices: int | None = None, axis_name: str = "data",
              devices=None) -> Mesh:
    """1-D data-parallel mesh over the first n devices (default: all) of
    `devices` (default: the machine's CUDA devices)."""
    devs = _machine_devices() if devices is None else list(devices)
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"requested {n_devices} devices, have "
                             f"{len(devs)}")
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("requested a mesh of the machine's CUDA devices, "
                         "have 0")
    return Mesh(tuple(torch.device(d) for d in devs), (len(devs),),
                (axis_name,))
