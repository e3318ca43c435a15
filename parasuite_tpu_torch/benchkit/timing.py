"""Throughput harness: reads/s with warm-up separated (BASELINE.json:metric;
SURVEY.md §5 tracing).

The reference's ThroughputTimer (parasuite_tpu/benchkit/timing.py:18-54)
with the same report. Where the reference blocks on the result with
jax.block_until_ready (:29-35), stop() here synchronises the CUDA device of any
tensor in the result, so asynchronous launches cannot flatter the
numbers; a result on the CPU is ready when it is returned.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field

import torch


def _cuda_device(result):
    """The CUDA device of the first CUDA tensor in a (nested) tuple of
    tensors, or None."""
    if isinstance(result, torch.Tensor):
        return result.device if result.is_cuda else None
    if isinstance(result, (tuple, list)):
        for x in result:
            dev = _cuda_device(x)
            if dev is not None:
                return dev
    return None


def block_until_ready(result):
    """jax.block_until_ready for tensors: waits for the CUDA device the
    result lives on (nothing to wait for on the CPU) -> result."""
    dev = _cuda_device(result)
    if dev is not None:
        torch.cuda.synchronize(dev)
    return result


@dataclass
class ThroughputTimer:
    name: str = "align"
    _t0: float = 0.0
    items: int = 0
    seconds: float = 0.0
    stage_seconds: dict = field(default_factory=dict)

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, n_items: int, result=None) -> float:
        block_until_ready(result)
        dt = time.perf_counter() - self._t0
        self.items += n_items
        self.seconds += dt
        return dt

    def stage(self, key: str, seconds: float) -> None:
        self.stage_seconds[key] = self.stage_seconds.get(key, 0.0) + seconds

    @property
    def per_second(self) -> float:
        return self.items / self.seconds if self.seconds > 0 else 0.0

    def report(self, **extra) -> dict:
        d = {"name": self.name, "items": self.items,
             "seconds": round(self.seconds, 4),
             "items_per_second": round(self.per_second, 2)}
        if self.stage_seconds:
            d["stages"] = {k: round(v, 4) for k, v in self.stage_seconds.items()}
        d.update(extra)
        return d

    def json_line(self, **extra) -> str:
        return json.dumps(self.report(**extra))
