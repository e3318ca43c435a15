"""Compiled device steps: the port's counterpart of the JAX engine's jax.jit.

The JAX engine compiles each device step once per shape
(jax.jit(functools.partial(step, cfg=cfg), static_argnames=...):
parasuite_tpu/pipeline/align.py:251-291, pipeline/combined.py:285, :334)
and replays the program for every batch. CompiledStep does the same with
CUDA graphs, so a step is one graph launch instead of some 500 kernels and
copies enqueued op by op from Python:

  * cache: one entry per key -- the shapes and dtypes of the tensor
    arguments, the values of the static keyword arguments (with_counts,
    cap_entries, ...) and the cfg the partial carries. A new key is a new
    capture, as a new shape is a new compile under jit: a short final batch
    and the rescue step's `cap` rows get entries of their own;
  * warm-up and capture: a new key runs the function once on a side stream
    (which builds the kernel library at first use, ops/_build.py); that
    eager run is the first call's result. The key is then captured with
    torch.cuda.graph, and every later call copies its tensors into the
    entry's static inputs and replays;
  * fresh outputs, as jit returns them: after each replay every output is
    cloned on the same stream, so results still in flight (stream.py keeps
    `depth` batches pending, the bench loop a whole round, the rescue step
    runs while the primary batch is fetched) are never overwritten by the
    next replay;
  * parameters by address: the tensors the partial binds (DeviceIndex,
    ScoreParams, the min-score table, TxDeviceTables) are read where they
    lie at replay time. They are updated in place, never rebound
    (AlignerEngine.set_profile copies pass 2's scores into pass 1's);
  * launch counts: a replay runs no Python, so the launches of the kernel
    wrappers (KERNELS: cuda_seed.seeded_launches, cuda_seed.launches,
    cuda_extend.launches, cuda_finalize.launches) that a graph holds are
    counted at capture and added to the counters on every replay; a step's
    graph holds one seeded select launch, no launch from rows of diagonals,
    one extend launch and one finalize launch;
  * no eager fallback on CUDA: a capture that fails raises, naming the step,
    its device and the key;
  * the step's device: warm-up, capture and replay run with it as the
    current device, so a step on cuda:1 (a mesh slot, parallel/) is never
    captured under cuda:0.

On the CPU (tests, --device cpu) nothing is captured, and the discipline is
the same: a call copies its tensors into the entry's inputs, runs the
function, writes its outputs into the entry's outputs and returns clones of
those. So a caller that held a result across calls without the clone, or an
output that aliases a reused buffer, fails on the CPU as on the card.

Spans (utils/runlog.py): step.replay (copy in, replay or run, clone out)
and step.capture (a new key's warm-up and capture), which also counts
step.captures.
"""

from __future__ import annotations

import time

import torch
from torch.utils import _pytree as pytree

from parasuite_tpu_torch.ops import cuda_extend, cuda_finalize, cuda_seed
from parasuite_tpu_torch.utils.runlog import count, span

# the launch counters of the kernel wrappers, by kernel name: (module,
# counter); the select kernel counts its two row sources apart
KERNELS = {"seed_select": (cuda_seed, "seeded_launches"),
           "select_candidates": (cuda_seed, "launches"),
           "extend_candidates": (cuda_extend, "launches"),
           "finalize_select": (cuda_finalize, "launches")}


def launch_counts() -> dict:
    """{kernel name: launches so far} of every wrapper in KERNELS."""
    return {name: getattr(*where) for name, where in KERNELS.items()}


def _add_launches(counts: dict) -> None:
    for name, n in counts.items():
        mod, counter = KERNELS[name]
        setattr(mod, counter, getattr(mod, counter) + n)


class _Entry:
    """One key: static inputs and outputs (flat, with the tree spec), and
    on CUDA the graph and the kernel launches it holds."""

    def __init__(self, inputs):
        self.inputs = inputs
        self.graph = None
        self.outputs = self.spec = None
        self.held: dict = {}
        self.capture_ms = 0.0


class CompiledStep:
    """fn, compiled once per key and replayed (see the module docstring).

    fn takes the step's tensors positionally and the names in `static` as
    keyword arguments; everything else it needs is bound by a partial.
    The steps of one engine share `pool` (torch.cuda.graph_pool_handle), so
    their keys reuse each other's scratch memory. That is safe because
    replays run on one stream and each replay's outputs are cloned before
    the stream runs anything else."""

    def __init__(self, fn, device, name: str, static=(), pool=None):
        self.fn = fn
        self.device = torch.device(device)
        self.name = name
        self.static = frozenset(static)
        self.pool = pool
        self.entries: dict = {}
        self._cfg = getattr(fn, "keywords", {}).get("cfg")

    def key(self, tensors, static: dict) -> tuple:
        return (self._cfg, tuple(sorted(static.items())),
                tuple((tuple(t.shape), t.dtype) for t in tensors))

    @property
    def capture_ms(self) -> float:
        return sum(e.capture_ms for e in self.entries.values())

    @property
    def graphs(self) -> int:
        return sum(e.graph is not None for e in self.entries.values())

    def __call__(self, *tensors: torch.Tensor, **static):
        unknown = set(static) - self.static
        if unknown:
            raise TypeError(f"{self.name}: {sorted(unknown)} are not static "
                            f"arguments of this step")
        key = self.key(tensors, static)
        entry = self.entries.get(key)
        if entry is None:
            entry = _Entry([torch.empty_like(t) for t in tensors])
            if self.device.type == "cuda":
                # the current device is the step's: the kernel wrappers
                # launch on the runtime's current device
                with span("step.capture"), torch.cuda.device(self.device):
                    count("step.captures")
                    out = self._capture(entry, key, tensors, static)
                self.entries[key] = entry
                return out
            self.entries[key] = entry
        with span("step.replay"):
            for dst, src in zip(entry.inputs, tensors):
                dst.copy_(src)
            if entry.graph is None:
                self._run_into(entry, static)
            else:
                with torch.cuda.device(self.device):
                    entry.graph.replay()
                _add_launches(entry.held)
            return pytree.tree_unflatten([x.clone() for x in entry.outputs],
                                         entry.spec)

    def _run_into(self, entry: _Entry, static: dict) -> None:
        """The CPU's replay: fn's outputs are written into the entry's own,
        as a graph writes into the outputs it captured."""
        leaves, spec = pytree.tree_flatten(self.fn(*entry.inputs, **static))
        if entry.outputs is None:
            entry.outputs, entry.spec = [x.clone() for x in leaves], spec
            return
        for dst, src in zip(entry.outputs, leaves):
            dst.copy_(src)

    def _capture(self, entry: _Entry, key, tensors, static):
        """Warm up on a side stream (the call's result), then capture."""
        cur = torch.cuda.current_stream(self.device)
        for dst, src in zip(entry.inputs, tensors):
            dst.copy_(src)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self.fn(*entry.inputs, **static)
        cur.wait_stream(side)
        for x in pytree.tree_leaves(out):
            if isinstance(x, torch.Tensor):
                x.record_stream(cur)
        torch.cuda.synchronize(self.device)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            # the stream context restores the caller's stream whatever the
            # capture raises
            with torch.cuda.stream(side):
                graph.capture_begin(pool=self.pool,
                                    capture_error_mode="thread_local")
                try:
                    captured = self.fn(*entry.inputs, **static)
                finally:
                    graph.capture_end()
        except Exception as err:
            raise RuntimeError(f"CUDA graph capture of step {self.name!r} "
                               f"failed on {self.device} at key {key}: "
                               f"{err}") from err
        finally:
            # the capture launched nothing: its wrapper counts are the
            # graph's, added back on every replay
            after = launch_counts()
            entry.held = {k: v - before[k] for k, v in after.items()}
            _add_launches({k: -n for k, n in entry.held.items()})
        entry.capture_ms = 1e3 * (time.perf_counter() - t0)
        entry.outputs, entry.spec = pytree.tree_flatten(captured)
        entry.graph = graph
        return out
