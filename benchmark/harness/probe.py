"""Timers of a traced run: the stage functions of streaming_align wrapped
from outside the program, as tools/torch_profile_e2e.py wraps them (its
Acc arithmetic is copied here: `seconds` inclusive, `self_seconds` without
the timers nested on the same thread).

Timer names:
  reader.next_batch                  FASTQ -> ReadBatch (reader thread)
  main.dispatch                      the engine's step: host packing,
                                     upload, graph replay (enqueue only)
  main.to_host                       fetch + host finishing, inclusive
  main.to_host.host_tracebacks_batch the batched gapped DP and walks
  main.to_host.slow_path             combined mode's re-finalization
  writer.emit                        emit_sam (native formatter and writes)

With `intervals` on, every timed call also leaves (thread, name, t0, t1)
on the host clock, for labelling the device's idle gaps.
"""

from __future__ import annotations

import threading
import time


class Acc:
    def __init__(self):
        self.seconds: dict = {}
        self.self_seconds: dict = {}
        self.calls: dict = {}
        self.intervals = None
        self._local = threading.local()

    def declare(self, name: str) -> None:
        self.seconds.setdefault(name, 0.0)
        self.self_seconds.setdefault(name, 0.0)
        self.calls.setdefault(name, 0)

    def add(self, name: str, dt: float, child: float = 0.0) -> None:
        self.seconds[name] += dt
        self.self_seconds[name] += dt - child
        self.calls[name] += 1

    def reset(self) -> None:
        for d in (self.seconds, self.self_seconds, self.calls):
            for k in d:
                d[k] = 0

    def wrap(self, name: str, fn):
        self.declare(name)

        def inner(*a, **kw):
            stack = self._local.__dict__.setdefault("stack", [])
            stack.append(0.0)
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                t1 = time.perf_counter()
                child = stack.pop()
                if stack:
                    stack[-1] += t1 - t0
                self.add(name, t1 - t0, child)
                if self.intervals is not None:
                    self.intervals.append((name.split(".")[0], name, t0, t1))

        return inner

    def report(self) -> dict:
        return {k: {"seconds": self.seconds[k],
                    "self_seconds": self.self_seconds[k],
                    "calls": self.calls[k]} for k in sorted(self.seconds)}


_ENGINE = {"to_host": "main.to_host", "_slow_path": "main.to_host.slow_path",
           "emit_sam": "writer.emit"}


class Probe:
    """Wraps one engine and the stream / align / combined modules with
    timers; `hook` (if given) is called around every dispatch with the
    dispatch's index and "before" / "after". restore() undoes it all."""

    def __init__(self, engine, hook=None):
        import parasuite_tpu_torch.pipeline.align as palign
        import parasuite_tpu_torch.pipeline.combined as pcombined
        import parasuite_tpu_torch.pipeline.stream as pstream

        self.acc = acc = Acc()
        self._undo: list = []
        self.n_dispatch = 0

        def patch(obj, attr, new):
            self._undo.append((obj, attr, getattr(obj, attr),
                               attr in vars(obj)))
            setattr(obj, attr, new)

        fq_iter = pstream.iter_fastq_batches
        acc.declare("reader.next_batch")

        def timed_iter(*a, **kw):
            it = fq_iter(*a, **kw)
            while True:
                t0 = time.perf_counter()
                try:
                    b = next(it)
                except StopIteration:
                    return
                t1 = time.perf_counter()
                acc.add("reader.next_batch", t1 - t0)
                if acc.intervals is not None:
                    acc.intervals.append(("reader", "reader.next_batch",
                                          t0, t1))
                yield b

        patch(pstream, "iter_fastq_batches", timed_iter)

        step_name = ("align_device_packed" if engine.supports_packed
                     else "align_device")
        step = acc.wrap("main.dispatch", getattr(engine, step_name))

        def hooked(*a, **kw):
            k = self.n_dispatch
            self.n_dispatch += 1
            if hook is not None:
                hook(k, "before")
            out = step(*a, **kw)
            if hook is not None:
                hook(k, "after")
            return out

        patch(engine, step_name, hooked)
        for attr, name in _ENGINE.items():
            if hasattr(engine, attr):
                patch(engine, attr, acc.wrap(name, getattr(engine, attr)))
        tb = acc.wrap("main.to_host.host_tracebacks_batch",
                      palign.host_tracebacks_batch)
        for mod in (palign, pcombined):
            patch(mod, "host_tracebacks_batch", tb)

    def restore(self) -> None:
        for obj, attr, old, had in reversed(self._undo):
            if had:
                setattr(obj, attr, old)
            else:
                delattr(obj, attr)
        self._undo.clear()
