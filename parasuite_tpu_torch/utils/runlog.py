"""Structured per-stage stats -> JSONL (SURVEY.md §5 metrics/observability).

The reference prints progress to stderr; here every pipeline stage appends a
JSON line (reads in/aligned/unaligned, conversion counts, reads/s, scaling
numbers) so the BASELINE config-5 scaling report is a jq query away.

A run log made with record=True also keeps spans and counters in memory,
one set a batch:

  * span(name): the time a thread spends in one stage of one batch, from
    time.perf_counter_ns(), with the thread's role, the batch index and
    the span it sits in (the innermost open span on the same thread). A
    span inherits its parent's batch index, so only the spans that open a
    batch's work on each thread (pipeline/stream.py) name it, and the
    engine's spans need no parameter for it. Across threads the batch
    index is the link;
  * count(name, n): adds n to the current batch's counter `name` (the
    batch of the innermost open span).

Both act on the log bound to the calling thread (bind); on a thread with
none, span() returns one shared null context and count() returns at once,
so a run that does not record allocates and times nothing for them. While
a torch.profiler session is active, each span also opens a
torch.profiler.record_function range of its name: on the profiled thread
the spans then sit in the profiler's own trace, on the same clock as the
device's activity.

`calls` counts the streaming calls that recorded into the log (a span's
`call`), since every call numbers its batches from 1. write_spans() puts
each span and each batch's counters into the JSONL as events.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from collections import namedtuple

# one closed span: its role's thread, streaming call and batch index, start
# and end in perf_counter_ns, and the id of its parent span (None at a root)
Span = namedtuple("Span", "sid name thread call batch t0 t1 parent")

_local = threading.local()      # .log (the recording RunLog), .thread, .stack


class _NullSpan:
    """What span() gives on a thread that records nothing: one shared
    object that times nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def drop(self) -> None:
        pass


NULL_SPAN = _NullSpan()


class _OpenSpan:
    __slots__ = ("log", "name", "batch", "sid", "parent", "t0", "range",
                 "dropped")

    def __init__(self, log, name: str, batch):
        self.log, self.name, self.batch = log, name, batch
        self.range = None
        self.dropped = False

    def __enter__(self):
        stack = _local.stack
        parent = stack[-1] if stack else None
        self.parent = parent.sid if parent is not None else None
        if self.batch is None and parent is not None:
            self.batch = parent.batch
        self.sid = next(self.log._ids)
        stack.append(self)
        if self.log._profiling():
            self.range = self.log._range(self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _local.stack.pop()
        if not self.dropped:
            self.log.spans.append(Span(self.sid, self.name, _local.thread,
                                       self.log.calls, self.batch, self.t0,
                                       t1, self.parent))
        return False

    def drop(self) -> None:
        """Keep no record of this span (a wait that ended the stream)."""
        self.dropped = True


def span(name: str, batch: int | None = None):
    """A span of the current thread's stage `name` (module docstring);
    `batch` names the batch index where no open span gives it."""
    log = getattr(_local, "log", None)
    if log is None:
        return NULL_SPAN
    return _OpenSpan(log, name, batch)


def count(name: str, n: int = 1) -> None:
    """Add n to the current batch's counter `name` (module docstring)."""
    log = getattr(_local, "log", None)
    if log is None:
        return
    stack = _local.stack
    key = (log.calls, stack[-1].batch if stack else None, name)
    log.counters[key] = log.counters.get(key, 0) + n


class _Bound:
    def __init__(self, log, thread: str):
        self.log, self.thread = log, thread

    def __enter__(self):
        self.saved = (getattr(_local, "log", None),
                      getattr(_local, "thread", None),
                      getattr(_local, "stack", None))
        _local.log, _local.thread, _local.stack = self.log, self.thread, []
        return self

    def __exit__(self, *exc) -> bool:
        _local.log, _local.thread, _local.stack = self.saved
        return False


def bind(log, thread: str):
    """Context: the calling thread's spans and counts go to `log` under the
    role `thread` ("reader", "main", "writer"). A log that does not record
    (or any other object with an event method) binds nothing."""
    if not getattr(log, "recording", False):
        return NULL_SPAN
    return _Bound(log, thread)


class RunLog:
    """Append-only JSONL event log; with record=True also the in-memory
    spans and counters of the streaming calls it is passed to."""

    def __init__(self, path=None, run_id: str = "", record: bool = False):
        self._fh = open(path, "a") if path else None
        self.run_id = run_id
        self._t0 = time.time()
        self.recording = record
        self.spans: list = []
        self.counters: dict = {}         # (call, batch, name) -> total
        self.calls = 0
        self._ids = itertools.count()
        if record:
            import torch

            self._profiling = torch.autograd._profiler_enabled
            self._range = torch.profiler.record_function

    @property
    def live(self) -> bool:
        """Whether an event goes anywhere (a file)."""
        return self._fh is not None

    def event(self, stage: str, **fields) -> dict:
        rec = {"ts": round(time.time() - self._t0, 3), "stage": stage,
               **({"run": self.run_id} if self.run_id else {}), **fields}
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        return rec

    def begin_call(self) -> None:
        """A streaming call starts: its spans and counters carry the next
        call number."""
        self.calls += 1

    def summary(self) -> dict:
        """{"spans": {name: {"seconds" (inclusive), "self_seconds" (without
        the spans directly inside it), "calls"}}, "counters": {name:
        total}} over everything recorded."""
        child: dict = {}
        for s in self.spans:
            if s.parent is not None:
                child[s.parent] = child.get(s.parent, 0) + s.t1 - s.t0
        out: dict = {}
        for s in self.spans:
            t = out.setdefault(s.name, {"seconds": 0.0, "self_seconds": 0.0,
                                        "calls": 0})
            t["seconds"] += (s.t1 - s.t0) / 1e9
            t["self_seconds"] += (s.t1 - s.t0 - child.get(s.sid, 0)) / 1e9
            t["calls"] += 1
        totals: dict = {}
        for (_c, _b, name), n in self.counters.items():
            totals[name] = totals.get(name, 0) + n
        return {"spans": out, "counters": totals}

    def write_spans(self) -> None:
        """Each recorded span as one `span` event, then each batch's
        counters as one `counters` event."""
        for s in self.spans:
            self.event("span", name=s.name, thread=s.thread, call=s.call,
                       batch=s.batch, t0_ns=s.t0, t1_ns=s.t1, id=s.sid,
                       parent=s.parent)
        by_batch: dict = {}
        for (c, b, name), n in self.counters.items():
            by_batch.setdefault((c, b), {})[name] = n
        for (c, b), fields in by_batch.items():
            self.event("counters", call=c, batch=b, **fields)

    def close(self) -> None:
        if self._fh:
            self._fh.close()


NULL_LOG = RunLog()
