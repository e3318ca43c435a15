"""The device side of a traced run, from torch.profiler's CUDA activity
over a short sub-window of batches: each kernel's time by name, the union
of kernel and memory-copy intervals (the device's busy time), and the idle
gaps between them labelled with the host stage each thread was in.

Host and device clocks are tied by the step's graph launches: the k-th
cudaGraphLaunch of the trace is the k-th dispatch the timers saw, and the
median difference of their end times maps the host clock onto the trace's.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import sys
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SELECT = re.compile(r"\bselect(_wide)?_kernel\b")
EXTEND = re.compile(r"\bextend_kernel\b")


def short(name: str) -> str:
    """A kernel's name without its argument list."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name.strip()[:160]


class DeviceTrace:
    """torch.profiler over the dispatches [first, stop): call `at` from the
    dispatch hook; it starts before dispatch `first` and, after dispatch
    stop - 1, waits for the device and stops."""

    def __init__(self, first: int, stop: int):
        self.first, self.stop = first, stop
        self.prof = None
        self.t0 = self.t1 = None
        self.dispatch_end: list = []
        self.events: list = []

    def at(self, k: int, when: str) -> None:
        import torch

        if when == "before" and k == self.first:
            import warnings

            from torch.profiler import ProfilerActivity, profile

            warnings.filterwarnings("ignore", message=".*clears events")
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            self.t0 = time.perf_counter()
        if when == "after" and self.first <= k < self.stop:
            self.dispatch_end.append(time.perf_counter())
            if k == self.stop - 1:
                torch.cuda.synchronize()
                self.t1 = time.perf_counter()
                self.prof.stop()
                fd, path = tempfile.mkstemp(suffix=".json")
                os.close(fd)
                try:
                    self.prof.export_chrome_trace(path)
                    with open(path) as fh:
                        self.events = json.load(fh)["traceEvents"]
                finally:
                    os.unlink(path)
                self.prof = None

    def reduce(self, intervals: list) -> dict | None:
        """-> kernels {short name: [seconds]}, busy_s, window_s,
        device_ops, idle_gaps; None (and why, on standard error) if
        nothing was traced or the clocks cannot be tied."""
        if self.t1 is None:
            return None
        dev = [e for e in self.events
               if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        launches = sorted(e["ts"] + e["dur"] for e in self.events
                          if e.get("ph") == "X"
                          and e.get("cat") == "cuda_runtime"
                          and e.get("name", "").startswith("cudaGraphLaunch"))
        if not dev or len(launches) != len(self.dispatch_end):
            print(f"device trace not reduced: {len(launches)} graph "
                  f"launches traced for {len(self.dispatch_end)} "
                  f"dispatches, {len(dev)} device events", file=sys.stderr)
            return None
        off = statistics.median(t - 1e6 * h for t, h in
                                zip(launches, self.dispatch_end))
        lo, hi = 1e6 * self.t0 + off, 1e6 * self.t1 + off
        spans = sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
                       for e in dev)
        union, busy = [], 0.0
        for a, b in spans:
            if b <= a:
                continue
            if union and a <= union[-1][1]:
                union[-1][1] = max(union[-1][1], b)
            else:
                union.append([a, b])
        busy = sum(b - a for a, b in union)
        edges = [lo] + [x for ab in union for x in ab] + [hi]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                       for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:10]
        kernels: dict = {}
        totals: dict = {}
        for e in dev:
            if e["ts"] < lo or e["ts"] + e["dur"] > hi:
                continue
            nm = short(e["name"])
            totals[nm] = totals.get(nm, 0.0) + e["dur"] / 1e6
            if e["cat"] == "kernel":
                kernels.setdefault(nm, []).append(e["dur"] / 1e6)
        top = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
        return {"kernels": kernels, "busy_s": busy / 1e6,
                "window_s": self.t1 - self.t0,
                "device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[label(intervals, (a + d / 2 - off) / 1e6),
                               d / 1e6] for d, a in gaps]}


def label(intervals: list, t: float) -> str:
    """What each host thread was doing at host time t: its innermost timed
    stage."""
    inner: dict = {}
    for thread, name, a, b in intervals:
        if a <= t <= b and (thread not in inner
                            or b - a < inner[thread][1]):
            inner[thread] = (name, b - a)
    return "; ".join(f"{th}: {nm}" for th, (nm, _) in sorted(inner.items())
                     ) or "no timed host stage"


def kernel_seconds(kernels: dict, pattern) -> list:
    return [d for nm, ds in kernels.items() if pattern.search(nm) for d in ds]
