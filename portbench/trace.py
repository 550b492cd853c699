"""The device trace of a traced slice: torch.profiler over a few more
units of the cell's traffic after the measured window, exported as a
Chrome trace (into the run's TMPDIR, removed after reading) and reduced
to device operations, the union of their intervals, and the host activity
under each idle gap.

Two slices: one with the device's activity alone, whose window is the
host clock's and which the metrics read (recording every host operation
as well slows the host by half in the training cell, which would inflate
the idle share), and one with the host's operations too, read only for
the breakdown of the idle gaps by what the host was doing."""
from __future__ import annotations

import json
import math
import os
import tempfile
from collections import defaultdict

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profile(fn, cuda: bool, host: bool = True):
    """Run fn() under the profiler inside a ``portbench.window`` span and
    return the trace's events; ``host``: record the host's operations too
    (without a card they are all there is)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    from torch.profiler import record_function

    acts = ([ProfilerActivity.CPU] if host or not cuda else []) + (
        [ProfilerActivity.CUDA] if cuda else [])
    with prof_ctx(activities=acts) as prof:
        with record_function(WINDOW):
            fn()
            if cuda:
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    return events.get("traceEvents", []) if isinstance(events, dict) \
        else events


def union_length(intervals) -> float:
    """Total length covered by a set of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def short_name(name: str) -> str:
    """A kernel's name without its return type, template and arguments."""
    name = name.split("(")[0]
    name = name.split("<")[0]
    return name.replace("void ", "").strip()[:80] or "?"


class Trace:
    """Times in seconds; the window is the ``portbench.window`` span, or
    ``window_s`` as the host clock measured it."""

    def __init__(self, events, window_s=None):
        if window_s is not None:
            self.t0, self.t1, self.window_s = -math.inf, math.inf, window_s
        else:
            spans = [e for e in events if e.get("name") == WINDOW
                     and e.get("cat", "").lower() == "user_annotation"]
            if not spans:
                raise RuntimeError("the trace holds no portbench.window span")
            self.t0 = float(spans[0]["ts"])
            self.t1 = self.t0 + float(spans[0]["dur"])
            self.window_s = (self.t1 - self.t0) * 1e-6
        self.ops = []           # (name, start us, end us) on the device
        self.host = []          # (name, start us, end us) host ops
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat", "").lower()
            a = float(e["ts"])
            b = a + float(e["dur"])
            if cat in DEVICE_CATS:
                a, b = max(a, self.t0), min(b, self.t1)
                if b > a:
                    self.ops.append((e.get("name", "?"), a, b))
            elif cat in ("cpu_op", "user_annotation", "cuda_runtime") \
                    and e.get("name") != WINDOW:
                self.host.append((e.get("name", "?"), a, b))
        self.busy_s = union_length((a, b) for _, a, b in self.ops) * 1e-6

    def kernel_times(self, part: str):
        """Durations (s) of the device operations whose name holds
        ``part``."""
        return [(b - a) * 1e-6 for n, a, b in self.ops if part in n]

    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def device_ops(self, top: int = 10):
        by = defaultdict(float)
        for n, a, b in self.ops:
            by[short_name(n)] += (b - a) * 1e-6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10):
        """The device's idle time in the window, by the innermost host
        operation running at the middle of each gap."""
        ivs = sorted((a, b) for _, a, b in self.ops)
        gaps, cur = [], self.t0
        for a, b in ivs:
            if a > cur:
                gaps.append((cur, a))
            cur = max(cur, b)
        if self.t1 > cur:
            gaps.append((cur, self.t1))
        host = sorted(self.host, key=lambda h: h[1])
        by, active, i = defaultdict(float), [], 0
        for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = 0.5 * (a + b)
            while i < len(host) and host[i][1] <= mid:
                active.append(host[i])
                i += 1
            active = [h for h in active if h[2] >= mid]
            inner = min(active, key=lambda h: h[2] - h[1], default=None)
            by[inner[0] if inner else "(host Python between ops)"] += (b - a) * 1e-6
        return sorted(([k[:80], v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:top]
