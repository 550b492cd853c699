"""Tracing and profiling.

PyTorch counterpart of ``knode_cosserat_tpu/utils/profiling.py``:

- ``trace(logdir)``: a ``torch.profiler`` session (CPU activity, and CUDA
  activity when a card is present) that writes a Chrome trace into
  ``logdir`` (open it in Perfetto or chrome://tracing).
- ``annotate(name)``: a named region in that timeline
  (``torch.profiler.record_function``).
- ``Timer`` / ``timed``: host-side phase timers; ``Timer.phase(sync=t)``
  synchronises the CUDA device of tensor ``t`` before it reads the clock,
  so device work is measured, not only its launch.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch

__all__ = ["trace", "annotate", "Timer", "timed"]


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the body; the Chrome trace lands in ``logdir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """Named region in the profiler timeline."""
    return torch.profiler.record_function(name)


class Timer:
    """Accumulating phase timer: Timer.phase('train') as context manager."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync: Optional[torch.Tensor] = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None and sync.device.type == "cuda":
                torch.cuda.synchronize(sync.device)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, tot in sorted(self.totals.items()):
            n = self.counts[name]
            lines.append(f"{name:24s} total {tot:9.3f}s  n={n:5d}  "
                         f"avg {tot / n * 1e3:9.3f}ms")
        return "\n".join(lines)


@contextlib.contextmanager
def timed(name: str, log=print):
    t0 = time.perf_counter()
    yield
    log(f"{name}: {time.perf_counter() - t0:.3f}s")
