"""Tracing and profiling.

PyTorch counterpart of ``knode_cosserat_tpu/utils/profiling.py``:

- ``trace(logdir)``: a ``torch.profiler`` session (CPU activity, and CUDA
  activity when a card is present) that writes a Chrome trace into
  ``logdir`` (open it in Perfetto or chrome://tracing).
- ``annotate(name)``: a named span of the hot paths. With no profiler
  running it is a shared null context: one check, no torch operation,
  nothing recorded. While a ``torch.profiler`` profile runs it enters a
  record function of the user scope, as ``torch.profiler.record_function``
  does (a ``user_annotation`` event in the profiler's timeline, on the
  device events' clock), through its binding rather than the dispatcher
  (a fifth of the cost), and appends the span to the program's record:
  its name, its start and end (``perf_counter_ns``), the index of its
  parent span and the call it belongs to (``new_call``).
- ``count(name, value)``: a counter, kept only while a profiler runs; a
  tensor value is kept as it is (no device operation, no synchronisation)
  and summed when the record is read.
- ``enabled()``: whether a profiler runs (what ``annotate`` and ``count``
  check), for a hot path that makes something only for a counter.
- ``drain()``: the record (spans, counters, entries dropped past
  ``LIMIT``), which it clears.

The record is module state for the thread that runs the hot paths.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import List, NamedTuple

import torch

__all__ = ["trace", "annotate", "count", "enabled", "new_call", "drain",
           "Span", "Record", "LIMIT"]

LIMIT = 65536           # spans, and counter entries, the record keeps

_NULL = contextlib.nullcontext()
_on = torch.autograd._profiler_enabled
# record_function's own enter and exit, without its two dispatcher calls
_enter = torch._C._autograd._record_function_with_args_enter
_exit = torch._C._autograd._record_function_with_args_exit


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int          # index of the enclosing span in the record, or -1
    call: int            # the new_call() it belongs to (0: none yet)


class Record(NamedTuple):
    spans: List[Span]
    counts: List[tuple]  # (name, perf_counter_ns, value as a float)
    dropped: int


_spans: list = []        # [name, start, end or None, parent, call]
_counts: list = []       # [name, ns, value]
_open: list = []         # record indices of the open spans (-1: dropped)
_state = {"call": 0, "dropped": 0}


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


class _Span:
    __slots__ = ("name", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = _enter(self.name)
        if len(_spans) < LIMIT:
            parent = next((i for i in reversed(_open) if i >= 0), -1)
            _open.append(len(_spans))
            _spans.append([self.name, time.perf_counter_ns(), None, parent,
                           _state["call"]])
        else:
            _open.append(-1)
            _state["dropped"] += 1
        return self

    def __exit__(self, *exc):
        i = _open.pop() if _open else -1     # -1: dropped, or drained
        if 0 <= i < len(_spans):
            _spans[i][2] = time.perf_counter_ns()
        _exit(self.rf)


def annotate(name: str):
    """A named span: recorded only while a profiler runs (module doc)."""
    return _Span(name) if _on() else _NULL


def enabled() -> bool:
    """Whether a profiler runs (the one check of annotate and count)."""
    return _on()


def count(name: str, value):
    """Add ``value`` (a number or a tensor, summed at ``drain``) to the
    counter ``name``, only while a profiler runs."""
    if not _on():
        return
    if len(_counts) < LIMIT:
        _counts.append((name, time.perf_counter_ns(), value))
    else:
        _state["dropped"] += 1


def new_call():
    """Start a new call (a train_knode call, a rollout, a served step):
    the spans recorded from here on belong to it."""
    if _on():
        _state["call"] += 1


def drain() -> Record:
    """The record so far, which is then cleared; a span still open ends
    at the time of the read (and is recorded no further), a tensor
    counter is summed to a float."""
    now = time.perf_counter_ns()
    spans = [Span(n, a, now if b is None else b, p, c)
             for n, a, b, p, c in _spans]
    counts = [(n, t, float(v.sum()) if isinstance(v, torch.Tensor)
               else float(v)) for n, t, v in _counts]
    rec = Record(spans, counts, _state["dropped"])
    _spans.clear()
    _counts.clear()
    _open.clear()
    _state["dropped"] = 0
    return rec
