"""The program's own record of its spans and counters
(``knode_cosserat_tpu_torch/utils/profiling.py``) over the traced slice
the metrics read: the first, the device-only one, whose host runs
nearest the window's speed. The record is read once per run (the first
reader drains it, the rest share what it read) and cut to the spans and
counts that start within the slice's host-clock seconds of its first
span; the second slice, profiled with the host's operations, starts only
after the first's trace has been exported. A program without the record,
or a slice in which it recorded nothing, reads None."""
from __future__ import annotations

_last = {"traced": None, "record": None}


def first_slice(ctx):
    """(spans, counts) of the first traced slice, or None."""
    if _last["traced"] is not ctx.traced:
        try:
            from knode_cosserat_tpu_torch.utils.profiling import drain
        except ImportError:
            rec = None
        else:
            rec = cut(drain(), ctx.traced.get("wall_s"))
        _last.update(traced=ctx.traced, record=rec)
    return _last["record"]


def cut(rec, wall_s):
    """The record's spans and counts from its first span's start to wall_s
    seconds after it. Spans are recorded in order of their start, so the
    spans kept are a prefix and their parents' indices hold."""
    if rec is None or not rec.spans or not wall_s:
        return None
    t0 = rec.spans[0].start_ns
    t1 = t0 + wall_s * 1e9
    spans = [s for s in rec.spans if s.start_ns < t1]
    counts = [(n, t, v) for n, t, v in rec.counts if t0 <= t < t1]
    return spans, counts


def named(spans, name):
    """Indices of the spans called ``name``."""
    return [i for i, s in enumerate(spans) if s.name == name]


def length_ms(s) -> float:
    return (s.end_ns - s.start_ns) * 1e-6


def children(spans, names):
    """{index of a span: the spans directly inside it whose name is in
    ``names``}."""
    out = {}
    for s in spans:
        if s.name in names:
            out.setdefault(s.parent, []).append(s)
    return out


def per_parent_ms(ctx, parent, inner, exclusive=False):
    """Over the slice's ``parent`` spans, in ms a parent: the time of their
    direct children named in ``inner`` or, with ``exclusive``, the parents'
    own time less those children's. None where no parent was recorded."""
    rec = first_slice(ctx)
    if rec is None:
        return None
    spans = rec[0]
    tops = named(spans, parent)
    if not tops:
        return None
    kids = children(spans, inner)
    inside = sum(length_ms(c) for i in tops for c in kids.get(i, ()))
    if exclusive:
        return (sum(length_ms(spans[i]) for i in tops) - inside) / len(tops)
    return inside / len(tops)


def counter(ctx, name):
    """The sum of counter ``name`` over the slice, or None."""
    rec = first_slice(ctx)
    vals = [v for n, _, v in rec[1] if n == name] if rec else []
    return sum(vals) if vals else None
