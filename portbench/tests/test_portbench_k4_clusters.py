"""The reader of K4's clusters a run (portbench/layer_metrics/
k4_clusters_per_run.train.py): the counter ``k4.clusters`` over the first
slice's ``k4.launch`` spans on a synthetic record of two traced slices,
and silence where the program records no counter or keeps no record."""
from __future__ import annotations

import json

import pytest

from knode_cosserat_tpu_torch.utils import profiling as P
from portbench import harness
from portbench.tests import fixture as F

MS = 1_000_000          # ns
METRIC, CELL = "k4_clusters_per_run.train", "train-real.real-h512"


def _span(name, a, b, parent=-1, call=1):
    return P.Span(name, int(a * MS), int(b * MS), parent, call)


def _ctx(wall_s):
    bench = json.load(open(F.REPO / "BENCHMARK.json"))
    cell, cfg, traffic, _, counts = harness.cell_files(bench, CELL)
    run = type("Run", (), dict(cfg=cfg, traffic=traffic, counts=counts,
                               cell=cell))()
    return harness.LayerCtx(run, {}, None, {"wall_s": wall_s})


def _read(monkeypatch, record, wall_s=0.02):
    monkeypatch.setattr(P, "drain", lambda: record)
    return harness.reader_of(METRIC)(_ctx(wall_s))


SPANS = [
    _span("train.chunk", 0, 10), _span("k4.launch", 3, 8, 0),
    _span("train.chunk", 10, 16), _span("k4.launch", 11, 14, 2),
    _span("train.chunk", 100, 200, call=2),
    _span("k4.launch", 110, 190, 4, call=2)]


# two launches in the first slice (the second slice starts at 100 ms, past
# its 20 ms, and its launch on 1 cluster is left out)
@pytest.mark.parametrize("clusters, want", [
    ((8.0, 8.0), 8.0), ((15.0, 15.0), 15.0), ((1.0, 1.0), 1.0),
    ((16.0, 2.0), 9.0)])
def test_the_clusters_a_run_on_a_synthetic_record(monkeypatch, clusters,
                                                  want):
    counts = [("k4.clusters", 4 * MS, clusters[0]),
              ("k4.clusters", 12 * MS, clusters[1]),
              ("k4.clusters", 150 * MS, 1.0)]
    got = _read(monkeypatch, P.Record(SPANS, counts, 0))
    assert got == pytest.approx(want)


@pytest.mark.parametrize("record", [
    P.Record([], [], 0),
    # a program whose launches count no clusters (the commit before it)
    P.Record(SPANS, [("k2.newton_iters", 1 * MS, 4.0)], 0)])
def test_the_reader_is_silent_without_the_counter(monkeypatch, record):
    assert _read(monkeypatch, record) is None


def test_the_reader_is_silent_without_a_record(monkeypatch):
    monkeypatch.delattr(P, "drain")
    assert harness.reader_of(METRIC)(_ctx(0.02)) is None
