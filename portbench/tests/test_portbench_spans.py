"""The readers of the program's spans and counters (portbench/spans.py and
the per-layer metrics that use it): their arithmetic on a synthetic
record of two traced slices, a program without the record, the partition
of a K4 chunk on a real CPU run, and fixture cells run with --trace 1."""
from __future__ import annotations

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from knode_cosserat_tpu_torch.utils import profiling as P
from portbench import harness, spans
from portbench.tests import fixture as F

MS = 1_000_000          # ns


def _span(name, a, b, parent=-1, call=1):
    return P.Span(name, int(a * MS), int(b * MS), parent, call)


def _ctx(wall_s, workload):
    bench = json.load(open(F.REPO / "BENCHMARK.json"))
    cell, cfg, traffic, _, counts = harness.cell_files(bench, workload)
    run = type("Run", (), dict(cfg=cfg, traffic=traffic, counts=counts,
                               cell=cell))()
    return harness.LayerCtx(run, {}, None, {"wall_s": wall_s})


def _read(monkeypatch, record, metric, workload, wall_s=0.02):
    monkeypatch.setattr(P, "drain", lambda: record)
    return harness.reader_of(metric)(_ctx(wall_s, workload))


# two chunks in the first slice (the second slice starts at 100 ms, past
# its 20 ms): chunk 0 of 10 ms (cells 2, launch 5 with the plain path's
# own wait inside it, waits 1 + 0.5), chunk 1 of 6 ms (cells 1, launch 3,
# wait 1)
TRAIN = P.Record([
    _span("train.chunk", 0, 10), _span("k4.cells", 0.5, 2.5, 0),
    _span("k4.launch", 3, 8, 0), _span("train.wait", 3.5, 4, 2),
    _span("train.wait", 8, 9, 0), _span("train.wait", 9.2, 9.7, 0),
    _span("train.chunk", 10, 16), _span("k4.cells", 10, 11, 6),
    _span("k4.launch", 11, 14, 6), _span("train.wait", 14, 15, 6),
    _span("train.chunk", 100, 200, call=2),
    _span("k4.cells", 100, 190, 10, call=2)], [], 0)
ROLL = P.Record([
    _span("rollout.step", 0, 1), _span("k2.launch", 0.2, 0.9, 0),
    _span("rollout.step", 1, 3), _span("k2.launch", 1.5, 2.5, 2),
    _span("rollout.step", 100, 150, call=2),
    _span("k2.launch", 101, 102, 4, call=2)],
    [("k2.newton_iters", 1 * MS, 512.0), ("k2.rod_steps", 1 * MS, 256.0),
     ("k2.newton_iters", 2 * MS, 520.0), ("k2.rod_steps", 2 * MS, 256.0),
     ("k2.newton_iters", 101 * MS, 9999.0), ("k2.rod_steps", 101 * MS, 1.0)],
    0)
SERVE = P.Record([
    _span("serve.step", 0, 1), _span("k2.launch", 0.3, 0.8, 0),
    _span("serve.step", 2, 3, call=2), _span("k2.launch", 2.1, 2.9, 2, 2),
    _span("serve.step", 200, 300, call=3),
    _span("k2.launch", 250, 260, 4, 3)],
    [("k2.newton_iters", 1 * MS, 2.0), ("k2.rod_steps", 1 * MS, 1.0),
     ("k2.newton_iters", 3 * MS, 3.0), ("k2.rod_steps", 3 * MS, 1.0)], 0)
TRAIN_CELL, ROLL_CELL, SERVE_CELL = ("train-real.real-h512",
                                     "rollout-r256.sim-nsw-h512",
                                     "serve-b1.sim-nsw-h512")


@pytest.mark.parametrize("metric, record, cell, want", [
    ("cells_ms_per_chunk.train", TRAIN, TRAIN_CELL, (2 + 1) / 2),
    ("wait_ms_per_chunk.train", TRAIN, TRAIN_CELL, (1.5 + 1) / 2),
    ("carry_ms_per_chunk.train", TRAIN, TRAIN_CELL,
     ((10 - 2 - 5 - 1.5) + (6 - 1 - 3 - 1)) / 2),
    ("glue_ms_per_step.rollout", ROLL, ROLL_CELL, (0.3 + 1.0) / 2),
    ("k2_iters_per_rod_step.rollout", ROLL, ROLL_CELL, 1032 / 512),
    ("prep_ms_per_step.serve", SERVE, SERVE_CELL, (0.3 + 0.1) / 2),
    ("k2_launch_ms.serve", SERVE, SERVE_CELL, (0.5 + 0.8) / 2),
    ("k2_iters_per_rod_step.serve", SERVE, SERVE_CELL, 2.5),
])
def test_readers_on_a_synthetic_record(monkeypatch, metric, record, cell,
                                       want):
    assert _read(monkeypatch, record, metric, cell) == pytest.approx(want)


def test_the_chunk_is_partitioned_on_a_synthetic_record(monkeypatch):
    ctx = _ctx(0.02, TRAIN_CELL)
    monkeypatch.setattr(P, "drain", lambda: TRAIN)
    parts = [harness.reader_of(m)(ctx) for m in (
        "cells_ms_per_chunk.train", "wait_ms_per_chunk.train",
        "carry_ms_per_chunk.train")]
    launch = spans.per_parent_ms(ctx, "train.chunk", ("k4.launch",))
    assert sum(parts) + launch == pytest.approx((10 + 6) / 2)


@pytest.mark.parametrize("metric", [
    "cells_ms_per_chunk.train", "wait_ms_per_chunk.train",
    "carry_ms_per_chunk.train", "glue_ms_per_step.rollout",
    "prep_ms_per_step.serve", "k2_launch_ms.serve",
    "k2_iters_per_rod_step.rollout", "k2_iters_per_rod_step.serve"])
def test_readers_are_silent_where_nothing_was_recorded(monkeypatch, metric):
    cell = {"train": TRAIN_CELL, "rollout": ROLL_CELL,
            "serve": SERVE_CELL}[metric.split(".")[1]]
    assert _read(monkeypatch, P.Record([], [], 0), metric, cell) is None
    # a program that keeps no record (the commit before it had one)
    monkeypatch.delattr(P, "drain")
    assert harness.reader_of(metric)(_ctx(0.02, cell)) is None


def test_the_record_is_drained_once_a_run():
    calls = []
    P_drain = P.drain

    def drain():
        calls.append(1)
        return P_drain()

    P.drain = drain
    try:
        ctx = _ctx(0.02, SERVE_CELL)
        for m in ("prep_ms_per_step.serve", "k2_launch_ms.serve",
                  "k2_iters_per_rod_step.serve"):
            harness.reader_of(m)(ctx)
        assert len(calls) == 1
        harness.reader_of("k2_launch_ms.serve")(_ctx(0.02, SERVE_CELL))
        assert len(calls) == 2
    finally:
        P.drain = P_drain


def test_a_cpu_training_run_is_partitioned():
    """cells + wait + carry + K4's launch = the chunk, on a real CPU run
    of train_knode (K4's wrapper runs its plain version)."""
    from knode_cosserat_tpu_torch.core.params import experimental_rod
    from knode_cosserat_tpu_torch.training.train import (TrainConfig,
                                                         train_knode)
    torch.set_num_threads(1)
    g = torch.Generator().manual_seed(3)
    trajs = torch.zeros(2, 5, 6, 25)
    trajs[..., 3] = 1.0
    trajs = trajs + 0.01 * torch.randn(trajs.shape, generator=g)
    ctls = 1.0 + torch.rand(2, 5, 4, generator=g)
    rod = experimental_rod(N=6, dtype=torch.float32, device="cpu")
    cfg = TrainConfig(epochs=7, hidden=16, fused="on", log_every=2,
                      keypoints=(1, 3, 5))
    P.drain()
    with profile(activities=[ProfilerActivity.CPU]):
        train_knode(rod, trajs, ctls, cfg, log=None)
    ctx = _ctx(60.0, TRAIN_CELL)
    parts = [harness.reader_of(m)(ctx) for m in (
        "cells_ms_per_chunk.train", "wait_ms_per_chunk.train",
        "carry_ms_per_chunk.train")]
    assert all(v > 0 for v in parts)
    launch = spans.per_parent_ms(ctx, "train.chunk", ("k4.launch",))
    ss = spans.first_slice(ctx)[0]
    chunks = [spans.length_ms(ss[i]) for i in spans.named(ss, "train.chunk")]
    assert len(chunks) == 4
    assert sum(parts) + launch == pytest.approx(sum(chunks) / 4, rel=1e-9)


NEW = {"tiny-train.tiny-real": ["cells_ms_per_chunk.train",
                                "wait_ms_per_chunk.train",
                                "carry_ms_per_chunk.train"],
       "tiny-rollout.tiny-sim": ["glue_ms_per_step.rollout",
                                 "k2_iters_per_rod_step.rollout"],
       "tiny-serve.tiny-sim": ["prep_ms_per_step.serve",
                               "k2_launch_ms.serve",
                               "k2_iters_per_rod_step.serve"]}
# on a CPU rod the trainer's "auto" is the plain epoch loop and the
# stepper's fast path the plain FD-Newton loop; the fixture runs them
# through K4's and K2's wrappers (their plain versions), as the card does
PATCH = {"train": """
from knode_cosserat_tpu_torch.training import train as T
T._resolve_fused = lambda *a, **k: "kernel"
""", "rollout": "", "serve": """
from knode_cosserat_tpu_torch import serving as S
_init = S.CompiledStepper.__init__
S.CompiledStepper.__init__ = lambda self, *a, **k: _init(
    self, *a, **dict(k, fast_impl="mega"))
"""}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    tmp = F.build(tmp_path_factory.mktemp("spans"))
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        for cell, names in NEW.items():
            if m["name"] in names:
                m["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.mark.parametrize("cell", sorted(NEW))
def test_a_traced_fixture_run_reports_the_span_metrics(tree, cell):
    rc, res, err = F.run_cell(tree, cell, trace=1,
                              patch=PATCH[cell.split("-")[1].split(".")[0]])
    assert rc == 0, err[-3000:]
    assert res["correct"] is True
    got = res["metrics"]
    assert set(NEW[cell]) <= set(got)
    for name in NEW[cell]:
        v = got[name]["value"]
        assert v > 0 and got[name]["unit"] == ("iters" if "iters" in name
                                               else "ms")
        if "iters" in name:
            assert 1.0 <= v <= 50.0
