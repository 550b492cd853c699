"""The harness: cells found by name from files alone, the result line, the
refusals (no card, no program, JAX loaded), BENCHMARK.json's contract,
and the arithmetic of the metrics on synthetic inputs."""
from __future__ import annotations

import ast
import json
import re
import shutil
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import compare, harness
from portbench.counts import k2, k4, peaks
from portbench.reference.rod import to_tf32
from portbench.tests import fixture as F
from portbench.trace import Trace, union_length

REPO = F.REPO
BENCH = json.load(open(REPO / "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return F.build(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", sorted(F.CELLS))
def test_a_fixture_cell_runs_from_files_alone(tree, cell):
    rc, res, err = F.run_cell(tree, cell)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True
    assert set(res["metrics"]) == {F.CELLS[cell], "setup_s"}
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checked"
    last = err.strip().splitlines()[-len(res["checked"]):]
    assert all(line.startswith("check ") for line in last)


@pytest.mark.parametrize("cell", sorted(F.CELLS))
def test_a_traced_run_reports_its_layer_metrics(tree, cell):
    rc, res, err = F.run_cell(tree, cell, trace=1)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True
    # on the CPU no device operation is traced: only the readers that need
    # none give a number
    want = {m for m in F.LAYERS[cell] if "mfu" in m}
    assert set(res["metrics"]) == want
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_card_exits_nonzero_without_a_result(capsys):
    rc = harness.main(["--workload", "serve-b1.sim-nsw-h512", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_the_benchmark_alone_has_no_program(tmp_path):
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    rc, out, _ = F.run_py(tmp_path, "sys.exit(harness.main(['--workload', "
                          "'serve-b1.sim-nsw-h512', '--seed', '1', "
                          "'--seconds', '1'], require=cpu))")
    assert rc != 0 and out.strip() == ""


def test_a_run_that_loaded_jax_prints_no_result(tree):
    patch = "import types; sys.modules['jax'] = types.ModuleType('jax')"
    rc, res, err = F.run_cell(tree, "tiny-serve.tiny-sim", patch=patch)
    assert rc != 0 and res is None
    assert "jax" in err


def _imports(path: Path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(
    p.relative_to(REPO).as_posix() for p in (REPO / "portbench").rglob("*.py")
    if "tests" not in p.parts))
def test_nothing_the_benchmark_runs_imports_jax(path):
    names = _imports(REPO / path)
    assert not names & set(harness.FORBIDDEN)
    if "/reference/" in path:
        assert not names & {"knode_cosserat_tpu_torch", "portbench"}


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = {w["name"]: w for w in BENCH["workloads"]}
    configs = {c["name"]: c for c in BENCH["configs"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    names = list(cells) + list(configs) + list(e2e) + [
        m["name"] for m in BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in cells.values()]:
        assert NAME.match(n), n
    for c in configs.values():
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert json.load(open(REPO / c["file"]))["name"] == c["name"]
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1
        assert len(w["why"]) <= 200
        for d in ("traffic", "limits"):
            stem = w["traffic"] if d == "traffic" else w["name"]
            assert (REPO / "portbench" / d / f"{stem}.json").exists()
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e[
        "setup_s"]
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert any((REPO / "portbench/layer_metrics" / f"{n}.py").exists()
                   for n in (m["name"], m["name"].split(".")[0]))
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
        layers.setdefault(m["layer"], set()).add(m["name"])
    for w in cells:
        assert sum(w in m.get("workloads", [w])
                   for m in BENCH["end_to_end"]) >= 2
        assert any(w in m["workloads"] for m in BENCH["per_layer"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_percentile_rate_and_union():
    lat = np.arange(1, 101) * 1e-3
    assert harness.percentile(lat, 95) == pytest.approx(0.09505)
    w = {"lat": list(lat), "wall_s": 2.0, "epochs": 602, "rod_steps": 12544}
    from portbench.feeds import fast_rollout, stepper, train_knode
    assert train_knode.Cell.e2e(w)["train_epochs_per_s"] == 301.0
    assert fast_rollout.Cell.e2e(w)["rollout_rod_steps_per_s"] == 6272.0
    assert stepper.Cell.e2e(w)["step_latency_p95_ms"] == pytest.approx(
        95.05)
    assert union_length([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4.0
    assert union_length([]) == 0.0


def _events():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "portbench.window",
           "ts": 1000.0, "dur": 1000.0}]
    for i in range(4):     # 4 launches of 150 us, 100 us of memcpy
        ev.append({"ph": "X", "cat": "kernel", "name":
                   "void step_kernel<float, 28>(RodConsts<float>)",
                   "ts": 1100.0 + 200 * i, "dur": 150.0})
    ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
               "ts": 1850.0, "dur": 100.0})
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::cat",
               "ts": 1000.0, "dur": 100.0})
    ev.append({"ph": "X", "cat": "cuda_runtime", "name":
               "cudaDeviceSynchronize", "ts": 1900.0, "dur": 100.0})
    return ev


def test_trace_busy_idle_and_gaps():
    t = Trace(_events())
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx(700e-6)
    assert t.idle_share() == pytest.approx(0.3)
    assert t.kernel_times("step_kernel") == pytest.approx([150e-6] * 4)
    ops = dict(t.device_ops())
    assert ops["step_kernel"] == pytest.approx(600e-6)
    gaps = dict(t.idle_gaps())
    assert gaps["aten::cat"] == pytest.approx(100e-6)
    assert gaps["cudaDeviceSynchronize"] == pytest.approx(50e-6)
    assert sum(gaps.values()) == pytest.approx(300e-6)


def _ctx(trace, window, traced, workload="rollout-r256.sim-nsw-h512"):
    cell, cfg, traffic, _, counts = harness.cell_files(BENCH, workload)
    run = SimpleNamespace(cfg=cfg, traffic=traffic, counts=counts,
                          cell=cell)
    return harness.LayerCtx(run, window, trace, traced)


def test_rollout_readers_on_a_synthetic_trace():
    t = Trace(_events())
    ctx = _ctx(t, {"calls": 2, "wall_s": 0.1, "rod_steps": 2 * 256 * 49},
               {"launches": 4, "rod_steps": 4 * 256})
    c = ctx.run.counts
    flops = 4 * 256 * k2.rod_step_flops([28, 512, 25], 10,
                                        c["sweeps_per_rod_step"],
                                        c["iters_per_rod_step"])
    want = 100 * peaks.bound_s(flops, 4 * k2.launch_bytes(
        [28, 512, 25], 10, 256)) / 600e-6
    read = lambda m: harness.reader_of(m)(ctx)
    assert read("k2_roofline.rollout") == pytest.approx(want)
    assert read("host_ms_per_step.rollout") == pytest.approx(
        1e3 * (0.1 / 98 - 150e-6))
    assert read("device_idle_pct.rollout") == pytest.approx(30.0)
    assert read("rollout_mfu_pct") == pytest.approx(
        100 * flops / 4 * 49 * 2 / 0.1 / 67e12)
    # a profiler that kept 4 of 8 launches: the rest at their mean
    ctx.traced.update(launches=8, rod_steps=8 * 256)
    assert read("k2_roofline.rollout") == pytest.approx(want)


def test_train_readers_on_a_synthetic_trace():
    ev = _events()
    for e in ev:
        e["name"] = e["name"].replace("step_kernel", "train_kernel")
    ctx = _ctx(Trace(ev), {"wall_s": 0.5, "epochs": 602, "launches": 62},
               {"launches": 4, "epochs": 31}, "train-real.real-h512")
    C = 1904
    assert k4.cells(4, 120, 4) == C
    assert k4.epoch_mlp_flops(C, [28, 512, 25]) == 2 * C * 512 * 131
    read = lambda m: harness.reader_of(m)(ctx)
    want = 100 * peaks.bound_s(31 * k4.epoch_flops(C, [28, 512, 25]),
                               4 * k4.launch_bytes(C, [28, 512, 25], 31 / 4)
                               ) / 600e-6
    assert read("k4_roofline.train") == pytest.approx(want)
    assert read("host_ms_per_chunk.train") == pytest.approx(
        1e3 * (0.5 / 62 - 150e-6))
    assert read("train_mfu_pct") == pytest.approx(
        100 * 602 * 2 * C * 512 * 131 / 0.5 / 67e12)


def test_serve_readers_and_silent_readers():
    ctx = _ctx(Trace(_events()), {"lat": [0.4e-3, 0.6e-3]}, {},
               "serve-b1.sim-nsw-h512")
    read = lambda m: harness.reader_of(m)(ctx)
    assert read("k2_device_ms.serve") == pytest.approx(0.15)
    assert read("host_ms_per_step.serve") == pytest.approx(0.35)
    empty = _ctx(None, {"lat": [1.0]}, {}, "serve-b1.sim-nsw-h512")
    for m in ("k2_device_ms.serve", "host_ms_per_step.serve",
              "device_idle_pct.serve"):
        assert harness.reader_of(m)(empty) is None


def test_one_reader_serves_a_name_and_its_stem():
    ctx = _ctx(Trace(_events()), {"calls": 1, "wall_s": 0.01,
                                  "launches": 40}, {"launches": 4})
    for cell in ("train", "rollout", "serve"):
        assert harness.reader_of(f"device_idle_pct.{cell}")(ctx) == \
            pytest.approx(30.0)
        # 700 us busy over 4 launches, 40 launches in 10 ms: 70% busy
        assert harness.reader_of(f"window_idle_pct.{cell}")(ctx) == \
            pytest.approx(30.0)
    with pytest.raises(FileNotFoundError):
        harness.reader_of("no_such_metric.train")


def test_a_metric_without_workloads_goes_where_what_it_moves_goes():
    bench = json.loads(json.dumps(BENCH))
    bench["per_layer"].append({"name": "k2_launches.any", "unit": "1",
                               "better": "lower", "source": "program_counter",
                               "layer": "K2", "moves":
                               "rollout_rod_steps_per_s"})
    names = lambda w: {m["name"] for m in harness.metrics_of(
        bench, w, "per_layer")}
    assert "k2_launches.any" in names("rollout-r256.sim-nsw-h512")
    assert "k2_launches.any" not in names("serve-b1.sim-nsw-h512")
    assert "k2_roofline.rollout" not in names("serve-b1.sim-nsw-h512")
    assert {m["name"] for m in harness.metrics_of(
        bench, "serve-b1.sim-nsw-h512", "end_to_end")} == {
        "step_latency_p95_ms", "setup_s"}


def test_comparisons():
    ref = torch.zeros(3, 10, 25, dtype=torch.float64)
    ref[..., 2] = 0.5
    ref[..., 7] = 5.0
    prog = ref.clone()
    prog[0, 3, 2] += 1e-3
    assert compare.state_err(prog, ref) == pytest.approx(2e-3)
    prog[0, 0, 0] = float("nan")
    assert compare.state_err(prog, ref) == float("inf")
    assert compare.norm_gap([1.0, 2.0, 3.0], [1.0, 2.0, 3.3]) == \
        pytest.approx(0.3 / 3.3)
    assert compare.norm_gap([1e-9, 2.0, 3.0], [0.0, 2.0, 3.0]) == \
        pytest.approx(5e-10)
    assert compare.rel_gap([1.0, 2.0], [1.0, 2.5]) == pytest.approx(0.2)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -3.14159265], dtype=torch.float32)
    y = to_tf32(x)
    assert y[0] == 1.0 + 2 ** -10
    assert y[1] == 1.0                     # a tie to even
    assert y[2] == 1.0 + 2 ** -9
    assert abs(float(y[3]) + 3.14159265) < 2 ** -10 * 4


def test_reservoir_is_uniform_and_seeded():
    hits = np.zeros(10)
    for s in range(2000):
        r = harness.Reservoir(2, np.random.default_rng(s))
        for i in range(10):
            r.offer(i)
        hits[r.items] += 1
    assert hits.min() > 300 and hits.max() < 500
    a, b = (harness.Reservoir(3, np.random.default_rng(5)) for _ in "ab")
    for i in range(50):
        a.offer(i)
        b.offer(i)
    assert a.items == b.items
