"""The RK4 rollout cell's feed, readers and check, on the CPU at a fixture's
size: it runs from files alone and reads ``correct`` true, a traced run
reports every per-layer metric the cell lists, and the program broken
underneath (Euler in RK4's place) or the reference in its place with TF32
products reads ``correct`` false."""
from __future__ import annotations

import json

import pytest

from portbench.tests import fixture as F

RK4 = "tiny-rollout-rk4.tiny-rk4"
RK4_CELL = "rollout-r256-rk4.sim-nsw-h512-rk4n40"
FILES = {
    "configs/tiny-rk4.json": dict(F.FILES["configs/tiny-sim.json"],
                                  name="tiny-rk4", method="rk4"),
    "traffic/tiny-rollout-rk4.json": dict(
        F.FILES["traffic/tiny-rollout.json"], entry="fast_rollout_rk4"),
    f"limits/{RK4}.json": json.load(open(
        F.REPO / "portbench/limits" / f"{RK4_CELL}.json")),
    f"counts/{RK4}.json": {"sweeps_per_rod_step": 16.0,
                           "iters_per_rod_step": 2.0},
}
# the per-layer metrics BENCHMARK.json lists for the RK4 cell
LAYERS = [m["name"] for m in json.load(open(F.REPO / "BENCHMARK.json"))[
    "per_layer"] if RK4_CELL in m.get("workloads", [])]
# on the CPU no device operation is traced: what needs K2's device time or
# the device's busy intervals reads nothing
DEVICE = {"k2_roofline.rk4", "host_ms_per_step.rk4", "device_idle_pct.rk4",
          "window_idle_pct.rk4"}
# the program broken underneath: the RK4 cell's rollout built with the
# Euler sweep
EULER = ("import knode_cosserat_tpu_torch.core.fast_rollout as FR\n"
         "orig = FR.make_fast_rollout\n"
         "FR.make_fast_rollout = lambda *a, **k: orig(*a, **dict(k, "
         "method='euler'))\n")


def build(tmp):
    """fixture.build's tree with the RK4 fixture cell added."""
    F.build(tmp)
    for rel, body in FILES.items():
        (tmp / "portbench" / rel).write_text(json.dumps(body))
    bench = json.load(open(tmp / "BENCHMARK.json"))
    bench["configs"].append({
        "name": "tiny-rk4", "source": "fixture", "reduced": ["N"],
        "file": "portbench/configs/tiny-rk4.json", "why": "fixture"})
    traffic, config = RK4.split(".")
    bench["workloads"].append({"name": RK4, "config": config,
                               "traffic": traffic, "chips": 1,
                               "why": "fixture"})
    next(m for m in bench["end_to_end"] if m["name"] ==
         "rollout_rod_steps_per_s")["workloads"].append(RK4)
    for m in bench["per_layer"]:
        if m["name"] in LAYERS:
            m["workloads"].append(RK4)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return build(tmp_path_factory.mktemp("new_cells"))


def test_a_new_cell_runs_and_reads_correct(tree):
    rc, res, err = F.run_cell(tree, RK4, seed=2 ** 33 + 5)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True, res["checked"]
    assert set(res["metrics"]) == {"rollout_rod_steps_per_s", "setup_s"}
    assert res["metrics"]["rollout_rod_steps_per_s"]["value"] > 0


def test_a_traced_new_cell_reports_its_layer_metrics(tree):
    rc, res, err = F.run_cell(tree, RK4, trace=1)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True, res["checked"]
    assert len(LAYERS) == 8
    assert set(res["metrics"]) == set(LAYERS) - DEVICE
    m = {k: v["value"] for k, v in res["metrics"].items()}
    # K2 counts at least the first residual, an iteration's 7 sweeps and
    # the recording sweep a rod-step
    assert m["k2_sweeps_per_rod_step.rk4"] >= 2 + 7 * m[
        "k2_iters_per_rod_step.rk4"]
    assert m["glue_ms_per_step.rk4"] > 0


def test_a_new_cell_with_the_program_broken_reads_not_correct(tree):
    rc, res, err = F.run_cell(tree, RK4, patch=EULER)
    assert rc == 0, err[-3000:]
    assert res["correct"] is False, res["checked"]


def test_a_new_cell_with_the_control_in_the_programs_place_reads_not_correct(
        tree):
    rc, out, err = F.run_py(tree, (
        "from portbench.calibrate import readings\n"
        f"print(__import__('json').dumps(readings({RK4!r}, 11, 'control', "
        "0.2, require=cpu)))"))
    assert rc == 0, err[-3000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is False, res["numbers"]


def test_the_counts_readings_come_from_the_reference(tree):
    rc, out, err = F.run_py(tree, (
        "from portbench.calibrate import readings\n"
        f"print(__import__('json').dumps(readings({RK4!r}, 3, 'counts', "
        "0.2, require=cpu)))"))
    assert rc == 0, err[-3000:]
    extra = json.loads(out.strip().splitlines()[-1])["extra"]
    assert extra["sweeps_per_rod_step"] >= 2 + 7 * extra["iters_per_rod_step"]
