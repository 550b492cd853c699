"""A copy of the benchmark with small fixture cells added from files
alone, run on the CPU with the chip check stubbed out."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

ROD = json.load(open(REPO / "portbench/configs/sim-nsw-h512.json"))["rod"]
REAL_ROD = json.load(open(REPO / "portbench/configs/real-h512.json"))["rod"]
NET = {"dims": [28, 16, 25], "activation": "elu", "history": False,
       "init": "abs_normal"}
FILES = {
    "configs/tiny-sim.json": {
        "name": "tiny-sim", "source": "fixture", "N": 6, "rod": ROD,
        "net": dict(NET, weight_scale=0.001), "dtype": "float32",
        "tf32": False, "reduced": ["N"]},
    "configs/tiny-real.json": {
        "name": "tiny-real", "source": "fixture", "N": 6, "rod": REAL_ROD,
        "net": dict(NET, weight_scale=1.0),
        "train": {"epochs": 39, "lr": 0.01, "weight_decay": 0.1,
                  "keypoints": [1, 3, 5], "plateau_patience": 80,
                  "plateau_factor": 0.5, "clamp_weights": True},
        "data": {"recordings": 2, "train_len": 6, "noise_traj": 0.01},
        "dtype": "float32", "tf32": False, "reduced": ["N"]},
    "traffic/tiny-train.json": {
        "entry": "train_knode", "recording": {
            "state_std": 0.01, "tension_range": [1.0, 3.0]},
        "trace_calls": 2,
        "check": {"epochs": 20, "late_from": 30, "late_epochs": 3}},
    "traffic/tiny-rollout.json": {
        "entry": "fast_rollout", "impl": "mega", "rods": 4, "steps": 5,
        "schedule": {"period_s": [0.5, 2.0]},
        "schedules_per_run": 2, "tol": 1e-10, "max_iter": 50,
        "trace_calls": 2},
    "traffic/tiny-serve.json": {
        "entry": "stepper", "rods": 1,
        "schedule": {"period_s": [0.5, 2.0], "segments": 2,
                     "segment_steps": 32},
        "tol": 1e-10, "max_iter": 20,
        "warm_steps": 2, "trace_steps": 5,
        "check": {"start_steps": 4, "sampled_steps": 6}},
    "limits/tiny-train.tiny-real.json": json.load(open(
        REPO / "portbench/limits/train-real.real-h512.json")),
    "limits/tiny-rollout.tiny-sim.json": json.load(open(
        REPO / "portbench/limits/rollout-r256.sim-nsw-h512.json")),
    "limits/tiny-serve.tiny-sim.json": json.load(open(
        REPO / "portbench/limits/serve-b1.sim-nsw-h512.json")),
    "counts/tiny-rollout.tiny-sim.json": {"sweeps_per_rod_step": 16.0,
                                          "iters_per_rod_step": 2.0},
}
CELLS = {"tiny-train.tiny-real": "train_epochs_per_s",
         "tiny-rollout.tiny-sim": "rollout_rod_steps_per_s",
         "tiny-serve.tiny-sim": "step_latency_p95_ms"}
LAYERS = {"tiny-train.tiny-real": ["k4_roofline.train",
                                   "host_ms_per_chunk.train",
                                   "train_mfu_pct", "device_idle_pct.train",
                                   "window_idle_pct.train"],
          "tiny-rollout.tiny-sim": ["k2_roofline.rollout",
                                    "host_ms_per_step.rollout",
                                    "rollout_mfu_pct",
                                    "device_idle_pct.rollout",
                                    "window_idle_pct.rollout"],
          "tiny-serve.tiny-sim": ["k2_device_ms.serve",
                                  "host_ms_per_step.serve",
                                  "device_idle_pct.serve",
                                  "window_idle_pct.serve"]}


def build(tmp: Path) -> Path:
    """The repo's benchmark copied to tmp, the fixture's files added, and
    a BENCHMARK.json that holds the repo's entries and the fixture's."""
    shutil.copytree(REPO / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(REPO / "knode_cosserat_tpu_torch",
               tmp / "knode_cosserat_tpu_torch")
    for rel, body in FILES.items():
        (tmp / "portbench" / rel).write_text(json.dumps(body))
    bench = json.load(open(REPO / "BENCHMARK.json"))
    for name in ("tiny-sim", "tiny-real"):
        bench["configs"].append({
            "name": name, "source": "fixture", "reduced": ["N"],
            "file": f"portbench/configs/{name}.json", "why": "fixture"})
    for cell, e2e in CELLS.items():
        traffic, config = cell.split(".")
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": traffic, "chips": 1,
                                   "why": "fixture"})
        next(m for m in bench["end_to_end"]
             if m["name"] == e2e)["workloads"].append(cell)
        for m in bench["per_layer"]:
            if m["name"] in LAYERS[cell]:
                m["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


PRELUDE = """
import sys, torch
sys.path.insert(0, {root!r})
torch.set_num_threads(2)
from portbench import harness
cpu = lambda n: torch.device("cpu")
"""


def run_py(tmp: Path, body: str, timeout: int = 600):
    """Run PRELUDE + body in a fresh Python in tmp; (rc, stdout, stderr)."""
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONDONTWRITEBYTECODE="1")
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "-c",
                        PRELUDE.format(root=str(tmp)) + body], cwd=tmp,
                       env=env, capture_output=True, text=True,
                       timeout=timeout)
    return p.returncode, p.stdout, p.stderr


def run_cell(tmp: Path, cell: str, seed: int = 7, trace: int = 0,
             patch: str = ""):
    """One run of a fixture cell on the CPU; (rc, result or None, stderr)."""
    argv = ["--workload", cell, "--seed", str(seed), "--seconds", "0.3",
            "--trace", str(trace)]
    rc, out, err = run_py(tmp, patch + f"\nsys.exit(harness.main({argv!r}, "
                          "require=cpu))")
    lines = out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 and lines else None), err
