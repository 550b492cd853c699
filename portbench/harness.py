"""One run of one cell: set-up, the measured window, the traced slice, the
check against the plain reference, and the result line.

Everything is found by name from files: the cell in ``BENCHMARK.json``,
its configuration ``configs/<config>.json``, its traffic mix
``traffic/<traffic>.json`` (whose ``entry`` names the module
``feeds/<entry>.py`` that feeds it to the program), the limits of its check
``limits/<workload>.json``, its frozen counts ``counts/<workload>.json``
and each per-layer metric's reader ``layer_metrics/<metric>.py`` (or
that of the name's stem before its first dot).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(os.path.abspath(__file__)).parent
ROOT = HERE.parent
PORT = "knode_cosserat_tpu_torch"
# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "knode_cosserat_tpu")


class NoChip(SystemExit):
    pass


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(bench: dict, workload: str):
    """(cell, configuration, traffic, limits, counts) of a workload."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the benchmark has "
                         f"{sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = load_json(ROOT / configs[cell["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{workload}.json")
    counts_path = HERE / "counts" / f"{workload}.json"
    counts = load_json(counts_path) if counts_path.exists() else {}
    return cell, cfg, traffic, limits, counts


def feed_of(traffic: dict):
    return importlib.import_module(f"portbench.feeds.{traffic['entry']}")


def reader_of(metric: str):
    """The reader ``layer_metrics/<metric>.py``, or, where there is none,
    the one of the name's stem before its first dot (one reader serves
    ``device_idle_pct.train`` and ``device_idle_pct.serve``)."""
    path = HERE / "layer_metrics" / f"{metric}.py"
    if not path.exists():
        path = HERE / "layer_metrics" / f"{metric.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.layer_metrics." + metric.replace(".", "_").replace(
            "-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def require_chips(n: int):
    """The CUDA device, or exit (non-zero, no result) when the machine has
    no card or fewer than the cell asks for."""
    import torch

    if not torch.cuda.is_available():
        raise NoChip("no CUDA device: this benchmark runs only on the card")
    if torch.cuda.device_count() < n:
        raise NoChip(f"the cell asks for {n} cards, the machine has "
                     f"{torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def import_port():
    """The program from this checkout (never an installed copy)."""
    sys.path.insert(0, str(ROOT))
    port = importlib.import_module(PORT)
    where = Path(os.path.abspath(port.__file__))
    if ROOT not in where.parents:
        raise SystemExit(f"{PORT} found at {where}, outside {ROOT}")
    return port


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def percentile(xs, q: float) -> float:
    """The q-th percentile, linear between order statistics."""
    return float(np.percentile(np.asarray(xs, np.float64), q))


class Reservoir:
    """A uniform sample of k items of a stream of unknown length, drawn
    from a seeded generator (Algorithm R); costs the host a draw an item."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.n, self.items = k, rng, 0, []

    def offer(self, item):
        self.n += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(self.n))
            if j < self.k:
                self.items[j] = item


@dataclasses.dataclass
class Run:
    """What a feed is given: the cell's files, the seed, the device."""
    workload: str
    cell: dict
    cfg: dict
    traffic: dict
    counts: dict
    seed: int
    device: object
    rng: np.random.Generator

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def generator(self):
        """A torch.Generator on the run's device, seeded from --seed."""
        import torch
        return torch.Generator(device=self.device).manual_seed(
            self.seed % (1 << 63))

    def sync(self):
        import torch
        if self.cuda:
            torch.cuda.synchronize(self.device)


@dataclasses.dataclass
class LayerCtx:
    """What a per-layer metric's reader sees."""
    run: Run
    window: dict        # host-clock facts of the measured window
    trace: object       # trace.Trace of the traced slice, or None
    traced: dict        # facts of the traced slice (units run, counters)


def setup_run(workload: str, seed: int, require=require_chips):
    """(BENCHMARK.json, the Run, the check's limits) of one cell, on the
    device ``require`` gives (the card; the CPU stands in for it only in
    the benchmark's own tests)."""
    bench = load_json(ROOT / "BENCHMARK.json")
    cell, cfg, traffic, limits, counts = cell_files(bench, workload)
    import torch

    device = require(int(cell["chips"]))
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg.get("tf32", False))
    torch.backends.cudnn.allow_tf32 = bool(cfg.get("tf32", False))
    import_port()
    run = Run(workload, cell, cfg, traffic, counts, seed, device,
              np.random.default_rng(seed))
    return bench, run, limits


def judge(checked, limits):
    """[(name, value, limit, ok)] and whether every number is within."""
    rows = []
    for name, value in checked:
        limit = float(limits[name])
        ok = bool(math.isfinite(value) and value <= limit)
        rows.append((name, float(value), limit, ok))
    return rows, all(r[3] for r in rows)


def main(argv=None, t_start=None, require=require_chips):
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of the port's "
                                 "benchmark once and print its result line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = time.perf_counter() if t_start is None else t_start
    try:
        bench, run, limits = setup_run(args.workload, args.seed, require)
    except NoChip as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    import torch

    from . import trace as tracing

    t_build = time.perf_counter()
    feed = feed_of(run.traffic).Cell(run)
    t_warm = time.perf_counter()
    feed.warm()
    run.sync()
    # set-up's objects out of the collector's way: a collection in the
    # window then scans only what the window made
    gc.collect()
    gc.freeze()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    print(f"portbench: set-up: start {t_build - t_start:.3f} s, inputs and "
          f"program {t_warm - t_build:.3f} s, warm-up {t0 - t_warm:.3f} s",
          file=sys.stderr)
    window = feed.window(args.seconds)
    tr = parts = None
    if args.trace:
        traced = {}

        def slice_():
            run.sync()
            a = time.perf_counter()
            traced.update(feed.traced())
            run.sync()
            traced["wall_s"] = time.perf_counter() - a
        tr = tracing.Trace(tracing.profile(slice_, run.cuda, host=False),
                           window_s=traced["wall_s"])
        parts = tracing.Trace(tracing.profile(feed.traced, run.cuda))
        ctx = LayerCtx(run, window, tr, traced)
        metrics = {}
        for m in metrics_of(bench, args.workload, "per_layer"):
            v = reader_of(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        e2e = dict(feed.e2e(window), setup_s=setup_s)
        metrics = {m["name"]: {"value": float(e2e[m["name"]]),
                               "unit": m["unit"]}
                   for m in metrics_of(bench, args.workload, "end_to_end")}
    peak = torch.cuda.max_memory_allocated(run.device) if run.cuda else 0
    feed.release()
    gc.collect()
    if run.cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    rows, correct = judge(feed.check(), limits)
    print(f"portbench: set-up {setup_s:.3f} s, window {window['wall_s']:.3f}"
          f" s, check {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}; nothing of JAX or of the JAX "
              "package may run here", file=sys.stderr)
        return 4
    device = {"platform": "gpu" if run.cuda else "cpu",
              "kind": (torch.cuda.get_device_name(run.device) if run.cuda
                       else "cpu"),
              "count": int(run.cell["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": int(window["attempted"]),
           "failed": 0, "metrics": metrics, "device": device}
    if tr is not None:
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.device_ops(),
                            "idle_gaps": parts.idle_gaps()}
    out["checked"] = {n: {"value": v, "limit": lim} for n, v, lim, _ in rows}
    for n, v, lim, ok in rows:
        print(f"check {n} {v!r} limit {lim!r} {'ok' if ok else 'FAIL'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def metrics_of(bench: dict, workload: str, kind: str):
    """The metrics of ``kind`` that this cell reports: those that list it
    under ``workloads``; one without that key, in every cell (end-to-end)
    or in every cell that reports the metric it moves (per-layer)."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload])
            and ("workloads" in m or m["moves"] in names)]
