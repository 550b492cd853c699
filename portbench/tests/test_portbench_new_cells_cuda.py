"""On the card, at the RK4 rollout cell's own size: the program broken
underneath reads ``correct`` false (its ``make_fast_rollout`` built with
the Euler sweep), and the reference's graphed sweep is its eager sweep.
(The control, the plain reference in the program's place with TF32
products, is test_portbench_control_cuda.py's, for every cell.) Run on a
machine with the card:

    python -m pytest portbench/tests/test_portbench_new_cells_cuda.py -m cuda
"""
from __future__ import annotations

import json

import pytest
import torch

from portbench.calibrate import readings
from portbench.reference import rod as R
from portbench.reference import rod_rk4 as RK
from portbench.tests.fixture import REPO

CELL = "rollout-r256-rk4.sim-nsw-h512-rk4n40"


@pytest.mark.cuda
def test_euler_in_rk4s_place_fails_at_the_cells_size(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    import knode_cosserat_tpu_torch.core.fast_rollout as FR
    orig = FR.make_fast_rollout
    monkeypatch.setattr(FR, "make_fast_rollout", lambda *a, **k: orig(
        *a, **dict(k, method="euler")))
    res = readings(CELL, 2024, "program", 1.0)
    assert res["correct"] is False, res["numbers"]


@pytest.mark.cuda
def test_the_graphed_sweep_is_the_eager_sweep_at_the_cells_shapes():
    """The rollout's sweeps replayed as CUDA graphs equal the eager sweep
    bit for bit, at the batch shapes a Newton step of the cell's 256 rods
    sweeps (the residual, 6 probes and 7 candidates a rod), in the check's
    float64 and the control's float32, on a second draw of inputs too (a
    replay of the captured graph)."""
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    cfg = json.load(open(REPO / "portbench/configs/sim-nsw-h512-rk4n40.json"))
    din, hidden, dout = cfg["net"]["dims"]
    N, rods = cfg["N"], 256
    g = torch.Generator(device="cuda").manual_seed(3)
    for dtype in (torch.float64, torch.float32):
        rn = lambda *s: torch.randn(*s, generator=g, device="cuda",
                                    dtype=dtype)
        rod = R.derive(cfg["rod"], N, dtype, "cuda")
        w = [1e-3 * (0.01 + 0.01 * rn(hidden, din)).abs(), 1e-5 * rn(hidden),
             1e-3 * (0.01 + 0.01 * rn(dout, hidden)).abs(), 1e-5 * rn(dout)]
        fn = RK.sweeper(rod, w)
        assert isinstance(fn, RK.Graphed)
        for rows in (rods, 6 * rods, 7 * rods):
            for _ in range(2):
                ins = (0.05 * rn(rows, 6), 1e-3 * rn(rows, N, 19),
                       1e-3 * rn(rows, N, 6), rn(rows, 3))
                got, want = fn(*ins), RK.sweep(rod, *ins, w)
                for a, b in zip(got, want):
                    assert torch.equal(a, b), (dtype, rows)
        assert len(fn.graphs) == 3
