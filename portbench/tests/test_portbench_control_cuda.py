"""On the card, at each cell's own size: the control (the plain reference in
the program's place, float32 with TF32 products) reads ``correct`` false,
and in the training cell so do the half-batch fault and the program with
its weights or its optimizer state dropped between K4's chunks. Run on a
machine with the card:

    python -m pytest portbench/tests/test_portbench_control_cuda.py -m cuda
"""
from __future__ import annotations

import json

import pytest
import torch

from portbench.calibrate import readings
from portbench.tests.fixture import REPO

BENCH = json.load(open(REPO / "BENCHMARK.json"))
CASES = [(w["name"], "control") for w in BENCH["workloads"]] + [
    ("train-real.real-h512", k) for k in ("half_batch", "copy_back_dropped",
                                          "carry_dropped")]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,kind", CASES)
def test_the_control_fails_at_the_cells_size(cell, kind):
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    res = readings(cell, 2024, kind, 1.0)
    assert res["correct"] is False, res["numbers"]
