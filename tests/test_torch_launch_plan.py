"""The launch plans of K2 (ops/step.py) and K3 (ops/sweep.py): pure Python,
so they are checked here on the CPU. The plan fits the H100's 232,448
bytes of dynamic shared memory or reads the net from global memory, with
room for every unit of a ragged hidden width (100); it does not depend
on the batch."""
import contextlib

import pytest
import torch

import knode_cosserat_tpu_torch as K
from knode_cosserat_tpu_torch.ops import _build
from knode_cosserat_tpu_torch.ops import step as kstep
from knode_cosserat_tpu_torch.ops import sweep as ksweep

DTYPES = [torch.float32, torch.float64]
NN_IN = [0, 28, 53]
HIDDEN = [16, 100, 512, 2048]
METHODS = ["euler", "rk4"]
BUDGET = 232_448


def _weight_bytes(dtype, nn_in, hidden):
    """W1, b1, W2, b2 as nn.Linear holds them, unpadded."""
    size = 8 if dtype == torch.float64 else 4
    return size * (hidden * (nn_in + 1) + 25 * hidden + 25)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("hidden", HIDDEN)
@pytest.mark.parametrize("nn_in", NN_IN)
@pytest.mark.parametrize("dtype", DTYPES)
def test_step_plan_fits_or_reads_global(dtype, nn_in, hidden, method):
    plan = kstep.launch_plan(dtype, nn_in, hidden, method)
    state = kstep._STATE_BYTES[dtype]
    assert ksweep.SMEM_BUDGET == BUDGET
    assert plan.smem_bytes <= BUDGET
    if nn_in == 0:
        assert plan == (28, 4, 4 * state, False)
        return
    assert (plan.threads, plan.rods_per_block) == (7 * 32, 1)
    w = ksweep.net_smem_bytes(dtype, nn_in, hidden)
    # the staged net: W1 transposed with one pad column, rounded to 8 B
    assert _weight_bytes(dtype, nn_in, hidden) <= w
    assert w <= _weight_bytes(dtype, nn_in, hidden) + 8 * nn_in + 8
    assert plan.staged == (w + state <= BUDGET)
    assert plan.smem_bytes == state + (w if plan.staged else 0)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("hidden", HIDDEN)
@pytest.mark.parametrize("nn_in", NN_IN)
@pytest.mark.parametrize("dtype", DTYPES)
def test_sweep_plan_fits_or_reads_global(dtype, nn_in, hidden, method):
    plan = ksweep.launch_plan(dtype, nn_in, hidden, method)
    assert plan.smem_bytes <= BUDGET
    if nn_in == 0:
        assert plan == (32, 32, 0, False)
        return
    assert (plan.threads, plan.lanes) == (8 * 32, 8)
    w = ksweep.net_smem_bytes(dtype, nn_in, hidden)
    assert plan.staged == (w <= BUDGET)
    assert plan.smem_bytes == (w if plan.staged else 0)


def test_plans_route_the_reference_nets(monkeypatch):
    """hidden 512: the weights are staged but for float64 with 53 inputs
    (324 KB), which reads them from global memory; a budget of 0 sends
    every net there."""
    for dtype in DTYPES:
        for nn_in in (28, 53):
            staged = not (dtype == torch.float64 and nn_in == 53)
            assert kstep.launch_plan(dtype, nn_in, 512, "euler").staged == staged
            assert ksweep.launch_plan(dtype, nn_in, 512, "rk4").staged == staged
    monkeypatch.setattr(ksweep, "SMEM_BUDGET", 0)
    for dtype in DTYPES:
        for nn_in in (28, 53):
            assert not kstep.launch_plan(dtype, nn_in, 16, "euler").staged
            assert not ksweep.launch_plan(dtype, nn_in, 16, "euler").staged


def test_plans_refuse_bad_arguments():
    with pytest.raises(ValueError):
        kstep.launch_plan(torch.float32, 28, 64, "midpoint")
    with pytest.raises(ValueError):
        ksweep.launch_plan(torch.float32, 28, 64, "midpoint")


class _Recorder:
    """Stands in for the kernel library: records each entry's arguments."""

    def __init__(self):
        self.calls = []

    def _entry(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call

    def __getattr__(self, name):
        if name.startswith("knode_"):
            return self._entry(name)
        raise AttributeError(name)


def _inputs(p, B, dtype):
    g = torch.Generator().manual_seed(B)
    mk = lambda *shape: torch.randn(*shape, generator=g, dtype=dtype)
    return mk(B, 6), mk(B, p.N, 19), mk(B, p.N, 6), mk(B, 3)


@pytest.mark.parametrize("history", [None, False, True])
def test_plan_is_the_same_for_any_batch(monkeypatch, history):
    """The wrappers hand the C entries the same launch shape at B = 1 and
    B = 256 (only B and the data differ)."""
    rec = _Recorder()
    monkeypatch.setattr(_build, "library", lambda: rec)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(kstep, "stream_of", lambda t: 0)
    monkeypatch.setattr(ksweep, "stream_of", lambda t: 0)
    dtype = torch.float64
    p = K.experimental_rod(N=5, device="cpu").to(dtype=dtype)
    spec = net = None
    if history is not None:
        spec = K.MLPSpec.for_knode(100, history=history)
        net = K.init_mlp(spec, torch.Generator().manual_seed(0), dtype, "cpu")
    consts = ksweep.rod_consts(p)
    with torch.no_grad():
        for B in (1, 256):
            ins = _inputs(p, B, dtype)
            kstep._launch(p, consts, spec, 1e-10, 30, 7, "rk4", *ins, net)
            ksweep._launch(p, consts, spec, "euler", True, *ins, net)
    shapes = {}
    for name, args in rec.calls:
        # the plan: the 3 arguments before the stream
        B = args[4]
        plan = args[-4:-1]
        shapes.setdefault(name, {})[B] = plan
    assert set(shapes) == {"knode_step", "knode_sweep"}
    for name, by_batch in shapes.items():
        assert set(by_batch) == {1, 256}
        assert by_batch[1] == by_batch[256], name
    nn_in = 0 if history is None else (53 if history else 28)
    step_plan = kstep.launch_plan(dtype, nn_in, 100, "rk4")
    assert shapes["knode_step"][1] == (step_plan.threads, step_plan.smem_bytes,
                                       int(step_plan.staged))
