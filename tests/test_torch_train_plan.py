"""The launch plans of the training kernels: K4 / K5 (ops/train.py, a
thread-block cluster per run) and K6 (ops/train_wide.py, register-tiled
products over the card). Pure Python, so they are checked here on the CPU:
each plan fits the H100's 232,448 bytes of dynamic shared memory, K4's
cluster is portable (8 blocks at most), every hidden unit has exactly one
owner, K4's plan does not depend on the cell count or the number of runs,
and K6's scratch buffers are the sizes its plan gives the C entry."""
import contextlib

import pytest
import torch

from knode_cosserat_tpu_torch.ops import _build
from knode_cosserat_tpu_torch.ops import train as ktrain
from knode_cosserat_tpu_torch.ops import train_wide as kwide

BUDGET = 232_448        # dynamic shared memory of one block
SM_BYTES = 233_472      # one SM's shared memory (228 KB), 1 KB per block
PORTABLE_CLUSTER = 8
DINS = [28, 53]


def _unit_owners(plan, hidden):
    """(block rank, unit slot) of each hidden unit, as csrc/train.cu deals
    them: block r owns the units [r U, r U + U), U = plan.units, its slot u
    holding unit r U + u (the slot's threads, one per cell slice, share
    it); the slots past what the block owns hold zeros."""
    owners = []
    for r in range(plan.cluster):
        n = max(0, min(plan.units, hidden - r * plan.units))
        owners += [(r, u) for u in range(n)]
    return owners


@pytest.mark.parametrize("hidden", [1, 48, 100, 512])
@pytest.mark.parametrize("din", DINS)
def test_k4_plan_fits_and_owns_every_unit_once(din, hidden):
    plan = ktrain.launch_plan(din, hidden)
    assert plan.smem_bytes <= BUDGET
    assert plan.cluster <= PORTABLE_CLUSTER
    assert plan.threads == 512 and plan.threads % plan.slots == 0
    # every slice of threads deals the tile's cell quads evenly
    slices = plan.threads // plan.slots
    assert (plan.tile // 4) % slices == 0
    assert plan.units <= plan.slots <= 64 and plan.slots >= 8
    owners = _unit_owners(plan, hidden)
    assert len(owners) == hidden == len(set(owners))
    for unit, (rank, slot) in enumerate(owners):
        assert 0 <= rank < plan.cluster and 0 <= slot < plan.units
        assert rank * plan.units + slot == unit


@pytest.mark.parametrize("din", DINS)
def test_k4_plan_shared_memory_by_width(din):
    """The plan's bytes: X tile (+ ones), H, two partial buffers of 25
    rows, W1 (+ b1) and W2 over the unit slots, and 128 floats of b2 and
    the loss; at hidden 512 it leaves room below the budget."""
    for hidden in (1, 48, 100, 512):
        plan = ktrain.launch_plan(din, hidden)
        row = plan.tile + 4
        want = 4 * ((din + 1) * row + plan.slots * row + 2 * 25 * row
                    + (din + 1) * plan.slots + 25 * plan.slots + 128)
        assert plan.smem_bytes == want
    assert ktrain.launch_plan(din, 512).slots == 64


def test_plans_refuse_bad_arguments():
    for args in ((27, 64), (28, 0), (53, 513)):
        with pytest.raises(ValueError):
            ktrain.launch_plan(*args)
    for args in ((27, 64, 232), (28, 0, 232), (53, 64, 0),
                 (53, 64, kwide.WIDE_MAX_CELLS + 1)):
        with pytest.raises(ValueError):
            kwide.launch_plan(*args)


class _Recorder:
    """Stands in for the kernel library: records each entry's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("knode_"):
            raise AttributeError(name)

        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def recorder(monkeypatch):
    """The wrappers' launches on CPU tensors, into a _Recorder."""
    rec = _Recorder()
    monkeypatch.setattr(_build, "library", lambda: rec)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())

    class _Stream:
        cuda_stream = 0
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: _Stream())
    return rec


def _run_args(C, din, hidden, lead=()):
    g = torch.Generator().manual_seed(C)
    mk = lambda *shape: torch.randn(*lead, *shape, generator=g)
    cells = ktrain.Cells(mk(C, din), mk(C, 19), mk(C, 6), mk(C, 19),
                         mk(C, 6), mk(C, 3), (1.0, 1.0, 1.0, 1.0), 0.01)
    W = [mk(hidden, din), mk(hidden), mk(25, hidden), mk(25)]
    state = {"moments": tuple(torch.zeros_like(w) for w in W
                              for _ in range(2)),
             "scalars": torch.zeros(*lead, 4)}
    return cells, W, state


def _fields(c_struct) -> tuple:
    """A TrainPlanC / WidePlanC read back as a plain tuple."""
    return tuple(getattr(c_struct, f) for f, _ in c_struct._fields_)


HYPER = ktrain.TrainHyper(lr=1e-3, weight_decay=0.0, factor=0.5, patience=10,
                          clamp=True)


@pytest.mark.parametrize("din", DINS)
def test_k4_plan_is_the_same_for_every_cell_count_and_grid(recorder, din):
    """K4 at 232 and 1,904 cells and K5 at 1 and 3 runs hand the C entries
    one plan, launch_plan(din, hidden)'s, so K5's runs equal K4 launches."""
    hidden = 100
    for C in (232, 1904):
        ktrain._launch(*_run_args(C, din, hidden), 5, HYPER)
        for G in (1, 3):
            ds = torch.full((G,), 0.01, dtype=torch.float64)
            ktrain._launch(*_run_args(C, din, hidden, (G,)), 5, HYPER,
                           ds_grid=ds)
    plans = {_fields(args[-2]._obj) if name == "knode_train_grid"
             else _fields(args[1]._obj) for name, args in recorder.calls}
    assert len(recorder.calls) == 6
    assert plans == {tuple(ktrain.launch_plan(din, hidden))}


@pytest.mark.parametrize("hidden", [64, 640, 2048, 8192])
@pytest.mark.parametrize("din", DINS)
def test_k6_plan_fits_and_covers_every_unit_and_cell(din, hidden):
    for C in (232, 1904, kwide.WIDE_MAX_CELLS):
        plan = kwide.launch_plan(din, hidden, C)
        # two blocks of either phase fit on an SM
        for smem in (plan.fwd_smem, plan.bwd_smem):
            assert smem <= BUDGET and 2 * (smem + 1024) <= SM_BYTES
        n_fu = -(-hidden // plan.fwd_units)
        n_bu = -(-hidden // plan.bwd_units)
        n_chunks = -(-C // plan.bwd_cells)
        # every unit in one forward tile and one backward tile, in one group
        # of 4 units per thread; every cell chunk in exactly one slice
        owners = {}
        for u in range(hidden):
            tile, at = divmod(u, plan.bwd_units)
            owners.setdefault((tile, at // 4), []).append(u)
        assert sum(len(v) for v in owners.values()) == hidden
        assert all(len(v) <= 4 for v in owners.values())
        assert max(t for t, _ in owners) == n_bu - 1
        slices = [min(n_chunks, (s + 1) * plan.chunks) - s * plan.chunks
                  for s in range(plan.slices)]
        assert all(n >= 1 for n in slices) and sum(slices) == n_chunks
        # every forward cell tile in exactly one block's group
        n_ft = -(-C // plan.fwd_cells)
        groups = -(-n_ft // plan.fwd_tiles)
        assert (groups - 1) * plan.fwd_tiles < n_ft <= groups * plan.fwd_tiles
        assert plan.part_floats == n_fu * C * 25
        assert plan.sums_floats == -(-C // plan.loss_cells) * 26
        assert plan.grad_floats == plan.slices * hidden * (din + 26)
        assert plan.counters == 1


@pytest.mark.parametrize("hidden", [64, 640])
def test_k6_scratch_is_what_the_plan_says(recorder, monkeypatch, hidden):
    """The wrapper allocates the plan's scratch sizes and hands the C entry
    that plan and those buffers."""
    made = []
    scratch = kwide.scratch
    monkeypatch.setattr(kwide, "scratch",
                        lambda *a: made.append(scratch(*a)) or made[-1])
    C, din = 232, 53
    kwide._launch(*_run_args(C, din, hidden), 5, HYPER)
    (name, args), = recorder.calls
    assert name == "knode_train_wide"
    a, plan = args[0]._obj, args[1]._obj
    assert _fields(plan) == tuple(kwide.launch_plan(din, hidden, C))
    buf, = made
    assert buf["part"].numel() == plan.part_floats
    assert buf["grad"].numel() == plan.grad_floats
    assert buf["count"].numel() == plan.counters
    assert buf["count"].dtype == torch.int32 and not buf["count"].any()
    assert buf["sums"].numel() == plan.sums_floats
    assert buf["g"].shape == (C, 25)
    for field in ("part", "grad", "count", "g", "sums"):
        assert getattr(a, field) == buf[field].data_ptr()
