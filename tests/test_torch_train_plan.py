"""The launch plans of the training kernels: K4 / K5 (ops/train.py, a
thread-block cluster per run) and K6 (ops/train_wide.py, register-tiled
products over the card). Pure Python, so they are checked here on the CPU:
each plan fits the H100's 232,448 bytes of dynamic shared memory, K4's
cluster is portable (8 blocks at most), every hidden unit has exactly one
owner, K4's plan depends on the cell count and the number of runs only
through the clusters a run (P), which spreads a run over the card without
leaving the clusters it holds at once, and the scratch buffers are the
sizes the plans give the C entries."""
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


RESIDENT = 16           # the recorder's answer to the occupancy query


class _Recorder:
    """Stands in for the kernel library: records each entry's arguments;
    the occupancy query reads RESIDENT clusters."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("knode_"):
            raise AttributeError(name)

        def call(*args):
            self.calls.append((name, args))
            if name == "knode_train_clusters":
                args[-1]._obj.value = RESIDENT
            return 0
        return call


@pytest.fixture
def recorder(monkeypatch):
    """The wrappers' launches on CPU tensors, into a _Recorder."""
    rec = _Recorder()
    monkeypatch.setattr(_build, "library", lambda: rec)
    monkeypatch.setattr(ktrain, "_RESIDENT", {})
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


def _launches(recorder):
    """(entry, runs, plan fields, args) of each recorded K4 / K5 launch."""
    out = []
    for name, args in recorder.calls:
        if name == "knode_train":
            out.append((name, 1, _fields(args[1]._obj), args[0]._obj))
        elif name == "knode_train_grid":
            out.append((name, args[1], _fields(args[2]._obj), args[0]._obj))
    return out


@pytest.mark.parametrize("din", DINS)
def test_k4_plan_is_the_same_for_every_cell_count_and_grid(recorder, din):
    """K4 at 232 and 1,904 cells and K5 at 1 and 3 runs hand the C entries
    launch_plan(din, hidden)'s threads, hidden split, slots, part size and
    shared memory; only the clusters a run differ, clusters_per_run's P for
    (C, G, the card's resident clusters), which the kernel's fold keeps out
    of the bits (the cuda tier holds K5 to K4 bit for bit)."""
    hidden = 100
    for C in (232, 1904):
        ktrain._launch(*_run_args(C, din, hidden), 5, HYPER)
        for G in (1, 3):
            ds = torch.full((G,), 0.01, dtype=torch.float64)
            ktrain._launch(*_run_args(C, din, hidden, (G,)), 5, HYPER,
                           ds_grid=ds)
    launches = _launches(recorder)
    assert len(launches) == 6
    base = tuple(ktrain.launch_plan(din, hidden))
    got = []
    for (name, G, plan, a), C in zip(launches, [232] * 3 + [1904] * 3):
        assert plan[:-1] == base[:-1] and a.C == C
        got.append((C, G, plan[-1]))
        assert plan[-1] == ktrain.clusters_per_run(C, G, RESIDENT)
    assert got == [(232, 1, 2), (232, 1, 2), (232, 3, 2),
                   (1904, 1, 15), (1904, 1, 15), (1904, 3, 5)]
    # asked once for the card's clusters
    asked = [n for n, _ in recorder.calls if n == "knode_train_clusters"]
    assert len(asked) == 1


@pytest.mark.parametrize("C", [1, 128, 129, 232, 1904, 2048, 8192])
def test_the_part_count_depends_on_the_cell_count_alone(C):
    n = ktrain.parts(C)
    assert (n - 1) * 128 < C <= n * 128
    assert ktrain.launch_plan(28, 512).tile == 128
    for G, resident in ((1, 16), (3, 16), (40, 16), (1, 1), (2, 132)):
        assert 1 <= ktrain.clusters_per_run(C, G, resident) <= n


@pytest.mark.parametrize("resident", [0, 1, 8, 16, 17, 132])
def test_one_cluster_a_run_within_a_part_or_on_a_full_card(resident):
    for G in (1, 2, 16, 40):
        assert ktrain.clusters_per_run(100, G, resident) == 1
        assert ktrain.clusters_per_run(128, G, resident) == 1
        if G >= resident:
            for C in (129, 232, 1904, 8192):
                assert ktrain.clusters_per_run(C, G, resident) == 1


@pytest.mark.parametrize("G", [1, 2, 3, 5, 8, 16])
def test_the_runs_never_take_more_clusters_than_the_card_holds(G):
    for resident in (1, 7, 16, 31, 132):
        for C in range(1, 8193, 97):
            P = ktrain.clusters_per_run(C, G, resident)
            assert P <= ktrain.parts(C)
            assert P <= max(1, resident // G)
            assert G * P <= resident or P == 1
            # as many as fit, up to one a part
            assert P == ktrain.parts(C) or P == max(1, resident // G)


def test_k4_at_train_real_spreads_over_the_card():
    """train-real's 1,904 cells are 15 parts: one run on a card holding 16
    clusters spreads over 15 of them; 16 runs keep one each."""
    assert ktrain.parts(1904) == 15
    assert ktrain.clusters_per_run(1904, 1, 16) == 15
    assert ktrain.clusters_per_run(1904, 2, 16) == 8
    assert ktrain.clusters_per_run(1904, 16, 16) == 1


@pytest.mark.parametrize("din,C,G", [(28, 1904, 1), (53, 1904, 1),
                                     (28, 232, 1), (28, 1904, 3)])
def test_k4_scratch_is_what_the_plan_says_and_made_once(recorder, din, C, G):
    """The wrapper hands the C entry a scratch of scratch_floats a run
    (a slab a part and the weight exchange) and two zeroed barrier words a
    run, made at the cells' first launch and reused by the next."""
    hidden = 512
    cells, W, state = _run_args(C, din, hidden, (G,) if G > 1 else ())
    ds = torch.full((G,), 0.01, dtype=torch.float64) if G > 1 else None
    for _ in range(2):
        ktrain._launch(cells, W, state, 5, HYPER, ds_grid=ds)
    (_, _, plan, a1), (_, _, _, a2) = _launches(recorder)
    (part, bar), = cells.scratch.values()
    plan = ktrain.TrainPlan(*plan)
    slab = 8 * (din + 26) * plan.slots + 32
    assert ktrain.scratch_floats(plan, din, C) == (ktrain.parts(C) + 1) * slab
    assert part.numel() == G * ktrain.scratch_floats(plan, din, C)
    assert part.dtype == torch.float32
    assert bar.dtype == torch.int32 and bar.numel() == 2 * G
    assert not bar.any()
    assert a1.part == a2.part == part.data_ptr()
    assert a1.bar == a2.bar == bar.data_ptr()


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
