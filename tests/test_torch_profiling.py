"""The port's spans and counters (utils/profiling.py): nothing recorded and
no torch operation with no profiler running, the hot paths' spans nested
in time under torch.profiler (CPU), in its Chrome trace as
user_annotation events, the record's bound and counters of tensors."""
import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

import knode_cosserat_tpu_torch as K
from knode_cosserat_tpu_torch.core.fast_rollout import make_fast_rollout
from knode_cosserat_tpu_torch.evaluation.tables import _mega_rollouts
from knode_cosserat_tpu_torch.models.mlp import MLPSpec, init_mlp
from knode_cosserat_tpu_torch.ops import step as kstep
from knode_cosserat_tpu_torch.serving import CompiledStepper
from knode_cosserat_tpu_torch.training.train import TrainConfig, train_knode
from knode_cosserat_tpu_torch.utils import profiling as P

torch.set_num_threads(1)

STEPS, RODS, T, EPOCHS, CHUNK = 3, 2, 4, 5, 2
CHUNKS = (EPOCHS + 1 + CHUNK - 1) // CHUNK


@pytest.fixture(scope="module")
def case():
    dev = torch.device("cpu")
    p = K.experimental_rod("nsw", N=6, dtype=torch.float32, device=dev)
    spec = MLPSpec.for_knode(16)
    net = init_mlp(spec, torch.Generator().manual_seed(0), torch.float32,
                   dev)
    g = torch.Generator().manual_seed(1)
    trajs = torch.zeros(2, 5, 6, 25)
    trajs[..., 3] = 1.0
    trajs = trajs + 0.01 * torch.randn(trajs.shape, generator=g)
    ctls = 1.0 + torch.rand(2, 5, 4, generator=g)
    return p, spec, net, trajs, ctls


def serve(case):
    p, spec, net, _, _ = case
    st = CompiledStepper(p, spec, net, fast=True, fast_impl="mega")
    s = st.reset()
    for _ in range(STEPS):
        s, _ = st.step(s, torch.full((4,), 5.0))


def rollout(case):
    p, spec, net, _, _ = case
    make_fast_rollout(p, spec, impl="mega")(torch.full((RODS, T, 4), 5.0),
                                            net)


def train(case):
    p, _, _, trajs, ctls = case
    cfg = TrainConfig(epochs=EPOCHS, hidden=16, fused="on", dtype="float32",
                      log_every=CHUNK, keypoints=(1, 3, 5))
    train_knode(p, trajs, ctls, cfg, log=None)


def eval_rollouts(case):
    p, spec, net, _, _ = case
    _mega_rollouts(p, spec, [net, net], torch.full((T, 4), 5.0))


PATHS = {"serve": serve, "rollout": rollout, "train": train,
         "eval": eval_rollouts}


@pytest.fixture(autouse=True)
def empty_record():
    P.drain()
    yield
    P.drain()


def _refuse(*a, **k):
    raise AssertionError("a record function entered with no profiler "
                         "running")


class Ops(TorchDispatchMode):
    """The torch operations dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


def test_annotate_without_a_profiler_is_one_shared_null_context(monkeypatch):
    monkeypatch.setattr(P, "_enter", _refuse)
    t = torch.ones(3)
    with Ops() as ops:
        a, b = P.annotate("x"), P.annotate("y")
        with a:
            with b:
                P.count("c", t)
                P.new_call()
    assert a is b and ops.seen == []
    rec = P.drain()
    assert rec.spans == [] and rec.counts == [] and rec.dropped == 0
    with Ops() as ops:           # the mode sees what does dispatch
        t + 1
    assert ops.seen == ["aten.add.Tensor"]


@pytest.mark.parametrize("path", sorted(PATHS))
def test_hot_paths_record_nothing_without_a_profiler(case, monkeypatch,
                                                     path):
    monkeypatch.setattr(P, "_enter", _refuse)
    PATHS[path](case)
    rec = P.drain()
    assert rec.spans == [] and rec.counts == [] and rec.dropped == 0


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    rec = P.drain()
    assert rec.dropped == 0
    for s in rec.spans:      # every span inside its parent, in time
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            up = rec.spans[s.parent]
            assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns
    return rec


def _names(rec, parent=None):
    return [s.name for s in rec.spans
            if parent is None or s.parent == parent]


def test_a_served_step_records_its_span_its_launch_and_counters(case):
    rec = _profiled(lambda: serve(case))
    steps = [i for i, s in enumerate(rec.spans) if s.name == "serve.step"]
    assert len(steps) == STEPS
    for i in steps:
        assert rec.spans[i].parent == -1
        assert _names(rec, i) == ["k2.launch"]
    assert len({rec.spans[i].call for i in steps}) == STEPS
    total = lambda n: sum(v for m, _, v in rec.counts if m == n)
    assert total("k2.rod_steps") == STEPS
    assert total("k2.newton_iters") >= STEPS


def test_a_rollout_records_a_step_span_and_a_launch_a_step(case):
    rec = _profiled(lambda: rollout(case))
    steps = [i for i, s in enumerate(rec.spans) if s.name == "rollout.step"]
    assert len(steps) == T - 1
    assert all(_names(rec, i) == ["k2.launch"] for i in steps)
    assert len({s.call for s in rec.spans}) == 1
    assert sum(v for m, _, v in rec.counts if m == "k2.rod_steps") == \
        RODS * (T - 1)


def test_train_knode_records_a_chunk_span_a_chunk(case):
    rec = _profiled(lambda: train(case))
    chunks = [i for i, s in enumerate(rec.spans) if s.name == "train.chunk"]
    assert len(chunks) == CHUNKS
    for k, i in enumerate(chunks):
        assert rec.spans[i].parent == -1
        # the cells are built in the first chunk; the losses are read back
        # in the last, for the return
        assert _names(rec, i) == (["k4.cells"] * (k == 0) + ["k4.launch"]
                                  + ["train.wait"] * (k == CHUNKS - 1))
        # on a CPU rod K4's wrapper runs its plain version, which pours the
        # state into its own optimizer
        launch = next(j for j, s in enumerate(rec.spans)
                      if s.parent == i and s.name == "k4.launch")
        assert _names(rec, launch) == ["train.wait"]
    assert len({s.call for s in rec.spans}) == 1


@pytest.mark.parametrize("checkpoint_every, readbacks", [
    (None, 1),
    # checkpoints after epochs 4 and 6 (chunks end at 2, 4, 6): the losses
    # and the optimizer's state read back for each, nothing left at the end
    (3, 4)])
def test_train_knode_builds_the_cells_once_and_reads_back_where_needed(
        case, tmp_path, checkpoint_every, readbacks):
    p, _, _, trajs, ctls = case
    kw = {} if checkpoint_every is None else dict(
        checkpoint_every=checkpoint_every)
    cfg = TrainConfig(epochs=EPOCHS, hidden=16, fused="on", dtype="float32",
                      log_every=CHUNK, keypoints=(1, 3, 5), **kw)
    rec = _profiled(lambda: train_knode(
        p, trajs, ctls, cfg, log=None,
        checkpoint_path=checkpoint_every and str(tmp_path / "ck")))
    total = lambda n: sum(v for m, _, v in rec.counts if m == n)
    assert total("train.cells_built") == 1
    assert total("train.readbacks") == readbacks


def test_the_chrome_trace_holds_the_spans_as_user_annotations(case,
                                                              tmp_path):
    with P.trace(str(tmp_path)):
        serve(case)
        rollout(case)
    (name,) = os.listdir(tmp_path)
    events = json.loads((tmp_path / name).read_text())["traceEvents"]
    marked = {e["name"] for e in events
              if e.get("cat", "").lower() == "user_annotation"}
    assert {"serve.step", "rollout.step", "k2.launch"} <= marked
    assert len(P.drain().spans) == 2 * STEPS + 2 * (T - 1)


def test_the_record_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(P, "LIMIT", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        with P.annotate("a"):
            with P.annotate("b"):
                pass
            with P.annotate("c"):
                with P.annotate("d"):
                    pass
            for _ in range(4):
                P.count("n", 1)
        with P.annotate("e"):
            pass
    rec = P.drain()
    assert [(s.name, s.parent) for s in rec.spans] == [
        ("a", -1), ("b", 0), ("c", 0)]
    assert len(rec.counts) == 3 and rec.dropped == 2 + 1
    assert P.drain() == P.Record([], [], 0)


def test_counters_keep_tensors_and_sum_them_when_read():
    ones = torch.ones(4, dtype=torch.int32)
    with profile(activities=[ProfilerActivity.CPU]):
        P.count("iters", ones)
        P.count("iters", 2 * ones)
        P.count("rods", 4)
        kept = P._counts[0][2]
    assert kept is ones          # no device operation while recording
    rec = P.drain()
    sums = {}
    for name, _, v in rec.counts:
        sums[name] = sums.get(name, 0.0) + v
    assert sums == {"iters": 12.0, "rods": 4.0}
    assert all(isinstance(v, float) for _, _, v in rec.counts)


def test_new_call_numbers_the_spans_calls_and_drain_ends_open_spans():
    with profile(activities=[ProfilerActivity.CPU]):
        P.new_call()
        with P.annotate("one"):
            pass
        P.new_call()
        with P.annotate("two"):
            rec = P.drain()          # read while "two" is open
            with P.annotate("three"):
                pass
    one, two = rec.spans
    assert two.call == one.call + 1 and two.end_ns >= two.start_ns
    (three,) = P.drain().spans
    assert three.parent == -1 and three.call == two.call


def test_the_eval_records_its_stacking_of_the_nets(case):
    rec = _profiled(lambda: eval_rollouts(case))
    assert _names(rec, -1)[0] == "eval.stack"
    assert _names(rec, -1).count("eval.stack") == 1
    assert _names(rec, -1).count("rollout.step") == T - 1


def _k2_case(case, far):
    """A float64 K2 step of 5 rods on the CPU (its plain version); from a far
    start the line search also runs its tile of the other candidates."""
    p, spec, _, _, _ = case
    p = p.to(dtype=torch.float64)
    net = init_mlp(spec, torch.Generator().manual_seed(3), torch.float64,
                   torch.device("cpu"))
    g = torch.Generator().manual_seed(4)
    G = (3.0 if far else 0.0) * torch.randn(5, 6, generator=g,
                                            dtype=torch.float64)
    yh = 1e-3 * torch.randn(5, p.N, 19, generator=g, dtype=torch.float64)
    zh = 1e-3 * torch.randn(5, p.N, 6, generator=g, dtype=torch.float64)
    tf = torch.randn(5, 3, generator=g, dtype=torch.float64)
    return p, spec, net, (G, yh, zh, tf)


@pytest.mark.parametrize("method", ["euler", "rk4"])
@pytest.mark.parametrize("far", [False, True])
def test_k2_counts_the_sweeps_of_its_plain_twin(case, method, far):
    """Under a profiler K2's wrapper counts ``k2.sweeps``: on the CPU its
    plain version fills the buffer, and the count is the twin's own on the
    same inputs. Rod by rod it is the first residual, 6 probes and alpha =
    1 an iteration, a tile of the 6 other candidates for each iteration
    whose alpha = 1 did not improve, and the recording sweep."""
    p, spec, net, ins = _k2_case(case, far)
    fn = kstep.make_step_kernel(p, spec, tol=1e-18, max_iter=30,
                                method=method)
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn(*ins, net)
    rec = P.drain()
    counted = [v for n, _, v in rec.counts if n == "k2.sweeps"]
    sweeps = torch.zeros(5, dtype=torch.int32)
    want = kstep.step_reference(p, *ins, net, tol=1e-18, max_iter=30,
                                method=method, sweeps=sweeps)
    assert counted == [float(sweeps.sum())]
    for a, b in zip(out, want):
        assert torch.equal(a, b)
    extra = sweeps - 2 - 7 * want[4]
    assert bool((extra >= 0).all()) and bool((extra % 6 == 0).all())
    assert bool((extra > 0).any()) == far


def test_k2_makes_no_sweep_buffer_without_a_profiler(case, monkeypatch):
    p, spec, net, ins = _k2_case(case, False)
    seen = []
    orig = kstep.step_reference

    def spy(*a, **k):
        seen.append(a[10] if len(a) > 10 else k.get("sweeps"))
        return orig(*a, **k)
    monkeypatch.setattr(kstep, "step_reference", spy)
    kstep.make_step_kernel(p, spec, tol=1e-18)(*ins, net)
    assert seen == [None]
    rec = P.drain()
    assert rec.spans == [] and rec.counts == []


@pytest.fixture
def k4_library(monkeypatch):
    """K4's C entries on CPU tensors: each call recorded and answered 0,
    the occupancy query with 16 clusters."""
    import contextlib

    from knode_cosserat_tpu_torch.ops import _build
    from knode_cosserat_tpu_torch.ops import train as ktrain
    calls = []

    class Lib:
        def __getattr__(self, name):
            def call(*args):
                calls.append(name)
                if name == "knode_train_clusters":
                    args[-1]._obj.value = 16
                return 0
            return call
    monkeypatch.setattr(_build, "library", lambda: Lib())
    monkeypatch.setattr(ktrain, "_RESIDENT", {})
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: type("S", (), {"cuda_stream": 0})())
    return calls


def _k4_args(C, G):
    from knode_cosserat_tpu_torch.ops import train as ktrain
    lead = (G,) if G > 1 else ()
    g = torch.Generator().manual_seed(C)
    mk = lambda *shape: torch.randn(*lead, *shape, generator=g)
    cells = ktrain.Cells(mk(C, 28), mk(C, 19), mk(C, 6), mk(C, 19), mk(C, 6),
                         mk(C, 3), (1.0,) * 4, 0.01)
    W = [mk(64, 28), mk(64), mk(25, 64), mk(25)]
    state = {"moments": tuple(torch.zeros_like(w) for w in W
                              for _ in range(2)),
             "scalars": torch.zeros(*lead, 4)}
    ds = torch.full((G,), 0.01, dtype=torch.float64) if G > 1 else None
    return cells, W, state, ds


@pytest.mark.parametrize("C,G,want", [(1904, 1, 15), (232, 1, 2),
                                      (100, 1, 1), (1904, 3, 5),
                                      (1904, 40, 1)])
def test_k4_counts_the_clusters_of_each_launch(k4_library, C, G, want):
    """Under a profiler K4's and K5's wrapper counts ``k4.clusters``, the
    plan's clusters a run, once a launch; with no profiler, nothing."""
    from knode_cosserat_tpu_torch.ops import train as ktrain
    hyper = ktrain.TrainHyper(1e-3, 0.0, 0.5, 10, True)
    cells, W, state, ds = _k4_args(C, G)
    ktrain._launch(cells, W, state, 3, hyper, ds_grid=ds)
    assert P.drain().counts == []
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            ktrain._launch(cells, W, state, 3, hyper, ds_grid=ds)
    rec = P.drain()
    assert [(n, v) for n, _, v in rec.counts] == [("k4.clusters", want)] * 2
    assert want == ktrain.clusters_per_run(C, G, 16)
    launched = [n for n in k4_library if n.startswith("knode_train")
                and n != "knode_train_clusters"]
    assert len(launched) == 3
