"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips where no GPU is present. On a GPU machine:
    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest
(``--noconftest``: tests/conftest.py sets up JAX, which a GPU machine
need not have; this file imports only the port.)
(chip_smoke.py runs the same comparisons at the model's full width.)
"""
import numpy as np
import pytest
import torch

import knode_cosserat_tpu_torch as K
from knode_cosserat_tpu_torch.core.fast_rollout import make_fast_rollout
from knode_cosserat_tpu_torch.core.stepper import initial_state
from knode_cosserat_tpu_torch.ops import step as kstep
from knode_cosserat_tpu_torch.ops import sweep as ksweep
from knode_cosserat_tpu_torch.ops import train as ktrain

pytestmark = pytest.mark.cuda
TOL = {torch.float64: (1e-10, 1e-12), torch.float32: (1e-4, 1e-5)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def _inputs(p, B, seed, dev):
    g = np.random.RandomState(seed)
    y0, z0 = (a.cpu().double().numpy() for a in initial_state(p))
    y = y0 + 1e-3 * g.randn(B, p.N, 19)
    z = z0 + 1e-3 * g.randn(B, p.N, 6)
    c1, c2 = float(p.c1), float(p.c2)
    tf = (5 + 2 * g.rand(B, 4)) @ p.tendon_dirs.cpu().double().numpy()
    arrays = (0.05 * g.randn(B, 6), c1 * y + c2 * y0, c1 * z + c2 * z0, tf)
    return [torch.tensor(a, dtype=p.dtype, device=dev) for a in arrays]


def _net(history, dtype, dev, scale=1.0):
    spec = K.MLPSpec.for_knode(64, history=history)
    net = K.init_mlp(spec, torch.Generator().manual_seed(0), dtype, dev)
    with torch.no_grad():
        for t in net.parameters():
            t.mul_(scale)
    return spec, net


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("method", ["euler", "rk4"])
@pytest.mark.parametrize("history", [None, False, True])
def test_sweep_kernel_matches_plain(dev, dtype, method, history):
    p = K.experimental_rod(N=10, device=dev).to(dtype=dtype)
    G, yh, zh, tf = _inputs(p, 67, 0, dev)
    spec, net = (None, None) if history is None else _net(history, dtype, dev)
    before = ksweep.LAUNCHES
    with torch.no_grad():
        got = ksweep.make_sweep_kernel(p, spec, method=method)(G, yh, zh, tf, net)
        want = ksweep.sweep_reference(p, G, yh, zh, tf, net, method)
    torch.cuda.synchronize()
    assert ksweep.LAUNCHES == before + 1
    rtol, atol = TOL[dtype]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("history", [None, False])
def test_step_kernel_matches_plain(dev, dtype, history):
    p = K.experimental_rod(N=10, device=dev).to(dtype=dtype)
    G, yh, zh, tf = _inputs(p, 45, 1, dev)
    G = torch.zeros_like(G)
    spec, net = (None, None) if history is None else _net(history, dtype, dev,
                                                          1e-2)
    tol = 1e-18 if dtype == torch.float64 else 1e-13   # both to the floor
    with torch.no_grad():
        got = kstep.make_step_kernel(p, spec, tol=tol)(G, yh, zh, tf, net)
        want = kstep.step_reference(p, G, yh, zh, tf, net, tol=tol)
    torch.cuda.synchronize()
    if dtype == torch.float64:
        for a, b in zip(got[:4], want[:4]):
            torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-10)
    else:
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-4)
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-5)


# a rod's result does not depend on the batch: K2 runs one block per rod
# and K3 one warp per lane, and the net's sums run in an order fixed by
# the hidden width alone, so rod b alone == rod b of 256, bit for bit
@pytest.mark.parametrize("history", [None, False])
def test_step_kernel_rod_alone_equals_rod_in_batch(dev, history):
    p = K.experimental_rod(N=10, device=dev).to(dtype=torch.float32)
    G, yh, zh, tf = _inputs(p, 256, 4, dev)
    G = torch.zeros_like(G)
    spec, net = (None, None) if history is None else _net(
        history, torch.float32, dev, 1e-2)
    k = kstep.make_step_kernel(p, spec, tol=1e-10)
    with torch.no_grad():
        got = k(G, yh, zh, tf, net)
        for b in (0, 101, 255):
            alone = k(G[b:b + 1], yh[b:b + 1], zh[b:b + 1], tf[b:b + 1], net)
            for x, w in zip(got, alone):
                assert torch.equal(x[b:b + 1], w)


@pytest.mark.parametrize("history", [None, True])
def test_sweep_kernel_lane_alone_equals_lane_in_batch(dev, history):
    p = K.experimental_rod(N=10, device=dev).to(dtype=torch.float32)
    G, yh, zh, tf = _inputs(p, 256, 5, dev)
    spec, net = (None, None) if history is None else _net(
        history, torch.float32, dev)
    k = ksweep.make_sweep_kernel(p, spec, method="rk4")
    with torch.no_grad():
        got = k(G, yh, zh, tf, net)
        for b in (0, 130, 255):
            alone = k(G[b:b + 1], yh[b:b + 1], zh[b:b + 1], tf[b:b + 1], net)
            for x, w in zip(got, alone):
                assert torch.equal(x[b:b + 1], w)


# ragged hidden widths (the last tile of units masked), 53 inputs in
# float64, the net staged in shared memory or, with a budget of 0, read
# from global memory (the route float64 with 53 inputs takes at hidden 512)
@pytest.mark.parametrize("budget", [None, 0])
@pytest.mark.parametrize("hidden", [48, 100])
def test_step_kernel_ragged_hidden_matches_plain(dev, monkeypatch, hidden,
                                                 budget):
    if budget is not None:
        monkeypatch.setattr(ksweep, "SMEM_BUDGET", budget)
    dtype = torch.float64
    p = K.experimental_rod(N=10, device=dev).to(dtype=dtype)
    G, yh, zh, tf = _inputs(p, 45, 6, dev)
    G = torch.zeros_like(G)
    spec = K.MLPSpec.for_knode(hidden, history=True)
    net = K.init_mlp(spec, torch.Generator().manual_seed(1), dtype, dev)
    with torch.no_grad():
        for t in net.parameters():
            t.mul_(1e-2)
    assert kstep.launch_plan(dtype, 53, hidden, "euler").staged == (
        budget is None)
    with torch.no_grad():
        got = kstep.make_step_kernel(p, spec, tol=1e-18)(G, yh, zh, tf, net)
        want = kstep.step_reference(p, G, yh, zh, tf, net, tol=1e-18)
    torch.cuda.synchronize()
    for a, b in zip(got[:4], want[:4]):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-10)


def test_step_kernel_physics_rk4_matches_plain(dev):
    p = K.experimental_rod(N=10, device=dev).to(dtype=torch.float64)
    G, yh, zh, tf = _inputs(p, 45, 7, dev)
    G = torch.zeros_like(G)
    with torch.no_grad():
        got = kstep.make_step_kernel(p, None, tol=1e-18, method="rk4")(
            G, yh, zh, tf)
        want = kstep.step_reference(p, G, yh, zh, tf, tol=1e-18,
                                    method="rk4")
    torch.cuda.synchronize()
    for a, b in zip(got[:4], want[:4]):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-10)


# K2 with the KNODE net of 28 inputs and hidden 512 and the RK4 sweep
# (node_step<RK4=true>: four net calls a node): float64 at N=10 to the f64
# step tolerances, float32 at N=40 (the sim-nsw-h512-rk4n40 rod) to the f32
# ones. In float64 the kernel and its plain version take the same path, so
# their sweep counts agree rod for rod (from a far start too, where the
# line search runs its tile of the other candidates).
@pytest.mark.parametrize("dtype,N,start", [(torch.float64, 10, 0.0),
                                           (torch.float64, 10, 3.0),
                                           (torch.float32, 40, 0.0)])
def test_step_kernel_hybrid_rk4_matches_plain(dev, dtype, N, start):
    p = K.experimental_rod("nsw", N=N, device=dev).to(dtype=dtype)
    G, yh, zh, tf = _inputs(p, 24, 12, dev)
    G = start * G
    spec = K.MLPSpec.for_knode(512)
    net = K.init_mlp(spec, torch.Generator().manual_seed(2), dtype, dev)
    with torch.no_grad():
        for t in net.parameters():
            t.mul_(1e-3)
    f64 = dtype == torch.float64
    tol = 1e-18 if f64 else 1e-13   # both to the floor
    got_sw = torch.empty(24, dtype=torch.int32, device=dev)
    want_sw = torch.zeros(24, dtype=torch.int32, device=dev)
    with torch.no_grad():
        got = kstep._launch(p, ksweep.rod_consts(p), spec, tol, 30, 7, "rk4",
                            G, yh, zh, tf, net, got_sw)
        want = kstep.step_reference(p, G, yh, zh, tf, net, tol=tol,
                                    method="rk4", sweeps=want_sw)
    torch.cuda.synchronize()
    if f64:
        solved = want[3] <= 1e-18
        for a, b in zip(got[:4], want[:4]):
            torch.testing.assert_close(a[solved], b[solved], rtol=1e-9,
                                       atol=1e-10)
        assert torch.equal(got_sw[solved], want_sw[solved])
        assert bool((got[3][~solved] > 1e-18).all())
    else:
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-4)
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-5)
        assert bool((got_sw >= 2 + 7 * got[4]).all())


def test_step_kernel_counts_sweeps_only_under_a_profiler(dev):
    """The wrapper hands K2 a sweep buffer only while a profiler runs; the
    counter then sums the plain version's counts on the same inputs."""
    from torch.profiler import ProfilerActivity, profile

    from knode_cosserat_tpu_torch.utils import profiling as P
    p = K.experimental_rod("nsw", N=10, device=dev).to(dtype=torch.float64)
    G, yh, zh, tf = _inputs(p, 16, 13, dev)
    G = torch.zeros_like(G)
    spec, net = _net(False, torch.float64, dev, 1e-2)
    fn = kstep.make_step_kernel(p, spec, tol=1e-18, method="rk4")
    P.drain()
    with torch.no_grad():
        fn(G, yh, zh, tf, net)
        assert P.drain().counts == []
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            fn(G, yh, zh, tf, net)
        want_sw = torch.zeros(16, dtype=torch.int32, device=dev)
        kstep.step_reference(p, G, yh, zh, tf, net, tol=1e-18, method="rk4",
                             sweeps=want_sw)
    counted = [v for n, _, v in P.drain().counts if n == "k2.sweeps"]
    assert counted == [float(want_sw.sum())]


def test_step_kernel_far_start_matches_plain(dev):
    """From a far start alpha = 1 often fails, so the line search runs its
    second tile (the other candidates at once): each rod the plain version
    solves, the kernel solves to the same root, to the f64 step
    tolerances. A rod that stalls (its escalations spent) stops where
    rounding led it, so for it the test asks only that the kernel stall
    too."""
    p = K.experimental_rod(N=10, device=dev).to(dtype=torch.float64)
    G, yh, zh, tf = _inputs(p, 20, 8, dev)
    G = 30 * G                                # far: alpha = 1 often fails
    spec, net = _net(False, torch.float64, dev, 1e-2)
    with torch.no_grad():
        got = kstep.make_step_kernel(p, spec, tol=1e-18)(G, yh, zh, tf, net)
        want = kstep.step_reference(p, G, yh, zh, tf, net, tol=1e-18)
    solved = want[3] <= 1e-18
    assert bool((got[3][~solved] > 1e-18).all())
    for a, b in zip(got[:4], want[:4]):
        torch.testing.assert_close(a[solved], b[solved], rtol=1e-9,
                                   atol=1e-10)


def test_step_kernel_raises_when_the_card_refuses(dev, monkeypatch):
    """A plan the card cannot take (a 324 KB staged net: float64, 53
    inputs, hidden 512) raises; nothing falls back."""
    monkeypatch.setattr(ksweep, "SMEM_BUDGET", 1 << 20)
    p = K.experimental_rod(N=10, device=dev).to(dtype=torch.float64)
    spec = K.MLPSpec.for_knode(512, history=True)
    net = K.init_mlp(spec, torch.Generator().manual_seed(0), torch.float64,
                     dev)
    G, yh, zh, tf = _inputs(p, 2, 9, dev)
    before = kstep.LAUNCHES
    with torch.no_grad(), pytest.raises(RuntimeError):
        kstep.make_step_kernel(p, spec)(G, yh, zh, tf, net)
    with torch.no_grad(), pytest.raises(RuntimeError):
        ksweep.make_sweep_kernel(p, spec)(G, yh, zh, tf, net)
    assert kstep.LAUNCHES == before


def test_deeper_net_raises_on_cuda(dev):
    """Nets of any depth up to ops/sweep.py's MAX_LAYERS run on the kernels
    (the deep-net tests below); a deeper one raises before a launch."""
    p = K.experimental_rod(device=dev).to(dtype=torch.float32)
    spec = K.MLPSpec(dims=(28,) + (16,) * ksweep.MAX_LAYERS + (25,))
    net = K.init_mlp(spec, torch.Generator().manual_seed(0), torch.float32, dev)
    G, yh, zh, tf = _inputs(p, 4, 2, dev)
    before = ksweep.LAUNCHES
    with pytest.raises(ValueError, match="at most"):
        ksweep.make_sweep_kernel(p, spec)(G, yh, zh, tf, net)
    assert ksweep.LAUNCHES == before


# nets of three layers and more: the JAX package's deep kernel tests'
# shapes (tests/test_pallas_kernels.py:26-32) and the 512-wide middle
# layers that no block can stage
DEEP = [((28, 32, 32, 25), "elu"), ((53, 16, 16, 16, 25), "tanh"),
        ((28, 512, 512, 25), "elu"), ((53, 512, 512, 512, 25), "tanh")]


def _deep(dims, act, dtype, dev, scale=1.0, seed=0):
    spec = K.MLPSpec(dims=dims, activation=act, history=dims[0] == 53)
    net = K.init_mlp(spec, torch.Generator().manual_seed(seed), dtype, dev)
    with torch.no_grad():
        for t in net.parameters():
            t.mul_(scale)
    return spec, net


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("method", ["euler", "rk4"])
@pytest.mark.parametrize("dims,act", DEEP)
def test_sweep_kernel_deep_net_matches_plain(dev, dtype, method, dims, act):
    p = K.experimental_rod(N=10, device=dev).to(dtype=dtype)
    G, yh, zh, tf = _inputs(p, 67, 0, dev)
    spec, net = _deep(dims, act, dtype, dev, 0.1)
    before = ksweep.LAUNCHES
    with torch.no_grad():
        got = ksweep.make_sweep_kernel(p, spec, method=method)(G, yh, zh, tf,
                                                               net)
        want = ksweep.sweep_reference(p, G, yh, zh, tf, net, method)
    torch.cuda.synchronize()
    assert ksweep.LAUNCHES == before + 1
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=TOL[dtype][0],
                                   atol=TOL[dtype][1])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("dims,act", DEEP)
def test_step_kernel_deep_net_matches_plain(dev, dtype, dims, act):
    p = K.experimental_rod(N=10, device=dev).to(dtype=dtype)
    G, yh, zh, tf = _inputs(p, 45, 1, dev)
    G = torch.zeros_like(G)
    spec, net = _deep(dims, act, dtype, dev, 1e-2)
    tol = 1e-18 if dtype == torch.float64 else 1e-13   # both to the floor
    before = kstep.LAUNCHES
    with torch.no_grad():
        got = kstep.make_step_kernel(p, spec, tol=tol)(G, yh, zh, tf, net)
        want = kstep.step_reference(p, G, yh, zh, tf, net, tol=tol)
    torch.cuda.synchronize()
    assert kstep.LAUNCHES == before + 1
    if dtype == torch.float64:
        for a, b in zip(got[:4], want[:4]):
            torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-10)
    else:
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-4)
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-5)


@pytest.mark.parametrize("dims,act", DEEP[:2])
def test_step_kernel_deep_per_rod_nets_match_single_net_launches(dev, dims,
                                                                 act):
    from knode_cosserat_tpu_torch.models.mlp import StackedMLP
    p = K.experimental_rod(N=10, device=dev).to(dtype=torch.float32)
    G, yh, zh, tf = _inputs(p, 3, 4, dev)
    G = torch.zeros_like(G)
    nets = [_deep(dims, act, torch.float32, dev, 1e-2, seed=g)[1]
            for g in range(3)]
    k = kstep.make_step_kernel(p, nets[0].spec, tol=1e-13)
    with torch.no_grad():
        got = k(G, yh, zh, tf, StackedMLP(nets))
        singles = [k(G[b:b + 1], yh[b:b + 1], zh[b:b + 1], tf[b:b + 1],
                     nets[b]) for b in range(3)]
    for b in range(3):
        for x, w in zip(got, singles[b]):
            assert torch.equal(x[b:b + 1], w)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("dims,act", DEEP)
def test_next_segment_kernel_deep_net_matches_plain(dev, dtype, dims, act):
    from knode_cosserat_tpu_torch.ops import next_segment as kseg
    p = K.apply_mod("nsw", dtype=dtype, device=dev)
    spec, net = _deep(dims, act, dtype, dev)
    g = np.random.RandomState(3)
    B = 300
    G, yh, zh, tf = _inputs(K.experimental_rod(N=10, device=dev).to(
        dtype=dtype), B, 3, dev)
    y = yh[:, 4] + torch.tensor(1e-3 * g.randn(B, 19), dtype=dtype,
                                device=dev)
    cells = (y.contiguous(), yh[:, 3].contiguous(), zh[:, 3].contiguous(),
             tf.contiguous())
    W = [t for wb in net.weights() for t in wb]
    before = kseg.LAUNCHES
    with torch.no_grad():
        got = kseg.make_fused_next_segment(p, spec)(net, *cells)
        want = kseg.next_segment_reference(p, spec, *cells, *W)
    torch.cuda.synchronize()
    assert kseg.LAUNCHES == before + 1
    tol = {torch.float64: (1e-12, 1e-12), torch.float32: (1e-5, 1e-5)}[dtype]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=tol[0], atol=tol[1])


def test_mega_rollout_matches_plain(dev):
    p = K.experimental_rod(N=10, dtype=torch.float32, device=dev)
    spec, net = _net(False, torch.float32, dev, 1e-3)
    ctl = torch.tensor(np.stack([K.calc_controls("sine", 0.5 + i / 8, 0.05, 12)
                                 for i in range(8)]), device=dev)
    # both solvers run to the f32 floor: at tol=1e-10 each stops at its own
    # point inside |r| <= 1e-5, and the states differ by more than 1e-4
    traj, _, _ = make_fast_rollout(p, spec, tol=1e-13, impl="mega")(ctl, net)
    ref, _, _ = make_fast_rollout(p, spec, tol=1e-13, impl="plain",
                                  fd_order=1)(ctl, net)
    torch.testing.assert_close(traj, ref, rtol=1e-4, atol=1e-4)


def _train_case(dev, history=False, **cfg_kw):
    ref = K.apply_mod(None, device=dev)
    trajs, ctls = K.make_training_data(ref, [("sine", 0.5), ("sine", 1.0)],
                                       train_len=8)
    cfg = K.TrainConfig(hidden=64, history=history, **cfg_kw)
    p = K.apply_mod("nsw", dtype=torch.float32, device=dev)
    net = K.init_mlp(cfg.spec(), torch.Generator().manual_seed(0),
                     torch.float32, dev)
    return p, cfg, net, trajs.float(), ctls.float()


# K4 against its plain version: the tolerances of the JAX package's own
# fused-vs-scan tests (tests/test_pallas_train.py): both run float32 and
# sum in different orders
@pytest.mark.parametrize("case", [dict(), dict(weight_decay=1e-4),
                                  dict(plateau_patience=4),
                                  dict(history=True)])
def test_train_kernel_matches_plain(dev, case):
    p, cfg, net, trajs, ctls = _train_case(dev, **case)
    before = ktrain.LAUNCHES
    got = ktrain.make_fused_training_run(p, cfg.spec(), cfg, 30)(net, trajs,
                                                                 ctls)
    want = ktrain.make_fused_training_run(p, cfg.spec(), cfg, 30,
                                          plain=True)(net, trajs, ctls)
    torch.cuda.synchronize()
    assert ktrain.LAUNCHES == before + 1
    torch.testing.assert_close(got[1], want[1], rtol=2e-4, atol=1e-9)
    for a, b in zip(got[0].parameters(), want[0].parameters()):
        torch.testing.assert_close(a, b, rtol=3e-3, atol=3e-5)
    torch.testing.assert_close(got[2]["scalars"], want[2]["scalars"])


# ragged widths: block r of the cluster owns units [r U, r U + U), U =
# ceil(h / 8); at hidden 1 seven of the eight blocks own none
@pytest.mark.parametrize("hidden", [1, 48, 100])
def test_train_kernel_ragged_hidden_matches_plain(dev, hidden):
    p, cfg, _, trajs, ctls = _train_case(dev)
    cfg = K.TrainConfig(hidden=hidden)
    net = K.init_mlp(cfg.spec(), torch.Generator().manual_seed(0),
                     torch.float32, dev)
    before = ktrain.LAUNCHES
    got = ktrain.make_fused_training_run(p, cfg.spec(), cfg, 30)(net, trajs,
                                                                 ctls)
    want = ktrain.make_fused_training_run(p, cfg.spec(), cfg, 30,
                                          plain=True)(net, trajs, ctls)
    torch.cuda.synchronize()
    assert ktrain.LAUNCHES == before + 1
    torch.testing.assert_close(got[1], want[1], rtol=2e-4, atol=1e-9)
    for a, b in zip(got[0].parameters(), want[0].parameters()):
        torch.testing.assert_close(a, b, rtol=3e-3, atol=3e-5)
    torch.testing.assert_close(got[2]["scalars"], want[2]["scalars"])


def test_train_kernel_raises_when_the_card_refuses_the_cluster(dev,
                                                               monkeypatch):
    """A plan of 32-block clusters (beyond what any card takes) reaches the
    card and is refused: K4 and K5 raise a RuntimeError naming the CUDA
    error, count no launch and fall back to nothing."""
    from knode_cosserat_tpu_torch.models.mlp import StackedMLP
    monkeypatch.setattr(ktrain, "_CLUSTER", 32)
    assert ktrain.launch_plan(28, 64).cluster == 32
    p, cfg, net, trajs, ctls = _train_case(dev)
    k4, k5 = ktrain.LAUNCHES, ktrain.GRID_LAUNCHES
    with pytest.raises(RuntimeError, match=r"CUDA error \d+ \(cuda\w+\)"):
        ktrain.make_fused_training_run(p, cfg.spec(), cfg, 5)(net, trajs,
                                                              ctls)
    with pytest.raises(RuntimeError, match=r"CUDA error \d+ \(cuda\w+\)"):
        ktrain.make_fused_grid_training_run(cfg.spec(), cfg, 5)(
            [p, p], StackedMLP([net, net]), torch.stack([trajs] * 2),
            torch.stack([ctls] * 2))
    assert (ktrain.LAUNCHES, ktrain.GRID_LAUNCHES) == (k4, k5)
    # the card is left usable: the real plan launches again
    monkeypatch.undo()
    ktrain.make_fused_training_run(p, cfg.spec(), cfg, 5)(net, trajs, ctls)
    torch.cuda.synchronize()
    assert ktrain.LAUNCHES == k4 + 1


def test_train_kernel_chunks_compose(dev):
    p, cfg, net, trajs, ctls = _train_case(dev)
    run20 = ktrain.make_fused_training_run(p, cfg.spec(), cfg, 20)
    run10 = ktrain.make_fused_training_run(p, cfg.spec(), cfg, 10)
    whole, l20, _ = run20(net, trajs, ctls)
    mid, la, s = run10(net, trajs, ctls)
    end, lb, _ = run10(mid, trajs, ctls, s)
    torch.testing.assert_close(torch.cat([la, lb]), l20, rtol=1e-6, atol=0)
    for a, b in zip(end.parameters(), whole.parameters()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


def test_train_knode_runs_on_the_kernels(dev):
    p, cfg, _, trajs, ctls = _train_case(dev)
    cfg.epochs, cfg.eval_every, cfg.eval_len = 20, 10, 8
    vc, vt = K.make_validation_reference(K.apply_mod(None, device=dev),
                                         ("sine", 1.25), 8)
    k4, k2 = ktrain.LAUNCHES, kstep.LAUNCHES
    r = K.train_knode(p, trajs, ctls, cfg, vc, vt, log=None)
    assert ktrain.LAUNCHES - k4 == 3 and kstep.LAUNCHES > k2
    assert r.loss_history.shape == (21,) and np.isfinite(r.best_dtw)
    assert r.device == torch.cuda.get_device_name(dev)


# validation every 10 epochs with a log line every chunk; or a checkpoint
# after epochs 15 and 25 of chunks of 5, and no log
@pytest.mark.parametrize("fused", ["on", "wide"])
@pytest.mark.parametrize("case", [dict(eval_every=10, eval_len=8),
                                  dict(log_every=5, checkpoint_every=12)])
def test_train_knode_on_the_card_equals_the_chunk_by_chunk_chain(
        dev, fused, case, tmp_path, monkeypatch):
    """train_knode's fused run held on the card across its chunks (K4, or
    K6) == make_fused_training_run / make_wide_training_run composed chunk
    by chunk with the state poured through the optimizer, bit for bit:
    losses, net, validation DTWs, log lines and checkpoints."""
    from fused_chain import chained, flat
    from knode_cosserat_tpu_torch.training import checkpoint as kckpt
    p, cfg, _, trajs, ctls = _train_case(dev, fused=fused, epochs=24,
                                         **case)
    evals = ((None, None) if "eval_every" not in case else
             K.make_validation_reference(K.apply_mod(None, device=dev),
                                         ("sine", 1.25), 8))
    saved, lines = [], []
    monkeypatch.setattr(kckpt, "save_checkpoint",
                        lambda path, tree, meta: saved.append(
                            (meta["epoch"], tree)))
    ckpt = str(tmp_path / "ck") if "checkpoint_every" in case else None
    r = K.train_knode(p, trajs, ctls, cfg, *evals, checkpoint_path=ckpt,
                      log=lines.append if ckpt is None else None)
    hist, net, dtws, want_lines, want_saved = chained(
        p, trajs, ctls, cfg, *evals, checkpoint=ckpt is not None)
    np.testing.assert_array_equal(r.loss_history, np.asarray(hist))
    for a, b in zip(r.params.parameters(), net.parameters()):
        assert torch.equal(a, b)
    assert r.dtw_history == dtws
    if ckpt is None:
        assert len(dtws) == 3 and lines == want_lines
    else:
        assert [e for e, _ in saved] == [e for e, _ in want_saved] == [15, 25]
        for (_, got), (_, want) in zip(saved, want_saved):
            (s1, l1), (s2, l2) = flat(got), flat(want)
            assert s1 == s2
            for a, b in zip(l1, l2):
                np.testing.assert_array_equal(a, b)


# hidden 512 x 10 rods: the multitrain eval's launch (10 cells of a mod)
@pytest.mark.parametrize("hidden,rods", [(64, 5), (512, 10)])
def test_step_kernel_per_rod_nets_match_single_net_launches(dev, hidden,
                                                            rods):
    """K2 with one net per rod (the eval tables' stacked cells) == one
    single-net launch per rod, bit for bit."""
    from knode_cosserat_tpu_torch.models.mlp import StackedMLP
    p = K.experimental_rod(N=10, device=dev).to(dtype=torch.float32)
    G, yh, zh, tf = _inputs(p, rods, 3, dev)
    G = torch.zeros_like(G)
    spec = K.MLPSpec.for_knode(hidden)
    nets = [K.init_mlp(spec, torch.Generator().manual_seed(s), torch.float32,
                       dev) for s in range(rods)]
    for n in nets:
        with torch.no_grad():
            for t in n.parameters():
                t.mul_(1e-2)
    k = kstep.make_step_kernel(p, spec, tol=1e-10)
    before = kstep.LAUNCHES
    with torch.no_grad():
        got = k(G, yh, zh, tf, StackedMLP(nets))
        assert kstep.LAUNCHES == before + 1
        for b in range(rods):
            want = k(G[b:b + 1], yh[b:b + 1], zh[b:b + 1], tf[b:b + 1],
                     nets[b])
            for x, w in zip(got, want):
                assert torch.equal(x[b:b + 1], w)


def test_grid_kernel_matches_k4_bit_for_bit_and_plain(dev):
    """K5's cell g == a K4 launch on cell g (same rod, net, data), bit for
    bit; and K5 against its plain version at K4's tolerances."""
    from knode_cosserat_tpu_torch.models.mlp import StackedMLP
    _, cfg, _, trajs, ctls = _train_case(dev)
    mods = ["nsw", "short", "youngs", "nsw"]
    rods = [K.apply_mod(m, dtype=torch.float32, device=dev) for m in mods]
    nets = [K.init_mlp(cfg.spec(), torch.Generator().manual_seed(s),
                       torch.float32, dev) for s in range(len(mods))]
    tg, cg = torch.stack([trajs] * 4), torch.stack([ctls] * 4)
    before = ktrain.GRID_LAUNCHES
    pg, lg, sg = ktrain.make_fused_grid_training_run(cfg.spec(), cfg, 30)(
        rods, StackedMLP(nets), tg, cg)
    torch.cuda.synchronize()
    assert ktrain.GRID_LAUNCHES == before + 1
    for g, (rod, net) in enumerate(zip(rods, nets)):
        p1, l1, s1 = ktrain.make_fused_training_run(rod, cfg.spec(), cfg, 30)(
            net, trajs, ctls)
        assert torch.equal(lg[g], l1)
        for a, b in zip(pg.unstack()[g].parameters(), p1.parameters()):
            assert torch.equal(a, b)
        assert torch.equal(sg["scalars"][g], s1["scalars"])
    pp, lp, _ = ktrain.make_fused_grid_training_run(cfg.spec(), cfg, 30,
                                                    plain=True)(
        rods, StackedMLP(nets), tg, cg)
    torch.testing.assert_close(lg, lp, rtol=2e-4, atol=1e-9)
    for a, b in zip(pg.parameters(), pp.parameters()):
        torch.testing.assert_close(a, b, rtol=3e-3, atol=3e-5)


def test_grid_kernel_beyond_resident_clusters_equals_k4(dev):
    """K5 at 40 runs (more clusters than the card holds at once, so they
    run in waves) == 40 K4 launches, bit for bit."""
    from knode_cosserat_tpu_torch.models.mlp import StackedMLP
    _, cfg, _, trajs, ctls = _train_case(dev)
    G = 40
    spec = cfg.spec()
    assert G > ktrain.max_active_clusters(spec.dims[0], spec.dims[1], dev)
    mods = ["nsw", "short", "youngs", "lengthstiff"]
    rods = [K.apply_mod(mods[g % 4], dtype=torch.float32, device=dev)
            for g in range(G)]
    nets = [K.init_mlp(spec, torch.Generator().manual_seed(s), torch.float32,
                       dev) for s in range(G)]
    pg, lg, sg = ktrain.make_fused_grid_training_run(spec, cfg, 20)(
        rods, StackedMLP(nets), torch.stack([trajs] * G),
        torch.stack([ctls] * G))
    unstacked = pg.unstack()
    for g in range(G):
        p1, l1, s1 = ktrain.make_fused_training_run(rods[g], spec, cfg, 20)(
            nets[g], trajs, ctls)
        assert torch.equal(lg[g], l1)
        assert torch.equal(sg["scalars"][g], s1["scalars"])
        for a, b in zip(unstacked[g].parameters(), p1.parameters()):
            assert torch.equal(a, b)


def test_k4_spread_over_the_card_at_train_real_equals_one_cluster_a_run(
        dev):
    """train-real's shape (1,904 cells, 28 inputs, hidden 512, AdamW 0.1):
    K4 spreads the run over P > 1 clusters and equals, bit for bit, run 0 of
    a K5 grid that fills the card (one cluster a run); it matches its plain
    version at the K4 tolerances, repeats bit for bit, and counts its P
    under a profiler."""
    from torch.profiler import ProfilerActivity, profile

    from knode_cosserat_tpu_torch.models.mlp import StackedMLP
    from knode_cosserat_tpu_torch.training.loss import DEFAULT_KEYPOINTS_REAL
    from knode_cosserat_tpu_torch.utils import profiling as prof
    trajs, ctls = K.make_training_data(
        K.apply_mod(None, device=dev),
        [("sine", 0.5), ("sine", 1.0), ("sine", 1.25), ("sine", 1.5)],
        train_len=120)
    cfg = K.TrainConfig(hidden=512, weight_decay=0.1,
                        keypoints=DEFAULT_KEYPOINTS_REAL)
    spec = cfg.spec()
    p = K.apply_mod("nsw", dtype=torch.float32, device=dev)
    C = trajs.shape[0] * (trajs.shape[1] - 1) * len(cfg.keypoints)
    resident = ktrain.max_active_clusters(28, 512, dev)
    P = ktrain.clusters_per_run(C, 1, resident)
    G = max(resident, 2)
    assert C == 1904 and P > 1 and ktrain.clusters_per_run(C, G, resident) == 1
    nets = [K.init_mlp(spec, torch.Generator().manual_seed(s), torch.float32,
                       dev) for s in range(G)]
    run = ktrain.make_fused_training_run(p, spec, cfg, 30)
    got = run(nets[0], trajs, ctls)
    again = run(nets[0], trajs, ctls)
    pg, lg, sg = ktrain.make_fused_grid_training_run(spec, cfg, 30)(
        [p] * G, StackedMLP(nets), torch.stack([trajs] * G),
        torch.stack([ctls] * G))
    for losses, state, params in (
            (again[1], again[2], again[0].parameters()),
            (lg[0], {"moments": tuple(m[0] for m in sg["moments"]),
                     "scalars": sg["scalars"][0]},
             pg.unstack()[0].parameters())):
        assert torch.equal(losses, got[1])
        assert torch.equal(state["scalars"], got[2]["scalars"])
        for a, b in zip(state["moments"], got[2]["moments"]):
            assert torch.equal(a, b)
        for a, b in zip(params, got[0].parameters()):
            assert torch.equal(a, b)
    want = ktrain.make_fused_training_run(p, spec, cfg, 30, plain=True)(
        nets[0], trajs, ctls)
    torch.testing.assert_close(got[1], want[1], rtol=2e-4, atol=1e-9)
    for a, b in zip(got[0].parameters(), want[0].parameters()):
        torch.testing.assert_close(a, b, rtol=3e-3, atol=3e-5)
    prof.drain()
    with profile(activities=[ProfilerActivity.CUDA]):
        run(nets[0], trajs, ctls)
        torch.cuda.synchronize()
    rec = prof.drain()
    assert [v for n, _, v in rec.counts if n == "k4.clusters"] == [float(P)]


def _wide_case(dev, hidden, big):
    """hidden 640 on the small data, or the train-real shape (1,904 cells,
    53 inputs, AdamW 0.1) on random data made as the JAX bench makes it,
    plus the identity quaternion (chip_smoke.py::train_real_data: random
    quaternions put Euler angles at the loss's +-pi wrap, where two float32
    runs part)."""
    from knode_cosserat_tpu_torch.training.loss import DEFAULT_KEYPOINTS_REAL
    if not big:
        p, cfg, _, trajs, ctls = _train_case(dev)
        cfg = K.TrainConfig(hidden=hidden)
    else:
        p = K.apply_mod("nsw", dtype=torch.float32, device=dev)
        g = np.random.default_rng(0)
        trajs = torch.tensor(g.normal(size=(4, 120, p.N, 25)) * 0.01
                             + np.eye(1, 25, 3)[0], dtype=torch.float32,
                             device=dev)
        ctls = torch.tensor(g.uniform(1, 3, size=(4, 120, 4)),
                            dtype=torch.float32, device=dev)
        cfg = K.TrainConfig(hidden=hidden, history=True, weight_decay=0.1,
                            keypoints=DEFAULT_KEYPOINTS_REAL)
    net = K.init_mlp(cfg.spec(), torch.Generator().manual_seed(0),
                     torch.float32, dev)
    return p, cfg, net, trajs, ctls


# params: the JAX package's rtol 3e-3 / atol 3e-5 at hidden 640; at the
# train-real shape, chip_smoke.py's RANDOM_PARAM: Adam's step divides by the
# gradient's own size, so a weight whose gradient sums over the 1,904 cells
# to within a few eps of 0 carries that sum's rounding (another order in
# each version) into its step
@pytest.mark.parametrize("hidden,big,param_atol", [(640, False, 3e-5),
                                                   (8192, True, 2e-4)])
def test_wide_kernel_matches_plain(dev, hidden, big, param_atol):
    from knode_cosserat_tpu_torch.ops import train_wide as kwide
    p, cfg, net, trajs, ctls = _wide_case(dev, hidden, big)
    before = kwide.LAUNCHES
    got = kwide.make_wide_training_run(p, cfg.spec(), cfg, 20)(net, trajs,
                                                               ctls)
    want = kwide.make_wide_training_run(p, cfg.spec(), cfg, 20, plain=True)(
        net, trajs, ctls)
    torch.cuda.synchronize()
    assert kwide.LAUNCHES == before + 1
    torch.testing.assert_close(got[1], want[1], rtol=2e-4, atol=1e-9)
    for a, b in zip(got[0].parameters(), want[0].parameters()):
        torch.testing.assert_close(a, b, rtol=3e-3, atol=param_atol)
    torch.testing.assert_close(got[2]["scalars"], want[2]["scalars"])


def test_wide_kernel_chunks_compose(dev):
    from knode_cosserat_tpu_torch.ops import train_wide as kwide
    p, cfg, net, trajs, ctls = _wide_case(dev, 640, False)
    whole, l20, s20 = kwide.make_wide_training_run(p, cfg.spec(), cfg, 20)(
        net, trajs, ctls)
    run10 = kwide.make_wide_training_run(p, cfg.spec(), cfg, 10)
    mid, la, s = run10(net, trajs, ctls)
    end, lb, s2 = run10(mid, trajs, ctls, s)
    assert torch.equal(torch.cat([la, lb]), l20)
    for a, b in zip(end.parameters(), whole.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(s2["scalars"], s20["scalars"])


# hidden 64: one forward unit tile, ragged; 640: five tiles
@pytest.mark.parametrize("hidden", [64, 640])
def test_wide_kernel_narrow_matches_plain_and_composes(dev, hidden):
    from knode_cosserat_tpu_torch.ops import train_wide as kwide
    p, cfg, net, trajs, ctls = _wide_case(dev, hidden, False)
    run = lambda n, **kw: kwide.make_wide_training_run(p, cfg.spec(), cfg, n,
                                                       **kw)
    got = run(20)(net, trajs, ctls)
    want = run(20, plain=True)(net, trajs, ctls)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[1], want[1], rtol=2e-4, atol=1e-9)
    for a, b in zip(got[0].parameters(), want[0].parameters()):
        torch.testing.assert_close(a, b, rtol=3e-3, atol=3e-5)
    torch.testing.assert_close(got[2]["scalars"], want[2]["scalars"])
    mid, la, s = run(10)(net, trajs, ctls)
    end, lb, s2 = run(10)(mid, trajs, ctls, s)
    assert torch.equal(torch.cat([la, lb]), got[1])
    for a, b in zip(end.parameters(), got[0].parameters()):
        assert torch.equal(a, b)
    assert torch.equal(s2["scalars"], got[2]["scalars"])


def _assembly_step_inputs(asm, seed):
    """One coupled step from a perturbed history around the straight
    assembly: X0, yh, zh, tf, pph, vph, hph, wbh on the assembly's device."""
    from knode_cosserat_tpu_torch.core.assembly import AssemblyCarry
    g = np.random.RandomState(seed)
    kw = dict(dtype=asm.dtype, device=asm.device)
    rnd = lambda shape, s: s * torch.tensor(g.randn(*shape), **kw)
    carry = AssemblyCarry.initial(asm)
    p0 = asm.rods[0]
    c1, c2 = float(p0.c1), float(p0.c2)
    yh = c1 * (carry.y + rnd(carry.y.shape, 1e-3)) + c2 * carry.y
    zh = c1 * (carry.z + rnd(carry.z.shape, 1e-3)) + c2 * carry.z
    tf = torch.tensor((5 + 2 * g.rand(asm.M, 4))
                      @ p0.tendon_dirs.cpu().double().numpy(), **kw)
    X0 = torch.cat([torch.zeros(6 * asm.M, **kw), carry.pp, carry.hp])
    return (X0, yh, zh, tf, (c1 + c2) * carry.pp + rnd((3,), 1e-4),
            rnd((3,), 1e-3), (c1 + c2) * carry.hp + rnd((4,), 1e-4),
            rnd((3,), 1e-3))


# (M, N, bound on X and on y relative to its largest). At M = 9 the
# coupled Jacobian's condition number is ~1e7 (1.2e5 at M = 3), and the
# plain version alone moves X by 1.6e-9 when the tendon forces change by
# 1e-15 relative (CPU, float64): two solves that both stop at |r|^2 <=
# 1e-24 agree there to ~1e-9, not beyond
@pytest.mark.parametrize("M,N,tol", [(1, 6, 1e-9), (2, 6, 1e-9),
                                     (3, 10, 1e-9), (9, 10, 1e-8)])
def test_assembly_kernel_matches_plain(dev, M, N, tol):
    """K7 against its plain version, f64, both solved to 1e-24: X within
    tol, y within tol of its largest, the same iterations."""
    from knode_cosserat_tpu_torch.core.assembly import make_ring_assembly
    from knode_cosserat_tpu_torch.ops import assembly as kasm
    asm = make_ring_assembly(n_rods=M, base_radius=0.05, N=N, device=dev)
    ins = _assembly_step_inputs(asm, M)
    kasm.LAUNCHES = 0
    got = kasm.make_assembly_step_kernel(asm, tol=1e-24, max_iter=30)(*ins)
    want = kasm.assembly_step_reference(asm, *ins, tol=1e-24, max_iter=30)
    torch.cuda.synchronize()
    assert kasm.LAUNCHES == 1
    assert float((got[0] - want[0]).abs().max()) < tol
    assert float((got[1] - want[1]).abs().max()) < tol * float(
        want[1].abs().max())
    assert int(got[4]) == int(want[4])


def test_fused_assembly_rollout_runs_on_the_kernel(dev):
    """simulate_assembly(fused=True) at the JAX bench's assembly, f32: one
    K7 launch per step, finite plate poses, the plain rollout's plate
    within 1e-4."""
    from knode_cosserat_tpu_torch.controls import calc_controls
    from knode_cosserat_tpu_torch.core.assembly import (make_ring_assembly,
                                                        simulate_assembly)
    from knode_cosserat_tpu_torch.ops import assembly as kasm
    asm = make_ring_assembly(n_rods=3, base_radius=0.05, N=10,
                             dtype=torch.float32, device=dev)
    ctl = torch.tensor(np.stack([calc_controls("sine", a, 0.005, 6)
                                 for a in (0.7, 1.0, 1.3)], axis=1),
                       dtype=torch.float32, device=dev)
    kasm.LAUNCHES = 0
    out = simulate_assembly(asm, ctl, fused=True)
    assert kasm.LAUNCHES == 5 and bool(torch.isfinite(out.plate_pose).all())
    plain = simulate_assembly(asm, ctl)
    assert float((out.plate_pose - plain.plate_pose).abs().max()) < 1e-4


@pytest.mark.parametrize("seed", [9, 10, 11])
def test_assembly_kernel_f32_nine_rods_matches_plain(dev, seed):
    """K7 in f32 at M = 9 (the fused step's largest assembly) against the
    same wrapper on CPU tensors (its plain version), one step of two
    Newton iterations: the first stalls, the second is LM-damped and takes
    r2 from ~3 to ~1e-6. Equal iterations; the plate pose within 1e-6
    (the two differ by <= 4e-8; a kernel that reads the base tip for the
    -h probes, drops the LM term's 2h floor, skips one -h lane or sweeps a
    wrong candidate moves it by >= 1.4e-5, the kernel emulated on the CPU);
    G within 1% of its largest (<= 0.2%; the near-null direction of the
    rods' axial forces); r2 within 10x (<= 2.9x); y as the plain sweep at
    the kernel's own X. From the third iteration on, rounding decides where
    each stalls (PERF.md)."""
    from knode_cosserat_tpu_torch.core.assembly import (_sweep_all,
                                                        make_ring_assembly)
    from knode_cosserat_tpu_torch.ops import assembly as kasm
    M = 9
    asms = {d: make_ring_assembly(n_rods=M, base_radius=0.05, N=10,
                                  dtype=torch.float32, device=d)
            for d in ("cpu", dev)}
    ins = [t.float() for t in _assembly_step_inputs(
        make_ring_assembly(n_rods=M, base_radius=0.05, N=10, device="cpu"),
        seed)]
    kasm.LAUNCHES = 0
    got = kasm.make_assembly_step_kernel(asms[dev], max_iter=2)(
        *[t.to(dev) for t in ins])
    got = [t.cpu() for t in got]
    assert kasm.LAUNCHES == 1
    want = kasm.make_assembly_step_kernel(asms["cpu"], max_iter=2)(*ins)
    assert int(got[4]) == int(want[4]) == 2
    assert float((got[0][6 * M:] - want[0][6 * M:]).abs().max()) < 1e-6
    G = want[0][:6 * M]
    assert float((got[0][:6 * M] - G).abs().max()) < 1e-2 * float(
        G.abs().max())
    assert 0.1 < float(got[3]) / float(want[3]) < 10.0
    y, z = _sweep_all(asms["cpu"], got[0][:6 * M].reshape(M, 6), *ins[1:4],
                      None, False)
    assert torch.allclose(got[1], y, rtol=1e-5, atol=1e-6)
    assert torch.allclose(got[2], z, rtol=1e-5, atol=1e-6)


def test_assembly_kernel_just_under_the_48kb_default(dev):
    """K7 at M = 6, N = 10, f64: its 48,944 B plan and the kernel's
    static shared memory together pass the 48 KB a block gets by default,
    so the launch must raise the limit. Both solved to 1e-20 (at 1e-24
    these inputs straddle the stop test): the same iterations, X and y
    within 1e-7 (~1e-8 apart on the CPU emulation of the kernel)."""
    from knode_cosserat_tpu_torch.core.assembly import make_ring_assembly
    from knode_cosserat_tpu_torch.ops import assembly as kasm
    asm = make_ring_assembly(n_rods=6, base_radius=0.05, N=10, device=dev)
    assert 47 * 1024 < kasm.launch_plan(torch.float64, 6, 10).smem_bytes \
        <= 48 * 1024
    ins = _assembly_step_inputs(asm, 6)
    kasm.LAUNCHES = 0
    got = kasm.make_assembly_step_kernel(asm, tol=1e-20, max_iter=30)(*ins)
    want = kasm.assembly_step_reference(asm, *ins, tol=1e-20, max_iter=30)
    torch.cuda.synchronize()
    assert kasm.LAUNCHES == 1
    assert int(got[4]) == int(want[4])
    assert float((got[0] - want[0]).abs().max()) < 1e-7
    assert float((got[1] - want[1]).abs().max()) < 1e-7 * float(
        want[1].abs().max())


@pytest.mark.parametrize("M,N", [(1, 1127), (9, 99)])
def test_assembly_kernel_at_its_longest_rod(dev, M, N):
    """K7 at the longest rod its block holds (ops/assembly.py::launch_plan,
    f64) launches and agrees with its plain version: both solved to 1e-24,
    X and y within 1e-7 (at M = 9, N = 99 the plain version alone moves X
    by 1.7e-8 when the tendon forces change by 1e-15 relative, and its
    iterations by one: CPU, float64)."""
    from knode_cosserat_tpu_torch.core.assembly import make_ring_assembly
    from knode_cosserat_tpu_torch.ops import assembly as kasm
    asm = make_ring_assembly(n_rods=M, base_radius=0.05, N=N, device=dev)
    with pytest.raises(ValueError):
        kasm.launch_plan(torch.float64, M, N + 1)
    ins = _assembly_step_inputs(asm, M)
    kasm.LAUNCHES = 0
    got = kasm.make_assembly_step_kernel(asm, tol=1e-24, max_iter=30)(*ins)
    want = kasm.assembly_step_reference(asm, *ins, tol=1e-24, max_iter=30)
    torch.cuda.synchronize()
    assert kasm.LAUNCHES == 1
    assert float(got[3]) <= 1e-24
    assert abs(int(got[4]) - int(want[4])) <= 1
    assert float((got[0] - want[0]).abs().max()) < 1e-7
    assert float((got[1] - want[1]).abs().max()) < 1e-7 * float(
        want[1].abs().max())


def _batched_assembly_inputs(asm, seeds):
    """B systems' K7 inputs (_assembly_step_inputs at each seed), each
    stacked on a leading batch axis."""
    return [torch.stack(t) for t in
            zip(*(_assembly_step_inputs(asm, s) for s in seeds))]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_batched_assembly_kernel_is_single_launches(dev, dtype):
    """K7 over a grid of B = 5 blocks, one launch, against 5 launches of
    one system each: every output bit for bit (block b runs system b's
    own Newton loop on the same code)."""
    from knode_cosserat_tpu_torch.core.assembly import make_ring_assembly
    from knode_cosserat_tpu_torch.ops import assembly as kasm
    asm = make_ring_assembly(n_rods=3, base_radius=0.05, N=10, dtype=dtype,
                             device=dev)
    ins = _batched_assembly_inputs(asm, range(20, 25))
    k = kasm.make_assembly_step_kernel(asm, max_iter=30)
    kasm.LAUNCHES = 0
    got = k(*ins)
    torch.cuda.synchronize()
    assert kasm.LAUNCHES == 1
    assert got[0].shape == (5, 25) and got[4].shape == (5,)
    for b in range(5):
        one = k(*(t[b] for t in ins))
        for a, w in zip(got, one):
            assert torch.equal(a[b], w)
    assert kasm.LAUNCHES == 6


def test_batched_assembly_kernel_matches_batched_plain(dev):
    """One batched K7 launch against its batched plain version, f64, both
    solved to 1e-24, at chip_smoke's phase_k7 bars: X within 1e-9, y and
    z within 1e-9 of their largest, the same iterations per system."""
    from knode_cosserat_tpu_torch.core.assembly import make_ring_assembly
    from knode_cosserat_tpu_torch.ops import assembly as kasm
    asm = make_ring_assembly(n_rods=3, base_radius=0.05, N=10, device=dev)
    ins = _batched_assembly_inputs(asm, range(30, 35))
    got = kasm.make_assembly_step_kernel(asm, tol=1e-24, max_iter=30)(*ins)
    want = kasm.assembly_step_reference(asm, *ins, tol=1e-24, max_iter=30)
    torch.cuda.synchronize()
    assert float((got[0] - want[0]).abs().max()) < 1e-9
    for i in (1, 2):
        assert float((got[i] - want[i]).abs().max()) < 1e-9 * float(
            want[i].abs().max())
    assert torch.equal(got[4], want[4])


def _segment_cells(B, dtype, dev, seed=1):
    g = np.random.RandomState(seed)
    return [torch.tensor(a, dtype=dtype, device=dev) for a in (
        np.eye(1, 19, 3)[0] + 1e-2 * g.randn(B, 19),
        1e-2 * g.randn(B, 19), 1e-2 * g.randn(B, 6), g.randn(B, 3))]


@pytest.mark.parametrize("dtype,history,hidden", [
    (torch.float64, False, 64), (torch.float64, True, 64),
    (torch.float32, False, 64), (torch.float32, True, 64),
    (torch.float32, False, 100), (torch.float64, True, 100),
    (torch.float64, True, 512)])
def test_next_segment_kernel_matches_plain(dev, dtype, history, hidden):
    """K8 against its plain version on 300 cells: the staged net, a ragged
    hidden width (100), and float64 with 53 inputs at hidden 512, whose
    324 KB net is read from global memory."""
    from knode_cosserat_tpu_torch.ops import next_segment as kseg
    p = K.apply_mod("nsw", dtype=dtype, device=dev)
    spec = K.MLPSpec.for_knode(hidden, history=history)
    net = K.init_mlp(spec, torch.Generator().manual_seed(0), dtype, dev)
    assert kseg.launch_plan(dtype, spec.dims[0], hidden, 300).staged == (
        hidden != 512)
    cells = _segment_cells(300, dtype, dev)
    kseg.LAUNCHES = 0
    with torch.no_grad():
        got = kseg.make_fused_next_segment(p, spec)(net, *cells)
        want = kseg.next_segment_reference(p, spec, *cells, *[
            t for wb in net.weights() for t in wb])
    torch.cuda.synchronize()
    assert kseg.LAUNCHES == 1
    rtol, atol = TOL[dtype]
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_next_segment_cell_alone_equals_cell_in_batch(dev, dtype):
    """A cell's bits depend on the net and the warp alone: the same cell
    alone and inside batches of 31, 300 and 1,904 (other launch plans)."""
    from knode_cosserat_tpu_torch.ops import next_segment as kseg
    p = K.apply_mod("nsw", dtype=dtype, device=dev)
    spec = K.MLPSpec.for_knode(512)
    net = K.init_mlp(spec, torch.Generator().manual_seed(0), dtype, dev)
    fn = kseg.make_fused_next_segment(p, spec)
    cells = _segment_cells(1904, dtype, dev, seed=3)
    with torch.no_grad():
        alone = fn(net, *[c[17:18] for c in cells])
        for B in (31, 300, 1904):
            got = fn(net, *[c[:B] for c in cells])
            for a, b in zip(alone, got):
                assert torch.equal(a[0], b[17]), B


def test_next_segment_raises_when_the_card_refuses(dev, monkeypatch):
    """A plan the card cannot take (the 324 KB float64 53-input net at
    hidden 512 staged) raises; nothing falls back."""
    from knode_cosserat_tpu_torch.ops import next_segment as kseg
    monkeypatch.setattr(ksweep, "SMEM_BUDGET", 1 << 20)
    p = K.apply_mod("nsw", dtype=torch.float64, device=dev)
    spec = K.MLPSpec.for_knode(512, history=True)
    net = K.init_mlp(spec, torch.Generator().manual_seed(0), torch.float64,
                     dev)
    assert kseg.launch_plan(torch.float64, 53, 512, 8).staged
    before = kseg.LAUNCHES
    with torch.no_grad(), pytest.raises(RuntimeError):
        kseg.make_fused_next_segment(p, spec)(
            net, *_segment_cells(8, torch.float64, dev))
    assert kseg.LAUNCHES == before


def test_fused_train_step_runs_on_the_kernel(dev):
    """make_train_step(use_pallas=True) launches K8 once per step and
    tracks the plain step (f32, 5 steps, losses within rtol 1e-4)."""
    import copy

    from knode_cosserat_tpu_torch.ops import next_segment as kseg
    from knode_cosserat_tpu_torch.training.train import (make_optimizer,
                                                         make_train_step)
    cfg = K.TrainConfig(hidden=64)
    p = K.apply_mod("nsw", dtype=torch.float32, device=dev)
    trajs, ctls = K.make_training_data(K.apply_mod(None, device=dev),
                                       [("sine", 0.5)], train_len=8)
    trajs, ctls = trajs.float(), ctls.float()
    net = K.init_mlp(cfg.spec(), torch.Generator().manual_seed(0),
                     torch.float32, dev)
    losses = []
    for fused in (True, False):
        n = copy.deepcopy(net)
        step, _ = make_train_step(p, cfg.spec(), make_optimizer(cfg, n),
                                  cfg.keypoints, True, use_pallas=fused)
        kseg.LAUNCHES = 0
        losses.append(torch.stack([step(n, trajs, ctls) for _ in range(5)]))
        assert kseg.LAUNCHES == (5 if fused else 0)
    assert torch.allclose(losses[0], losses[1], rtol=1e-4, atol=0)


@pytest.mark.parametrize("hybrid", [False, True])
def test_planner_roots_run_on_k2(dev, hybrid):
    """make_planner on a CUDA rod: every forward root a K2 launch
    ((iterations + 2) x horizon, none in the implicit backward), the cost
    falls; in float64 the cost history through K2's roots equals the one
    through newton_solve's within rtol 1e-6."""
    from knode_cosserat_tpu_torch.control import mpc
    H, iters = 3, 3
    spec, net = _net(False, torch.float32, dev, 1e-3) if hybrid else (None,
                                                                      None)
    p = K.experimental_rod(N=6, dtype=torch.float32, device=dev)
    u = torch.tensor([[2.0, 3.0, 6.0, 1.0], [7.0, 4.0, 5.0, 1.5],
                      [12.0, 5.0, 4.0, 2.0]], device=dev)
    state = mpc.PlanState.initial(p)
    with torch.no_grad():
        target, _ = mpc.rollout_tips(p, state, u)
    kstep.LAUNCHES = 0
    r = mpc.make_planner(p, H, spec, opt_iters=iters, w_du=0.0)(
        state, target, nn_params=net)
    assert kstep.LAUNCHES == (iters + 2) * H
    assert float(r.cost) < float(r.cost_history[0])
    p64 = K.experimental_rod(N=6, device=dev)
    net64 = None
    if hybrid:
        net64 = K.init_mlp(spec, torch.Generator().manual_seed(0),
                           torch.float64, dev)
        net64.load_state_dict({k: v.double() for k, v in
                               net.state_dict().items()})
    a, b = (mpc.make_planner(p64, H, spec, opt_iters=2, tol=1e-20,
                             _root=root)(mpc.PlanState.initial(p64),
                                         target.double(), nn_params=net64)
            for root in ("k2", "newton"))
    np.testing.assert_allclose(a.cost_history.cpu().numpy(),
                               b.cost_history.cpu().numpy(), rtol=1e-6)


@pytest.mark.parametrize("history", [False, True])
def test_step_kernel_bf16_spec_computes_the_net_in_f32(dev, history):
    """A spec with compute_dtype="bfloat16": K2 computes the net in the
    weights' float32, as the JAX TPU kernel does, so it matches its plain
    version with the compute dtype dropped."""
    p = K.experimental_rod(N=10, dtype=torch.float32, device=dev)
    G, yh, zh, tf = _inputs(p, 45, 1, dev)
    G = torch.zeros_like(G)
    spec16 = K.MLPSpec.for_knode(64, history=history,
                                 compute_dtype="bfloat16")
    net16 = K.init_mlp(spec16, torch.Generator().manual_seed(0),
                       torch.float32, dev)
    with torch.no_grad():
        for t in net16.parameters():
            t.mul_(1e-2)
    spec, net = _net(history, torch.float32, dev, 1e-2)
    net.load_state_dict(net16.state_dict())
    with torch.no_grad():
        got = kstep.make_step_kernel(p, spec16, tol=1e-13)(G, yh, zh, tf,
                                                            net16)
        want = kstep.step_reference(p, G, yh, zh, tf, net, tol=1e-13)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-4)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-5)


def test_fine_rod_and_reference_solvers_on_the_card(dev):
    """simulate_scan_ms (structured and dense) and simulate_fsolve with the
    residual on the card, float64, against physics-only K2 rollouts."""
    from knode_cosserat_tpu_torch.controls import calc_controls
    from knode_cosserat_tpu_torch.core.multiple_shooting import \
        simulate_scan_ms
    from knode_cosserat_tpu_torch.core.reference_solver import \
        simulate_fsolve

    for N, S in ((13, 4), (10, None)):
        p = K.experimental_rod(N=N, dtype=torch.float64, device=dev)
        ctl = torch.tensor(calc_controls("sine", 1.0, float(p.del_t), 6),
                           dtype=torch.float64, device=dev)
        with torch.no_grad():
            ref = make_fast_rollout(p, None, tol=1e-20, impl="mega")(
                ctl[None])[0][0]
        if S is None:
            got = torch.from_numpy(simulate_fsolve(p, ctl.cpu().numpy()))
            rmse = float(((got - ref.cpu()) ** 2).mean().sqrt())
            assert rmse < 1e-7, rmse
            continue
        for solver in ("structured", "dense"):
            o = simulate_scan_ms(p, ctl, S, tol=1e-20, solver=solver)
            assert o.traj.device == ref.device
            rel = float((o.traj - ref).abs().max() / ref.abs().max())
            assert rel < 1e-9, (solver, rel)


@pytest.mark.parametrize("objective", ["teacher", "rollout"])
def test_batched_sysid_fit_equals_its_starts_solo_fits(dev, objective):
    """fit_rod_params(n_starts=3) on the card, float64: the one-batch fit's
    loss history of each start against that start's solo fit (1e-10
    relative), and the winner's curve returned."""
    from knode_cosserat_tpu_torch.controls import calc_controls
    from knode_cosserat_tpu_torch.models.mlp import MLPSpec
    from knode_cosserat_tpu_torch.training import sysid as ks

    plant = K.experimental_rod(N=6, dtype=torch.float64, device=dev)
    p0 = K.apply_mod("youngs", N=6, dtype=torch.float64, device=dev)
    T = 5 if objective == "teacher" else 4
    ctl = torch.tensor(calc_controls("sine", 1.0, float(plant.del_t), T),
                       dtype=torch.float64, device=dev)
    traj = K.simulate_scan(plant, ctl).traj[:, :, :25]
    kw = dict(fields=("E",), objective=objective, steps=3, lr=0.1,
              keypoints=(3, 5))
    starts = ks._jitter_starts(ks.theta_init(p0, ("E",)), 3, 0.25,
                               torch.Generator().manual_seed(0))
    loss_fn = ks._make_objective(p0, traj[None], ctl[None], objective,
                                 (3, 5), MLPSpec.for_knode(), "euler", None,
                                 50)
    _, _, hist, finals = ks._fit_batch(loss_fn, starts, None, 3, 0.1, 1e-2)
    assert hist.device == dev and hist.shape == (3, 3)
    for i in range(3):
        solo = ks.fit_rod_params(ks.apply_theta(p0, {"E": starts["E"][i]}),
                                 traj, ctl, **kw)
        torch.testing.assert_close(solo.loss_history, hist[i], rtol=1e-10,
                                   atol=0)
    res = ks.fit_rod_params(p0, traj, ctl, n_starts=3,
                            generator=torch.Generator().manual_seed(0), **kw)
    torch.testing.assert_close(res.loss_history,
                               hist[int(torch.argmin(finals))], rtol=0,
                               atol=0)
