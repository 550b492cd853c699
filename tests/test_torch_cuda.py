"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips where no GPU is present. On a GPU machine:
    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest
(``--noconftest``: tests/conftest.py sets up JAX, which a GPU machine
need not have; this file imports only the port.)
Beside the small widths each kernel is held at the model's full width
(``for_knode(512)``, every benchmark cell's), and each main path is run
end to end on the card with its kernel launches counted: serving, the
rollouts, train_knode, the multitrain grid, the study's CLI, the fused
training step, the assemblies and their planners, the single-rod planner,
identification and online adaptation, the fine rods, the deep nets and a
mesh of one card.
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
# a rollout against its plain version, float32, both solved to the floor
ROLLOUT_F32 = dict(rtol=1e-4, atol=1e-4)
MODS = ["nsw", "short", "youngs", "lengthstiff"]
SINES = [("sine", 0.5), ("sine", 1.0), ("sine", 1.25), ("sine", 1.5)]


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


def _net(history, dtype, dev, scale=1.0, hidden=64):
    spec = K.MLPSpec.for_knode(hidden, history=history)
    net = K.init_mlp(spec, torch.Generator().manual_seed(0), dtype, dev)
    with torch.no_grad():
        for t in net.parameters():
            t.mul_(scale)
    return spec, net


def _sines(p, R, T):
    """(R, T, 4) sine tensions, rod r's period 0.5 + 1.5 r / R s."""
    return torch.tensor(np.stack([
        K.calc_controls("sine", 0.5 + 1.5 * r / R, float(p.del_t), T)
        for r in range(R)]), dtype=p.dtype, device=p.device)


def test_sweep_kernel_one_node_without_the_rod_matches_plain(dev):
    """K1 alone: a K3 sweep over N=2 (one node) at 1,792 lanes with the
    for_knode(512) net, want_rod=False (the residual only), f32."""
    p = K.experimental_rod(N=2, device=dev).to(dtype=torch.float32)
    G, yh, zh, tf = _inputs(p, 1792, 0, dev)
    spec, net = _net(False, torch.float32, dev, hidden=512)
    with torch.no_grad():
        got = ksweep.make_sweep_kernel(p, spec, want_rod=False)(G, yh, zh,
                                                                tf, net)
        want = ksweep.sweep_reference(p, G, yh, zh, tf, net, want_rod=False)
    rtol, atol = TOL[torch.float32]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=rtol, atol=atol)


@pytest.mark.parametrize("N,hidden", [(10, 64), (10, 512), (40, 512)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("method", ["euler", "rk4"])
@pytest.mark.parametrize("history", [None, False, True])
def test_sweep_kernel_matches_plain(dev, dtype, method, history, N, hidden):
    p = K.experimental_rod(N=N, device=dev).to(dtype=dtype)
    G, yh, zh, tf = _inputs(p, 67, 0, dev)
    spec, net = (None, None) if history is None else _net(
        history, dtype, dev, hidden=hidden)
    before = ksweep.LAUNCHES
    with torch.no_grad():
        got = ksweep.make_sweep_kernel(p, spec, method=method)(G, yh, zh, tf, net)
        want = ksweep.sweep_reference(p, G, yh, zh, tf, net, method)
    torch.cuda.synchronize()
    assert ksweep.LAUNCHES == before + 1
    rtol, atol = TOL[dtype]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=rtol, atol=atol)


# hidden 64 at N=10, and at for_knode(512) the Euler and RK4 sweeps, both
# nets (28 inputs; 53, whose float64 net is read from global memory) and
# the physics-only rod at N=40
@pytest.mark.parametrize("dtype,N,method,history,hidden", [
    (torch.float64, 10, "euler", None, None),
    (torch.float64, 10, "euler", False, 64),
    (torch.float32, 10, "euler", None, None),
    (torch.float32, 10, "euler", False, 64),
    (torch.float64, 10, "euler", False, 512),
    (torch.float64, 10, "euler", True, 512),
    (torch.float64, 10, "rk4", False, 512),
    (torch.float64, 40, "euler", None, None),
    (torch.float32, 10, "euler", False, 512),
    (torch.float32, 10, "rk4", True, 512),
    (torch.float32, 40, "rk4", None, None)])
def test_step_kernel_matches_plain(dev, dtype, N, method, history, hidden):
    p = K.experimental_rod(N=N, device=dev).to(dtype=dtype)
    G, yh, zh, tf = _inputs(p, 45, 1, dev)
    G = torch.zeros_like(G)
    spec, net = (None, None) if history is None else _net(
        history, dtype, dev, 1e-2, hidden)
    tol = 1e-18 if dtype == torch.float64 else 1e-13   # both to the floor
    with torch.no_grad():
        got = kstep.make_step_kernel(p, spec, tol=tol, method=method)(
            G, yh, zh, tf, net)
        want = kstep.step_reference(p, G, yh, zh, tf, net, tol=tol,
                                    method=method)
    torch.cuda.synchronize()
    if dtype == torch.float64:
        for a, b in zip(got[:4], want[:4]):
            torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-10)
    else:
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-4)
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-5)
        assert bool(torch.isfinite(got[2]).all() and torch.isfinite(
            got[3]).all())


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


@pytest.mark.parametrize("N", [10, 40])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("method", ["euler", "rk4"])
@pytest.mark.parametrize("dims,act", DEEP)
def test_sweep_kernel_deep_net_matches_plain(dev, dtype, method, dims, act,
                                             N):
    p = K.experimental_rod(N=N, device=dev).to(dtype=dtype)
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


@pytest.mark.parametrize("dims,act", DEEP[:3])
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


# K2 (impl "mega") and the FD-Newton driver over K3 (impl "sweep", forward
# differences) with the net at hidden 64, 512 and three layers
@pytest.mark.parametrize("width", [64, 512, "deep"])
@pytest.mark.parametrize("impl", ["mega", "sweep"])
def test_mega_rollout_matches_plain(dev, impl, width):
    p = K.experimental_rod(N=10, dtype=torch.float32, device=dev)
    spec, net = (_deep(DEEP[2][0], DEEP[2][1], torch.float32, dev, 1e-3)
                 if width == "deep" else
                 _net(False, torch.float32, dev, 1e-3, width))
    ctl = torch.tensor(np.stack([K.calc_controls("sine", 0.5 + i / 8, 0.05, 12)
                                 for i in range(8)]), device=dev)
    kern = kstep if impl == "mega" else ksweep
    before = kern.LAUNCHES
    # both solvers run to the f32 floor: at tol=1e-10 each stops at its own
    # point inside |r| <= 1e-5, and the states differ by more than 1e-4
    traj, _, _ = make_fast_rollout(p, spec, tol=1e-13, impl=impl,
                                   fd_order=1)(ctl, net)
    assert kern.LAUNCHES > before
    ref, _, _ = make_fast_rollout(p, spec, tol=1e-13, impl="plain",
                                  fd_order=1)(ctl, net)
    torch.testing.assert_close(traj, ref, **ROLLOUT_F32)


def test_compiled_stepper_serves_256_rods_on_k2(dev):
    """CompiledStepper(fast=True) answers 20 requests for 256 rods of the
    measured-hardware rod with the for_knode(512) net: a K2 launch each,
    each residual within 1e-5, every state finite."""
    p = K.experimental_rod(N=10, dtype=torch.float32, device=dev)
    spec, net = _net(False, torch.float32, dev, 1e-3, 512)
    ctl = _sines(p, 256, 20)
    stepper = K.CompiledStepper(p, spec, net, batch=256, fast=True)
    state = stepper.reset()
    before = kstep.LAUNCHES
    for t in range(20):
        state, info = stepper.step(state, ctl[:, t])
        assert float(info["residual"]) <= 1e-5
        assert bool(torch.isfinite(state.y).all())
    assert kstep.LAUNCHES - before == 20


def _train_data(dev, n_traj=2, train_len=8):
    """Float32 training data of the first n_traj SINES made on the card:
    2 x 30 steps are tests/golden/bench_data.npz's 232 cells."""
    trajs, ctls = K.make_training_data(K.apply_mod(None, device=dev),
                                       SINES[:n_traj], train_len=train_len)
    return trajs.float(), ctls.float()


def _train_case(dev, history=False, hidden=64, train_len=8, **cfg_kw):
    trajs, ctls = _train_data(dev, train_len=train_len)
    cfg = K.TrainConfig(hidden=hidden, history=history, **cfg_kw)
    p = K.apply_mod("nsw", dtype=torch.float32, device=dev)
    net = K.init_mlp(cfg.spec(), torch.Generator().manual_seed(0),
                     torch.float32, dev)
    return p, cfg, net, trajs, ctls


def test_training_data_made_on_the_card_matches_the_golden_data(dev):
    """make_training_data on the card (the plain scan of the reference rod,
    float64) against tests/golden/bench_data.npz: RMSE within 1e-7, the
    controls equal."""
    import os
    d = np.load(os.path.join(os.path.dirname(__file__), "golden",
                             "bench_data.npz"))
    trajs, ctls = K.make_training_data(K.apply_mod(None, device=dev),
                                       SINES[:2], train_len=30)
    want = torch.tensor(np.moveaxis(d["trajs"], 2, 3), device=dev)
    assert float(((trajs - want) ** 2).mean().sqrt()) <= 1e-7
    assert torch.equal(ctls, torch.tensor(d["controls"], device=dev))


# K4 against its plain version: the tolerances of the JAX package's own
# fused-vs-scan tests (tests/test_pallas_train.py): both run float32 and
# sum in different orders. At hidden 512 on the 232 cells of 2 x 30 steps
# for 40 epochs, where the loss falls
@pytest.mark.parametrize("hidden,train_len,epochs", [(64, 8, 30),
                                                     (512, 30, 40)])
@pytest.mark.parametrize("case", [dict(), dict(weight_decay=1e-4),
                                  dict(plateau_patience=4),
                                  dict(history=True)])
def test_train_kernel_matches_plain(dev, case, hidden, train_len, epochs):
    p, cfg, net, trajs, ctls = _train_case(dev, hidden=hidden,
                                           train_len=train_len, **case)
    before = ktrain.LAUNCHES
    got = ktrain.make_fused_training_run(p, cfg.spec(), cfg, epochs)(
        net, trajs, ctls)
    want = ktrain.make_fused_training_run(p, cfg.spec(), cfg, epochs,
                                          plain=True)(net, trajs, ctls)
    torch.cuda.synchronize()
    assert ktrain.LAUNCHES == before + 1
    torch.testing.assert_close(got[1], want[1], rtol=2e-4, atol=1e-9)
    for a, b in zip(got[0].parameters(), want[0].parameters()):
        torch.testing.assert_close(a, b, rtol=3e-3, atol=3e-5)
    torch.testing.assert_close(got[2]["scalars"], want[2]["scalars"])
    if hidden == 512:
        assert float(got[1][-1]) < float(got[1][0])


# the train-real configuration (53 inputs, AdamW 0.1, its keypoints) on
# random data of its shape at two seeds, after one epoch and after 40: the
# weights at test_wide_kernel_matches_plain's bar for this shape (Adam's
# first step is lr g / (|g| + eps), so a weight whose gradient sums to
# within a few eps of 0 carries that sum's rounding into its step)
@pytest.mark.parametrize("epochs", [1, 40])
@pytest.mark.parametrize("seed", [0, 1])
def test_train_kernel_matches_plain_on_random_train_real_data(dev, seed,
                                                             epochs):
    p, cfg, net, trajs, ctls = _wide_case(dev, 512, True, seed)
    got, want = (ktrain.make_fused_training_run(p, cfg.spec(), cfg, epochs,
                                                plain=plain)(net, trajs, ctls)
                 for plain in (False, True))
    torch.cuda.synchronize()
    torch.testing.assert_close(got[1], want[1], rtol=2e-4, atol=1e-9)
    for a, b in zip(got[0].parameters(), want[0].parameters()):
        torch.testing.assert_close(a, b, rtol=3e-3, atol=2e-4)
    if epochs > 1:
        assert float(got[1][-1]) < float(got[1][0])


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


# hidden 8192: fused="auto" routes to K6 (WIDE_FROM_HIDDEN)
@pytest.mark.parametrize("hidden", [64, 512, 8192])
def test_train_knode_runs_on_the_kernels(dev, hidden):
    from knode_cosserat_tpu_torch.ops import train_wide as kwide
    from knode_cosserat_tpu_torch.training.train import WIDE_FROM_HIDDEN
    p, cfg, _, trajs, ctls = _train_case(dev, hidden=hidden)
    cfg.epochs, cfg.eval_every, cfg.eval_len = 20, 10, 8
    vc, vt = K.make_validation_reference(K.apply_mod(None, device=dev),
                                         ("sine", 1.25), 8)
    k4, k6, k2 = ktrain.LAUNCHES, kwide.LAUNCHES, kstep.LAUNCHES
    r = K.train_knode(p, trajs, ctls, cfg, vc, vt, log=None)
    assert (ktrain.LAUNCHES - k4, kwide.LAUNCHES - k6) == (
        (0, 3) if hidden >= WIDE_FROM_HIDDEN else (3, 0))
    assert kstep.LAUNCHES > k2
    assert r.loss_history.shape == (21,) and np.isfinite(r.best_dtw)
    assert r.loss_history[-1] < r.loss_history[0]
    assert all(np.isfinite(d) for _, d in r.dtw_history)
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
    single-net launch per rod, bit for bit; and, both solved to the f32
    floor, against its plain version with the same stack."""
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
        got = kstep.make_step_kernel(p, spec, tol=1e-13)(
            G, yh, zh, tf, StackedMLP(nets))
        want = kstep.step_reference(p, G, yh, zh, tf, StackedMLP(nets),
                                    tol=1e-13)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-4)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-5)


# 4 runs at hidden 64; at hidden 512, 40 epochs, the multitrain grid's two
# sub-grid shapes: 8 runs x 232 cells (2 x 30 steps) and 20 runs x 348
# cells (3 x 30 steps)
@pytest.mark.parametrize("G,n_traj,hidden,train_len,epochs", [
    (4, 2, 64, 8, 30), (8, 2, 512, 30, 40), (20, 3, 512, 30, 40)])
def test_grid_kernel_matches_k4_bit_for_bit_and_plain(dev, G, n_traj, hidden,
                                                      train_len, epochs):
    """K5's cell g == a K4 launch on cell g (same rod, net, data), bit for
    bit; and K5 against its plain version at K4's tolerances."""
    from knode_cosserat_tpu_torch.models.mlp import StackedMLP
    trajs, ctls = _train_data(dev, n_traj, train_len)
    cfg = K.TrainConfig(hidden=hidden)
    rods = [K.apply_mod(MODS[g % 4], dtype=torch.float32, device=dev)
            for g in range(G)]
    nets = [K.init_mlp(cfg.spec(), torch.Generator().manual_seed(s),
                       torch.float32, dev) for s in range(G)]
    tg, cg = torch.stack([trajs] * G), torch.stack([ctls] * G)
    before = ktrain.GRID_LAUNCHES
    pg, lg, sg = ktrain.make_fused_grid_training_run(cfg.spec(), cfg, epochs)(
        rods, StackedMLP(nets), tg, cg)
    torch.cuda.synchronize()
    assert ktrain.GRID_LAUNCHES == before + 1
    for g, (rod, net) in enumerate(zip(rods, nets)):
        p1, l1, s1 = ktrain.make_fused_training_run(rod, cfg.spec(), cfg,
                                                    epochs)(net, trajs, ctls)
        assert torch.equal(lg[g], l1)
        for a, b in zip(pg.unstack()[g].parameters(), p1.parameters()):
            assert torch.equal(a, b)
        assert torch.equal(sg["scalars"][g], s1["scalars"])
    pp, lp, _ = ktrain.make_fused_grid_training_run(cfg.spec(), cfg, epochs,
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


def _wide_case(dev, hidden, big, seed=0):
    """hidden 640 on the small data, or the train-real shape (1,904 cells,
    53 inputs, AdamW 0.1) on random data from ``seed`` made as the JAX bench
    makes it (bench.py:612-623), plus the identity quaternion: the bench's
    random quaternions put Euler angles at the loss's +-pi wrap, where two
    float32 runs part; a real rod's orientation stays near identity."""
    from knode_cosserat_tpu_torch.training.loss import DEFAULT_KEYPOINTS_REAL
    if not big:
        p, cfg, _, trajs, ctls = _train_case(dev)
        cfg = K.TrainConfig(hidden=hidden)
    else:
        p = K.apply_mod("nsw", dtype=torch.float32, device=dev)
        g = np.random.default_rng(seed)
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
# train-real shape (two seeds, after one epoch and after 20) atol 2e-4, a
# fiftieth of lr: Adam's step divides by the gradient's own size (lr g /
# (|g| + eps) at the first epoch), so a weight whose gradient sums over the
# 1,904 cells to within a few eps of 0 carries that sum's rounding (another
# order in each version) into its step, up to lr / 4 times its error
@pytest.mark.parametrize("hidden,big,param_atol,seed,epochs", [
    (640, False, 3e-5, 0, 20), (8192, True, 2e-4, 0, 20),
    (8192, True, 2e-4, 1, 20), (8192, True, 2e-4, 0, 1),
    (8192, True, 2e-4, 1, 1)])
def test_wide_kernel_matches_plain(dev, hidden, big, param_atol, seed,
                                   epochs):
    from knode_cosserat_tpu_torch.ops import train_wide as kwide
    p, cfg, net, trajs, ctls = _wide_case(dev, hidden, big, seed)
    before = kwide.LAUNCHES
    got = kwide.make_wide_training_run(p, cfg.spec(), cfg, epochs)(
        net, trajs, ctls)
    want = kwide.make_wide_training_run(p, cfg.spec(), cfg, epochs,
                                        plain=True)(net, trajs, ctls)
    torch.cuda.synchronize()
    assert kwide.LAUNCHES == before + 1
    torch.testing.assert_close(got[1], want[1], rtol=2e-4, atol=1e-9)
    for a, b in zip(got[0].parameters(), want[0].parameters()):
        torch.testing.assert_close(a, b, rtol=3e-3, atol=param_atol)
    torch.testing.assert_close(got[2]["scalars"], want[2]["scalars"])
    if epochs > 1:
        assert float(got[1][-1]) < float(got[1][0])


@pytest.mark.parametrize("hidden,big", [(640, False), (8192, True)])
def test_wide_kernel_chunks_compose(dev, hidden, big):
    from knode_cosserat_tpu_torch.ops import train_wide as kwide
    p, cfg, net, trajs, ctls = _wide_case(dev, hidden, big)
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


ASM_AMPS = (0.7, 1.0, 1.3)   # the JAX bench's sine parameter per rod


def _assembly_controls(asm, T, amps=ASM_AMPS):
    """(T, M, 4) sine tensions, rod i's parameter amps[i] (the JAX bench's
    schedule, bench.py:517-525)."""
    dt = float(asm.rods[0].del_t)
    return torch.tensor(np.stack([K.calc_controls("sine", a, dt, T)
                                  for a in amps[:asm.M]], axis=1),
                        dtype=asm.dtype, device=asm.device)


def _assembly_rollout(asm, ctl, solve_fn, tol):
    """The coupled rollout with a given root solver: G (T-1, M, 6), plate
    poses (T-1, 7), y (T-1, M, N, 19), iterations and residual norms
    (T-1,)."""
    from knode_cosserat_tpu_torch.core.assembly import (AssemblyCarry,
                                                        assembly_step_carry)
    carry, out = AssemblyCarry.initial(asm), [[] for _ in range(5)]
    with torch.no_grad():
        for u in ctl[:-1]:
            carry, rec, plate7, G, stats = assembly_step_carry(
                asm, carry, u, tol=tol, solve_fn=solve_fn)
            for lst, v in zip(out, (G, plate7, rec[..., :19],
                                    stats.iterations, stats.residual_norm)):
                lst.append(v)
    return tuple(torch.stack(v) for v in out)


def _rel(a, b):
    return float((a - b).abs().max()) / float(b.abs().max())


# f64, both solved to 1e-24 from a sine rollout's inputs. M = 2 (N = 6) and
# 3 (N = 10): one step and 20-step rollouts, X, G and the plate within 1e-9
# and y, z within 1e-9 of their largest, the same iterations but at up to 2
# of the 20 steps, where both converged one iteration apart (a residual
# after an iteration spans 1e-30 to 1e-18 over a rollout; where it lands
# near the tolerance, the central differences' rounding decides the stop).
# M = 6 and 9: one step within 1e-8 (test_assembly_kernel_matches_plain's
# reason)
@pytest.mark.parametrize("M,N,bar,steps", [(2, 6, 1e-9, 20),
                                           (3, 10, 1e-9, 20),
                                           (6, 10, 1e-8, 0),
                                           (9, 10, 1e-8, 0)])
def test_assembly_kernel_in_a_rollout_matches_plain(dev, M, N, bar, steps):
    from knode_cosserat_tpu_torch.core.assembly import make_ring_assembly
    from knode_cosserat_tpu_torch.ops import assembly as kasm
    asm = make_ring_assembly(n_rods=M, base_radius=0.05, N=N, device=dev)
    ctl = _assembly_controls(asm, 21, ASM_AMPS if M <= 3
                             else np.linspace(0.7, 1.3, M))
    k = kasm.make_assembly_step_kernel(asm, tol=1e-24, max_iter=30)
    plain = lambda *a: kasm.assembly_step_reference(asm, *a, tol=1e-24,
                                                    max_iter=30)
    grab = []
    _assembly_rollout(asm, ctl[:5], lambda *a: grab.append(a) or k(*a),
                      1e-24)
    got, want = k(*grab[3]), plain(*grab[3])
    assert float((got[0] - want[0]).abs().max()) <= bar
    assert _rel(got[1], want[1]) <= bar and _rel(got[2], want[2]) <= bar
    assert int(got[4]) == int(want[4])
    if not steps:
        return
    before = kasm.LAUNCHES
    rk = _assembly_rollout(asm, ctl[:steps + 1], k, 1e-24)
    assert kasm.LAUNCHES - before == steps
    rp = _assembly_rollout(asm, ctl[:steps + 1], plain, 1e-24)
    assert float((rk[0] - rp[0]).abs().max()) <= bar
    assert float((rk[1] - rp[1]).abs().max()) <= bar
    assert _rel(rk[2], rp[2]) <= bar
    apart = rk[3] != rp[3]
    assert int(apart.sum()) <= 2
    assert bool(((rk[3] - rp[3]).abs() <= 1).all())
    assert bool((torch.maximum(rk[4], rp[4])[apart] ** 2 <= 1e-24).all())


def test_assembly_kernel_f32_inside_the_f64_envelope(dev):
    """K7 and its plain version at the JAX bench's assembly, float32, 20
    steps at tol 1e-10: each one's G and plate poses within 3x the plain
    coupled Newton's own float32 distance from the float64 truth (plus 1e-6
    on G, 1e-7 on the plate), as the JAX package's
    tests/test_assembly_fused.py holds them."""
    from knode_cosserat_tpu_torch.core.assembly import (make_ring_assembly,
                                                        simulate_assembly)
    from knode_cosserat_tpu_torch.ops import assembly as kasm
    asm = make_ring_assembly(n_rods=3, base_radius=0.05, N=10,
                             dtype=torch.float32, device=dev)
    ctl = _assembly_controls(asm, 21)
    truth = simulate_assembly(make_ring_assembly(
        n_rods=3, base_radius=0.05, N=10, dtype=torch.float64, device="cpu"),
        ctl.cpu().double(), tol=1e-24)
    plain = simulate_assembly(asm, ctl)
    err = lambda a, b: float((a.cpu().double() - b).abs().max())
    eG, ep = (err(plain.Gs[1:], truth.Gs[1:]),
              err(plain.plate_pose[1:], truth.plate_pose[1:]))
    for solve in (kasm.make_assembly_step_kernel(asm, tol=1e-10),
                  lambda *a: kasm.assembly_step_reference(asm, *a,
                                                          tol=1e-10)):
        Gs, plates, _, _, _ = _assembly_rollout(asm, ctl, solve, 1e-10)
        assert err(Gs, truth.Gs[1:]) < 3.0 * eG + 1e-6
        assert err(plates, truth.plate_pose[1:]) < 3.0 * ep + 1e-7


def _plate_target(asm, carry, H):
    """A sway of 1 cm in x and a lift of 0.1 mm of the plate, ramped over
    the horizon from its start."""
    ramp = torch.arange(1, H + 1, dtype=asm.dtype,
                        device=asm.device)[:, None] / H
    return carry.pp + ramp * torch.tensor((0.01, 0.0, 1e-4), dtype=asm.dtype,
                                          device=asm.device)


def test_assembly_planner_runs_on_k7(dev):
    """make_assembly_planner(fused=True, w_du=0) at the JAX bench's
    assembly, float32, horizon 8, 10 iterations: K7 launches, the cost
    falls; the float64 gradient of the plan's first cost through K7's roots
    against the one through the plain coupled Newton's, within 1e-6
    relative. (With the default w_du 1e-4 the penalty on Adam's first
    tension steps outweighs mm-to-cm errors on these stiff rods.)"""
    from knode_cosserat_tpu_torch.control import (make_assembly_planner,
                                                  rollout_plate)
    from knode_cosserat_tpu_torch.core.assembly import (AssemblyCarry,
                                                        make_ring_assembly)
    from knode_cosserat_tpu_torch.ops import assembly as kasm
    H = 8
    asm = make_ring_assembly(n_rods=3, base_radius=0.05, N=10,
                             dtype=torch.float32, device=dev)
    carry = AssemblyCarry.initial(asm)
    target = _plate_target(asm, carry, H)
    before = kasm.LAUNCHES
    r = make_assembly_planner(asm, H, fused=True, w_du=0.0, opt_iters=10)(
        carry, target)
    assert kasm.LAUNCHES > before
    costs = r.cost_history.cpu().numpy()
    assert np.isfinite(costs).all() and costs[-1] < costs[0]
    asm64 = make_ring_assembly(n_rods=3, base_radius=0.05, N=10,
                               dtype=torch.float64, device=dev)
    c64, tgt = AssemblyCarry.initial(asm64), target.double()
    grads = []
    for solve_fn in (kasm.make_assembly_step_kernel(asm64, tol=1e-20), None):
        logits = torch.zeros((H, 3, 4), dtype=torch.float64, device=dev,
                             requires_grad=True)
        plates, _ = rollout_plate(asm64, c64, 20.0 * torch.sigmoid(logits),
                                  tol=1e-20, solve_fn=solve_fn)
        cost = ((plates[:, :3] - tgt) ** 2).sum(-1).mean()
        grads.append(torch.autograd.grad(cost, logits)[0])
    assert _rel(grads[0], grads[1]) <= 1e-6


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
    solved to 1e-24, at test_assembly_kernel_in_a_rollout_matches_plain's
    bars: X within 1e-9, y and z within 1e-9 of their largest, the same
    iterations per system."""
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


def _batched_schedules(asm, B, T, seed=0):
    """(B, T, M, 4) tensions 5 + U(0, 1) N, the JAX bench's batched
    workload (bench.py:566-578), from a seeded generator."""
    g = torch.Generator().manual_seed(seed)
    return (5.0 + torch.rand((B, T, asm.M, 4), generator=g,
                             dtype=torch.float64)).to(dtype=asm.dtype,
                                                      device=asm.device)


# path G's step: K7 at B = 256 on the inputs of step 5 of the batched fused
# rollout over the JAX bench's schedules, against 256 single launches bit
# for bit; in f64 against its batched plain version at
# test_assembly_kernel_in_a_rollout_matches_plain's bars, with up to 26
# systems (that test's 2 of 20 steps, the same share) ending one iteration
# apart, both converged
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-8),
                                       (torch.float64, 1e-24)])
def test_batched_assembly_kernel_at_256_systems(dev, dtype, tol):
    from knode_cosserat_tpu_torch.core.assembly import (AssemblyCarry,
                                                        assembly_step_carry,
                                                        make_ring_assembly)
    from knode_cosserat_tpu_torch.ops import assembly as kasm
    B = 256
    asm = make_ring_assembly(n_rods=3, base_radius=0.05, N=10, dtype=dtype,
                             device=dev)
    ctl = _batched_schedules(asm, B, 8)
    k, grab = kasm.make_assembly_step_kernel(asm, tol=tol, max_iter=30), []
    carry = AssemblyCarry.initial(asm, B)
    with torch.no_grad():
        for t in range(6):
            carry = assembly_step_carry(
                asm, carry, ctl[:, t], tol=tol,
                solve_fn=lambda *a: grab.append(a) or k(*a))[0]
    ins = grab[5]
    got = k(*ins)
    for b in range(B):
        for a, w in zip(got, k(*(t[b] for t in ins))):
            assert torch.equal(a[b], w)
    if dtype == torch.float32:
        return
    want = kasm.assembly_step_reference(asm, *ins, tol=tol, max_iter=30)
    assert float((got[0] - want[0]).abs().max()) <= 1e-9
    assert _rel(got[1], want[1]) <= 1e-9 and _rel(got[2], want[2]) <= 1e-9
    apart = got[4] != want[4]
    assert int(apart.sum()) <= 26
    assert bool(((got[4] - want[4]).abs() <= 1).all())
    assert bool((torch.maximum(got[3], want[3])[apart] <= tol).all())


def test_batched_assembly_rollout_runs_on_k7(dev):
    """simulate_assembly(fused=True) over the JAX bench's 256 schedules
    (T = 50, tol 1e-8, f32): one K7 launch a step for the batch, finite
    outputs of the batched shapes; four of its systems against their
    rollouts alone, the plate within 1e-6 and G within 1e-3 (the batch's
    glue may round otherwise than one system's)."""
    from knode_cosserat_tpu_torch.core.assembly import (make_ring_assembly,
                                                        simulate_assembly)
    from knode_cosserat_tpu_torch.ops import assembly as kasm
    B, T = 256, 50
    asm = make_ring_assembly(n_rods=3, base_radius=0.05, N=10,
                             dtype=torch.float32, device=dev)
    ctl = _batched_schedules(asm, B, T)
    before = kasm.LAUNCHES
    res = simulate_assembly(asm, ctl, fused=True, tol=1e-8)
    assert kasm.LAUNCHES - before == T - 1
    assert [tuple(f.shape) for f in res] == [
        (B, T, 3, 10, 50), (B, T, 7), (B, T, 3, 6), (B, T), (B, T)]
    assert all(bool(torch.isfinite(f).all()) for f in res)
    for b in (0, 85, 170, 255):
        alone = simulate_assembly(asm, ctl[b], fused=True, tol=1e-8)
        assert float((res.plate_pose[b] - alone.plate_pose).abs().max()) \
            <= 1e-6
        assert float((res.Gs[b] - alone.Gs).abs().max()) <= 1e-3


def test_batched_plain_coupled_newton_matches_the_fused_batch(dev):
    """The plain batched coupled Newton against the fused batch (K7) on 16
    of the JAX bench's schedules x T = 11, f64, both solved to 1e-24: G and
    the plate within 1e-9, the rods' states within 1e-9 of their largest;
    in f32 both finite."""
    from knode_cosserat_tpu_torch.core.assembly import (make_ring_assembly,
                                                        simulate_assembly)
    asms = {dt: make_ring_assembly(n_rods=3, base_radius=0.05, N=10,
                                   dtype=dt, device=dev)
            for dt in (torch.float32, torch.float64)}
    ctl = _batched_schedules(asms[torch.float64], 16, 11)
    truth = simulate_assembly(asms[torch.float64], ctl, tol=1e-24)
    fused = simulate_assembly(asms[torch.float64], ctl, tol=1e-24, fused=True)
    assert float((fused.Gs - truth.Gs).abs().max()) <= 1e-9
    assert float((fused.plate_pose - truth.plate_pose).abs().max()) <= 1e-9
    assert _rel(fused.traj, truth.traj) <= 1e-9
    for fused32 in (False, True):
        r = simulate_assembly(asms[torch.float32], ctl.float(), tol=1e-10,
                              fused=fused32)
        assert all(bool(torch.isfinite(f).all()) for f in r)


def test_multistart_assembly_planner_runs_on_k7(dev):
    """make_multistart_assembly_planner(restarts=8, fused=True, w_du=0) at
    test_assembly_planner_runs_on_k7's plan: one K7 launch per forward step
    for all restarts ((iterations + 1) x horizon), the winner's cost falls;
    two restarts as one batch (3 iterations) against their two single
    plans, the costs within 1e-4 relative and the tensions within 1e-3 N
    (the batch's implicit backward solves its systems in one batched LU)."""
    from knode_cosserat_tpu_torch.control import (
        make_assembly_planner, make_multistart_assembly_planner)
    from knode_cosserat_tpu_torch.core.assembly import (AssemblyCarry,
                                                        make_ring_assembly)
    from knode_cosserat_tpu_torch.ops import assembly as kasm
    H, iters = 8, 10
    asm = make_ring_assembly(n_rods=3, base_radius=0.05, N=10,
                             dtype=torch.float32, device=dev)
    carry = AssemblyCarry.initial(asm)
    target = _plate_target(asm, carry, H)
    plan = make_multistart_assembly_planner(asm, H, restarts=8, fused=True,
                                            w_du=0.0, opt_iters=iters)
    before = kasm.LAUNCHES
    r = plan(carry, target, torch.Generator().manual_seed(0))
    assert kasm.LAUNCHES - before == (iters + 1) * H
    costs = r.cost_history.cpu().numpy()
    assert np.isfinite(costs).all() and costs[-1] < costs[0]
    two = make_assembly_planner(asm, H, fused=True, w_du=0.0, opt_iters=3)
    g = torch.Generator().manual_seed(0)
    starts = torch.cat([torch.zeros((1, H, 3, 4)), 2.0 * torch.randn(
        (1, H, 3, 4), generator=g, dtype=torch.float64).float()]).to(dev)
    both = two(carry, target, logits_init=starts)
    for i, s in enumerate(starts):
        one = two(carry, target, logits_init=s)
        assert abs(float(both.cost[i]) - float(one.cost)) <= 1e-4 * abs(
            float(one.cost))
        assert float((both.tensions[i] - one.tensions).abs().max()) <= 1e-3


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


def _path_c_case(dev, kind, dtype=torch.float32):
    """(rod, config, net, trajs, ctls) of the fused training path: hidden 64
    on one 8-step trajectory; hidden 512 on the 232 cells of 2 x 30 steps;
    the train-real shape (53 inputs, AdamW 0.1, 1,904 random cells,
    _wide_case's data); the four-layer history net on the 232 cells."""
    from knode_cosserat_tpu_torch.training.loss import DEFAULT_KEYPOINTS_REAL
    p = K.apply_mod("nsw", dtype=dtype, device=dev)
    if kind == "train-real":
        _, cfg, _, trajs, ctls = _wide_case(dev, 512, True)
    else:
        trajs, ctls = (_train_data(dev, 1, 8) if kind == "h64" else
                       _train_data(dev, 2, 30))
        cfg = (K.TrainConfig(history=True, keypoints=DEFAULT_KEYPOINTS_REAL)
               if kind == "deep" else
               K.TrainConfig(hidden=64 if kind == "h64" else 512))
    if kind == "deep":
        spec, net = _deep(*DEEP[3], dtype, dev)
    else:
        spec = cfg.spec()
        net = K.init_mlp(spec, torch.Generator().manual_seed(0), dtype, dev)
    return p, cfg, spec, net, trajs.to(dtype), ctls.to(dtype)


# K8 on the cells path C hands it (taken from grow_predictions) at the
# benchmark's width: the 232 cells of 28 inputs and the train-real shape's
# 1,904 cells of 53 inputs. f64 to rounding; f32, where the net's 512-term
# sums run in another order, 1e-5 (~5e-7 on y_grown ~ 2 on an H100)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("kind", ["h512", "train-real"])
def test_next_segment_kernel_on_path_c_cells_matches_plain(dev, kind, dtype,
                                                           tol):
    from knode_cosserat_tpu_torch.ops import next_segment as kseg
    from knode_cosserat_tpu_torch.training.loss import grow_predictions
    p, cfg, spec, net, trajs, ctls = _path_c_case(dev, kind, dtype)
    grab = []
    grow_predictions(p, spec, net, trajs, ctls, cfg.keypoints,
                     fused_fn=lambda n, *xs: grab.append(xs) or xs[::2])
    cells = grab[0]
    assert cells[0].shape[0] == (232 if kind == "h512" else 1904)
    before = kseg.LAUNCHES
    with torch.no_grad():
        got = kseg.make_fused_next_segment(p, spec)(net, *cells)
        want = kseg.next_segment_reference(p, spec, *cells, *[
            t for wb in net.weights() for t in wb])
    torch.cuda.synchronize()
    assert kseg.LAUNCHES == before + 1
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol)


# make_train_step(use_pallas=True) launches K8 once per step and tracks the
# plain step from the same net (f32, losses within rtol 1e-4): 5 steps at
# hidden 64, 200 on the 232 cells at hidden 512, 20 at the train-real
# shape, 20 with the four-layer history net
@pytest.mark.parametrize("kind,steps", [("h64", 5), ("h512", 200),
                                        ("train-real", 20), ("deep", 20)])
def test_fused_train_step_runs_on_the_kernel(dev, kind, steps):
    import copy

    from knode_cosserat_tpu_torch.ops import next_segment as kseg
    from knode_cosserat_tpu_torch.training.train import (make_optimizer,
                                                         make_train_step)
    p, cfg, spec, net, trajs, ctls = _path_c_case(dev, kind)
    losses = []
    for fused in (True, False):
        n = copy.deepcopy(net)
        step, _ = make_train_step(p, spec, make_optimizer(cfg, n),
                                  cfg.keypoints, cfg.clamp_weights,
                                  use_pallas=fused)
        kseg.LAUNCHES = 0
        losses.append(torch.stack([step(n, trajs, ctls)
                                   for _ in range(steps)]))
        assert kseg.LAUNCHES == (steps if fused else 0)
    assert torch.allclose(losses[0], losses[1], rtol=1e-4, atol=0)


@pytest.mark.parametrize("hidden", [None, 64, 512])
def test_planner_roots_run_on_k2(dev, hidden):
    """make_planner on a CUDA rod, physics only or with the net: every
    forward root a K2 launch ((iterations + 2) x horizon, none in the
    implicit backward), the cost falls; in float64 the first cost's
    gradient and the cost history through K2's roots equal those through
    newton_solve's within rtol 1e-6."""
    from knode_cosserat_tpu_torch.control import mpc
    H, iters = 3, 3
    hybrid = hidden is not None
    spec, net = (_net(False, torch.float32, dev, 1e-3, hidden) if hybrid
                 else (None, None))
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
    grads = []
    for root in ("k2", "newton"):
        logits = torch.zeros((H, 4), dtype=torch.float64, device=dev,
                             requires_grad=True)
        tips, _ = mpc.rollout_tips(p64, mpc.PlanState.initial(p64),
                                   20.0 * torch.sigmoid(logits), spec,
                                   net64, tol=1e-20, _root=root)
        cost = ((tips - target.double()) ** 2).sum(-1).mean()
        grads.append(torch.autograd.grad(cost, logits)[0])
    assert _rel(grads[0], grads[1]) <= 1e-6


@pytest.mark.parametrize("hidden", [64, 512])
@pytest.mark.parametrize("history", [False, True])
def test_step_kernel_bf16_spec_computes_the_net_in_f32(dev, history, hidden):
    """A spec with compute_dtype="bfloat16": K2 computes the net in the
    weights' float32, as the JAX TPU kernel does, so it matches its plain
    version with the compute dtype dropped."""
    p = K.experimental_rod(N=10, dtype=torch.float32, device=dev)
    G, yh, zh, tf = _inputs(p, 45, 1, dev)
    G = torch.zeros_like(G)
    spec16 = K.MLPSpec.for_knode(hidden, history=history,
                                 compute_dtype="bfloat16")
    net16 = K.init_mlp(spec16, torch.Generator().manual_seed(0),
                       torch.float32, dev)
    with torch.no_grad():
        for t in net16.parameters():
            t.mul_(1e-2)
    spec, net = _net(history, torch.float32, dev, 1e-2, hidden)
    net.load_state_dict(net16.state_dict())
    with torch.no_grad():
        got = kstep.make_step_kernel(p, spec16, tol=1e-13)(G, yh, zh, tf,
                                                            net16)
        want = kstep.step_reference(p, G, yh, zh, tf, net, tol=1e-13)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-4)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-5)


# the fine rod of N - 1 = 39 = 3 x 13 nodes in 3 and 13 segments
@pytest.mark.parametrize("N,S", [(13, 4), (40, 3), (40, 13), (10, None)])
def test_fine_rod_and_reference_solvers_on_the_card(dev, N, S):
    """simulate_scan_ms (structured and dense) and simulate_fsolve with the
    residual on the card, float64, against physics-only K2 rollouts."""
    from knode_cosserat_tpu_torch.controls import calc_controls
    from knode_cosserat_tpu_torch.core.multiple_shooting import \
        simulate_scan_ms
    from knode_cosserat_tpu_torch.core.reference_solver import \
        simulate_fsolve

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
        return
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


def test_bf16_train_knode_runs_on_the_plain_loop_with_k2_validations(dev):
    """train_knode(nn_dtype="bfloat16", fused="off") at for_knode(512) on
    the 232 cells of 2 x 30 steps, 20 epochs, validations at 0 and 20:
    the loss falls, the master weights stay float32, no K4 launch, K2 in
    the validation."""
    p, cfg, _, trajs, ctls = _train_case(
        dev, hidden=512, train_len=30, epochs=20, eval_every=20, eval_len=20,
        nn_dtype="bfloat16", fused="off")
    vc, vt = K.make_validation_reference(K.apply_mod(None, device=dev),
                                         ("sine", 1.25), 20)
    k4, k2 = ktrain.LAUNCHES, kstep.LAUNCHES
    r = K.train_knode(p, trajs, ctls, cfg, vc, vt, log=None)
    assert ktrain.LAUNCHES == k4 and kstep.LAUNCHES > k2
    assert np.isfinite(r.loss_history).all()
    assert r.loss_history[-1] < r.loss_history[0]
    assert {t.dtype for t in r.params.parameters()} == {torch.float32}
    assert r.params.spec.compute_dtype == "bfloat16"


def test_replicate_runs_on_the_card(dev, tmp_path):
    """replicate at its CPU test's size (a step experiment, short settle
    and tail, 3 epochs of an 8-unit net; the C++ firmware built with the
    host's g++): the bag, prepared, estimated and model files, a finite
    ingest DTW, a falling loss, K4 launched."""
    import os

    from knode_cosserat_tpu_torch import cli
    out = tmp_path / "rep"
    k4 = ktrain.LAUNCHES
    summ = cli.main(["replicate", "--out_dir", str(out), "--experiment",
                     "step_x", "--parameter", "1", "--settle", "0.3",
                     "--tail", "0.7", "--epochs", "3", "--layers", "8",
                     "--trim", "2", "--train_len", "12"])
    assert ktrain.LAUNCHES > k4
    assert all(os.path.exists(summ[k]) for k in ("bag", "prepared",
                                                 "estimated", "model"))
    assert np.isfinite(summ["dtw"])
    assert summ["loss_final"] < summ["loss_initial"]


def test_multitrain_runs_on_k5_and_k2(dev, tmp_path, monkeypatch):
    """The multitrain command at a small grid (2 datas x 2 mods x 2 seeds,
    hidden 64, 20 epochs): K5 trains the grid; the eval launches K2 once a
    step per mod for the stacked cells and once per mod for the baselines;
    every cell's loss falls and every DTW is finite."""
    from knode_cosserat_tpu_torch import cli
    monkeypatch.setitem(cli.DATAS, False, ["sine 0.5", "sine sine 0.5 1.0"])
    monkeypatch.setitem(cli.EVAL_SETS, False, ["sine 1.5"])
    monkeypatch.setattr(cli, "MODS", ["nsw", "short"])
    monkeypatch.setattr(cli, "TRAIN_LEN", 8)
    monkeypatch.setattr(cli, "EVAL_LEN", 6)
    k5, k2 = ktrain.GRID_LAUNCHES, kstep.LAUNCHES
    out = cli.main(["multitrain", "--n_seeds", "2", "--epochs", "20",
                    "--layers", "64", "--save_dir", str(tmp_path / "saved"),
                    "--evals_dir", str(tmp_path / "evals")])
    res, records = out["result"], out["records"]
    assert len(res.cells) == 8 and ktrain.GRID_LAUNCHES > k5
    assert kstep.LAUNCHES - k2 == 2 * 2 * 1 * (6 - 1)
    assert np.isfinite(res.loss_history).all()
    assert (res.loss_history[-1] < res.loss_history[0]).all()
    assert all(np.isfinite(r.dtw) for r in records)


def test_the_studys_train_and_simulate_commands_run_on_the_kernels(
        dev, tmp_path):
    """train on the nsw rod (K4; the validation on K2), then simulate
    --model of its checkpoint with --fast (K2 with the net, a launch a
    step) against the plain scan (float32 rollouts, both to the floor)."""
    import os

    from knode_cosserat_tpu_torch import cli
    saved = tmp_path / "saved"
    k4 = ktrain.LAUNCHES
    res = cli.main(["train", "sine", "sine", "0.5", "1.0", "--mod", "nsw",
                    "--epochs", "40", "--layers", "64", "--train_len", "8",
                    "--save_dir", str(saved)])
    assert ktrain.LAUNCHES > k4
    lh = res.loss_history
    assert np.isfinite(lh).all() and lh[-1] < lh[0]
    assert np.isfinite(res.best_dtw)
    (name,) = os.listdir(saved)
    trajs = []
    for fast in (["--fast"], []):
        k2 = kstep.LAUNCHES
        trajs.append(torch.as_tensor(cli.main([
            "simulate", "--model", str(saved / name), "--steps", "20",
            "--save", str(tmp_path / f"sim{len(trajs)}.npz"), *fast])))
        assert kstep.LAUNCHES - k2 == (19 if fast else 0)
    torch.testing.assert_close(trajs[0], trajs[1], **ROLLOUT_F32)


def test_the_real_data_commands_run_on_the_kernels(dev, tmp_path):
    """simulate --fast (physics-only K2) at the sinesine preset's two sine
    periods, saved as prepare's files; estimate of each (with the simulated
    rod's del_t the estimated velocities within 0.05, mean abs, of the
    simulator's, as tests/test_realworld.py:69-78 holds them; the command,
    which estimates with the reference rod's del_t, the same scaled);
    train-real on them (K4), its loss falling; and where this host has
    pandas, prepare and estimate of tests/fixtures/sil_step_1100."""
    import importlib.util
    import os

    from knode_cosserat_tpu_torch import cli
    from knode_cosserat_tpu_torch.realworld import estimate_state, fit_curve
    datas = tmp_path / "datas"
    datas.mkdir()
    p_sim = K.apply_mod(None, dtype=torch.float32, device=dev)
    p_est = K.make_rod(device=dev)
    train_len = 12
    for fname, period in zip(cli.REAL_PRESETS["sinesine"], (1.0, 3.0)):
        out = str(tmp_path / f"{fname}_sim.npz")
        k2 = kstep.LAUNCHES
        traj = cli.main(["simulate", "--fast", "--type", "sine", "--arg",
                         str(period), "--steps",
                         str(cli.REAL_TRIM + train_len + 10), "--save", out])
        assert kstep.LAUNCHES > k2
        ctl = np.load(out)["controls"]
        np.savez_compressed(
            datas / f"{fname}.npz", t=np.arange(len(traj)) * float(
                p_sim.del_t), traj=traj, controls=ctl,
            interpolated=np.moveaxis(traj[:, :, :7], 1, 2),
            positions=traj[:, cli.MARKER_NODES, :3])
        cli.main(["estimate", fname, "--data_dir", str(datas)])
        est = np.load(datas / f"{fname}_estimated.npz")["traj"]
        sim = np.moveaxis(traj, 1, 2).astype(np.float64)      # (T, 50, N)
        grid = fit_curve(sim[:, :7, cli.MARKER_NODES], cli.MARKER_LOC,
                         p_sim.N)
        mine, _ = estimate_state(grid, ctl, p_sim)
        assert np.abs(mine[5:-5, 13:16, 5] - sim[5:-5, 13:16, 5]).mean() \
            < 0.05
        ratio = float(p_sim.del_t) / float(p_est.del_t)
        assert np.isfinite(est).all()
        assert np.abs(est[:, 13:16] / ratio - mine[:, 13:16]).max() < 1e-9
    k4 = ktrain.LAUNCHES
    res = cli.main(["train-real", "--data", "sinesine", "--data_dir",
                    str(datas), "--epochs", "20", "--layers", "64",
                    "--train_len", str(train_len), "--save_path",
                    str(tmp_path / "real_model")])
    assert ktrain.LAUNCHES > k4
    lh = res.loss_history
    assert np.isfinite(lh).all() and lh[-1] < lh[0]
    if importlib.util.find_spec("pandas") is None:
        return
    fix = tmp_path / "fixture"
    cli.main(["prepare", os.path.join(os.path.dirname(__file__), "fixtures",
                                      "sil_step_1100"),
              "--out_dir", str(fix)])
    cli.main(["estimate", "sil_step_1100", "--data_dir", str(fix)])
    prep = np.load(fix / "sil_step_1100.npz")
    est = np.load(fix / "sil_step_1100_estimated.npz")
    T = len(prep["t"])
    assert prep["traj"].shape == (T, 10, 50)
    assert prep["traj"].dtype == np.float64
    assert est["traj"].shape == (T, 25, 10)
    assert np.isfinite(prep["traj"]).all() and np.isfinite(est["traj"]).all()


def test_simulate_assembly_command_on_the_card(dev, tmp_path):
    """simulate-assembly at its defaults (3 rods, N=10), 20 steps: the
    file's arrays of the command's shapes, finite."""
    from knode_cosserat_tpu_torch import cli
    path = tmp_path / "assembly.npz"
    cli.main(["simulate-assembly", "--steps", "20", "--save", str(path)])
    d = np.load(path)
    assert {k: d[k].shape for k in d.files} == {
        "traj": (20, 3, 10, 50), "plate_pose": (20, 7),
        "controls": (20, 3, 4)}
    assert np.isfinite(d["traj"]).all()


def test_simulate_fast_of_a_three_layer_checkpoint_matches_the_scan(
        dev, tmp_path):
    """simulate --model of a (28, 512, 512, 25) ELU checkpoint: --fast (K2
    with the three-layer net, a launch a step) against the plain scan
    (float32, 50 steps)."""
    from knode_cosserat_tpu_torch import cli
    from knode_cosserat_tpu_torch.training.checkpoint import save_checkpoint
    from knode_cosserat_tpu_torch.training.train import _net_tree
    _, net = _deep(*DEEP[2], torch.float32, dev, 1e-3)
    ckpt = str(tmp_path / "deep")
    save_checkpoint(ckpt, {"params": _net_tree(net)},
                    meta={"train": {"activation": DEEP[2][1]}})
    trajs = []
    for fast in (["--fast"], []):
        k2 = kstep.LAUNCHES
        trajs.append(torch.as_tensor(cli.main([
            "simulate", "--model", ckpt, "--steps", "50", "--save",
            str(tmp_path / f"sim{len(trajs)}.npz"), *fast])))
        assert kstep.LAUNCHES - k2 == (49 if fast else 0)
    torch.testing.assert_close(trajs[0], trajs[1], **ROLLOUT_F32)


def test_multistart_planner_and_controller_run_on_k2(dev):
    """make_multistart_planner (8 restarts, 2 iterations, horizon 10) on a
    CUDA rod: one K2 launch per horizon step for all restarts ((iterations
    + 2) x horizon), a finite best cost; five MPCController.act calls
    (2 iterations, then 2) give finite tips."""
    from knode_cosserat_tpu_torch.control import mpc
    H, iters = 10, 2
    p = K.experimental_rod(N=10, dtype=torch.float32, device=dev)
    # the tip track of a reachable schedule, every tendon its own ramp (so
    # no tension's gradient vanishes by symmetry)
    sched = np.stack([np.linspace(a, b, H) for a, b in
                      ((2.0, 12.0), (3.0, 5.0), (6.0, 4.0), (1.0, 2.0))],
                     axis=1)
    state = mpc.PlanState.initial(p)
    with torch.no_grad():
        target, _ = mpc.rollout_tips(p, state, torch.tensor(
            sched, dtype=p.dtype, device=dev))
    before = kstep.LAUNCHES
    r = mpc.make_multistart_planner(p, H, restarts=8, opt_iters=iters,
                                    w_du=0.0)(
        state, target, torch.Generator().manual_seed(0))
    assert kstep.LAUNCHES - before == (iters + 2) * H
    assert np.isfinite(float(r.cost))
    ctl = mpc.MPCController(p, horizon=H, first_iters=iters, replan_iters=2,
                            w_du=0.0)
    tips = torch.stack([ctl.act(target)[1]["tip"] for _ in range(5)])
    assert bool(torch.isfinite(tips).all())


@pytest.mark.parametrize("argv", [
    ["sysid", "--length", "6", "--steps", "3"],
    ["sysid", "--n_starts", "4", "--length", "6", "--steps", "3"],
    ["sysid", "--objective", "rollout", "--length", "4", "--steps", "2"],
    ["sysid", "--assembly", "2", "--length", "4", "--steps", "2"],
    ["design", "--horizon", "3", "--steps", "2"],
], ids=["teacher", "teacher-4-starts", "rollout", "assembly", "design"])
def test_sysid_and_design_commands_on_the_card(dev, argv, tmp_path):
    """sysid (teacher, with 4 starts as one batch, rollout, --assembly 2)
    and design on the card at their CPU tests' sizes: the loss falls
    (every start's loss finite), or the design's information grows."""
    from knode_cosserat_tpu_torch import cli
    if argv[0] == "design":
        res = cli.main(argv + ["--save", str(tmp_path / "designed.npz")])
        assert res.info_final > res.info_initial
        return
    res = cli.main(argv)
    h = res.loss_history.cpu().numpy()
    assert np.isfinite(h).all() and h[-1] < h[0]
    if "--n_starts" in argv:
        assert res.start_losses.shape == (4,)
        assert bool(torch.isfinite(res.start_losses).all())


def test_posterior_ensemble_equals_its_draws_solo_rollouts(dev):
    """16 draws of a Laplace posterior of E (std 0.05, made by hand) rolled
    out as one simulate_scan of the stack (N=10, T=20, f64): the tips
    spread; the first and the last draw equal their solo rollouts (the
    same iterations, the states within 1e-12)."""
    from knode_cosserat_tpu_torch.core.params import rod_at
    from knode_cosserat_tpu_torch.training import sysid as ks
    plant = K.experimental_rod(N=10, dtype=torch.float64, device=dev)
    post = ks.LaplacePosterior(labels=["E"],
                               theta=ks.theta_init(plant, ("E",)),
                               covariance=np.array([[0.05 ** 2]]),
                               std=np.array([0.05]), sigma2=0.0,
                               n_residuals=0)
    draws = ks.sample_posterior(plant, post, torch.Generator().manual_seed(0),
                                16)
    ctl = torch.tensor(K.calc_controls("sine", 1.0, float(plant.del_t), 20),
                       dtype=torch.float64, device=dev)
    ens = K.simulate_scan(draws, ctl)
    assert ens.traj.shape == (16, 20, 10, 50)
    assert float(ens.traj[:, :, -1, 0:3].std(0).max()) > 0
    for i in (0, 15):
        solo = K.simulate_scan(rod_at(draws, i), ctl)
        assert torch.equal(solo.newton_iters, ens.newton_iters[i])
        assert float((solo.traj - ens.traj[i]).abs().max()) <= 1e-12


def test_online_adapter_on_k2_rollout_frames(dev):
    """An OnlineAdapter on the damping-fault model fed 100 frames of the
    true rod rolled out on K2: its window loss falls below the physics
    model's, and an update is certified."""
    from knode_cosserat_tpu_torch.training.online import (OnlineAdapter,
                                                          OnlineConfig)
    true = K.experimental_rod(N=10, dtype=torch.float32, device=dev)
    model = K.apply_mod("damping", dtype=torch.float32, device=dev)
    stream = _sines(true, 1, 100)[0]
    before = kstep.LAUNCHES
    frames = make_fast_rollout(true, impl="mega", tol=1e-10)(
        stream[None])[0][0]
    assert kstep.LAUNCHES > before
    ad = OnlineAdapter(model, OnlineConfig(window=64, min_fill=16,
                                           steps_per_update=4, hidden=64))
    for t in range(100):
        ad.observe(frames[t], stream[t])
        if ad.ready and t % 2 == 0:
            ad.update()
    assert ad.window_loss() < ad.physics_loss()
    assert ad.certified_params is not None


# a world of one on the card (NCCL refuses two ranks on one card; the world
# of two runs on the CPU in tests/test_torch_parallel.py), in a process of
# its own so that no group outlives the test
_MESH_RUN = r"""
import os, socket
import numpy as np
import torch
import torch.distributed as dist
import knode_cosserat_tpu_torch as K
from knode_cosserat_tpu_torch.core.multiple_shooting import simulate_scan_ms
from knode_cosserat_tpu_torch.ops import step as kstep
from knode_cosserat_tpu_torch.ops import train as ktrain
from knode_cosserat_tpu_torch.parallel import (build_grid, grid_train,
                                               init_distributed, make_mesh,
                                               simulate_scan_ms_halo)

torch.backends.cuda.matmul.allow_tf32 = False
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                  WORLD_SIZE="1", RANK="0", LOCAL_RANK="0")
assert init_distributed()
mesh = make_mesh(1, 1, 1)
dev = torch.device("cuda", 0)
try:
    # grid_train(mesh=): K5, every cell the unsharded grid's bit for bit
    ref = K.apply_mod(None, dtype=torch.float32, device=dev)
    cells = build_grid(["sine sine 0.5 1.0"], ["nsw", "short", "youngs",
                                               "lengthstiff"], 2)
    cfg = K.TrainConfig(hidden=512, epochs=40)
    k5 = ktrain.GRID_LAUNCHES
    sharded = grid_train(cells, cfg, reference_rod=ref, mesh=mesh)
    assert ktrain.GRID_LAUNCHES > k5
    one = grid_train(cells, cfg, reference_rod=ref)
    assert np.array_equal(sharded.loss_history, one.loss_history)
    for x, y in zip(sharded.params, one.params):
        for a, b in zip(x.parameters(), y.parameters()):
            assert torch.equal(a, b)
    # train_knode(mesh=) (K4 declined under a mesh; K2 in its validation)
    # against the unsharded plain loop, losses within 1e-4 relative
    trajs, ctls = K.make_training_data(ref, [("sine", 0.5), ("sine", 1.0)],
                                       train_len=30)
    vc, vt = K.make_validation_reference(ref, ("sine", 1.25), 20)
    p = K.apply_mod("nsw", dtype=torch.float32, device=dev)
    runs = {}
    for label, m, fused, val in (("mesh", mesh, "auto", (vc, vt)),
                                 ("plain", None, "off", (None, None))):
        cfg = K.TrainConfig(hidden=512, epochs=200, eval_every=200,
                            eval_len=20, fused=fused)
        k2, k4 = kstep.LAUNCHES, ktrain.LAUNCHES
        runs[label] = K.train_knode(p, trajs, ctls, cfg, *val, log=None,
                                    mesh=m)
        if label == "mesh":
            assert (kstep.LAUNCHES - k2, ktrain.LAUNCHES - k4) == (19, 0)
    a, b = (np.asarray(runs[k].loss_history) for k in ("mesh", "plain"))
    assert np.all(np.abs(a - b) <= 1e-4 * np.abs(b))
    # simulate_scan_ms(mesh=) and simulate_scan_ms_halo at D = 1 against
    # simulate_scan_ms, N=40, S=3, f64
    p = K.experimental_rod(N=40, device=dev).to(dtype=torch.float64)
    ctl = torch.tensor(K.calc_controls("sine", 0.5, float(p.del_t), 10),
                       device=dev)
    want = simulate_scan_ms(p, ctl, 3).traj
    for got in (simulate_scan_ms(p, ctl, 3, mesh=mesh).traj,
                simulate_scan_ms_halo(p, ctl, 3, mesh).traj):
        assert float((got - want).abs().max()) <= 1e-9 * float(
            want.abs().max())
finally:
    dist.destroy_process_group()
print("mesh of one: ok")
"""


def test_mesh_of_one_card(dev):
    """make_mesh(1, 1, 1) over an NCCL world of one started by
    init_distributed: grid_train(mesh=) on K5 equals the unsharded grid
    bit for bit; train_knode(mesh=) declines K4, validates on K2 and
    tracks the plain loop; the sharded multiple-shooting rollouts equal
    the unsharded one."""
    import os
    import subprocess
    import sys
    out = subprocess.run([sys.executable, "-c", _MESH_RUN],
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))),
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "mesh of one: ok" in out.stdout
