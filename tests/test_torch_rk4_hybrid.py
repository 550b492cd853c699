"""The hybrid rod's RK4 mega rollout (K2's plain version on the CPU) against
the benchmark's plain reference, ``portbench/reference/rod_rk4.py``, in
float64 at a small size: a seeded hidden-16 KNODE net at N=6, one net for
all rods and one net per rod (a StackedMLP), and K2's sweep count against
the reference's. The reference imports nothing of the port; it shares no
code with it."""
import pytest
import torch

from knode_cosserat_tpu_torch.core.fast_rollout import make_fast_rollout
from knode_cosserat_tpu_torch.core.params import experimental_rod
from knode_cosserat_tpu_torch.models.mlp import KnodeMLP, MLPSpec, StackedMLP
from knode_cosserat_tpu_torch.ops import step as kstep
from portbench.feeds.common import sine_tensions
from portbench.reference import rod as R
from portbench.reference import rod_rk4 as RK
from portbench.tests.fixture import ROD

torch.set_num_threads(1)

F64 = torch.float64
H, N = 16, 6
TOL = 1e-18          # both Newton solves to their float64 floor


def _weights(seed, scale=1e-3):
    """The benchmark's init, |0.01 + 0.01 N| weights and 0.01 N biases,
    times ``scale``, drawn from a CPU generator."""
    g = torch.Generator().manual_seed(seed)
    w = [(0.01 + 0.01 * torch.randn(H, 28, generator=g, dtype=F64)).abs(),
         0.01 * torch.randn(H, generator=g, dtype=F64),
         (0.01 + 0.01 * torch.randn(25, H, generator=g, dtype=F64)).abs(),
         0.01 * torch.randn(25, generator=g, dtype=F64)]
    return [x * scale for x in w]


def _net(w):
    net = KnodeMLP(MLPSpec.for_knode(H), dtype=F64, device="cpu")
    with torch.no_grad():
        for P, x in zip(net.parameters(), w):
            P.copy_(x)
    return net


def _controls(rods, T=7):
    per = torch.linspace(0.6, 1.9, rods, dtype=F64)
    return sine_tensions(per, 0.05, T).double()


def _rollout(nets, ctl):
    p = experimental_rod("nsw", N=N, dtype=F64, device="cpu")
    roll = make_fast_rollout(p, MLPSpec.for_knode(H), tol=TOL, max_iter=50,
                             impl="mega", method="rk4")
    return roll(ctl, nets)


def _reference(weights, ctl):
    return RK.rollout(R.derive(ROD, N, F64, "cpu"), ctl, weights, TOL, 50)


def _check(got, want):
    traj, res, iters = got
    ref, r2, ref_iters, _ = want
    assert traj.shape == ref.shape
    # the forward-difference Jacobian's floor (probe step 1e-8 (1 + |G|)):
    # both solves stop within it of the root, as the JAX parity test of the
    # mega rollout allows (tests/test_torch_rollout.py)
    torch.testing.assert_close(traj, ref, rtol=1e-7, atol=2e-8)
    # G is node 0's n and m: held to the same floor
    torch.testing.assert_close(traj[:, 1:, 0, 7:13], ref[:, 1:, 0, 7:13],
                               rtol=1e-7, atol=2e-8)
    # the same Newton on the same residual takes the same iterations
    assert torch.equal(iters.T.long(), ref_iters.T.long())
    assert float(res.max()) ** 2 <= TOL and float(r2.max()) <= TOL


def test_rk4_mega_rollout_matches_the_plain_reference():
    w = _weights(5)
    ctl = _controls(3)
    _check(_rollout(_net(w), ctl), _reference(w, ctl))


def test_rk4_mega_rollout_with_a_net_per_rod_matches_the_reference():
    """A StackedMLP's rollout, rod by rod against the reference's rollout
    of that rod with its own weights."""
    ws = [_weights(s, 1e-3 * (1 + s)) for s in range(3)]
    ctl = _controls(3)
    traj, res, iters = _rollout(StackedMLP([_net(w) for w in ws]), ctl)
    for b, w in enumerate(ws):
        _check((traj[b:b + 1], res[:, b:b + 1], iters[:, b:b + 1]),
               _reference(w, ctl[b:b + 1]))


def test_the_sweep_is_its_method():
    """RK4's sweep differs from rod.py's Euler sweep by the spatial
    truncation error, small against the state and far above rounding;
    node 0's strains are the first stage's at the base either way."""
    rod = R.derive(ROD, N, F64, "cpu")
    G, yh, zh, tf = _sweep_inputs(1, 4)
    w = _weights(2)
    y, z = RK.sweep(rod, G, yh, zh, tf, w)
    ye, ze = R.sweep(rod, G, yh, zh, tf, w)
    assert torch.equal(z[:, 0], ze[:, 0])
    gap = float((y - ye).abs().max())
    assert 1e-9 < gap < 1e-1 * float(ye.abs().max())


def _sweep_inputs(seed, B):
    """A base reaction near the root and a small BDF-2 history."""
    g = torch.Generator().manual_seed(seed)
    return (0.05 * torch.randn(B, 6, generator=g, dtype=F64),
            1e-3 * torch.randn(B, N, 19, generator=g, dtype=F64),
            1e-3 * torch.randn(B, N, 6, generator=g, dtype=F64),
            torch.randn(B, 3, generator=g, dtype=F64))


def test_k2s_sweep_count_is_the_references():
    """K2's plain twin with the RK4 sweep counts, rod by rod, the
    reference's Newton sweeps plus the recording sweep, in as many
    iterations, where alpha = 1 improves each iteration (the frozen counts
    of counts/<cell>.json and k2_sweeps_per_rod_step read alike there)."""
    w = _weights(7)
    ins = _sweep_inputs(8, 5)
    p = experimental_rod("nsw", N=N, dtype=F64, device="cpu")
    sweeps = torch.zeros(5, dtype=torch.int32)
    got = kstep.step_reference(p, *ins, _net(w), tol=TOL, max_iter=30,
                               method="rk4", sweeps=sweeps)
    _, _, iters, ref = RK.newton(R.derive(ROD, N, F64, "cpu"), *ins, w, TOL,
                                 30)
    assert torch.equal(got[4].long(), iters)
    assert torch.equal(sweeps.long(), ref + 1)
    assert torch.equal(ref, 1 + 7 * iters)
