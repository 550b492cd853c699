"""Batched coupled assemblies: the port's batch axis on simulate_assembly,
assembly_step_carry, the coupled Newton, kernel K7's wrapper and plain
version, rollout_plate and the multi-start plate-pose planner, against
``jax.vmap`` of the JAX package's simulate_assembly and against the port's
own per-system loops (float64 on the CPU).

B = 3 systems of M = 2 rods, N = 6, T = 4: B matches neither the line
search's 7 candidates nor the 2U+1 = 39 probe lanes, so an axis paired
with the wrong one does not broadcast silently. The three schedules sit at
different tension levels, so the systems take different Newton iterations
at a step and the ones done first stay frozen while the others iterate.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knode_cosserat_tpu.core import assembly as ja
from knode_cosserat_tpu.models import mlp as jmlp
from knode_cosserat_tpu_torch.control import assembly_mpc as km
from knode_cosserat_tpu_torch.core import assembly as ka
from knode_cosserat_tpu_torch.core.multiple_shooting import _newton_loop
from knode_cosserat_tpu_torch.models import mlp as kmlp
from knode_cosserat_tpu_torch.ops import _build
from knode_cosserat_tpu_torch.ops import assembly as kops

torch.set_num_threads(1)
B, M, N, T = 3, 2, 6, 4
TOL = 1e-24                  # both sides stop at their floor
JAX_ATOL = 1e-9              # G and plate pose against JAX (as unbatched)
LOOP_ATOL = 1e-12            # batched against the port's own loop
STEP_ATOL = 1e-13            # K7's plain version, batched against single
GRAD_RTOL = 1e-10
COST_RTOL = 1e-10
H = 2                        # the planner's horizon


def _schedules(seed=0):
    """(B, T, M, 4) tensions: a level of 2, 5 or 9 N per system, plus
    U(0, 1) noise (the JAX bench's 5 + U(0, 1), bench.py:570-571)."""
    g = np.random.RandomState(seed)
    level = np.array([2.0, 5.0, 9.0])[:, None, None, None]
    return level + g.rand(B, T, M, 4)


@pytest.fixture(scope="module")
def pair():
    asm_j = ja.make_ring_assembly(n_rods=M, base_radius=0.04, N=N,
                                  dtype=jnp.float64, plate_mass=0.02,
                                  plate_inertia=1e-5 * np.eye(3))
    return asm_j, ka.assembly_from_jax(asm_j, device="cpu")


@pytest.fixture(scope="module")
def jax_vmapped(pair):
    """One vmapped JAX rollout of the three schedules."""
    ctl = _schedules()
    out = jax.vmap(lambda c: ja.simulate_assembly(pair[0], c, tol=TOL))(
        jnp.asarray(ctl))
    return ctl, out


def _stack(outs):
    return ka.AssemblySimOutput(*(torch.stack(f) for f in zip(*outs)))


def _same(got, want, atol, what=""):
    for name in got._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert a.shape == b.shape, (what, name, a.shape, b.shape)
        if name == "newton_iters":
            assert torch.equal(a, b), (what, a, b)
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=atol, err_msg=f"{what} {name}")


def test_batched_rollout_matches_jax_vmap(pair, jax_vmapped):
    ctl, want = jax_vmapped
    got = ka.simulate_assembly(pair[1], torch.tensor(ctl), tol=TOL)
    assert got.traj.shape == (B, T, M, N, 50)
    assert got.plate_pose.shape == (B, T, 7) and got.Gs.shape == (B, T, M, 6)
    assert got.newton_iters.shape == got.residual_norm.shape == (B, T)
    for name in ("Gs", "plate_pose"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=0,
                                   atol=JAX_ATOL, err_msg=name)
    t_j = np.asarray(want.traj)
    np.testing.assert_allclose(got.traj.numpy(), t_j, rtol=1e-9,
                               atol=1e-9 * np.abs(t_j).max())
    np.testing.assert_array_equal(got.newton_iters.numpy(),
                                  np.asarray(want.newton_iters))
    # the systems end a step at different iterations: the frozen ones held
    assert (got.newton_iters.max(0).values
            != got.newton_iters.min(0).values).any()


def _per_rod_nets():
    spec = kmlp.MLPSpec.for_knode(8)
    nets = []
    for i in range(M):
        tree = jax.tree.map(lambda a: 1e-2 * a, jmlp.init_mlp(
            jmlp.MLPSpec.for_knode(8), jax.random.PRNGKey(i), jnp.float64))
        nets.append(kmlp.params_from_jax(tree, spec, device="cpu"))
    return spec, nets


@pytest.mark.parametrize("case", ["structured", "dense", "contact",
                                  "per-rod nets"])
def test_batched_rollout_matches_the_loop(pair, case):
    """The batch against B unbatched rollouts of the port: both solvers,
    a contact plane the plate starts pressed on, and a net per rod."""
    asm, kw = pair[1], dict(tol=TOL)
    kw["solver"] = "dense" if case == "dense" else "structured"
    if case == "contact":
        asm = ka.with_contact_plane(asm, [0.0, 0.0, 1.0], 0.3999)
    if case == "per-rod nets":
        kw["nn_spec"], kw["nn_params"] = _per_rod_nets()
    ctl = torch.tensor(_schedules(1))
    got = ka.simulate_assembly(asm, ctl, **kw)
    want = _stack([ka.simulate_assembly(asm, c, **kw) for c in ctl])
    _same(got, want, LOOP_ATOL, case)


def test_batched_fused_rollout_matches_the_loop(pair):
    """fused=True on the CPU (K7's plain version): one batched solve a
    step, each system its unbatched fused rollout; no kernel launch."""
    ctl = torch.tensor(_schedules(2))
    kops.LAUNCHES = 0
    got = ka.simulate_assembly(pair[1], ctl, tol=TOL, fused=True)
    want = _stack([ka.simulate_assembly(pair[1], c, tol=TOL, fused=True)
                   for c in ctl])
    assert kops.LAUNCHES == 0
    _same(got, want, LOOP_ATOL, "fused")


def _step_inputs(asm, seed):
    """One coupled step's K7 inputs from a perturbed history around the
    straight assembly (float64)."""
    g = np.random.RandomState(seed)
    carry = ka.AssemblyCarry.initial(asm)
    p0 = asm.rods[0]
    c1, c2 = float(p0.c1), float(p0.c2)
    rnd = lambda shape, s: s * torch.tensor(g.randn(*shape))
    yh = c1 * (carry.y + rnd(carry.y.shape, 1e-3)) + c2 * carry.y
    zh = c1 * (carry.z + rnd(carry.z.shape, 1e-3)) + c2 * carry.z
    tf = torch.tensor((2 + 8 * g.rand(asm.M, 4))
                      @ p0.tendon_dirs.double().numpy())
    X0 = torch.cat([torch.zeros(6 * asm.M), carry.pp, carry.hp])
    return (X0, yh, zh, tf, (c1 + c2) * carry.pp + rnd((3,), 1e-4),
            rnd((3,), 1e-3), (c1 + c2) * carry.hp + rnd((4,), 1e-4),
            rnd((3,), 1e-3))


def test_step_reference_batched_matches_single_calls(pair):
    """K7's plain version on B systems at once, each under its own mask,
    against B single calls: X, y, z and r2 within 1e-13, iterations
    equal; the wrapper on CPU tensors is the same batched call."""
    asm = pair[1]
    singles = [_step_inputs(asm, s) for s in (3, 4, 5)]
    # system 1 starts at its own root: done before the first iteration
    X1 = kops.assembly_step_reference(asm, *singles[1], tol=TOL,
                                      max_iter=30)[0]
    singles[1] = (X1,) + singles[1][1:]
    batch = [torch.stack(t) for t in zip(*singles)]
    got = kops.assembly_step_reference(asm, *batch, tol=TOL, max_iter=30)
    want = [kops.assembly_step_reference(asm, *ins, tol=TOL, max_iter=30)
            for ins in singles]
    for i, name in enumerate(("X", "y", "z", "r2")):
        w = torch.stack([o[i] for o in want])
        assert got[i].shape == w.shape
        np.testing.assert_allclose(got[i].numpy(), w.numpy(), rtol=0,
                                   atol=STEP_ATOL, err_msg=name)
    iters = torch.stack([o[4] for o in want])
    assert torch.equal(got[4], iters) and got[4].dtype == torch.int32
    assert int(iters[1]) == 0 and min(iters[0], iters[2]) > 0
    k = kops.make_assembly_step_kernel(asm, tol=TOL, max_iter=30)
    for a, b in zip(k(*batch), got):
        assert torch.equal(a, b)


def test_gauss_jordan_batched_matches_single():
    g = np.random.RandomState(0)
    A = torch.tensor(g.randn(B, 9, 9))
    A[0, np.arange(9), np.arange(9)] = 0.0     # pivots past a zero diagonal
    b = torch.tensor(g.randn(B, 9))
    got = kops.gauss_jordan(A, b)
    for i in range(B):
        assert torch.equal(got[i], kops.gauss_jordan(A[i], b[i]))
        np.testing.assert_allclose(got[i].numpy(), np.linalg.solve(
            A[i].numpy(), b[i].numpy()), rtol=1e-10)


def test_newton_loop_batched_freezes_a_converged_system():
    """The batched loop on three scalar-coupled systems, one converged at
    its start: that one takes no iteration and keeps X0; the others are
    the unbatched loop's results."""
    target = torch.tensor([[1.0, 2.0], [0.0, 0.0], [3.0, -1.0]],
                          dtype=torch.float64)

    def res(X):
        return X ** 3 + X - target

    def direction(X, r, lam):
        return -r / (3 * X ** 2 + 1)

    X0 = torch.tensor([[0.5, 0.5], [0.0, 0.0], [1.0, 0.0]],
                      dtype=torch.float64)
    X, st = _newton_loop(res, direction, X0, 1e-24, 50)
    assert int(st.iterations[1]) == 0 and torch.equal(X[1], X0[1])
    for i in (0, 2):
        Xi, si = _newton_loop(lambda x: x ** 3 + x - target[i], direction,
                              X0[i], 1e-24, 50)
        assert torch.equal(X[i], Xi)
        assert int(st.iterations[i]) == int(si.iterations) > 0
        assert float(st.residual_norm[i]) == float(si.residual_norm)


def test_batched_carry_and_carry_from_jax(pair):
    """AssemblyCarry.initial(asm, batch) against a vmapped JAX carry
    through carry_from_jax, and B copies of the unbatched carry."""
    asm_j, asm_k = pair
    got = ka.AssemblyCarry.initial(asm_k, batch=B)
    one = ka.AssemblyCarry.initial(asm_k)
    vmapped = jax.vmap(lambda _: ja.AssemblyCarry.initial(asm_j))(
        jnp.arange(B))
    for a, b, c in zip(got, ka.carry_from_jax(vmapped, device="cpu"), one,
                       strict=True):
        assert a.shape == (B,) + c.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-16)
        assert torch.equal(a, c.expand_as(a))


def _loss(pose):
    return pose[..., -1, :3].sum(-1) + (pose[..., 3:] ** 2).sum((-2, -1))


@pytest.mark.parametrize("fused", [False, True])
def test_batched_gradient_matches_per_system(pair, fused):
    """d(sum of the systems' plate costs)/d(controls) through
    differentiable=True: each system's block equals its own gradient."""
    ctl = torch.tensor(_schedules(3))
    c = ctl.clone().requires_grad_(True)
    out = ka.simulate_assembly(pair[1], c, differentiable=True, tol=1e-20,
                               fused=fused)
    (got,) = torch.autograd.grad(_loss(out.plate_pose).sum(), c)
    for b in range(B):
        cb = ctl[b].clone().requires_grad_(True)
        ob = ka.simulate_assembly(pair[1], cb, differentiable=True,
                                  tol=1e-20, fused=fused)
        (want,) = torch.autograd.grad(_loss(ob.plate_pose), cb)
        np.testing.assert_allclose(got[b].numpy(), want.numpy(),
                                   rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * float(want.abs().max()))


def test_rollout_plate_broadcasts_one_carry(pair):
    """R schedules from one carry: each restart's plates are its own
    rollout's."""
    asm = pair[1]
    carry = ka.AssemblyCarry.initial(asm)
    u = torch.tensor(_schedules(4)[:, :H])
    plates, final = km.rollout_plate(asm, carry, u, tol=1e-20)
    assert plates.shape == (B, H, 7) and final.y.shape == (B, M, N, 19)
    for r in range(B):
        want, _ = km.rollout_plate(asm, carry, u[r], tol=1e-20)
        np.testing.assert_allclose(plates[r].numpy(), want.numpy(), rtol=0,
                                   atol=LOOP_ATOL)


@pytest.fixture(scope="module")
def target(pair):
    """A plate track 1 mm off the rollout of a known schedule."""
    u = np.full((H, M, 4), 5.0)
    u[:, 0, 0] = np.linspace(6.0, 9.0, H)
    plates, _ = km.rollout_plate(pair[1], ka.AssemblyCarry.initial(pair[1]),
                                 torch.tensor(u))
    return plates[:, :3] + 1e-3


def test_multistart_is_the_single_plans(pair, target):
    """make_multistart_assembly_planner(restarts=3): the batched plan's
    restarts against the three single plans from the same starts (restart
    0 at logits_init, the others at the generator's noise): costs within
    1e-10 relative and the same best restart, which the planner
    returns."""
    asm = pair[1]
    carry = ka.AssemblyCarry.initial(asm)
    kw = dict(opt_iters=2, tol=1e-20)
    gen = lambda: torch.Generator().manual_seed(7)
    best = km.make_multistart_assembly_planner(asm, H, restarts=3, **kw)(
        carry, target, gen())
    noise = 2.0 * torch.randn((2, H, M, 4), generator=gen(),
                              dtype=torch.float64)
    starts = torch.cat([torch.zeros((1, H, M, 4), dtype=torch.float64),
                        noise])
    plan = km.make_assembly_planner(asm, H, **kw)
    batched = plan(carry, target, logits_init=starts)
    singles = [plan(carry, target, logits_init=s) for s in starts]
    assert batched.cost.shape == (3,)
    assert batched.cost_history.shape == (3, 2)
    assert batched.plate_poses.shape == (3, H, 7)
    costs = torch.stack([s.cost for s in singles])
    np.testing.assert_allclose(batched.cost.numpy(), costs.numpy(),
                               rtol=COST_RTOL)
    np.testing.assert_allclose(
        batched.cost_history.numpy(),
        torch.stack([s.cost_history for s in singles]).numpy(),
        rtol=COST_RTOL)
    i = int(torch.argmin(costs))
    assert int(torch.argmin(batched.cost)) == i
    np.testing.assert_allclose(best.tensions.numpy(),
                               singles[i].tensions.numpy(), rtol=1e-9)
    np.testing.assert_allclose(float(best.cost), float(singles[i].cost),
                               rtol=COST_RTOL)


def test_multistart_skips_a_nan_restart(pair, target, monkeypatch):
    """A diverged restart's NaN cost never wins."""
    asm = pair[1]
    plan = km.make_multistart_assembly_planner(asm, H, restarts=3,
                                               opt_iters=1, tol=1e-20)
    real = km.rollout_plate

    def diverge_last(asm_, carry, u, **kw):
        plates, final = real(asm_, carry, u, **kw)
        return plates.clone().index_fill_(0, torch.tensor([2]),
                                          float("nan")), final

    monkeypatch.setattr(km, "rollout_plate", diverge_last)
    r = plan(ka.AssemblyCarry.initial(asm), target,
             torch.Generator().manual_seed(0))
    assert np.isfinite(float(r.cost))


class _Recorder:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("knode_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


def test_batched_wrapper_makes_one_launch(monkeypatch):
    """A batch of B systems on the card is ONE launch of B blocks with
    outputs (B, ...) (the library recorded, not run), and LAUNCHES counts
    launches; a malformed batch is refused before any launch."""
    rec = _Recorder()
    monkeypatch.setattr(_build, "library", lambda: rec)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(kops, "stream_of", lambda t: 0)
    asm = ka.make_ring_assembly(n_rods=M, N=5, device="cpu")
    U, kw = 6 * M + 7, dict(dtype=torch.float64)
    cache = {"consts": torch.zeros(1), "plate": torch.zeros(1)}
    ins = [torch.zeros(s, **kw) for s in ((5, U), (5, M, 5, 19),
                                          (5, M, 5, 6), (5, M, 3), (5, 13))]
    kops.LAUNCHES = 0
    X, y, z, r2, it = kops._launch(asm, cache, 1e-10, 50, *ins)
    (name, args), = rec.calls
    assert name == "knode_assembly" and args[1] == 5 and kops.LAUNCHES == 1
    assert X.shape == (5, U) and y.shape == (5, M, 5, 19)
    assert z.shape == (5, M, 4, 6) and r2.shape == it.shape == (5,)
    plan = kops.launch_plan(torch.float64, M, 5)
    assert args[-3:-1] == (plan.threads, plan.smem_bytes)
    with pytest.raises(ValueError, match="yh"):
        kops._launch(asm, cache, 1e-10, 50, ins[0], ins[1][:4], *ins[2:])
    with pytest.raises(ValueError, match="B >= 1"):
        kops._launch(asm, cache, 1e-10, 50, *(t[:0] for t in ins))
    assert len(rec.calls) == 1
