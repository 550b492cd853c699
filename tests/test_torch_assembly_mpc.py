"""Plate-pose MPC over the port's assemblies (control/assembly_mpc.py)
against the JAX package (float64 on the CPU): the implicit-function-theorem
gradient of a rollout, the planner's cost history, the multi-start and the
receding-horizon controller."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knode_cosserat_tpu.control import assembly_mpc as jm
from knode_cosserat_tpu.controls import calc_controls
from knode_cosserat_tpu.core import assembly as ja
from knode_cosserat_tpu_torch.control import assembly_mpc as km
from knode_cosserat_tpu_torch.core import assembly as ka

torch.set_num_threads(1)
GRAD_RTOL = 1e-6
H = 2


@pytest.fixture(scope="module")
def pair():
    asm_j = ja.make_ring_assembly(n_rods=2, base_radius=0.04, N=5,
                                  dtype=jnp.float64)
    return asm_j, ka.assembly_from_jax(asm_j, device="cpu")


@pytest.fixture(scope="module")
def target(pair):
    """A reachable plate track (the rollout of a known schedule), moved
    1 mm."""
    u = np.full((H, 2, 4), 5.0)
    u[:, 0, 0] = np.linspace(6.0, 9.0, H)
    plates, _ = jm.rollout_plate(pair[0], ja.AssemblyCarry.initial(pair[0]),
                                 jnp.asarray(u))
    return np.asarray(plates)[:, :3] + 1e-3


def _loss(pose):
    return pose[-1, :3].sum() + (pose[:, 3:] ** 2).sum()


@pytest.fixture(scope="module")
def jax_gradient(pair):
    """Controls of a T=4 rollout and jax.grad of the plate-pose loss
    through the JAX custom_root rollout."""
    ctl = np.stack([calc_controls("sine", a, 0.005, 4) for a in (0.8, 1.2)],
                   axis=1)
    return ctl, np.asarray(jax.grad(lambda c: _loss(ja.simulate_assembly(
        pair[0], c, differentiable=True, tol=1e-20).plate_pose))(
        jnp.asarray(ctl)))


@pytest.mark.parametrize("fused", [False, True])
def test_ift_gradient_matches_jax(pair, jax_gradient, fused):
    """d(plate-pose loss)/d(controls): the port's implicit gradient (at the
    plain Newton's root, or at K7's plain version's) against JAX's."""
    asm_k = pair[1]
    ctl, w = jax_gradient
    c = torch.tensor(ctl, requires_grad=True)
    out = ka.simulate_assembly(asm_k, c, differentiable=True, tol=1e-20,
                               fused=fused)
    (got,) = torch.autograd.grad(_loss(out.plate_pose), c)
    np.testing.assert_allclose(got.numpy(), w, rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * np.abs(w).max())
    assert int(out.newton_iters.max()) == 0     # implicit path: unavailable
    assert bool((out.residual_norm[1:] < 1e-9).all())


def test_planner_matches_jax(pair, target):
    asm_j, asm_k = pair
    want = jm.make_assembly_planner(asm_j, H, opt_iters=3)(
        ja.AssemblyCarry.initial(asm_j), jnp.asarray(target))
    got = km.make_assembly_planner(asm_k, H, opt_iters=3)(
        ka.AssemblyCarry.initial(asm_k), torch.tensor(target))
    np.testing.assert_allclose(got.cost_history.numpy(),
                               np.asarray(want.cost_history), rtol=1e-6)
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-6)
    np.testing.assert_allclose(got.tensions.numpy(),
                               np.asarray(want.tensions), rtol=1e-6)
    np.testing.assert_allclose(got.plate_poses.numpy(),
                               np.asarray(want.plate_poses), rtol=0,
                               atol=1e-9)


def test_fused_planner_matches_plain(pair, target):
    """fused=True (K7's plain version on the CPU solves each root, the
    gradients come through the plain residual) against the plain planner,
    both solving to 1e-20."""
    asm_k = pair[1]
    carry = ka.AssemblyCarry.initial(asm_k)
    a, b = (km.make_assembly_planner(asm_k, H, opt_iters=2, tol=1e-20,
                                     fused=f)(carry, torch.tensor(target))
            for f in (False, True))
    np.testing.assert_allclose(b.cost_history.numpy(),
                               a.cost_history.numpy(), rtol=1e-6)


def test_multistart_restart_zero_is_the_single_plan(pair, target):
    asm_k = pair[1]
    carry = ka.AssemblyCarry.initial(asm_k)
    single = km.make_assembly_planner(asm_k, H, opt_iters=2)(
        carry, torch.tensor(target))
    one = km.make_multistart_assembly_planner(asm_k, H, restarts=1,
                                              opt_iters=2)(
        carry, torch.tensor(target), torch.Generator().manual_seed(0))
    for a, b in zip(one, single):
        assert torch.equal(a, b)
    best = km.make_multistart_assembly_planner(asm_k, H, restarts=2,
                                               opt_iters=2)(
        carry, torch.tensor(target), torch.Generator().manual_seed(0))
    assert float(best.cost) <= float(single.cost)


def test_controller_acts(pair, target):
    asm_k = pair[1]
    ctl = km.AssemblyMPCController(asm_k, horizon=H, first_iters=2,
                                   replan_iters=1)
    u0, info = ctl.act(torch.tensor(target))
    assert u0.shape == (2, 4) and bool(((u0 >= 0) & (u0 <= 20)).all())
    assert np.isfinite(info["cost"])
    assert info["predicted_plates"].shape == (H, 7)
    assert torch.equal(ctl.carry.pp, info["plate_pose"][:3])
    assert ctl._logits.shape == (H, 2, 4)
    u1, _ = ctl.act(torch.tensor(target))
    assert u1.shape == (2, 4)
