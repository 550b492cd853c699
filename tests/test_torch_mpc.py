"""The single-rod planner of the port (control/mpc.py) against the JAX
package's (float64 on the CPU): the differentiable rollout of tip
positions and its gradients, the planner's cost history, the route that
takes every forward root from kernel K2's plain version (ops/step.
step_reference, what a CUDA rod launches) against newton_solve's, the
multi-start (one root solve per horizon step for all restarts) and the
receding-horizon controller."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knode_cosserat_tpu.control import mpc as jm
from knode_cosserat_tpu.core import params as jp
from knode_cosserat_tpu_torch.control import mpc as km
from knode_cosserat_tpu_torch.core import params as kp
from knode_cosserat_tpu_torch.models.mlp import MLPSpec, init_mlp
from knode_cosserat_tpu_torch.ops import step as kstep

torch.set_num_threads(1)
GRAD_RTOL = 1e-6
H = 3
# every tendon pulled by its own ramp: no tension's gradient vanishes by
# symmetry (Adam's normalized step would turn rounding noise into moves)
U = np.stack([np.linspace(2.0, 12.0, H), np.linspace(3.0, 5.0, H),
              np.linspace(6.0, 4.0, H), np.linspace(1.0, 2.0, H)], axis=1)


@pytest.fixture(scope="module")
def rods():
    return jp.make_rod(N=6, dtype=jnp.float64), kp.make_rod(N=6, device="cpu")


@pytest.fixture(scope="module")
def target(rods):
    """A reachable tip track (the rollout of U), moved 1 mm."""
    tips, _ = jm.rollout_tips(rods[0], jm.PlanState.initial(rods[0]),
                              jnp.asarray(U))
    return np.asarray(tips) + 1e-3


def _cost(tips, target):
    return ((tips - target) ** 2).sum(-1).mean()


def test_rollout_tips_and_gradients_match_jax(rods, target):
    pj, pk = rods
    want_tips = target - 1e-3
    want_g = jax.grad(lambda u: _cost(jm.rollout_tips(
        pj, jm.PlanState.initial(pj), u)[0], target))(jnp.asarray(U))
    u = torch.tensor(U, requires_grad=True)
    tips, final = km.rollout_tips(pk, km.PlanState.initial(pk), u)
    (g,) = torch.autograd.grad(_cost(tips, torch.tensor(target)), u)
    np.testing.assert_allclose(tips.detach().numpy(), want_tips, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g),
                               rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * np.abs(want_g).max())
    assert final.y.shape == (6, 19) and final.G.shape == (6,)


def test_planner_matches_jax(rods, target):
    pj, pk = rods
    want = jm.make_planner(pj, H, opt_iters=3)(jm.PlanState.initial(pj),
                                               jnp.asarray(target))
    got = km.make_planner(pk, H, opt_iters=3)(km.PlanState.initial(pk),
                                              torch.tensor(target))
    np.testing.assert_allclose(got.cost_history.numpy(),
                               np.asarray(want.cost_history), rtol=1e-6)
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-6)
    np.testing.assert_allclose(got.tensions.numpy(),
                               np.asarray(want.tensions), rtol=1e-6)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(got.tips.numpy(), np.asarray(want.tips),
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("hybrid", [False, True])
def test_k2_roots_match_newton_roots(rods, target, hybrid):
    """Every forward root from K2's plain version (forward differences, its
    own LM ladder) against newton_solve's, both solved to 1e-20: the cost
    histories, whose gradients come through the plain residual at each
    root, agree to rtol 1e-6 (with and without a net); no K2 launches on
    the CPU."""
    pk = rods[1]
    spec = net = None
    if hybrid:
        spec = MLPSpec.for_knode(8)
        net = init_mlp(spec, torch.Generator().manual_seed(0),
                       torch.float64, "cpu")
        with torch.no_grad():
            for t in net.parameters():
                t.mul_(1e-3)
    kstep.LAUNCHES = 0
    a, b = (km.make_planner(pk, H, spec, opt_iters=2, tol=1e-20,
                            _root=root)(km.PlanState.initial(pk),
                                        torch.tensor(target), nn_params=net)
            for root in ("k2", "newton"))
    np.testing.assert_allclose(a.cost_history.numpy(),
                               b.cost_history.numpy(), rtol=1e-6)
    np.testing.assert_allclose(float(a.cost), float(b.cost), rtol=1e-6)
    assert kstep.LAUNCHES == 0


def test_multistart_never_loses_to_single(rods, target):
    pk = rods[1]
    state = km.PlanState.initial(pk)
    single = km.make_planner(pk, H, opt_iters=2)(state, torch.tensor(target))
    one = km.make_multistart_planner(pk, H, restarts=1, opt_iters=2)(
        state, torch.tensor(target), torch.Generator().manual_seed(0))
    for x, y in zip(one, single):
        assert torch.equal(x, y)
    best = km.make_multistart_planner(pk, H, restarts=3, opt_iters=2)(
        state, torch.tensor(target), torch.Generator().manual_seed(0))
    assert best.tensions.shape == (H, 4) and best.tips.shape == (H, 3)
    assert best.cost_history.shape == (2,)
    assert float(best.cost) <= float(single.cost) * (1 + 1e-12)
    with pytest.raises(TypeError, match="unexpected"):
        km.make_multistart_planner(pk, H, horizon_typo=1)


def test_controller_advances(rods, target):
    pk = rods[1]
    ctl = km.MPCController(pk, horizon=H, first_iters=2, replan_iters=1,
                           _root="k2")
    tips = []
    for _ in range(2):
        u0, info = ctl.act(torch.tensor(target))
        assert u0.shape == (4,) and bool(((u0 >= 0) & (u0 <= 20)).all())
        assert np.isfinite(info["cost"])
        assert info["predicted_tips"].shape == (H, 3)
        assert torch.equal(ctl.state.y[-1, 0:3], info["tip"])
        tips.append(info["tip"])
    assert ctl._logits.shape == (H, 4)
    assert not torch.equal(tips[0], tips[1])      # the rod moved
    assert not ctl.state.y.requires_grad          # the advance keeps no graph
    ctl.reset()
    assert ctl._logits is None and torch.equal(
        ctl.state.y, km.PlanState.initial(pk).y)
