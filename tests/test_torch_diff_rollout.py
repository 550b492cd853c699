"""The port's differentiable rod against the JAX package (float64 on the
CPU): the one differentiable derive (core/params.derive) against the JAX
host derive and its traced twin, shooting.implicit_root, and
simulate_scan(differentiable=True, remat=True): gradients through every
implicit BDF-2 solve with respect to gravity, the tensions and the net's
weights, and remat against the plain path to second order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knode_cosserat_tpu.controls import calc_controls
from knode_cosserat_tpu.core import params as jp
from knode_cosserat_tpu.core import stepper as js
from knode_cosserat_tpu.models import mlp as jmlp
from knode_cosserat_tpu_torch.core import params as kp
from knode_cosserat_tpu_torch.core import stepper as ks
from knode_cosserat_tpu_torch.core.shooting import implicit_root
from knode_cosserat_tpu_torch.models.mlp import MLPSpec, bind, params_from_jax

torch.set_num_threads(1)
GRAD_RTOL = 1e-6
DERIVED = ("A", "Gmod", "ds", "J", "Kse", "Kbt", "c0", "c1", "c2",
           "Kse_c0Bse_inv", "Kbt_c0Bbt_inv", "Kse_vstar", "v_rest", "rhoA",
           "rhoAg", "rhoJ")
T = 5


@pytest.fixture(scope="module")
def rods():
    return jp.make_rod(N=6, dtype=jnp.float64), kp.make_rod(N=6, device="cpu")


@pytest.fixture(scope="module")
def ctl(rods):
    return calc_controls("sine", 1.0, float(rods[0].del_t), T)


def _tip_x(out):
    return out.traj[-1, -1, 0]


@pytest.mark.parametrize("rod", ["experimental", "original", "paper"])
def test_derive_matches_host_and_traced(rod):
    """The new derive against the JAX package's host-numpy derive (relative
    1e-15; it is equal bit for bit) and its derive_traced (relative 1e-12),
    and in float32 the float64-conditioned values cast once (bit for
    bit)."""
    make = {"experimental": "experimental_rod", "original": "original_rod",
            "paper": "make_rod"}[rod]
    kw = {} if rod == "paper" else {"mod": "damping"}
    pj = getattr(jp, make)(dtype=jnp.float64, **kw)
    pk = getattr(kp, make)(device="cpu", **kw)
    pt = jp.derive_traced(pj)
    for name in DERIVED:
        got = getattr(pk, name).numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(pj, name)),
                                   rtol=1e-15, atol=0, err_msg=name)
        np.testing.assert_allclose(got, np.asarray(getattr(pt, name)),
                                   rtol=1e-12, atol=0, err_msg=name)
    pj32 = getattr(jp, make)(dtype=jnp.float32, **kw)
    pk32 = getattr(kp, make)(dtype=torch.float32, device="cpu", **kw)
    for name in DERIVED:
        np.testing.assert_array_equal(getattr(pk32, name).numpy(),
                                      np.asarray(getattr(pj32, name)),
                                      err_msg=name)


def test_derive_gradients_match_traced(rods):
    """d(a scalar of every derived field)/d(base leaves): the port's derive
    against jax.grad through derive_traced."""
    pj, pk = rods
    names = ("E", "r", "L", "rho", "del_t", "Bbt", "Bse", "vstar", "g")
    w = {n: np.asarray(np.random.RandomState(i).rand(*np.shape(np.asarray(
        getattr(pj, n))))) for i, n in enumerate(DERIVED)}

    def jscore(leaves):
        q = jp.derive_traced(pj.replace(**leaves))
        return sum(jnp.sum(w[n] * getattr(q, n)) for n in DERIVED)

    want = jax.grad(jscore)({n: getattr(pj, n) for n in names})
    leaves = {n: getattr(pk, n).clone().requires_grad_(True) for n in names}
    q = kp.derive(pk.replace(**leaves), device="cpu")
    score = sum((torch.from_numpy(w[n]) * getattr(q, n)).sum()
                for n in DERIVED)
    got = torch.autograd.grad(score, [leaves[n] for n in names])
    for n, g in zip(names, got):
        w = np.asarray(want[n])
        # relative to each leaf's largest entry: the inverses' gradients
        # (LAPACK's here, the adjugate's in derive_traced) round apart
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12,
                                   atol=1e-12 * np.abs(w).max(), err_msg=n)


def test_implicit_root_batched_roots_and_gradients():
    """Independent roots of r(x, a) = x^3 + x - a, one per row: the value is
    the root, the gradient -J^-1 dr/da = 1 / (3x^2 + 1), the second
    derivative -6x / (3x^2 + 1)^3 (exact: ``a`` is an explicit argument),
    and stats report iterations 0 and converged from the residual."""
    a = torch.tensor([[0.5, 2.0], [3.0, -1.0]], dtype=torch.float64,
                     requires_grad=True)
    res = lambda x, a: x ** 3 + x - a
    x, stats = implicit_root(res, torch.zeros(2, 2, dtype=torch.float64),
                             tol=1e-28, args=(a,))
    np.testing.assert_allclose(res(x, a).detach().numpy(), 0, atol=1e-13)
    (g,) = torch.autograd.grad(x.sum(), a, create_graph=True)
    xd = x.detach()
    np.testing.assert_allclose(g.detach().numpy(),
                               (1 / (3 * xd ** 2 + 1)).numpy(), rtol=1e-12)
    (h,) = torch.autograd.grad(g.sum(), a)
    np.testing.assert_allclose(h.numpy(), (-6 * xd / (3 * xd ** 2 + 1) ** 3)
                               .numpy(), rtol=1e-10)
    assert stats.iterations.shape == (2,) and int(stats.iterations.max()) == 0
    assert bool(stats.converged.all())


@pytest.fixture(scope="module")
def gradients(rods, ctl):
    """d(tip x after the rollout) with respect to the tensions, gravity (it
    enters through the derived rhoAg: the gradient flows through the
    differentiable derive) and the hybrid rod's net weights, in one
    rollout of each package (JAX: one jax.grad through custom_root)."""
    pj, pk = rods
    spec_j = jmlp.MLPSpec.for_knode(8)
    params = jax.tree.map(lambda x: x * 1e-3, jmlp.init_mlp(
        spec_j, jax.random.PRNGKey(0), jnp.float64))

    def jtip(c, g, q):
        return _tip_x(js.simulate_scan(
            jp.derive_traced(pj.replace(g=g)), c,
            nn_fn=jmlp.bind(spec_j, q), differentiable=True))

    want = jax.grad(jtip, argnums=(0, 1, 2))(jnp.asarray(ctl),
                                              jnp.asarray(pj.g), params)
    spec = MLPSpec.for_knode(8)
    net = params_from_jax(params, spec, device="cpu")
    c = torch.tensor(ctl, requires_grad=True)
    g = pk.g.clone().requires_grad_(True)
    out = ks.simulate_scan(kp.derive(pk.replace(g=g), device="cpu"), c,
                           nn_fn=bind(spec, net), differentiable=True)
    got = torch.autograd.grad(_tip_x(out), [c, g, *net.parameters()])
    return want, got, out


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * np.abs(want).max())


def test_rollout_gradient_wrt_tensions_matches_jax(gradients):
    want, got, out = gradients
    _close(got[0], want[0])
    # the implicit path's stats: iterations unavailable, converged honest
    assert int(out.newton_iters.max()) == 0
    assert bool((out.residuals[1:] < 1e-8).all())


def test_rollout_gradient_wrt_gravity_matches_jax(gradients):
    want, got, _ = gradients
    _close(got[1], want[1])


def test_rollout_gradient_wrt_net_weights_matches_jax(gradients):
    want, got, _ = gradients
    flat = [a for layer in want[2] for a in (layer["w"], layer["b"])]
    for a, b in zip(got[2:], flat):
        _close(a, b)


def test_remat_equals_plain_to_second_order(rods, ctl):
    """remat=True (torch.utils.checkpoint per step) recomputes each root
    deterministically: the first and second derivatives with respect to
    log E equal the plain path's (relative 1e-12). (The second derivative
    through the implicit solves is held to jax.hessian by
    test_torch_sysid.py's Laplace posterior.)"""
    pk = rods[1]
    got = []
    for remat in (False, True):
        lE = torch.tensor(float(np.log(float(pk.E))), dtype=torch.float64,
                          requires_grad=True)
        out = ks.simulate_scan(kp.derive(pk.replace(E=torch.exp(lE)),
                                         device="cpu"),
                               torch.tensor(ctl), differentiable=True,
                               remat=remat)
        (g1,) = torch.autograd.grad(_tip_x(out), lE, create_graph=True)
        (g2,) = torch.autograd.grad(g1, lE)
        got.append((float(g1.detach()), float(g2)))
    (g_plain, h_plain), (g_remat, h_remat) = got
    assert g_remat == pytest.approx(g_plain, rel=1e-12)
    assert h_remat == pytest.approx(h_plain, rel=1e-12)
    assert np.isfinite(h_plain) and h_plain != 0.0


def test_non_differentiable_rollout_records_no_graph(rods, ctl):
    c = torch.tensor(ctl, requires_grad=True)
    out = ks.simulate_scan(rods[1], c)
    assert not out.traj.requires_grad
    ref = ks.simulate_scan(rods[1], torch.tensor(ctl), differentiable=True)
    np.testing.assert_allclose(out.traj.numpy(), ref.traj.detach().numpy(),
                               rtol=0, atol=1e-12)
