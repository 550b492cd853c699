"""The port's rollouts against the JAX package (float64 on the CPU): the
autodiff-Newton scan rollout, the fast rollout drivers against the JAX
mega kernel in interpret mode, and two reference goldens."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import knode_cosserat_tpu as J
import knode_cosserat_tpu_torch as K
from conftest import load_golden
from knode_cosserat_tpu.core.fast_rollout import make_fast_rollout as jax_roll
from knode_cosserat_tpu.models import mlp as jmlp
from knode_cosserat_tpu_torch.core.fast_rollout import (make_fast_rollout,
                                                        mega_rollout_cached)
from knode_cosserat_tpu_torch.models import mlp as kmlp

torch.set_num_threads(1)


def _nets(hidden, history, seed):
    spec = jmlp.MLPSpec.for_knode(hidden, history=history)
    params = jax.tree.map(lambda a: a * 1e-3,
                          jmlp.init_mlp(spec, jax.random.PRNGKey(seed),
                                        jnp.float64))
    kspec = kmlp.MLPSpec.for_knode(hidden, history=history)
    return spec, params, kspec, kmlp.params_from_jax(params, kspec, device="cpu")


@pytest.mark.parametrize("case", ["euler", "rk4", "hybrid"])
def test_simulate_scan_matches_jax(case):
    mod = "nsw" if case == "hybrid" else None
    pj, pk = J.apply_mod(mod), K.apply_mod(mod, device="cpu")
    method = "rk4" if case == "rk4" else "euler"
    ctl = J.calc_controls("sine", 1.0, float(pj.del_t), 6)
    nn_j = nn_k = None
    if case == "hybrid":
        spec, params, _, net = _nets(8, True, seed=0)
        nn_j, nn_k = jmlp.bind(spec, params), net
    want = J.simulate_scan(pj, jnp.asarray(ctl), nn_fn=nn_j,
                           nn_history=case == "hybrid", method=method)
    got = K.simulate_scan(pk, torch.tensor(ctl), nn_fn=nn_k,
                          nn_history=case == "hybrid", method=method)
    assert got.traj.shape == (6, pk.N, 50)
    np.testing.assert_allclose(got.traj.detach().numpy(), np.asarray(want.traj),
                               rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(got.G.detach().numpy(), np.asarray(want.G),
                               rtol=1e-9, atol=1e-10)
    assert int(got.newton_iters.max()) == int(want.newton_iters.max())


@pytest.fixture(scope="module", params=["euler", "rk4"])
def jax_mega_rollout(request):
    """The JAX mega rollout of the hybrid rod (interpret mode) with the
    Euler or the RK4 sweep."""
    method = request.param
    pj = J.apply_mod("nsw")
    spec, params, kspec, net = _nets(8, False, seed=1)
    ctls = np.stack([J.calc_controls("sine", 1.0, float(pj.del_t), 6),
                     J.calc_controls("step", 1.0, float(pj.del_t), 6)])
    roll = jax.jit(jax_roll(pj, spec=spec, tol=1e-18, impl="mega", block_b=8,
                            interpret=True, method=method))
    traj, res, iters = roll(jnp.asarray(ctls), params)
    return method, ctls, kspec, net, np.asarray(traj), np.asarray(iters)


@pytest.mark.parametrize("impl", ["plain", "mega"])
def test_fast_rollout_matches_jax_mega(jax_mega_rollout, impl):
    method, ctls, kspec, net, want, _ = jax_mega_rollout
    pk = K.apply_mod("nsw", device="cpu")
    roll = make_fast_rollout(pk, kspec, tol=1e-18, impl=impl, method=method)
    traj, res, iters = roll(torch.tensor(ctls), net)
    assert traj.shape == want.shape and res.shape == (5, 2)
    assert iters.shape == (5, 2) and iters.dtype == torch.int32
    # the FD1 floor of the line search (as the JAX package's own mega test)
    np.testing.assert_allclose(traj.numpy(), want, rtol=1e-7, atol=2e-8)


def test_mega_rollout_cache_is_keyed_by_content():
    rod = lambda mod: K.apply_mod(mod, device="cpu")
    a = mega_rollout_cached(rod("short"))
    assert mega_rollout_cached(rod("short")) is a
    assert mega_rollout_cached(rod("short"), max_iter=7) is not a
    assert mega_rollout_cached(rod("youngs")) is not a


@pytest.mark.parametrize("name,mod,bar", [("sine_0_5_30_None", None, 1e-7),
                                          ("sine_1_0_30_nsw", "nsw", 1e-7)])
def test_golden_trajectories(golden_dir, name, mod, bar):
    """Reference goldens at the JAX package's own bars (test_parity.py)."""
    controls, ref = load_golden(golden_dir, name)
    traj = K.simulate(K.apply_mod(mod, device="cpu"), controls,
                      reference_layout=True)
    assert traj.shape == ref.shape
    rmse = float(np.sqrt(np.mean((traj.numpy() - ref) ** 2)))
    assert rmse < bar, f"RMSE {rmse:.3e} vs reference for {name}"
