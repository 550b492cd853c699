"""The port's whole Newton shooting step (the plain version of kernel K2)
against the JAX package: its Pallas step kernel in interpret mode, and its
FD-Newton driver over the XLA sweeps (float64 on the CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import knode_cosserat_tpu as J
import knode_cosserat_tpu_torch as K
from knode_cosserat_tpu.core import fast_rollout as jfr
from knode_cosserat_tpu.core.stepper import initial_state as jinit
from knode_cosserat_tpu.models import mlp as jmlp
from knode_cosserat_tpu.ops.pallas_step import make_step_kernel as jax_step
from knode_cosserat_tpu_torch.models import mlp as kmlp
from knode_cosserat_tpu_torch.ops import step as kstep

torch.set_num_threads(1)
RTOL, ATOL = 1e-9, 1e-10


def _step_inputs(pj, B, seed):
    """One BDF-2 step from a perturbed history around the straight rod."""
    rng = np.random.RandomState(seed)
    y0, z0 = (np.asarray(a) for a in jinit(pj))
    y = y0 + 1e-3 * rng.randn(B, pj.N, 19)
    z = z0 + 1e-3 * rng.randn(B, pj.N, 6)
    c1, c2 = float(pj.c1), float(pj.c2)
    tf = (5 + 2 * rng.rand(B, 4)) @ np.asarray(pj.tendon_dirs)
    return np.zeros((B, 6)), c1 * y + c2 * y0, c1 * z + c2 * z0, tf


def _nets(hidden, history, seed):
    spec = jmlp.MLPSpec.for_knode(hidden, history=history)
    params = jax.tree.map(lambda a: a * 1e-2,
                          jmlp.init_mlp(spec, jax.random.PRNGKey(seed),
                                        jnp.float64))
    return spec, params, kmlp.params_from_jax(
        params, kmlp.MLPSpec.for_knode(hidden, history=history), device="cpu")


def _check(got, want, n=4):
    for name, g, w in zip(("G", "y", "z", "r2"), got[:n], want[:n]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_step_reference_matches_pallas_interpret():
    pj, pk = J.apply_mod("nsw"), K.apply_mod("nsw", device="cpu")
    spec, params, net = _nets(8, False, seed=0)
    ins = _step_inputs(pj, 3, seed=1)
    k = jax.jit(jax_step(pj, spec, block_b=8, tol=1e-18, max_iter=30,
                         interpret=True))
    want = k(*map(jnp.asarray, ins), params)
    got = kstep.step_reference(pk, *map(torch.tensor, ins), net, tol=1e-18,
                               max_iter=30)
    _check(got, want)
    assert got[4].dtype == torch.int32 and got[4].shape == (3,)


@pytest.mark.parametrize("method,history", [("euler", None), ("rk4", None),
                                            ("euler", False)])
def test_step_reference_matches_fd1_driver(method, history):
    """K2's semantics are JAX's _build_step with fd_order=1 and a Jacobian
    refreshed every iteration (JAX's XLA sweeps take no history net)."""
    pj, pk = J.apply_mod(None), K.apply_mod(None, device="cpu")
    spec = params = net = None
    if history is not None:
        spec, params, net = _nets(8, history, seed=2)
    rng = np.random.RandomState(3)
    y0, z0 = (np.asarray(a) for a in jinit(pj))
    y = jnp.asarray(y0 + 1e-3 * rng.randn(4, pj.N, 19))
    z = jnp.asarray(z0 + 1e-3 * rng.randn(4, pj.N, 6))
    y_prev, z_prev = (jnp.broadcast_to(a, b.shape) for a, b in ((y0, y), (z0, z)))
    tensions = jnp.asarray(5 + 2 * rng.rand(4, 4))
    k_res = jfr._xla_sweeps(pj, spec, want_rod=False, method=method)
    k_full = jfr._xla_sweeps(pj, spec, want_rod=True, method=method)
    drv = jfr._build_step(pj, k_res, k_full, 1e-16, 30, 7, 1, 1)
    y_new, z_new, G_new, yh, zh, r2, it = jax.jit(drv)(
        y, z, y_prev, z_prev, jnp.zeros((4, 6)), tensions, params)
    tf = np.asarray(tensions) @ np.asarray(pj.tendon_dirs)
    got = kstep.step_reference(pk, torch.zeros(4, 6, dtype=torch.float64),
                               *(torch.tensor(np.asarray(a)) for a in (yh, zh)),
                               torch.tensor(tf), net, tol=1e-16, max_iter=30,
                               method=method)
    _check(got, (G_new, y_new, z_new[:, :-1], r2))
    assert int(got[4].max()) == int(it)   # iters: per rod here, compare max


def test_make_step_kernel_on_cpu_is_the_reference():
    pk = K.apply_mod(None, device="cpu")
    G, yh, zh, tf = map(torch.tensor, _step_inputs(J.apply_mod(None), 2, 4))
    k = kstep.make_step_kernel(pk, tol=1e-16)
    for a, b in zip(k(G, yh, zh, tf),
                    kstep.step_reference(pk, G, yh, zh, tf, tol=1e-16)):
        assert torch.equal(a, b)
    assert kstep.fd1_eps(torch.float64) == 1e-8
    assert kstep.fd1_eps(torch.float32) == 3e-4
