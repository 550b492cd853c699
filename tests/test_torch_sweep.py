"""The port's spatial sweep (the plain version of kernel K3, with K1 inside)
against the JAX package: its XLA integrators, and once its Pallas kernel in
interpret mode (float64 on the CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import knode_cosserat_tpu as J
import knode_cosserat_tpu_torch as K
from knode_cosserat_tpu.core.spatial import (integrate_euler, integrate_rk4,
                                             tip_residual)
from knode_cosserat_tpu.models import mlp as jmlp
from knode_cosserat_tpu.ops.pallas_sweep import make_sweep_kernel as jax_sweep
from knode_cosserat_tpu_torch.models import mlp as kmlp
from knode_cosserat_tpu_torch.ops import sweep as ksweep

torch.set_num_threads(1)
RTOL, ATOL = 1e-10, 1e-12


def _inputs(p, B, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, 6) * 0.01, rng.randn(B, p.N, 19),
            rng.randn(B, p.N, 6), rng.randn(B, 3))


def _nets(hidden, history, seed=0):
    spec = jmlp.MLPSpec.for_knode(hidden, history=history)
    params = jax.tree.map(lambda a: a * 0.1,
                          jmlp.init_mlp(spec, jax.random.PRNGKey(seed),
                                        jnp.float64))
    kspec = kmlp.MLPSpec.for_knode(hidden, history=history)
    return spec, params, kspec, kmlp.params_from_jax(params, kspec, device="cpu")


def _jax_rows(pj, method, G, yh, zh, tf, nn_fn=None, history=False):
    def one(g, a, b, c):
        if method == "euler":
            y, z = integrate_euler(pj, g, a, b, c, nn_fn, history)
        else:
            y, z = integrate_rk4(pj, g, a, b, 0.5 * (a[:-1] + a[1:]),
                                 0.5 * (b[:-1] + b[1:]), c, nn_fn, history)
        return tip_residual(pj, y), y, z
    return jax.vmap(one)(*map(jnp.asarray, (G, yh, zh, tf)))


def _check(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("method", ["euler", "rk4"])
@pytest.mark.parametrize("history", [None, False, True])
def test_sweep_reference_matches_integrators(method, history):
    pj, pk = J.apply_mod("short"), K.apply_mod("short", device="cpu")
    ins = _inputs(pk, 4, seed=3)
    nn_fn = net = None
    if history is not None:
        spec, params, _, net = _nets(12, history)
        nn_fn = jmlp.bind(spec, params)
    want = _jax_rows(pj, method, *ins, nn_fn, bool(history))
    got = ksweep.sweep_reference(pk, *map(torch.tensor, ins), net, method)
    _check(got, want)
    # the kernel wrapper takes the plain version for a CPU tensor
    kspec = net.spec if net is not None else None
    k = ksweep.make_sweep_kernel(pk, kspec, method=method, want_rod=False)
    res = k(*map(torch.tensor, ins), net)
    np.testing.assert_array_equal(res.detach().numpy(), got[0].detach().numpy())


def test_sweep_reference_matches_pallas_interpret():
    """One case against the JAX Pallas kernel itself (interpret mode)."""
    pj, pk = J.apply_mod(None), K.apply_mod(None, device="cpu")
    spec, params, _, net = _nets(8, False, seed=4)
    ins = _inputs(pk, 3, seed=5)
    k = jax_sweep(pj, spec, block_b=8, interpret=True)
    want = k(*map(jnp.asarray, ins), params)
    got = ksweep.sweep_reference(pk, *map(torch.tensor, ins), net)
    _check(got, want)


def test_kernel_spec_checks():
    ksweep.check_spec(None)
    ksweep.check_spec(kmlp.MLPSpec.for_knode(512, history=True))
    # nets of any depth up to MAX_LAYERS layers (the JAX kernels' dims loop)
    ksweep.check_spec(kmlp.MLPSpec(dims=(28, 16, 16, 25)))
    ksweep.check_spec(kmlp.MLPSpec(dims=(53, 16, 16, 16, 25), history=True))
    with pytest.raises(ValueError, match="at most"):
        ksweep.check_spec(kmlp.MLPSpec(dims=(28,) + (8,) * 8 + (25,)))
    with pytest.raises(ValueError, match="not a KNODE net"):
        ksweep.check_spec(kmlp.MLPSpec(dims=(28, 16, 16, 24)))
    with pytest.raises(ValueError, match="not a KNODE net"):
        ksweep.check_spec(kmlp.MLPSpec(dims=(53, 16, 16, 25)))
    with pytest.raises(ValueError):
        ksweep.check_spec(kmlp.MLPSpec(dims=(28, 16, 25), activation="identity"))


def test_wrapper_refuses_other_devices_and_bad_inputs():
    pk = K.apply_mod(None, device="cpu")
    G, yh, zh, tf = map(torch.tensor, _inputs(pk, 2, seed=6))
    k = ksweep.make_sweep_kernel(pk)
    with pytest.raises(ValueError, match="device"):
        k(G.to("meta"), yh.to("meta"), zh.to("meta"), tf.to("meta"))
    with pytest.raises(ValueError, match="shape"):
        ksweep.check_inputs(pk, G, yh[:, :-1], zh, tf)
    with pytest.raises(ValueError, match="contiguous"):
        ksweep.check_inputs(pk, G, yh, zh, tf.t().contiguous().t())
