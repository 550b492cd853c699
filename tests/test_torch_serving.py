"""The port's serving stepper against the JAX package's (float64 on the
CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import knode_cosserat_tpu as J
import knode_cosserat_tpu_torch as K
from knode_cosserat_tpu.models import mlp as jmlp
from knode_cosserat_tpu.serving import CompiledStepper as JaxStepper
from knode_cosserat_tpu_torch.models import mlp as kmlp
from knode_cosserat_tpu_torch.serving import CompiledStepper

torch.set_num_threads(1)


@pytest.mark.parametrize("fast", [False, True])
def test_stepper_matches_jax(fast):
    pj, pk = J.apply_mod(None), K.apply_mod(None, device="cpu")
    kw = dict(tol=1e-16, max_iter=50)
    js = JaxStepper(pj, fast=fast, fast_impl="xla" if fast else None, **kw)
    ks = CompiledStepper(pk, fast=fast, **kw)
    ctl = J.calc_controls("sine", 1.0, float(pj.del_t), 5)
    sj, sk = js.reset(), ks.reset()
    for t in range(4):
        sj, ij = js.step(sj, ctl[t])
        sk, ik = ks.step(sk, ctl[t])
        assert float(ik["residual"]) < 1e-7
    for a, b in ((sk.y, sj.y), (sk.z, sj.z), (sk.G, sj.G),
                 (sk.y_prev, sj.y_prev)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                   atol=1e-9)


def test_stepper_batched_hybrid_matches_jax():
    pj, pk = J.apply_mod("nsw"), K.apply_mod("nsw", device="cpu")
    spec = jmlp.MLPSpec.for_knode(16)
    params = jax.tree.map(lambda a: a * 1e-3,
                          jmlp.init_mlp(spec, jax.random.PRNGKey(0),
                                        jnp.float64))
    kspec = kmlp.MLPSpec.for_knode(16)
    net = kmlp.params_from_jax(params, kspec, device="cpu")
    tensions = np.array([[6.0, 5.0, 4.0, 5.0], [5.0, 6.5, 5.0, 4.0],
                         [5.5, 5.5, 5.5, 5.5]])
    for fast in (False, True):
        js = JaxStepper(pj, spec=spec, nn_params=params, batch=3, fast=fast,
                        fast_impl="xla" if fast else None)
        ks = CompiledStepper(pk, spec=kspec, nn_params=net, batch=3, fast=fast)
        sj, sk = js.reset(), ks.reset()
        for _ in range(2):
            sj, _ = js.step(sj, tensions)
            sk, info = ks.step(sk, tensions)
        assert sk.y.shape == (3, pk.N, 19)
        np.testing.assert_allclose(sk.y.numpy(), np.asarray(sj.y), rtol=1e-9,
                                   atol=1e-9)
    b = ks.benchmark(n=3, reps=1)
    assert b["device"] == "cpu" and b["latency_ms"] > 0
    assert np.isfinite(b["realtime_factor"])
