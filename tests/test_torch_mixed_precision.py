"""The port's mixed-precision nets (MLPSpec.compute_dtype,
TrainConfig.nn_dtype) against the JAX package's, float32 on the CPU.

The same bfloat16 casts must agree far more closely than bfloat16 with
float32 (the JAX test's 2e-2): the products of bfloat16 operands are exact
in float32, so the two packages differ only by the order of summation
(relative 1e-6 here). The master weights stay float32 and take the
gradients; the fused trainers decline the spec; the plain K2 version
applies the casts."""
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
from knode_cosserat_tpu_torch.models.mlp import (MLPSpec, init_mlp,
                                                 mlp_apply, params_from_jax)
from knode_cosserat_tpu_torch.ops.train import fused_trainer_supported
from knode_cosserat_tpu_torch.ops.train_wide import wide_trainer_supported
from knode_cosserat_tpu_torch.training import train as ktrain

torch.set_num_threads(1)
BF16 = "bfloat16"


@pytest.fixture(scope="module")
def nets():
    spec = jmlp.MLPSpec.for_knode(64)
    params = jmlp.init_mlp(spec, jax.random.PRNGKey(0), jnp.float32)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (256, 28),
                                     jnp.float32))
    return params, x


@pytest.mark.parametrize("history", [False, True])
def test_bf16_apply_matches_jax(history):
    jspec = jmlp.MLPSpec.for_knode(64, history=history, compute_dtype=BF16)
    params = jmlp.init_mlp(jspec, jax.random.PRNGKey(0), jnp.float32)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                     (256, jspec.dims[0]), jnp.float32))
    want = np.asarray(jmlp.mlp_apply(jspec, params, jnp.asarray(x)))
    spec = MLPSpec.for_knode(64, history=history, compute_dtype=BF16)
    net = params_from_jax(params, spec, device="cpu")
    got = net(torch.tensor(x))
    assert got.dtype == torch.float32               # the caller's dtype
    rel = np.abs(got.detach().numpy() - want).max() / np.abs(want).max()
    assert rel < 1e-6, rel
    # and the casts are really applied: float32 is ~1e-3 away
    f32 = np.asarray(jmlp.mlp_apply(jmlp.MLPSpec.for_knode(
        64, history=history), params, jnp.asarray(x)))
    assert np.abs(got.detach().numpy() - f32).max() > 100 * rel * np.abs(
        want).max()


def test_mlp_apply_takes_the_spec_it_is_given(nets):
    """mlp_apply(spec16, net32, x) computes under the bf16 spec, as the
    JAX function takes the spec it is called with."""
    params, x = nets
    net = params_from_jax(params, MLPSpec.for_knode(64), device="cpu")
    spec16 = MLPSpec.for_knode(64, compute_dtype=BF16)
    want = np.asarray(jmlp.mlp_apply(jmlp.MLPSpec.for_knode(
        64, compute_dtype=BF16), params, jnp.asarray(x)))
    got = mlp_apply(spec16, net, torch.from_numpy(x)).detach().numpy()
    assert np.abs(got - want).max() < 1e-6 * np.abs(want).max()
    # float64 features on float32 weights compute in float64 (promotion)
    x64 = torch.from_numpy(x).double()
    assert mlp_apply(spec16, net, x64).dtype == torch.float64


def test_bf16_gradients_land_on_f32_master_weights(nets):
    params, x = nets
    spec = MLPSpec.for_knode(64, compute_dtype=BF16)
    net = params_from_jax(params, spec, device="cpu")
    loss = (net(torch.from_numpy(x)) ** 2).sum()
    loss.backward()
    for P in net.parameters():
        assert P.dtype == torch.float32 and P.grad.dtype == torch.float32
        assert bool(torch.isfinite(P.grad).all())
        assert float(P.grad.abs().max()) > 0


def test_fused_trainers_decline_mixed_precision():
    spec = MLPSpec.for_knode(512, compute_dtype=BF16)
    assert not fused_trainer_supported(spec, 128)
    assert not wide_trainer_supported(spec, 128)
    for dev in ("cpu", "cuda"):
        cfg = ktrain.TrainConfig(hidden=512, nn_dtype=BF16, fused="auto")
        assert cfg.spec() == spec
        assert ktrain._resolve_fused(cfg, spec, 128,
                                     torch.device(dev)) is None
        for mode in ("on", "plain", "wide"):
            with pytest.raises(ValueError, match="does not support"):
                ktrain._resolve_fused(ktrain.TrainConfig(
                    nn_dtype=BF16, fused=mode), spec, 128, torch.device(dev))


def test_train_knode_bf16_trains():
    """A short mixed-precision run on the plain epoch loop (the JAX test's
    configuration, on data of the JAX rollout): the loss falls and the
    master weights stay float32."""
    jrod = jp.make_rod(N=10, dtype=jnp.float32)
    ctl = calc_controls("sine", 0.5, float(jrod.del_t), 12)
    traj = np.asarray(js.simulate_scan(jrod, jnp.asarray(ctl, jnp.float32),
                                       tol=1e-10).traj[:, :, :25])
    cfg = ktrain.TrainConfig(epochs=20, hidden=64, eval_every=1000,
                             log_every=1000, nn_dtype=BF16, fused="off",
                             seed=0)
    res = ktrain.train_knode(kp.make_rod(N=10, dtype=torch.float32,
                                         device="cpu"),
                             traj[None], ctl[None], cfg, log=None)
    hist = res.loss_history
    assert all(P.dtype == torch.float32 for P in res.params.parameters())
    assert res.params.spec.compute_dtype == BF16
    assert np.isfinite(hist).all() and hist[-1] < hist[0]


def test_plain_k2_applies_the_casts():
    """K2's plain version (rollout_with_nn(impl="mega") on a CPU rod) runs
    the bf16 net, as the plain autodiff scan does; on the card K2 computes
    the net in float32 (ops/step.py)."""
    p = kp.make_rod(N=6, dtype=torch.float64, device="cpu")
    ctl = calc_controls("sine", 0.5, float(p.del_t), 5)
    spec = MLPSpec.for_knode(16, compute_dtype=BF16)
    net = init_mlp(spec, torch.Generator().manual_seed(0), torch.float64,
                   "cpu")
    full = init_mlp(MLPSpec.for_knode(16), torch.Generator().manual_seed(0),
                    torch.float64, "cpu")          # the same weights
    mega = ktrain.rollout_with_nn(p, ctl, spec, net, impl="mega")
    scan = ktrain.rollout_with_nn(p, ctl, spec, net, impl="scan")
    f64 = ktrain.rollout_with_nn(p, ctl, full.spec, full, impl="scan")
    # relative to the largest entry (the BDF-2 history columns reach ~2e3)
    err = float((mega - scan).abs().max() / scan.abs().max())
    assert err < 1e-8, err
    assert float((scan - f64).abs().max() / scan.abs().max()) > 100 * err
