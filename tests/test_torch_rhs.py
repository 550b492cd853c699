"""The port's quaternion ops, KNODE MLP and rod RHS against the JAX package
(float64 on the CPU, rtol 1e-12)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import knode_cosserat_tpu as J
import knode_cosserat_tpu_torch as K
from knode_cosserat_tpu.models import mlp as jmlp
from knode_cosserat_tpu.ops import quaternion as jq
from knode_cosserat_tpu_torch.models import mlp as kmlp
from knode_cosserat_tpu_torch.ops import quaternion as kq

torch.set_num_threads(1)
RTOL = 1e-12


def _jax_net(dims, activation, seed, scale=1.0):
    spec = jmlp.MLPSpec(dims=dims, activation=activation,
                        history=dims[0] == 53)
    params = jmlp.init_mlp(spec, jax.random.PRNGKey(seed), jnp.float64)
    params = jax.tree.map(lambda a: a * scale, params)
    kspec = kmlp.MLPSpec(dims=dims, activation=activation,
                         history=dims[0] == 53)
    return spec, params, kspec, kmlp.params_from_jax(params, kspec, device="cpu")


def test_quaternion_ops():
    rng = np.random.RandomState(0)
    h = rng.randn(5, 7, 4)
    u = rng.randn(5, 7, 3)
    np.testing.assert_allclose(kq.quat_to_rotmat(torch.tensor(h)).numpy(),
                               np.asarray(jq.quat_to_rotmat(jnp.asarray(h))),
                               rtol=RTOL, atol=1e-15)
    np.testing.assert_allclose(
        kq.quat_spatial_derivative(torch.tensor(u), torch.tensor(h)).numpy(),
        np.asarray(jq.quat_spatial_derivative(jnp.asarray(u), jnp.asarray(h))),
        rtol=RTOL, atol=1e-15)


@pytest.mark.parametrize("activation", ["elu", "tanh", "relu", "softplus"])
@pytest.mark.parametrize("dims", [(28, 16, 25), (53, 12, 25), (28, 8, 12, 25)])
def test_mlp_apply_matches_jax(dims, activation):
    spec, params, kspec, net = _jax_net(dims, activation, seed=len(dims))
    x = np.random.RandomState(1).randn(6, 4, dims[0]) * 3.0
    want = np.asarray(jmlp.mlp_apply(spec, params, jnp.asarray(x)))
    got = kmlp.mlp_apply(kspec, net, torch.tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-14)
    assert kmlp.count_params(net) == jmlp.count_params(params)


def test_init_and_clamp():
    spec = kmlp.MLPSpec.for_knode(64)
    net = kmlp.init_mlp(spec, torch.Generator().manual_seed(0),
                        torch.float64, device="cpu")
    w0, b0 = (t.detach() for t in net.weights()[0])
    assert w0.shape == (64, 28) and b0.shape == (64,)
    assert bool((w0 >= 0).all())                       # |N(0.01, 0.01)|
    assert abs(float(w0.mean()) - 0.0126) < 2e-3       # E|N(.01,.01)|
    assert abs(float(b0.std()) - 0.01) < 3e-3
    same = kmlp.init_mlp(spec, torch.Generator().manual_seed(0),
                         torch.float64, device="cpu")
    assert torch.equal(same.weights()[1][0], net.weights()[1][0])
    with torch.no_grad():
        net.layers[1].weight.sub_(0.05)
    kmlp.clamp_nonnegative(net)
    assert bool((net.layers[1].weight >= 0).all())


@pytest.mark.parametrize("net_kind", [None, 28, 53])
def test_rhs_matches_jax(net_kind):
    pj, pk = J.apply_mod("damping"), K.apply_mod("damping", device="cpu")
    rng = np.random.RandomState(2)
    y = rng.randn(4, 5, 19)
    y[..., 3:7] += np.array([1.0, 0, 0, 0])
    yh, zh, tf = rng.randn(4, 5, 19), rng.randn(4, 5, 6), rng.randn(4, 1, 3)
    nn_j = nn_k = None
    history = net_kind == 53
    if net_kind:
        spec, params, kspec, net = _jax_net((net_kind, 16, 25), "elu", 3)
        nn_j, nn_k = jmlp.bind(spec, params), kmlp.bind(kspec, net)
    dj, zj = J.rhs(pj, *map(jnp.asarray, (y, yh, zh, tf)), nn_j, history)
    dk, zk = K.rhs(pk, *map(torch.tensor, (y, yh, zh, tf)), nn_k, history)
    np.testing.assert_allclose(dk.detach().numpy(), np.asarray(dj), rtol=RTOL,
                               atol=1e-9)
    np.testing.assert_allclose(zk.detach().numpy(), np.asarray(zj), rtol=RTOL,
                               atol=1e-12)
