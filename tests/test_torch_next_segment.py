"""The fused next-segment op (the plain version of kernel K8) against the
JAX package (float64 on the CPU): its Pallas kernel in interpret mode, the
gradients of its custom VJP, and one make_train_step(use_pallas=True)
step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import knode_cosserat_tpu as J
import knode_cosserat_tpu_torch as K
from knode_cosserat_tpu.models import mlp as jmlp
from knode_cosserat_tpu.ops import pallas_rhs as jrhs
from knode_cosserat_tpu.training import data as jdata
from knode_cosserat_tpu.training import train as jtrain
from knode_cosserat_tpu_torch.models import mlp as kmlp
from knode_cosserat_tpu_torch.ops import next_segment as kseg
from knode_cosserat_tpu_torch.training import train as ktrain

torch.set_num_threads(1)
# f64, the same arithmetic in another order (and expm1 against the JAX
# kernel's exp(x) - 1 for ELU): agreement to rounding
FWD_RTOL, FWD_ATOL = 1e-12, 1e-12
GRAD_RTOL, GRAD_ATOL = 1e-10, 1e-12


def _cells(p, B, seed):
    """B cells around the straight rod: y, yh (B, 19), zh (B, 6), tf (B, 3)."""
    g = np.random.RandomState(seed)
    y0 = np.zeros(19)
    y0[3] = 1.0
    y = y0 + 1e-2 * g.randn(B, 19)
    c1, c2 = float(p.c1), float(p.c2)
    yh = (c1 + c2) * y0 + 1e-2 * g.randn(B, 19)
    zh = (c1 + c2) * np.eye(1, 6, 2)[0] + 1e-2 * g.randn(B, 6)
    tf = (5 + 2 * g.rand(B, 4)) @ np.asarray(p.tendon_dirs)
    return y, yh, zh, tf


def _nets(hidden, history, activation, seed=0):
    spec = jmlp.MLPSpec.for_knode(hidden, history=history,
                                  activation=activation)
    params = jmlp.init_mlp(spec, jax.random.PRNGKey(seed), jnp.float64)
    kspec = kmlp.MLPSpec.for_knode(hidden, history=history,
                                   activation=activation)
    return spec, params, kspec, kmlp.params_from_jax(params, kspec,
                                                     device="cpu")


@pytest.mark.parametrize("B,history,activation", [
    (64, False, "elu"), (100, True, "tanh"), (300, False, "tanh"),
    (300, True, "elu")])
def test_reference_matches_pallas_interpret(B, history, activation):
    pj, pk = J.apply_mod("nsw"), K.apply_mod("nsw", device="cpu")
    spec, params, kspec, net = _nets(16, history, activation)
    ins = _cells(pj, B, seed=B)
    fused = jrhs.make_fused_next_segment(pj, spec, interpret=True)
    want = fused(params, *map(jnp.asarray, ins))
    got = kseg.make_fused_next_segment(pk, kspec)(net,
                                                  *map(torch.tensor, ins))
    for name, g, w in zip(("y_grown", "z"), got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=FWD_RTOL, atol=FWD_ATOL, err_msg=name)
    plain = kseg.next_segment_reference(pk, kspec, *map(torch.tensor, ins),
                                        *[t for wb in net.weights()
                                          for t in wb])
    for a, b in zip(got, plain):
        assert torch.equal(a, b)


def test_gradients_match_custom_vjp():
    """d/d(params, y, yh, zh, tf) of sum(y_grown^2) + sum(z^2) through the
    op's backward (autograd of the plain version) against jax.grad through
    the JAX op's custom VJP."""
    pj, pk = J.apply_mod(None), K.apply_mod(None, device="cpu")
    spec, params, kspec, net = _nets(16, True, "elu", seed=1)
    ins = _cells(pj, 100, seed=5)
    fused = jrhs.make_fused_next_segment(pj, spec, interpret=True)

    def loss_j(q, *xs):
        yg, z = fused(q, *xs)
        return jnp.sum(yg ** 2) + jnp.sum(z ** 2)

    gj = jax.grad(loss_j, argnums=(0, 1, 2, 3, 4))(params,
                                                  *map(jnp.asarray, ins))
    xs = [torch.tensor(a, requires_grad=True) for a in ins]
    yg, z = kseg.make_fused_next_segment(pk, kspec)(net, *xs)
    ((yg ** 2).sum() + (z ** 2).sum()).backward()
    for (w, b), layer in zip(net.weights(), gj[0]):
        np.testing.assert_allclose(w.grad.numpy(), np.asarray(layer["w"]),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(layer["b"]),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)
    for x, g in zip(xs, gj[1:]):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_fused_train_step_matches_jax(monkeypatch):
    """One make_train_step(use_pallas=True) step, f64: the loss and the
    stepped weights against the JAX package's fused step (its kernel in
    interpret mode)."""
    orig = jrhs.make_fused_next_segment
    monkeypatch.setattr(jrhs, "make_fused_next_segment",
                        lambda p, s, **kw: orig(p, s, interpret=True))
    ref = J.apply_mod(None)
    trajs, ctls = jdata.make_training_data(ref, [("sine", 0.5),
                                                 ("sine", 1.0)], train_len=6)
    trajs, ctls = np.asarray(trajs), np.asarray(ctls)
    pj, pk = J.apply_mod("nsw"), K.apply_mod("nsw", device="cpu")
    cfg = jtrain.TrainConfig(hidden=16, dtype="float64")
    kcfg = ktrain.TrainConfig(hidden=16, dtype="float64")
    spec, params, kspec, net = _nets(16, False, "elu", seed=2)
    opt = jtrain.make_optimizer(cfg)
    step_j, _ = jtrain.make_train_step(pj, spec, opt, cfg.keypoints, True,
                                       use_pallas=True)
    p1, _, loss_j = step_j(params, opt.init(params), jnp.asarray(trajs),
                           jnp.asarray(ctls))

    kseg.LAUNCHES = 0
    step_k, _ = ktrain.make_train_step(
        pk, kspec, ktrain.make_optimizer(kcfg, net), kcfg.keypoints, True,
        use_pallas=True)
    loss_k = step_k(net, torch.tensor(trajs), torch.tensor(ctls))
    assert kseg.LAUNCHES == 0           # CPU tensors: the plain version
    np.testing.assert_allclose(float(loss_k), float(loss_j), rtol=1e-9)
    for (w, b), layer in zip(net.weights(), p1):
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(layer["w"]),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(layer["b"]),
                                   rtol=1e-9, atol=1e-12)


def test_deep_nets_raise_on_cuda_only():
    """A 3-layer net runs on the CPU (the plain version takes any depth)
    and the kernels take it too (check_spec); only a net deeper than the
    kernels' MAX_LAYERS raises, which check_spec gives without a card."""
    from knode_cosserat_tpu_torch.ops.sweep import MAX_LAYERS, check_spec
    pk = K.apply_mod(None, device="cpu")
    spec = kmlp.MLPSpec(dims=(28, 8, 8, 25))
    net = kmlp.init_mlp(spec, torch.Generator().manual_seed(0), torch.float64,
                        device="cpu")
    ins = [torch.tensor(a) for a in _cells(J.apply_mod(None), 10, seed=0)]
    yg, z = kseg.make_fused_next_segment(pk, spec)(net, *ins)
    assert yg.shape == (10, 19) and z.shape == (10, 6)
    check_spec(spec)
    with pytest.raises(ValueError, match="at most"):
        check_spec(kmlp.MLPSpec(dims=(28,) + (8,) * MAX_LAYERS + (25,)))
    with pytest.raises(ValueError, match="device"):
        kseg.make_fused_next_segment(pk, spec)(net, *(t.to("meta")
                                                      for t in ins))
