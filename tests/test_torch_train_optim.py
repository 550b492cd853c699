"""The optimizer, the plain epoch loop and the training data against the
JAX package (float64 on the CPU): AdamPlateau against make_optimizer's
optax chain, make_epoch_scan against JAX make_epoch_scan, a run resumed
from the JAX package's optimizer state, and make_training_data."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import knode_cosserat_tpu as J
import knode_cosserat_tpu_torch as K
from knode_cosserat_tpu.models import mlp as jmlp
from knode_cosserat_tpu.training import data as jdata
from knode_cosserat_tpu.training import train as jtrain
from knode_cosserat_tpu_torch.models import mlp as kmlp
from knode_cosserat_tpu_torch.training import data as kdata
from knode_cosserat_tpu_torch.training import train as ktrain

torch.set_num_threads(1)


def _params(hidden, seed=0):
    spec = jmlp.MLPSpec.for_knode(hidden)
    params = jmlp.init_mlp(spec, jax.random.PRNGKey(seed), jnp.float64)
    return spec, params, kmlp.params_from_jax(
        params, kmlp.MLPSpec.for_knode(hidden), device="cpu")


def _check_net(net, params, rtol, atol=0.0):
    for (w, b), layer in zip(net.weights(), params):
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(layer["w"]),
                                   rtol=rtol, atol=atol)
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(layer["b"]),
                                   rtol=rtol, atol=atol)


@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
def test_optimizer_matches_optax_chain(weight_decay):
    """30 steps on the same gradients and losses, with a loss that stalls
    so that the plateau (patience 2) cuts the scale."""
    import optax
    cfg = jtrain.TrainConfig(lr=1e-2, weight_decay=weight_decay,
                             plateau_patience=2, plateau_factor=0.5)
    kcfg = ktrain.TrainConfig(lr=1e-2, weight_decay=weight_decay,
                              plateau_patience=2, plateau_factor=0.5)
    _, params, net = _params(8)
    opt_j = jtrain.make_optimizer(cfg)
    state = opt_j.init(params)
    opt_k = ktrain.make_optimizer(kcfg, net)
    g = np.random.RandomState(0)
    losses = [1.0, 0.9, 0.95, 0.93, 0.92] * 6
    for t in range(30):
        grads = jax.tree.map(lambda a: jnp.asarray(g.randn(*a.shape)), params)
        upd, state = opt_j.update(grads, state, params, value=losses[t])
        params = optax.apply_updates(params, upd)
        for (w, b), layer in zip(net.weights(), grads):
            w.grad = torch.tensor(np.asarray(layer["w"]))
            b.grad = torch.tensor(np.asarray(layer["b"]))
        opt_k.step(torch.tensor(losses[t], dtype=torch.float64))
    _check_net(net, params, rtol=1e-12)
    assert float(state[1].scale) < 1.0                  # the plateau fired
    assert opt_k.chain["scale"] == float(state[1].scale)
    assert opt_k.chain["plateau_count"] == int(state[1].plateau_count)
    assert opt_k.chain["count"] == int(state[0][0].count) == 30
    # state_dict round-trips the plateau's scalars too
    again = ktrain.make_optimizer(kcfg, net)
    again.load_state_dict(opt_k.state_dict())
    assert again.chain == opt_k.chain


def _setup(train_len=6, hidden=16):
    pj, pk = J.apply_mod("nsw"), K.apply_mod("nsw", device="cpu")
    rj = J.apply_mod(None)
    trajs, ctls = jdata.make_training_data(rj, [("sine", 0.5), ("sine", 1.0)],
                                           train_len=train_len)
    return pj, pk, np.asarray(trajs), np.asarray(ctls), _params(hidden)


def test_epoch_loop_matches_jax_and_resumes_from_jax_state():
    """30 JAX epochs == 30 port epochs; then a run resumed from the JAX
    state after 10 epochs goes on as the JAX run does."""
    pj, pk, trajs, ctls, (spec, params, net) = _setup()
    cfg = jtrain.TrainConfig(hidden=16, plateau_patience=3)
    kcfg = ktrain.TrainConfig(hidden=16, plateau_patience=3)
    kspec = kcfg.spec()
    opt_j = jtrain.make_optimizer(cfg)
    run_j = jtrain.make_epoch_scan(pj, spec, opt_j, cfg.keypoints, True, 10)
    state = opt_j.init(params)
    pj_out, losses_j = params, []
    for _ in range(3):
        pj_out, state, lj = run_j(pj_out, state, jnp.asarray(trajs),
                                  jnp.asarray(ctls))
        losses_j.append(np.asarray(lj))
        if len(losses_j) == 1:
            p10, s10 = pj_out, state
    opt_k = ktrain.make_optimizer(kcfg, net)
    run_k = ktrain.make_epoch_scan(pk, kspec, opt_k, kcfg.keypoints, True, 30)
    lk = run_k(net, torch.tensor(trajs), torch.tensor(ctls))
    np.testing.assert_allclose(lk.numpy(), np.concatenate(losses_j),
                               rtol=1e-9)
    _check_net(net, pj_out, rtol=1e-9, atol=1e-14)

    # resume the port from the JAX run's weights and state after epoch 10
    net2 = kmlp.params_from_jax(p10, kspec, device="cpu")
    opt2 = ktrain.optim_state_from_jax(s10, ktrain.make_optimizer(kcfg, net2))
    run2 = ktrain.make_epoch_scan(pk, kspec, opt2, kcfg.keypoints, True, 10)
    l2 = run2(net2, torch.tensor(trajs), torch.tensor(ctls))
    np.testing.assert_allclose(l2.numpy(), losses_j[1], rtol=1e-9)
    # and the port's state written back in the JAX leaf order restores JAX
    tree = ktrain.optim_state_to_jax(opt2)
    leaves = jax.tree.leaves(tree)
    back = jax.tree.unflatten(jax.tree.structure(state), leaves)
    assert int(back[0][0].count) == 20


def test_make_epoch_scan_refuses_a_foreign_net():
    _, pk, trajs, ctls, (_, _, net) = _setup(train_len=4)
    kcfg = ktrain.TrainConfig(hidden=16)
    other = kmlp.init_mlp(kcfg.spec(), torch.Generator().manual_seed(1),
                          torch.float64, device="cpu")
    run = ktrain.make_epoch_scan(pk, kcfg.spec(), ktrain.make_optimizer(
        kcfg, other), kcfg.keypoints, True, 1)
    with pytest.raises(ValueError, match="optimizer"):
        run(net, torch.tensor(trajs), torch.tensor(ctls))
    # use_pallas routes the step through the fused next-segment op (K8's
    # plain version on the CPU): the same loss and weights as the plain
    # step, to rounding (f64; the cells are flattened for the op)
    fused_net = copy.deepcopy(net)
    steps = [ktrain.make_train_step(pk, kcfg.spec(), ktrain.make_optimizer(
        kcfg, n), kcfg.keypoints, True, use_pallas=u)[0]
        for n, u in ((fused_net, True), (net, False))]
    for _ in range(2):
        lf, lp = (step(n, torch.tensor(trajs), torch.tensor(ctls))
                  for step, n in zip(steps, (fused_net, net)))
        np.testing.assert_allclose(float(lf), float(lp), rtol=1e-12)
    for a, b in zip(fused_net.parameters(), net.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-10, atol=1e-15)


def test_training_data_matches_jax():
    rj, rk = J.apply_mod(None), K.apply_mod(None, device="cpu")
    specs = [("sine", 0.5), ("step", 1.0)]
    tj, cj = jdata.make_training_data(rj, specs, train_len=6)
    tk, ck = kdata.make_training_data(rk, specs, train_len=6)
    np.testing.assert_allclose(tk.numpy(), np.asarray(tj), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_array_equal(ck.numpy(), np.asarray(cj))
    vcj, vtj = jdata.make_validation_reference(rj, ("sine", 1.25), 6)
    vck, vtk = kdata.make_validation_reference(rk, ("sine", 1.25), 6)
    np.testing.assert_array_equal(vck, vcj)
    np.testing.assert_allclose(vtk.numpy(), np.asarray(vtj), rtol=1e-9,
                               atol=1e-12)
    assert kdata.parse_traj_specs(["sine", "step", "0.5", "1"]) == [
        ("sine", 0.5), ("step", 1.0)]
    # noise from a torch.Generator: reproducible from its seed
    a = kdata.make_training_data(rk, specs[:1], 4, 1e-3, 1e-2,
                                 torch.Generator().manual_seed(3))
    b = kdata.make_training_data(rk, specs[:1], 4, 1e-3, 1e-2,
                                 torch.Generator().manual_seed(3))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[1], ck[:1, :4])
