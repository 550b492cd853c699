"""A batch axis for rods (core/params.stack_params) through derive, the
physics core and the random-restart identification, against the JAX
package's ``jax.vmap`` of the same functions (float64 on the CPU, the
``data`` sizes of tests/test_torch_sysid.py: N=6, T=5, keypoints (3, 5)),
and against each rod's or start's own run. R=3 rods or starts, B=2
schedules: R, B, N and the Newton probes' 7 copies all differ, so a
leaf broadcast against the wrong axis fails here instead of passing
silently."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knode_cosserat_tpu.controls import calc_controls
from knode_cosserat_tpu.core import params as jp
from knode_cosserat_tpu.core import stepper as jst
from knode_cosserat_tpu.models import mlp as jmlp
from knode_cosserat_tpu.training import sysid as js
from knode_cosserat_tpu_torch.core import assembly as ka
from knode_cosserat_tpu_torch.core import params as kp
from knode_cosserat_tpu_torch.core import stepper as kst
from knode_cosserat_tpu_torch.models.mlp import (MLPSpec, StackedMLP, bind,
                                                 init_mlp, params_from_jax)
from knode_cosserat_tpu_torch.training import sysid as ks

torch.set_num_threads(1)
KP = (3, 5)                 # keypoints of a 6-node rod
T = 5
R = 3
RTOL = 1e-6                 # the fits against the JAX package's
SOLO_RTOL = 1e-10           # a start in the batch against its solo fit


@pytest.fixture(scope="module")
def data():
    """The true experimental rod's rollout (T=5, N=6), the model rod at the
    'youngs' fault in both packages, and R=3 jittered starts of (E, Bbt,
    C) drawn as fit_rod_params draws them."""
    plant = jp.experimental_rod(N=6, dtype=jnp.float64)
    ctl = calc_controls("sine", 1.0, float(plant.del_t), T)
    traj = np.asarray(jst.simulate_scan(plant, jnp.asarray(ctl)).traj)
    pk = kp.experimental_rod("youngs", N=6, device="cpu")
    starts = ks._jitter_starts(ks.theta_init(pk, ("E", "Bbt", "C")), R,
                               0.25, torch.Generator().manual_seed(0))
    return dict(traj=traj[:, :, :25], ctl=ctl, pk=pk, starts=starts,
                pj=jp.experimental_rod("youngs", N=6, dtype=jnp.float64))


def _leaf(p, name):
    """A leaf of the JAX package's stacked rod in the port's stacked layout
    (scalars (R, 1))."""
    v = np.asarray(getattr(p, name))
    return v[:, None] if v.ndim == 1 else v


def test_batched_apply_theta_matches_vmap_and_each_rod(data):
    """(a) apply_theta on a theta batch: a stack of R derived rods, equal
    to jax.vmap(apply_theta) within 1e-12 and to each start's own
    apply_theta bit for bit; the stack's round trip and the assembly's
    batched re-derive keep every bit."""
    pk, starts = data["pk"], data["starts"]
    assert starts["E"].shape == (R,) and starts["Bbt"].shape == (R, 3)
    assert torch.equal(starts["E"][0], ks.theta_init(pk, ("E",))["E"])
    stack = ks.apply_theta(pk, starts)
    assert stack.n_rods == R and pk.n_rods is None
    want = jax.vmap(lambda th: js.apply_theta(data["pj"], th))(
        {k: jnp.asarray(v.numpy()) for k, v in starts.items()})
    for name, v in stack.leaves():
        np.testing.assert_allclose(v.numpy(), _leaf(want, name), rtol=1e-12,
                                   atol=1e-300, err_msg=name)
    for i, rod in enumerate(kp.unstack_params(stack)):
        solo = ks.apply_theta(pk, {k: v[i] for k, v in starts.items()})
        for name, v in solo.leaves():
            got = getattr(rod, name)
            assert got.shape == v.shape and torch.equal(got, v), (i, name)
    again = kp.stack_params(kp.unstack_params(stack))
    assert all(torch.equal(v, getattr(again, k)) for k, v in stack.leaves())

    asm = ka.make_ring_assembly(n_rods=R, N=5, device="cpu")
    theta = ks._assembly_theta(asm, ("E", "Bbt"))
    theta = {k: v + 0.1 * torch.arange(R, dtype=v.dtype).reshape(
        (R,) + (1,) * (v.dim() - 1)) for k, v in theta.items()}
    fitted = ks._assembly_with(asm, theta)
    for i, rod in enumerate(asm.rods):
        solo = ks.apply_theta(rod, {k: v[i] for k, v in theta.items()})
        for name, v in solo.leaves():
            assert torch.equal(getattr(fitted.rods[i], name), v), (i, name)
            assert torch.equal(getattr(fitted.stacked_rods(), name),
                               getattr(kp.stack_params(fitted.rods), name))


def test_stacked_rollout_matches_vmap_and_each_rod(data):
    """(b) simulate_scan on a stack of 3 rods: jax.vmap(simulate_scan,
    in_axes=(0, None)) within 1e-12 RMSE with equal Newton iterations, and
    each rod's solo rollout within 1e-13 with equal iterations, also under
    B=2 schedules (rod-major: (R, B, T, N, 50)) and with the RK4 sweep."""
    pk, starts = data["pk"], data["starts"]
    stack = ks.apply_theta(pk, starts)
    ctl = torch.tensor(data["ctl"])
    got = kst.simulate_scan(stack, ctl)
    assert got.traj.shape == (R, T, 6, 50) and got.G.shape == (R, T, 6)
    rods_j = jax.vmap(lambda th: js.apply_theta(data["pj"], th))(
        {k: jnp.asarray(v.numpy()) for k, v in starts.items()})
    want = jax.vmap(jst.simulate_scan, in_axes=(0, None))(
        rods_j, jnp.asarray(data["ctl"]))
    rmse = float(np.sqrt(np.mean((got.traj.numpy()
                                  - np.asarray(want.traj)) ** 2)))
    assert rmse <= 1e-12, rmse
    np.testing.assert_array_equal(got.newton_iters.numpy(),
                                  np.asarray(want.newton_iters))
    assert int(got.newton_iters.sum()) > 0

    both = torch.stack([ctl, 0.6 * ctl])
    batch = kst.simulate_scan(stack, both)
    rk4 = kst.simulate_scan(stack, ctl[:3], method="rk4")
    assert batch.traj.shape == (R, 2, T, 6, 50)
    for i, rod in enumerate(kp.unstack_params(stack)):
        for out, c, method in ((got, ctl, "euler"), (batch, both, "euler"),
                               (rk4, ctl[:3], "rk4")):
            solo = kst.simulate_scan(rod, c, method=method)
            assert float((out.traj[i] - solo.traj).abs().max()) <= 1e-13
            assert torch.equal(out.newton_iters[i], solo.newton_iters)


def test_stacked_nets_follow_their_rods(data):
    """A StackedMLP of a net per rod, grouped along the rod axis behind the
    Newton probes' copies (``along(-2)``), against each rod's rollout with
    its own net, and against the grouping along the leading axis that the
    grid's callers use."""
    pk, starts = data["pk"], data["starts"]
    spec = MLPSpec.for_knode(8)
    nets = [init_mlp(spec, torch.Generator().manual_seed(i), torch.float64,
                     "cpu") for i in range(R)]
    stacked = StackedMLP(nets)
    x = torch.randn(7, R * 2, 28, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        y = stacked.along(-2)(x)
        for i in range(R):
            np.testing.assert_allclose(
                y[:, 2 * i:2 * i + 2].numpy(),
                nets[i](x[:, 2 * i:2 * i + 2]).numpy(), rtol=1e-14,
                atol=1e-18)
        lead = stacked(x.movedim(1, 0))
    np.testing.assert_array_equal(lead.movedim(0, 1).numpy(), y.numpy())

    stack = ks.apply_theta(pk, starts)
    ctl = torch.tensor(data["ctl"])
    got = kst.simulate_scan(stack, ctl, nn_fn=stacked.along(-2))
    for i, rod in enumerate(kp.unstack_params(stack)):
        solo = kst.simulate_scan(rod, ctl, nn_fn=bind(spec, nets[i]))
        assert float((got.traj[i] - solo.traj).abs().max()) <= 1e-13
        assert torch.equal(got.newton_iters[i], solo.newton_iters)


@pytest.mark.parametrize("objective,steps,fit_nn", [
    ("teacher", 3, False), ("rollout", 2, False), ("teacher", 3, True)],
    ids=["teacher", "rollout", "fit_nn"])
def test_batched_fit_matches_vmapped_jax_fit(data, objective, steps, fit_nn):
    """(c) the port's one-batch fit of the starts from _jitter_starts
    against the JAX package's vmapped fit program on the same theta batch
    (histories (R, steps) and final objectives at RTOL), each start's row
    against its solo port fit (1e-10 relative), and fit_rod_params(
    n_starts=3) returning the winner. The rollout objective at T=4."""
    pk, pj = data["pk"], data["pj"]
    n = T if objective == "teacher" else 4
    traj, ctl = data["traj"][:n], data["ctl"][:n]
    gen = lambda: torch.Generator().manual_seed(1)
    starts = ks._jitter_starts(ks.theta_init(pk, ("E",)), R, 0.25, gen())
    spec_j = jmlp.MLPSpec.for_knode(8)
    spec = MLPSpec.for_knode(8)
    nn0 = (jmlp.init_mlp(spec_j, jax.random.PRNGKey(0), jnp.float64)
           if fit_nn else None)
    net0 = params_from_jax(nn0, spec, device="cpu") if fit_nn else None

    opt, body, final = js._cached_fit_programs(
        objective, KP, spec_j, "euler", None, 50, False, 0.1, 1e-2, fit_nn,
        True)
    th = {"phys": {"E": jnp.asarray(starts["E"].numpy())}}
    if fit_nn:
        th["nn"] = jax.tree.map(
            lambda a: jnp.broadcast_to(a[None], (R,) + a.shape), nn0)
    tj, cj = jnp.asarray(traj)[None], jnp.asarray(ctl)[None]
    th_f, _, hist_j = body(pj, nn0, th, jax.vmap(opt.init)(th), tj, cj,
                           steps)
    final_j = np.asarray(final(pj, nn0, th_f, tj, cj))

    tk, ck = ks._batch(pk, traj, ctl, "test")
    loss_fn = ks._make_objective(pk, tk, ck, objective, KP, spec, "euler",
                                 None, 50)
    theta, nets, hist, finals = ks._fit_batch(loss_fn, starts, net0, steps,
                                              0.1, 1e-2)
    assert hist.shape == (R, steps) and finals.shape == (R,)
    np.testing.assert_allclose(hist.numpy(), np.asarray(hist_j), rtol=RTOL)
    np.testing.assert_allclose(finals.numpy(), final_j, rtol=RTOL)
    np.testing.assert_allclose(theta["E"].numpy(),
                               np.asarray(th_f["phys"]["E"]), rtol=RTOL)
    if fit_nn:
        for (w, _), layer in zip(nets.weights(), th_f["nn"]):
            np.testing.assert_allclose(w.detach().numpy(),
                                       np.asarray(layer["w"]), rtol=RTOL,
                                       atol=1e-12)

    kw = dict(fields=("E",), objective=objective, steps=steps, lr=0.1,
              keypoints=KP, spec=spec, nn_params=net0, fit_nn=fit_nn)
    for i in range(R):
        solo = ks.fit_rod_params(ks.apply_theta(pk, {"E": starts["E"][i]}),
                                 traj, ctl, **kw)
        np.testing.assert_allclose(solo.loss_history.numpy(),
                                   hist[i].numpy(), rtol=SOLO_RTOL)
    res = ks.fit_rod_params(pk, traj, ctl, n_starts=R, generator=gen(),
                            **kw)
    best = int(np.argmin(finals.numpy()))
    np.testing.assert_array_equal(res.start_losses.numpy(), finals.numpy())
    np.testing.assert_array_equal(res.loss_history.numpy(),
                                  hist[best].numpy())
    assert torch.equal(res.theta["E"], theta["E"][best])
    if fit_nn:
        assert not isinstance(res.nn_params, StackedMLP)
        for a, b in zip(res.nn_params.parameters(),
                        nets.unstack()[best].parameters()):
            assert torch.equal(a, b)


@pytest.mark.parametrize("n_starts", [1, R])
def test_one_objective_evaluation_per_step(data, monkeypatch, n_starts):
    """(d) one objective evaluation an Adam step for all starts (and one
    more for the starts' final objectives), the starts a batch."""
    calls = []
    make = ks._make_objective

    def counted(*a, **kw):
        fn = make(*a, **kw)

        def loss_fn(phys, net=None):
            calls.append(tuple(v.shape for v in phys.values()))
            return fn(phys, net)
        return loss_fn

    monkeypatch.setattr(ks, "_make_objective", counted)
    res = ks.fit_rod_params(data["pk"], data["traj"], data["ctl"],
                            fields=("E", "C"), steps=4, lr=0.1, keypoints=KP,
                            n_starts=n_starts)
    assert calls == [((n_starts,), (n_starts, 3))] * (
        4 + (n_starts > 1))
    assert res.loss_history.shape == (4,)
    assert (res.start_losses is None) == (n_starts == 1)
