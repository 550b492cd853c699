"""System identification in the port (training/sysid.py) against the JAX
package (float64 on the CPU, small rods and windows): the theta transforms,
teacher-forced residuals, fits by the teacher and the rollout objectives
(and a joint grey-box fit), identifiability Hessians (exact and
Gauss-Newton), Fisher-optimal design, the Laplace posterior and its
samples, and the assembly identification, whose gradients reach the rods'
and the plate's parameters through the coupled implicit solve."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knode_cosserat_tpu.controls import calc_controls
from knode_cosserat_tpu.core import assembly as ja
from knode_cosserat_tpu.core import params as jp
from knode_cosserat_tpu.core import stepper as jst
from knode_cosserat_tpu.models import mlp as jmlp
from knode_cosserat_tpu.training import loss as jloss
from knode_cosserat_tpu.training import sysid as js
from knode_cosserat_tpu_torch.core import assembly as ka
from knode_cosserat_tpu_torch.core import params as kp
from knode_cosserat_tpu_torch.core import stepper as kst
from knode_cosserat_tpu_torch.models.mlp import MLPSpec, params_from_jax
from knode_cosserat_tpu_torch.training import loss as kloss
from knode_cosserat_tpu_torch.training import sysid as ks

torch.set_num_threads(1)
KP = (3, 5)                 # keypoints of a 6-node rod
T = 5
RTOL = 1e-6


@pytest.fixture(scope="module")
def data():
    """The true experimental rod's rollout (T=5, N=6) and the model rod at
    the 'youngs' fault, in both packages."""
    plant = jp.experimental_rod(N=6, dtype=jnp.float64)
    ctl = calc_controls("sine", 1.0, float(plant.del_t), T)
    traj = np.asarray(jst.simulate_scan(plant, jnp.asarray(ctl)).traj)
    return dict(traj=traj[:, :, :25], traj50=traj, ctl=ctl,
                pj=jp.experimental_rod("youngs", N=6, dtype=jnp.float64),
                pk=kp.experimental_rod("youngs", N=6, device="cpu"))


def test_theta_transforms_match_jax(data):
    pj, pk = data["pj"], data["pk"]
    fields = ("E", "L", "Bbt", "C", "g")
    tj, tk = js.theta_init(pj, fields), ks.theta_init(pk, fields)
    for f in fields:
        np.testing.assert_allclose(tk[f].numpy(), np.asarray(tj[f]),
                                   rtol=1e-15, atol=0)
    bumped = {f: v + 0.1 for f, v in tj.items()}
    qj = js.apply_theta(pj, bumped)
    qk = ks.apply_theta(pk, {f: v + 0.1 for f, v in tk.items()})
    for name in ("E", "L", "Bbt", "C", "g", "Kse", "Kbt_c0Bbt_inv", "ds",
                 "v_rest", "rhoAg"):
        np.testing.assert_allclose(getattr(qk, name).numpy(),
                                   np.asarray(getattr(qj, name)),
                                   rtol=1e-12, atol=1e-300, err_msg=name)
    vj, vk = js.theta_values(bumped), ks.theta_values(
        {f: v + 0.1 for f, v in tk.items()})
    for f in fields:
        np.testing.assert_allclose(vk[f], vj[f], rtol=1e-14)
    with pytest.raises(ValueError, match="not fittable"):
        ks.theta_init(pk, ("N",))
    with pytest.raises(ValueError, match="log-space"):
        ks.theta_init(pk.replace(E=-pk.E), ("E",))


@pytest.mark.parametrize("skip_first", [False, True])
def test_teacher_forced_residuals_match_jax(data, skip_first):
    pj, pk = data["pj"], data["pk"]
    spec_j = jmlp.MLPSpec.for_knode(8)
    params = jmlp.init_mlp(spec_j, jax.random.PRNGKey(1), jnp.float64)
    net = params_from_jax(params, MLPSpec.for_knode(8), device="cpu")
    want = jloss.teacher_forced_residuals(pj, spec_j, params,
                                          jnp.asarray(data["traj"]),
                                          jnp.asarray(data["ctl"]), KP,
                                          skip_first=skip_first)
    traj, ctl = torch.tensor(data["traj"]), torch.tensor(data["ctl"])
    got = kloss.teacher_forced_residuals(pk, MLPSpec.for_knode(8), net, traj,
                                         ctl, KP, skip_first=skip_first)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-12, atol=1e-15)
    loss = kloss.teacher_forced_loss(pk, MLPSpec.for_knode(8), net, traj,
                                     ctl, KP, skip_first=skip_first)
    assert float((got.detach() ** 2).sum()) == pytest.approx(
        float(loss.detach()), rel=1e-13)
    both = kloss.teacher_forced_residuals(pk, MLPSpec.for_knode(8), net,
                                          traj.expand(2, -1, -1, -1),
                                          ctl.expand(2, -1, -1), KP,
                                          skip_first=skip_first)
    np.testing.assert_allclose(both[1].detach().numpy(),
                               got.detach().numpy(), rtol=1e-13, atol=1e-18)
    with pytest.raises(ValueError, match="3"):
        kloss.teacher_forced_residuals(pk, MLPSpec.for_knode(8), None,
                                       traj[:2], ctl[:2], KP,
                                       skip_first=True)


@pytest.mark.parametrize("objective", ["teacher", "rollout"])
def test_fit_matches_jax(data, objective):
    """Three Adam steps on log E: the loss history and the fitted value."""
    kw = dict(fields=("E",), objective=objective, steps=3, lr=0.1,
              keypoints=KP)
    want = js.fit_rod_params(data["pj"], data["traj"], data["ctl"], **kw)
    got = ks.fit_rod_params(data["pk"], data["traj50"], data["ctl"], **kw)
    np.testing.assert_allclose(got.loss_history.numpy(),
                               np.asarray(want.loss_history), rtol=RTOL)
    np.testing.assert_allclose(got.values["E"], want.values["E"], rtol=RTOL)
    assert float(got.params.Kse[2, 2]) == pytest.approx(
        float(got.values["E"]) * float(got.params.A), rel=1e-12)


def test_joint_grey_box_fit_matches_jax(data):
    """fit_nn=True: physics Adam(lr) and the net's own Adam(nn_lr); the net
    starts from the JAX package's and comes back fitted (a copy)."""
    spec_j = jmlp.MLPSpec.for_knode(8)
    nn0 = jmlp.init_mlp(spec_j, jax.random.PRNGKey(0), jnp.float64)
    kw = dict(fields=("E",), steps=2, lr=0.1, keypoints=KP, fit_nn=True)
    want = js.fit_rod_params(data["pj"], data["traj"], data["ctl"],
                             spec=spec_j, nn_params=nn0, **kw)
    net0 = params_from_jax(nn0, MLPSpec.for_knode(8), device="cpu")
    got = ks.fit_rod_params(data["pk"], data["traj"], data["ctl"],
                            spec=MLPSpec.for_knode(8), nn_params=net0, **kw)
    np.testing.assert_allclose(got.loss_history.numpy(),
                               np.asarray(want.loss_history), rtol=RTOL)
    for a, layer in zip(got.nn_params.weights(), want.nn_params):
        np.testing.assert_allclose(a[0].detach().numpy(),
                                   np.asarray(layer["w"]), rtol=RTOL,
                                   atol=1e-12)
    assert got.nn_params is not net0
    with pytest.raises(ValueError, match="nn_params"):
        ks.fit_rod_params(data["pk"], data["traj"], data["ctl"],
                          fit_nn=True, keypoints=KP, steps=1)


def test_multistart_chunk_and_best_start(data):
    pk = data["pk"]
    kw = dict(fields=("E", "C"), steps=2, lr=0.1, keypoints=KP)
    single = ks.fit_rod_params(pk, data["traj"], data["ctl"], **kw)
    multi = ks.fit_rod_params(pk, data["traj"], data["ctl"], n_starts=3,
                              generator=torch.Generator().manual_seed(0),
                              **kw)
    assert multi.start_losses.shape == (3,)
    assert float(multi.start_losses.min()) <= float(
        multi.start_losses[0]) * (1 + 1e-12)
    single_final = ks.fit_rod_params(pk, data["traj"], data["ctl"],
                                     fields=("E", "C"), steps=0,
                                     keypoints=KP)
    assert single_final.loss_history.shape == (0,)
    # start 0 is the unperturbed start: its curve is the single fit's
    assert float(multi.start_losses[0]) <= float(
        single.loss_history[0])
    zero = ks.fit_rod_params(pk, data["traj"], data["ctl"], fields=("E",),
                             steps=0, chunk=4, keypoints=KP)
    assert zero.loss_history.shape == (0,)
    np.testing.assert_allclose(float(zero.values["E"]), float(pk.E),
                               rtol=1e-12)
    with pytest.raises(ValueError, match="chunk"):
        ks.fit_rod_params(pk, data["traj"], data["ctl"], chunk=0,
                          keypoints=KP)
    nan = torch.tensor([float("nan"), 2.0, 1.0])
    assert ks._best_start(nan) == 2


@pytest.mark.parametrize("hessian", ["exact", "gn"])
def test_identifiability_matches_jax(data, hessian):
    kw = dict(fields=("E", "Bbt"), objective="teacher", keypoints=KP,
              hessian=hessian)
    want = js.identifiability(data["pj"], data["traj"], data["ctl"], **kw)
    got = ks.identifiability(data["pk"], data["traj"], data["ctl"], **kw)
    assert got.labels == want.labels == ["Bbt[0]", "Bbt[1]", "Bbt[2]", "E"]
    np.testing.assert_allclose(got.hessian, want.hessian, rtol=1e-8,
                               atol=1e-8 * np.abs(want.hessian).max())
    np.testing.assert_allclose(got.eigvals, want.eigvals, rtol=1e-8,
                               atol=1e-8 * np.abs(want.eigvals).max())
    assert got.loss_value == pytest.approx(want.loss_value, rel=1e-12)


def test_design_matches_jax(data):
    """D-optimal design from a given schedule (the default start is drawn
    from each package's own generator): two Adam steps' criterion values,
    the designed schedule and the information gain."""
    plant_j = jp.experimental_rod(N=6, dtype=jnp.float64)
    plant_k = kp.experimental_rod(N=6, device="cpu")
    u0 = np.full((3, 4), 5.0)
    u0[:, 0] = [3.0, 6.0, 8.0]
    # stiffness and density: both excited by the schedule (the torsional
    # damping Bbt[2] is not, and its near-zero curvature would make log det
    # a matter of rounding)
    kw = dict(fields=("E", "rho"), horizon=3, steps=2, keypoints=KP,
              u_init=u0)
    want = js.design_experiment(plant_j, **kw)
    got = ks.design_experiment(plant_k, **kw)
    np.testing.assert_allclose(got.objective_history.numpy(),
                               np.asarray(want.objective_history), rtol=RTOL)
    np.testing.assert_allclose(got.controls.numpy(),
                               np.asarray(want.controls), rtol=RTOL)
    assert got.info_initial == pytest.approx(want.info_initial, rel=RTOL)
    assert got.info_final == pytest.approx(want.info_final, rel=RTOL)
    gn = ks.design_experiment(plant_k, fisher="gn", **kw)
    # the Gauss-Newton Fisher of the teacher loss at the nominal rod: the
    # residuals vanish there, so its log det is the exact one's
    assert float(gn.objective_history[0]) == pytest.approx(
        float(got.objective_history[0]), rel=1e-6)
    with pytest.raises(ValueError, match="criterion"):
        ks.design_experiment(plant_k, criterion="A")


@pytest.fixture(scope="module")
def posterior(data):
    """The Laplace posterior of log E at the fault under the rollout
    objective (T=4): its Hessian is the second derivative through every
    implicit solve."""
    traj, ctl = data["traj"][:4], data["ctl"][:4]
    want = js.laplace_posterior(data["pj"], traj, ctl, fields=("E",),
                                keypoints=KP)
    got = ks.laplace_posterior(data["pk"], traj, ctl, fields=("E",),
                               keypoints=KP)
    return want, got


def test_laplace_posterior_matches_jax(posterior):
    want, got = posterior
    assert got.labels == want.labels and got.n_residuals == want.n_residuals
    np.testing.assert_allclose(got.theta["E"].numpy(),
                               np.asarray(want.theta["E"]), rtol=1e-15)
    np.testing.assert_allclose(got.covariance, want.covariance, rtol=RTOL)
    np.testing.assert_allclose(got.std, want.std, rtol=RTOL)
    assert got.sigma2 == pytest.approx(want.sigma2, rel=1e-12)


def test_sample_posterior_moments(data, posterior):
    """The draws come from a torch.Generator (the JAX package's from its
    PRNG), stacked on a leading axis as the JAX package returns them:
    their log E has the posterior's mean and standard deviation, every
    draw is derived, and the stack rolls out as one simulate_scan, a
    predictive ensemble that spreads."""
    _, post = posterior
    rods = ks.sample_posterior(data["pk"], post,
                               torch.Generator().manual_seed(0), 400)
    assert rods.n_rods == 400 and rods.N == 6 and rods.E.shape == (400, 1)
    logE = np.log(rods.E[:, 0].numpy())
    mean, std = float(post.theta["E"]), float(post.std[0])
    assert abs(logE.mean() - mean) < 4 * std / np.sqrt(400)
    assert abs(logE.std() / std - 1) < 0.15
    np.testing.assert_allclose(rods.Kse[:, 2, 2].numpy(),
                               (rods.E * rods.A)[:, 0].numpy(), rtol=1e-12)
    few = ks.sample_posterior(data["pk"], post,
                              torch.Generator().manual_seed(6), 8)
    sims = kst.simulate_scan(few, data["ctl"]).traj
    assert sims.shape == (8, T, 6, 50)
    tips = sims[:, :, -1, 0:3].numpy()
    assert np.all(np.isfinite(tips))
    assert tips.std(axis=0).max() > 0        # the ensemble spreads


@pytest.fixture(scope="module")
def assembly():
    """M=2 rods of N=5, a rod-asymmetric 4-step schedule, and plate rows
    observed from the assembly whose rod 0 is 35% stiffer, tilted."""
    asm_j = ja.make_ring_assembly(n_rods=2, N=5, dtype=jnp.float64)
    asm_k = ka.assembly_from_jax(asm_j, device="cpu")
    del_t = float(asm_k.rods[0].del_t)
    ctl = np.stack([calc_controls("sine", a, del_t, 4) for a in (0.7, 1.3)],
                   axis=1)
    stiff = [ks.apply_theta(r, {"E": ks.theta_init(r, ("E",))["E"]
                                + (0.3 if i == 0 else 0.0)})
             for i, r in enumerate(asm_k.rods)]
    obs = ka.simulate_assembly(asm_k.replace(rods=ka.stack_rods(stiff)), ctl)
    plate = obs.plate_pose.numpy()
    # tilt the observed plate by ~1 mrad: the orientation term 1 - cos^2
    # cancels to rounding when the quaternions agree to 1e-8
    plate[:, 4] += 1e-3
    return asm_j, asm_k, ctl, plate


def test_fit_assembly_matches_jax(assembly):
    asm_j, asm_k, ctl, plate = assembly
    kw = dict(fields=("E",), steps=2, lr=0.01, w_ori=0.5, tol=1e-24)
    want = js.fit_assembly_params(asm_j, plate, ctl, **kw)
    got = ks.fit_assembly_params(asm_k, plate, ctl, **kw)
    np.testing.assert_allclose(got.loss_history.numpy(),
                               np.asarray(want.loss_history), rtol=RTOL)
    np.testing.assert_allclose(got.values["E"], np.asarray(want.values["E"]),
                               rtol=RTOL)
    assert got.values["E"].shape == (2,)
    assert float(got.assembly.rods[0].E) == pytest.approx(
        float(got.values["E"][0]), rel=1e-12)
    with pytest.raises(ValueError, match="controls"):
        ks.fit_assembly_params(asm_k, plate, ctl[:, :1])
    with pytest.raises(ValueError, match="w_ori"):
        ks.fit_assembly_params(asm_k, plate[:, :3], ctl, w_ori=1.0)


def test_assembly_identifiability_matches_jax(assembly):
    asm_j, asm_k, ctl, plate = assembly
    want = js.assembly_identifiability(asm_j, plate, ctl, fields=("E",),
                                       w_ori=0.5)
    got = ks.assembly_identifiability(asm_k, plate, ctl, fields=("E",),
                                      w_ori=0.5)
    assert got.labels == want.labels == ["rod0:E", "rod1:E"]
    np.testing.assert_allclose(got.hessian, want.hessian, rtol=RTOL,
                               atol=RTOL * np.abs(want.hessian).max())
    assert got.loss_value == pytest.approx(want.loss_value, rel=RTOL)


def test_gradients_through_the_coupled_solve_reach_rod_and_plate(assembly):
    """d(plate-pose loss)/d(each rod's log E and density, the plate's mass
    and attachment offsets) through simulate_assembly(differentiable=True):
    the implicit function theorem at every coupled solve, against
    jax.grad through custom_root."""
    asm_j, asm_k, ctl, plate = assembly
    fields = ("E", "rho")

    def jloss_of(theta, mass, offsets):
        rods = jax.vmap(js.apply_theta)(asm_j.rods, theta)
        a = asm_j.replace(rods=rods, plate=asm_j.plate.replace(
            mass=mass, attach_offsets=offsets))
        sim = ja.simulate_assembly(a, jnp.asarray(ctl), differentiable=True)
        return jnp.sum((sim.plate_pose - plate) ** 2)

    th_j = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        js.theta_init(jax.tree.map(lambda x: x[i], asm_j.rods), fields)
        for i in range(2)])
    want = jax.grad(jloss_of, argnums=(0, 1, 2))(
        th_j, jnp.asarray(0.01), asm_j.plate.attach_offsets)

    th = {k: v.clone().requires_grad_(True)
          for k, v in ks._assembly_theta(asm_k, fields).items()}
    mass = torch.tensor(0.01, dtype=torch.float64, requires_grad=True)
    offsets = asm_k.plate.attach_offsets.clone().requires_grad_(True)
    a = ks._assembly_with(asm_k, th).replace(plate=asm_k.plate.replace(
        mass=mass, attach_offsets=offsets))
    sim = ka.simulate_assembly(a, ctl, differentiable=True)
    loss = ((sim.plate_pose - torch.tensor(plate)) ** 2).sum()
    got = torch.autograd.grad(loss, [th["E"], th["rho"], mass, offsets])
    for g, w in zip(got, (want[0]["E"], want[0]["rho"], want[1], want[2])):
        w = np.asarray(w)
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL,
                                   atol=RTOL * np.abs(w).max())
