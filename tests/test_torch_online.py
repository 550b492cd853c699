"""Online adaptation (training/online.py) and rollout / training health
(utils/health.py) of the port against the JAX package (float64 rods on
the CPU): the telemetry ring and its power-of-two buckets, skip_first,
validation, OnlineAdapter's update losses with the JAX net carried across,
the guard's rollback and certification, OnlineSysId's estimate, and
check_rollout / GuardedTraining."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knode_cosserat_tpu.controls import calc_controls
from knode_cosserat_tpu.core import params as jp
from knode_cosserat_tpu.core import stepper as jst
from knode_cosserat_tpu.training import online as jo
from knode_cosserat_tpu.utils import health as jh
from knode_cosserat_tpu_torch.core import params as kp
from knode_cosserat_tpu_torch.core import stepper as kst
from knode_cosserat_tpu_torch.models.mlp import params_from_jax
from knode_cosserat_tpu_torch.training import online as ko
from knode_cosserat_tpu_torch.training.loss import teacher_forced_loss
from knode_cosserat_tpu_torch.utils import health as kh

torch.set_num_threads(1)
RTOL = 1e-6
T = 14
CFG = dict(window=8, min_fill=4, steps_per_update=2, lr=1e-3, hidden=8,
           seed=0, keypoints=(3, 5), probe_horizon=3)


@pytest.fixture(scope="module")
def stream():
    """True-plant telemetry (N=6): traj (T, N, 50), controls (T, 4)."""
    plant = jp.apply_mod(None, N=6, dtype=jnp.float64)
    ctl = calc_controls("sine", 0.5, float(plant.del_t), T)
    return np.asarray(jst.simulate_scan(plant, jnp.asarray(ctl)).traj), ctl


def _model():
    return kp.apply_mod("damping", N=6, device="cpu")


def _rec(N, i=0.0):
    r = np.zeros((N, 25))
    r[:, 3] = 1.0
    r[:, 0] = i
    return r


def test_buffer_mechanics_and_validation():
    model = _model()
    ad = ko.OnlineAdapter(model, ko.OnlineConfig(window=8, min_fill=4,
                                                 hidden=8, keypoints=(3, 5)))
    assert ad.update() is None and ad.window_loss() is None
    for _ in range(3):
        ad.observe(_rec(6), np.zeros(4))
    assert not ad.ready and ad.update() is None
    ad.observe(_rec(6), np.zeros(4))
    assert ad.ready
    for _ in range(10):
        ad.observe(_rec(6), np.zeros(4))
    assert np.isfinite(ad.update())
    with pytest.raises(ValueError, match="record shape"):
        ad.observe(np.zeros((3, 25)), np.zeros(4))
    with pytest.raises(ValueError, match="control shape"):
        ad.observe(_rec(6), 5.0)
    with pytest.raises(ValueError, match="control shape"):
        ad.observe(_rec(6), np.zeros(3))
    with pytest.raises(ValueError, match="min_fill"):
        ko.OnlineAdapter(model, ko.OnlineConfig(window=4, min_fill=8))
    with pytest.raises(ValueError, match="min_fill"):
        ko.OnlineAdapter(model, ko.OnlineConfig(window=8, min_fill=2))
    with pytest.raises(ValueError, match="steps_per_update"):
        ko.OnlineAdapter(model, ko.OnlineConfig(steps_per_update=0))


def test_window_buckets_use_only_real_frames():
    ad = ko.OnlineAdapter(_model(), ko.OnlineConfig(window=12, min_fill=4,
                                                    hidden=8, keypoints=(3, 5)))
    for i in range(5):
        ad.observe(_rec(6, i), np.zeros(4))
    t, _ = ad._ordered_window()                 # count 5 -> bucket 4
    np.testing.assert_array_equal(t[:, 0, 0], [1, 2, 3, 4])
    for i in range(5, 9):
        ad.observe(_rec(6, i), np.zeros(4))
    t, _ = ad._ordered_window()                 # count 9 -> bucket 8
    np.testing.assert_array_equal(t[:, 0, 0], np.arange(1, 9))
    for i in range(9, 30):
        ad.observe(_rec(6, i), np.zeros(4))
    t, c = ad._device_window()                  # full ring: the window
    np.testing.assert_array_equal(t[:, 0, 0].numpy(), np.arange(18, 30))
    assert t.dtype == torch.float64 and c.shape == (12, 4)
    ad.reset_buffer()
    assert not ad.ready


def test_skip_first_drops_the_fabricated_history_transition(stream):
    """On self-consistent telemetry of the true rod every transition with a
    true history reproduces exactly; the window's first (self-prev history)
    does not."""
    traj, ctl = stream
    plant = kp.apply_mod(None, N=6, device="cpu")
    spec = ko.OnlineConfig().spec()
    w, c = torch.tensor(traj[4:12, :, :25]), torch.tensor(ctl[4:12])
    dirty = float(teacher_forced_loss(plant, spec, None, w, c, (3, 5)))
    clean = float(teacher_forced_loss(plant, spec, None, w, c, (3, 5),
                                      skip_first=True))
    assert clean < 1e-12
    assert dirty > 1e3 * max(clean, 1e-30)


def test_adapter_updates_match_jax(stream):
    """The JAX adapter's initial net carried across: three updates' losses,
    the certifications, and the window / physics losses (rtol 1e-6)."""
    traj, ctl = stream
    aj = jo.OnlineAdapter(jp.apply_mod("damping", N=6, dtype=jnp.float64),
                          jo.OnlineConfig(**CFG))
    cfg = ko.OnlineConfig(**CFG)
    ak = ko.OnlineAdapter(_model(), cfg,
                          params=params_from_jax(aj.params, cfg.spec(),
                                                 device="cpu"))
    lj, lk = [], []
    for t in range(10):
        aj.observe(traj[t], ctl[t])
        ak.observe(torch.tensor(traj[t]), torch.tensor(ctl[t]))
        if aj.ready and t % 2 == 0:
            lj.append(aj.update())
            lk.append(ak.update())
    assert len(lk) == 3
    np.testing.assert_allclose(lk, lj, rtol=RTOL)
    assert (ak.certified_updates, ak.rejected_updates) == (
        aj.certified_updates, aj.rejected_updates)
    assert ak.window_loss() == pytest.approx(aj.window_loss(), rel=RTOL)
    assert ak.physics_loss() == pytest.approx(aj.physics_loss(), rel=1e-12)
    # the nets are float32 (init_mlp's default in both packages)
    for layer, (w, b) in zip(aj.params, ak.params.weights()):
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(layer["w"]),
                                   rtol=RTOL, atol=1e-8)


def test_guard_rolls_back_and_certifies():
    """A non-finite window rolls the weights and the optimizer back to the
    snapshot; only certified weights reach a controller (a copy)."""
    model = _model()
    ad = ko.OnlineAdapter(model, ko.OnlineConfig(window=8, min_fill=4,
                                                 steps_per_update=1,
                                                 hidden=8, keypoints=(3, 5)))

    class _Ctl:
        nn_params = sentinel = object()

    c = _Ctl()
    assert ad.certified_params is None and not ad.handoff_to(c)
    assert c.nn_params is _Ctl.sentinel
    rec = _rec(6)
    rec[:, 2] = np.linspace(0.0, float(model.L), 6)
    for _ in range(4):
        ad.observe(rec, np.full(4, 5.0))
    ad.update()
    good = [t.detach().clone() for t in ad.params.parameters()]
    count = ad.opt_state.chain["count"]
    for _ in range(4):
        ad.observe(np.full((6, 25), np.nan), np.full(4, 5.0))
    ad.update()
    assert ad.rejected_updates > 0 and "diverged" in ad.last_reject_reason
    for a, b in zip(ad.params.parameters(), good):
        assert bool(torch.isfinite(a).all())
    assert ad.opt_state.chain["count"] <= count
    if ad.certified_params is not None:
        assert ad.handoff_to(c) and c.nn_params is ad.certified_params
        assert c.nn_params is not ad.params


def test_online_sysid_matches_jax(stream):
    """OnlineSysId from the 'youngs' fault on the true rod's stream: the
    per-update losses and the E estimate against the JAX tracker."""
    traj, ctl = stream
    kw = dict(fields=("E",), window=8, min_fill=4, steps_per_update=2,
              lr=0.1, keypoints=(3, 5))
    tj = jo.OnlineSysId(jp.experimental_rod("youngs", N=6,
                                            dtype=jnp.float64),
                        jo.OnlineSysIdConfig(**kw))
    tk = ko.OnlineSysId(kp.experimental_rod("youngs", N=6, device="cpu"),
                        ko.OnlineSysIdConfig(**kw))
    lj, lk = [], []
    for t in range(T):
        tj.observe(traj[t], ctl[t])
        tk.observe(traj[t], ctl[t])
        if tj.ready:
            lj.append(tj.update())
            lk.append(tk.update())
    np.testing.assert_allclose(lk, lj, rtol=RTOL)
    np.testing.assert_allclose(tk.values()["E"], tj.values()["E"], rtol=RTOL)
    assert tk.values()["E"] < 1e10                 # moved off the fault
    assert float(tk.rod.Kse[2, 2]) == pytest.approx(
        float(tk.values()["E"]) * float(tk.rod.A), rel=1e-12)
    assert tk.window_loss() == pytest.approx(tj.window_loss(), rel=RTOL)
    tk.reset_buffer()
    assert not tk.ready and tk.update() is None


def test_check_rollout_matches_jax(stream):
    traj, ctl = stream
    pk = kp.apply_mod(None, N=6, device="cpu")
    out = kst.simulate_scan(pk, torch.tensor(ctl))
    pj = jp.apply_mod(None, N=6, dtype=jnp.float64)
    out_j = jst.simulate_scan(pj, jnp.asarray(ctl))
    rk, rj = kh.check_rollout(out), jh.check_rollout(out_j)
    assert rk.ok and rj.ok and rk.n_steps == rj.n_steps == T
    assert rk.max_residual == pytest.approx(rj.max_residual, rel=1e-3,
                                            abs=1e-12)
    bad_traj = out.traj.clone()
    bad_traj[3] = float("nan")
    res = out.residuals.clone()
    res[5] = 1.0
    bad = out._replace(traj=bad_traj, residuals=res,
                       lm_retries=out.lm_retries.clone().fill_(0))
    bad.lm_retries[2] = 1
    bad_j = out_j._replace(traj=np.asarray(bad_traj),
                           residuals=np.asarray(res),
                           lm_retries=np.asarray(bad.lm_retries))
    rk, rj = kh.check_rollout(bad), jh.check_rollout(bad_j)
    assert not rk.ok
    assert (rk.bad_steps, rk.nan_steps, rk.lm_retry_steps) == (
        rj.bad_steps, rj.nan_steps, rj.lm_retry_steps) == ([5], [3], [2])
    assert str(rk) == str(rj)


def test_guarded_training_matches_jax():
    """The same loss stream through both watchdogs: the same rollbacks, the
    same relaxed reference, and the port restores its tensors in place."""
    w = {"w": torch.ones(3, dtype=torch.float64)}
    opt_state = [torch.zeros(3, dtype=torch.float64)]
    gk = kh.GuardedTraining(w, opt_state, divergence_factor=10.0,
                            snapshot_every=2, forget=3.0)
    gj = jh.GuardedTraining({"w": np.ones(3)}, [np.zeros(3)],
                            divergence_factor=10.0, snapshot_every=2,
                            forget=3.0)
    for i, loss in enumerate([1.0, 0.5, 0.4, 100.0, float("nan"), 4.5, 30.0,
                              0.3]):
        with torch.no_grad():
            w["w"] += 1.0
            opt_state[0] += 1.0
        _, _, rk = gk.update(w, opt_state, loss)
        pj, oj, rj = gj.update({"w": np.asarray(w["w"]).copy()},
                               [np.asarray(opt_state[0]).copy()], loss)
        assert rk == rj, (i, loss)
        assert gk.best_loss == gj.best_loss
        # a rollback restores the snapshot in place, as JAX returns it
        np.testing.assert_array_equal(w["w"].numpy(), pj["w"])
        np.testing.assert_array_equal(opt_state[0].numpy(), oj[0])
    assert gk.resets == gj.resets >= 2
