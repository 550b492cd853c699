"""Observed errors of the PyTorch port's CLI, real-world and model-based
modules against the JAX package, float64 on the CPU, on the inputs of
tests/test_torch_{realworld,cli_train,energy_io,diff_rollout,mpc,sysid,
online}.py (whose assertions hold the bars printed here). One line per
module: the largest error and its bar.

    JAX_PLATFORMS=cpu python scripts/torch_parity_report.py [model|solvers]

``model`` reports the model-based modules only (the differentiable rod,
the planner, system identification, online adaptation); ``solvers`` the
fine-rod and reference solvers, the dd reductions, the mixed-precision
net and the SIL recording (tests/test_torch_{multiple_shooting,
reference_solver,dd,mixed_precision,sil}.py).
"""
import os
import sys
import tempfile

import jax

os.environ.setdefault("KNODE_NO_COMPILE_CACHE", "1")   # the JAX CLI's
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import knode_cosserat_tpu as J  # noqa: E402
import knode_cosserat_tpu.realworld as JR  # noqa: E402
import knode_cosserat_tpu_torch as K  # noqa: E402
import knode_cosserat_tpu_torch.realworld as TR  # noqa: E402
from knode_cosserat_tpu import cli as jcli  # noqa: E402
from knode_cosserat_tpu.core import energy as jenergy  # noqa: E402
from knode_cosserat_tpu.models import io as jio  # noqa: E402
from knode_cosserat_tpu.ops.quaternion import \
    pairwise_angular_velocity as j_pav  # noqa: E402
from knode_cosserat_tpu_torch import cli as tcli  # noqa: E402
from knode_cosserat_tpu_torch.core import energy as tenergy  # noqa: E402
from knode_cosserat_tpu_torch.models import io as tio  # noqa: E402
from knode_cosserat_tpu_torch.ops.quaternion import \
    pairwise_angular_velocity as t_pav  # noqa: E402
from test_torch_cli_train import NAME, STEPS, TRAIN  # noqa: E402
from test_torch_energy_io import _states, _stand_in_robot  # noqa: E402
from test_torch_realworld import (BAG, CSV_DIR, DEL_T, _mocap_table,  # noqa
                                  _poses)

torch.set_num_threads(1)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def absd(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


def report(name, err, bar):
    print(f"{name:48s} {err:.3e}   (bar {bar})", flush=True)


def quiet(fn, *a):
    """Run a CLI entry point with its printout dropped."""
    with open(os.devnull, "w") as null:
        old, sys.stdout = sys.stdout, null
        try:
            return fn(*a)
        finally:
            sys.stdout = old


def model_based():
    """The differentiable derive and rollout, control/mpc, training/sysid
    and training/online against the JAX package."""
    from knode_cosserat_tpu.control import mpc as jm
    from knode_cosserat_tpu.core import assembly as ja
    from knode_cosserat_tpu.core import stepper as jst
    from knode_cosserat_tpu.training import online as jo
    from knode_cosserat_tpu.training import sysid as js
    from knode_cosserat_tpu_torch.control import mpc as km
    from knode_cosserat_tpu_torch.core import assembly as ka
    from knode_cosserat_tpu_torch.core import stepper as kst
    from knode_cosserat_tpu_torch.training import online as ko
    from knode_cosserat_tpu_torch.training import sysid as ks

    derived = ("A", "Gmod", "ds", "J", "Kse", "Kbt", "c0", "c1", "c2",
               "Kse_c0Bse_inv", "Kbt_c0Bbt_inv", "Kse_vstar", "v_rest",
               "rhoA", "rhoAg", "rhoJ")
    pj = J.experimental_rod("damping", dtype=jnp.float64)
    pk = K.experimental_rod("damping", device="cpu")
    pt = J.core.params.derive_traced(pj)
    nz = lambda name, q: np.asarray(getattr(q, name)) != 0
    report("derive vs the host derive, max rel",
           max(rel(getattr(pk, n).numpy()[nz(n, pj)],
                   np.asarray(getattr(pj, n))[nz(n, pj)]) for n in derived),
           "rtol 1e-15")
    report("derive vs derive_traced, max rel",
           max(rel(getattr(pk, n).numpy()[nz(n, pt)],
                   np.asarray(getattr(pt, n))[nz(n, pt)]) for n in derived),
           "rtol 1e-12")

    r6j, r6k = J.make_rod(N=6, dtype=jnp.float64), K.make_rod(N=6,
                                                               device="cpu")
    ctl = J.calc_controls("sine", 1.0, float(r6j.del_t), 5)
    tip = lambda out: out.traj[-1, -1, 0]
    want = jax.grad(lambda c, g: tip(jst.simulate_scan(
        J.core.params.derive_traced(r6j.replace(g=g)), c,
        differentiable=True)), argnums=(0, 1))(jnp.asarray(ctl),
                                               jnp.asarray(r6j.g))
    c, g = torch.tensor(ctl, requires_grad=True), r6k.g.clone()
    g.requires_grad_(True)
    got = torch.autograd.grad(tip(kst.simulate_scan(
        K.derive(r6k.replace(g=g), device="cpu"), c, differentiable=True)),
        [c, g])
    report("simulate_scan(differentiable) d tip / d tensions, max rel",
           absd(got[0], want[0]) / np.abs(want[0]).max(), "rtol 1e-6")
    report("simulate_scan(differentiable) d tip / d gravity, max rel",
           absd(got[1], want[1]) / np.abs(want[1]).max(), "rtol 1e-6")

    H = 3
    u = np.stack([np.linspace(2, 12, H), np.linspace(3, 5, H),
                  np.linspace(6, 4, H), np.linspace(1, 2, H)], axis=1)
    tips, _ = jm.rollout_tips(r6j, jm.PlanState.initial(r6j),
                              jnp.asarray(u))
    tgt = np.asarray(tips) + 1e-3
    want = jm.make_planner(r6j, H, opt_iters=3)(jm.PlanState.initial(r6j),
                                                jnp.asarray(tgt))
    got = km.make_planner(r6k, H, opt_iters=3)(km.PlanState.initial(r6k),
                                               torch.tensor(tgt))
    report("make_planner cost history (3 iterations), max rel",
           rel(got.cost_history, want.cost_history), "rtol 1e-6")
    a, b = (km.make_planner(r6k, H, opt_iters=2, tol=1e-20, _root=root)(
        km.PlanState.initial(r6k), torch.tensor(tgt))
        for root in ("k2", "newton"))
    report("make_planner on K2's plain roots vs newton_solve's, max rel",
           rel(a.cost_history, b.cost_history), "rtol 1e-6")

    plant = J.experimental_rod(N=6, dtype=jnp.float64)
    ctl = J.calc_controls("sine", 1.0, float(plant.del_t), 5)
    traj = np.asarray(jst.simulate_scan(plant, jnp.asarray(ctl)).traj)[
        ..., :25]
    p0j = J.experimental_rod("youngs", N=6, dtype=jnp.float64)
    p0k = K.experimental_rod("youngs", N=6, device="cpu")
    kp = (3, 5)
    for obj in ("teacher", "rollout"):
        kw = dict(fields=("E",), objective=obj, steps=3, lr=0.1,
                  keypoints=kp)
        report(f"fit_rod_params ({obj}) loss history, max rel",
               rel(ks.fit_rod_params(p0k, traj, ctl, **kw).loss_history,
                   js.fit_rod_params(p0j, traj, ctl, **kw).loss_history),
               "rtol 1e-6")
    for h in ("exact", "gn"):
        kw = dict(fields=("E", "Bbt"), keypoints=kp, hessian=h)
        report(f"identifiability ({h}, teacher) Hessian, max rel",
               absd(ks.identifiability(p0k, traj, ctl, **kw).hessian,
                    js.identifiability(p0j, traj, ctl, **kw).hessian)
               / np.abs(js.identifiability(p0j, traj, ctl,
                                           **kw).hessian).max(),
               "rtol 1e-8")
    u0 = np.full((3, 4), 5.0)
    u0[:, 0] = [3.0, 6.0, 8.0]
    kw = dict(fields=("E", "rho"), horizon=3, steps=2, keypoints=kp,
              u_init=u0)
    report("design_experiment objective history, max rel",
           rel(ks.design_experiment(K.experimental_rod(N=6, device="cpu"),
                                    **kw).objective_history,
               js.design_experiment(plant, **kw).objective_history),
           "rtol 1e-6")
    wj = js.laplace_posterior(p0j, traj[:4], ctl[:4], fields=("E",),
                              keypoints=kp)
    wk = ks.laplace_posterior(p0k, traj[:4], ctl[:4], fields=("E",),
                              keypoints=kp)
    report("laplace_posterior covariance (rollout Hessian), max rel",
           rel(wk.covariance, wj.covariance), "rtol 1e-6")

    asm_j = ja.make_ring_assembly(n_rods=2, N=5, dtype=jnp.float64)
    asm_k = ka.assembly_from_jax(asm_j, device="cpu")
    c2 = np.stack([J.calc_controls("sine", a, float(asm_k.rods[0].del_t), 4)
                   for a in (0.7, 1.3)], axis=1)
    stiff = [ks.apply_theta(r, {"E": ks.theta_init(r, ("E",))["E"]
                                + (0.3 if i == 0 else 0.0)})
             for i, r in enumerate(asm_k.rods)]
    plate = ka.simulate_assembly(asm_k.replace(rods=ka.stack_rods(stiff)),
                                 c2).plate_pose.numpy()
    plate[:, 4] += 1e-3              # tilted, as tests/test_torch_sysid.py
    kw = dict(fields=("E",), steps=2, lr=0.01, w_ori=0.5, tol=1e-24)
    report("fit_assembly_params loss history, max rel",
           rel(ks.fit_assembly_params(asm_k, plate, c2, **kw).loss_history,
               js.fit_assembly_params(asm_j, plate, c2, **kw).loss_history),
           "rtol 1e-6")
    hj = js.assembly_identifiability(asm_j, plate, c2, w_ori=0.5).hessian
    hk = ks.assembly_identifiability(asm_k, plate, c2, w_ori=0.5).hessian
    report("assembly_identifiability Hessian, max rel",
           absd(hk, hj) / np.abs(hj).max(), "rtol 1e-6")

    plant6 = J.apply_mod(None, N=6, dtype=jnp.float64)
    sctl = J.calc_controls("sine", 0.5, float(plant6.del_t), 14)
    stream = np.asarray(jst.simulate_scan(plant6, jnp.asarray(sctl)).traj)
    cfg = dict(window=8, min_fill=4, steps_per_update=2, lr=1e-3, hidden=8,
               seed=0, keypoints=kp, probe_horizon=3)
    aj = jo.OnlineAdapter(J.apply_mod("damping", N=6, dtype=jnp.float64),
                          jo.OnlineConfig(**cfg))
    ak = ko.OnlineAdapter(K.apply_mod("damping", N=6, device="cpu"),
                          ko.OnlineConfig(**cfg),
                          params=K.params_from_jax(
                              aj.params, ko.OnlineConfig(**cfg).spec(),
                              device="cpu"))
    lj, lk = [], []
    for t in range(10):
        aj.observe(stream[t], sctl[t])
        ak.observe(stream[t], sctl[t])
        if aj.ready and t % 2 == 0:
            lj.append(aj.update())
            lk.append(ak.update())
    report("OnlineAdapter update losses (JAX net carried), max rel",
           rel(lk, lj), "rtol 1e-6")


def main():
    for label, got, want in (
            ("read_topic_csvs (sil_step_1100)",
             TR.read_topic_csvs(CSV_DIR, DEL_T, CSV_DIR),
             JR.read_topic_csvs(CSV_DIR, DEL_T, CSV_DIR)),
            ("read_bag (sil_step_1100.bag, native reader)",
             TR.read_bag(BAG, DEL_T), JR.read_bag(BAG, DEL_T))):
        err = max(absd(got[k], want[k]) for k in
                  ("t", "controls", "interpolated", "positions"))
        report(label + ", max abs", err, "0, np.array_equal")
    table = _mocap_table()
    ts = np.arange(0.0, 0.35, 0.05)
    report("preprocessed (resampled), max abs",
           absd(TR.preprocessed(table, ts)[2], JR.preprocessed(table, ts)[2]),
           "0, np.array_equal")
    g = np.random.default_rng(0)
    poses = np.zeros((5, 7, 5))
    poses[:, :3] = np.cumsum(g.normal(size=(5, 3, 5)) * 0.01, axis=-1)
    q = g.normal(size=(5, 4, 5))
    poses[:, 3:] = q / np.linalg.norm(q, axis=1, keepdims=True)
    report("fit_curve, max abs",
           absd(TR.fit_curve(poses, tcli.MARKER_LOC, 10),
                JR.fit_curve(poses, tcli.MARKER_LOC, 10)), "0, np.array_equal")

    q1, q2 = np.random.default_rng(2).normal(size=(2, 6, 10, 4))
    report("pairwise_angular_velocity, max rel",
           rel(t_pav(torch.from_numpy(q1), torch.from_numpy(q2), 0.05),
               j_pav(jnp.asarray(q1), jnp.asarray(q2), 0.05)), "rtol 1e-10")
    poses = _poses(12)
    ctl = 6.0 + np.random.default_rng(3).normal(size=(12, 4))
    got, _ = TR.estimate_state(poses, ctl, K.make_rod(device="cpu"))
    want, _ = JR.estimate_state(poses, ctl, J.make_rod(dtype=jnp.float64))
    big = np.abs(want) > 1e-12
    report("estimate_state, max rel (entries > 1e-12)",
           rel(got[big], want[big]), "rtol 1e-10, atol 1e-12")
    report("estimate_state, max abs", absd(got, want), "atol 1e-12 + rtol")

    g = np.random.default_rng(0)
    traj = _states(g, (7,), 10)
    err = rel(tenergy.rod_energies(K.apply_mod("nsw", device="cpu"), traj)
              ["total"], jenergy.rod_energies(J.apply_mod(
                  "nsw", dtype=jnp.float64), traj)["total"])
    report("rod_energies (nsw), total, max rel", err, "rtol 1e-12")
    from knode_cosserat_tpu.core.assembly import make_ring_assembly as jr
    from knode_cosserat_tpu_torch.core.assembly import \
        make_ring_assembly as tr
    g = np.random.default_rng(3)
    traj = _states(g, (6, 3), 6)
    plate = np.concatenate([g.normal(size=(6, 3)) * 0.01 + [0, 0, 0.5],
                            np.tile([1.0, 0, 0, 0], (6, 1))], -1)
    e_t = tenergy.assembly_energies(tr(n_rods=3, N=6, plate_mass=0.2,
                                       device="cpu"), traj, plate)
    e_j = jenergy.assembly_energies(jr(n_rods=3, N=6, plate_mass=0.2,
                                       dtype=jnp.float64), traj, plate)
    report("assembly_energies (M=3), max rel over terms",
           max(rel(e_t[k], e_j[k]) for k in e_j), "rtol 1e-12")

    robot = _stand_in_robot(0)
    spec_j, params_j = jio.params_from_torch_modules(robot.nn_models,
                                                     jnp.float64)
    spec_t, net = tio.params_from_torch_modules(robot.nn_models,
                                                torch.float64, "cpu")
    x = np.random.default_rng(1).normal(size=(64, 53))
    report("params_from_torch_modules -> mlp_apply, max abs",
           absd(K.mlp_apply(spec_t, net, torch.from_numpy(x)).detach(),
                J.models.mlp_apply(spec_j, params_j, jnp.asarray(x))),
           "rtol 1e-12, atol 1e-15")

    with tempfile.TemporaryDirectory() as d:
        quiet(jcli.main, ["prepare", CSV_DIR, "--out_dir", d + "/j"])
        quiet(tcli.main, ["prepare", CSV_DIR, "--out_dir", d + "/t",
                          "--device", "cpu"])
        a, b = (np.load(f"{d}/{k}/sil_step_1100.npz") for k in "tj")
        report("prepare (sil_step_1100), traj RMSE", rmse(a["traj"],
                                                           b["traj"]), 1e-7)
        quiet(jcli.main, ["train", *TRAIN, "--save_dir", d + "/jax"])
        quiet(tcli.main, ["train", *TRAIN, "--device", "cpu", "--save_dir",
                          d + "/torch"])
        for writer in ("jax", "torch"):
            args = ["simulate", "--model", f"{d}/{writer}/{NAME}", "--mod",
                    "nsw", "--steps", STEPS]
            quiet(jcli.main, [*args, "--save", d + "/sj.npz"])
            quiet(tcli.main, [*args, "--dtype", "float64", "--device", "cpu",
                              "--save", d + "/st.npz"])
            report(f"simulate --model ({writer}'s train checkpoint), RMSE",
                   rmse(np.load(d + "/st.npz")["traj"],
                        np.load(d + "/sj.npz")["traj"]), 1e-7)
        for flags in ([], ["--fast"]):
            args = ["simulate", "--type", "step", "--arg", "1.5", "--steps",
                    STEPS, *flags]
            quiet(jcli.main, [*args, "--save", d + "/sj.npz"])
            quiet(tcli.main, [*args, "--dtype", "float64", "--device", "cpu",
                              "--save", d + "/st.npz"])
            report(f"simulate {' '.join(flags) or '(scan)'}, RMSE",
                   rmse(np.load(d + "/st.npz")["traj"],
                        np.load(d + "/sj.npz")["traj"]), 1e-7)


def solvers():
    """core/multiple_shooting, core/reference_solver, ops/dd, the bf16
    net and the SIL recording against the JAX package."""
    from knode_cosserat_tpu.controls import calc_controls
    from knode_cosserat_tpu.core import multiple_shooting as jms
    from knode_cosserat_tpu.core import reference_solver as jrs
    from knode_cosserat_tpu.hw import sil as jsil
    from knode_cosserat_tpu.models import mlp as jmlp
    from knode_cosserat_tpu.ops import dd as jdd
    from knode_cosserat_tpu_torch.core import multiple_shooting as tms
    from knode_cosserat_tpu_torch.core import reference_solver as trs
    from knode_cosserat_tpu_torch.hw import sil as tsil
    from knode_cosserat_tpu_torch.models.mlp import MLPSpec, params_from_jax
    from knode_cosserat_tpu_torch.ops import dd as tdd

    jrod, trod = J.make_rod(N=17), K.make_rod(N=17, device="cpu")
    ctl = calc_controls("sine", 0.5, float(trod.del_t), 12)
    for solver in ("structured", "dense"):
        err = max(absd(tms.simulate_scan_ms(trod, ctl, S, tol=1e-24,
                                            solver=solver).traj.numpy(),
                       jms.simulate_scan_ms(jrod, jnp.asarray(ctl), S,
                                            tol=1e-24, solver=solver).traj)
                  for S in (2, 4, 8))
        report(f"simulate_scan_ms {solver} N=17 S=2/4/8, max abs", err,
               1e-10)
    jrod, trod = J.make_rod(N=10), K.make_rod(N=10, device="cpu")
    ctl = calc_controls("sine", 0.5, float(trod.del_t), 8)
    for method in ("euler", "rk4"):
        report(f"simulate_fsolve {method} N=10, RMSE",
               rmse(trs.simulate_fsolve(trod, ctl, method=method),
                    jrs.simulate_fsolve(jrod, ctl, method=method)), 1e-9)
    rng = np.random.default_rng(0)
    U, _ = np.linalg.qr(rng.normal(size=(500, 7)))
    V, _ = np.linalg.qr(rng.normal(size=(7, 7)))
    J32 = ((U * np.logspace(0, -6, 7)) @ V.T).astype(np.float32)
    g_t = tdd.dd_to_float64(*tdd.dd_gram(torch.from_numpy(J32)))
    g_j = jdd.dd_to_float64(*jdd.dd_gram(jnp.asarray(J32)))
    report("dd_gram (500 x 7, f32), max abs vs JAX", absd(g_t, g_j), 0.0)
    J64 = torch.from_numpy(J32).double()
    report("sysid's f64 Gram vs JAX dd_gram, max abs",
           absd((J64.T @ J64).numpy(), g_j), 1e-14)
    jspec = jmlp.MLPSpec.for_knode(64, compute_dtype="bfloat16")
    params = jmlp.init_mlp(jspec, jax.random.PRNGKey(0), jnp.float32)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (256, 28),
                                     jnp.float32))
    want = np.asarray(jmlp.mlp_apply(jspec, params, jnp.asarray(x)))
    net = params_from_jax(params, MLPSpec.for_knode(
        64, compute_dtype="bfloat16"), device="cpu")
    got = net(torch.tensor(x)).detach().numpy()
    report("bf16 mlp_apply (f32 caller), max rel to max",
           absd(got, want) / np.abs(want).max(), 1e-6)
    vs = tsil.run_sil_experiment(tsil.joy_for("step_x", 1), settle=0.3,
                                 tail=0.7)
    with tempfile.TemporaryDirectory() as d:
        a = tsil.export_bag(vs, d + "/t.bag",
                            rod=K.apply_mod(None, device="cpu"))
        b = jsil.export_bag(vs, d + "/j.bag", rod=J.apply_mod(None))
    report("SIL truth rollout (step_x), max abs", absd(a["traj"], b["traj"]),
           1e-9)


if __name__ == "__main__":
    if sys.argv[1:] == ["model"]:
        model_based()
    elif sys.argv[1:] == ["solvers"]:
        solvers()
    else:
        main()
        model_based()
        solvers()
