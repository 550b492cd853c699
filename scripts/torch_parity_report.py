"""Observed errors of the PyTorch port's CLI and real-world modules against
the JAX package, float64 on the CPU, on the inputs of
tests/test_torch_{realworld,cli_train,energy_io}.py (whose assertions hold
the bars printed here). One line per module: the largest error and its bar.

    JAX_PLATFORMS=cpu python scripts/torch_parity_report.py
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


if __name__ == "__main__":
    main()
