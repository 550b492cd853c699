"""The port's reduced CLI on the CPU, at a tiny size: ``multitrain`` trains
the grid, writes one checkpoint per cell and the eval records, and prints
the table and its phases; ``graphs`` reads the records back into the same
table; ``simulate-assembly`` writes the coupled rollout the JAX CLI
writes; ``sysid`` (teacher, rollout, ``--assembly 2``) prints what the JAX
command prints, and ``design`` what the JAX package's design gives from
the same start."""
import os

import numpy as np
import pytest
import torch

from knode_cosserat_tpu_torch import cli
from knode_cosserat_tpu_torch.evaluation.tables import (aggregate_seeds,
                                                        format_table)
from knode_cosserat_tpu_torch.training.checkpoint import load_checkpoint

torch.set_num_threads(1)


@pytest.fixture
def tiny(monkeypatch):
    # 1 and 2 trajectories (two sub-grids), 2 mods, one short schedule
    monkeypatch.setitem(cli.DATAS, False, ["sine 0.5", "sine sine 0.5 1.0"])
    monkeypatch.setitem(cli.EVAL_SETS, False, ["sine 1.5"])
    monkeypatch.setattr(cli, "MODS", ["nsw", "short"])
    monkeypatch.setattr(cli, "TRAIN_LEN", 5)
    monkeypatch.setattr(cli, "EVAL_LEN", 6)


def test_multitrain_then_graphs(tiny, tmp_path, capsys):
    saved, evals = tmp_path / "saved_models", tmp_path / "evals"
    out = cli.main(["multitrain", "--epochs", "2", "--layers", "8",
                    "--device", "cpu", "--save_dir", str(saved),
                    "--evals_dir", str(evals)])
    printed = capsys.readouterr().out
    res, records = out["result"], out["records"]
    assert len(res.cells) == 4 and res.loss_history.shape == (2, 4)
    assert np.isfinite(res.loss_history).all()
    names = sorted(os.listdir(saved))
    assert names == sorted(f"{c.data}_{c.mod}_{c.seed}".replace(" ", "-")
                           + ".npz" for c in res.cells)
    tree, _ = load_checkpoint(str(saved / names[0]))
    assert tree["params"][0]["w"].shape == (8, 28)
    # 2 baselines + 4 cells, one schedule
    assert len(os.listdir(evals)) == 6 and len(records) == 6
    assert all(np.isfinite(r.dtw) for r in records)
    assert format_table(records) in printed
    assert "phases: datagen+train" in printed and ", eval " in printed

    table = cli.main(["graphs", "--evals_dir", str(evals)])
    assert table == format_table(aggregate_seeds(records))


def test_unported_options_raise(tiny, tmp_path, monkeypatch):
    # --mesh needs the ranks of its devices (torchrun) and a data,seq,model
    # triple; the mesh runs in tests/test_torch_parallel.py
    with pytest.raises(RuntimeError, match="torchrun"):
        cli.main(["multitrain", "--mesh", "2,1,1", "--device", "cpu"])
    with pytest.raises(SystemExit, match="data,seq,model"):
        cli.main(["train", "sine", "0.5", "--mesh", "1,1", "--device",
                  "cpu"])
    for extra in (["--model", "m.npz"], ["--fast"]):
        with pytest.raises(SystemExit, match="--segments"):
            cli.main(["simulate", "--segments", "3", "--steps", "3",
                      "--device", "cpu", *extra])
    # every command of the study takes the card unless --device says
    # otherwise: without one it raises before it reads or writes anything
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = str(tmp_path / "missing")
    for argv in (["train", "sine", "0.5"], ["simulate", "--steps", "3"],
                 ["prepare", missing], ["playback", missing],
                 ["estimate", "x", "--data_dir", missing],
                 ["train-real", "--data_dir", missing],
                 ["replicate", "--out_dir", missing]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)
    assert os.listdir(tmp_path) == []


def test_graphs_tipx_writes_figures(tmp_path, capsys):
    """graphs --tipx: one tip-X figure per eval schedule, from records in
    evaluate_cells' naming (a trained cell and the no-NN baseline)."""
    pytest.importorskip("matplotlib")
    evals, figs = tmp_path / "evals", tmp_path / "figs"
    evals.mkdir()
    rng = np.random.RandomState(0)
    ref = rng.randn(6, 10, 25)
    for label in ("sine_0.5_nsw_0", "baseline_nsw"):
        for sched in ("sine_1.5", "step_1.5"):
            np.savez(evals / f"physics_{sched}+{label}.npz",
                     tensions=np.ones((6, 4)), reference=ref,
                     predicted=ref + 0.01 * rng.randn(6, 10, 25))
    table = cli.main(["graphs", "--tipx", "--evals_dir", str(evals),
                      "--figs_dir", str(figs)])
    printed = capsys.readouterr().out
    assert table in printed
    assert sorted(os.listdir(figs)) == ["tipx_sine_1.5.png",
                                        "tipx_step_1.5.png"]
    assert f"saved {figs / 'tipx_sine_1.5.png'}" in printed


def test_simulate_segments_matches_the_jax_command(monkeypatch, capsys,
                                                   tmp_path):
    """simulate --segments 3 at N=10 (multiple shooting, float64 on the
    CPU) writes the trajectory the JAX command writes, within 1e-10."""
    want_path, got_path = tmp_path / "jax.npz", tmp_path / "port.npz"
    argv = ["simulate", "--segments", "3", "--steps", "8", "--arg", "0.5"]
    _jax_cli(monkeypatch, argv + ["--save", str(want_path)], capsys)
    traj = cli.main(argv + ["--dtype", "float64", "--device", "cpu",
                            "--save", str(got_path)])
    assert f"saved {got_path}: traj (8, 10, 50)" in capsys.readouterr().out
    want, got = np.load(want_path), np.load(got_path)
    assert want["traj"].dtype == got["traj"].dtype == np.float64
    np.testing.assert_array_equal(got["controls"], want["controls"])
    assert np.abs(got["traj"] - want["traj"]).max() < 1e-10
    np.testing.assert_array_equal(traj, got["traj"])


def test_replicate_matches_the_jax_command(monkeypatch, capsys, tmp_path):
    """replicate at its smallest working size (a step experiment, short
    settle and tail, 3 epochs of an 8-unit net) with float64 rods on the
    CPU against the JAX command under its 64-bit mode: the same files, the
    same telemetry, the ingest DTW within 1e-9 relative and the estimated
    states within 1e-10. The nets start from different random draws (the
    port's torch.Generator, JAX's PRNG), so the losses are held to 2e-2
    relative (the untrained nets' share of the nsw rod's loss); each
    falls."""
    argv = ["replicate", "--experiment", "step_x", "--parameter", "1",
            "--settle", "0.3", "--tail", "0.7", "--epochs", "3",
            "--layers", "8", "--trim", "2", "--train_len", "12"]
    jdir, kdir = tmp_path / "jax", tmp_path / "port"
    want_out = _jax_cli(monkeypatch, argv + ["--out_dir", str(jdir)], capsys)
    got = cli.main(argv + ["--out_dir", str(kdir), "--dtype", "float64",
                           "--device", "cpu"])
    printed = capsys.readouterr().out
    names = ["step_x_1.bag", "step_x_1.npz", "step_x_1_estimated.npz",
             "step_x_1_model.npz"]
    assert sorted(os.listdir(kdir)) == sorted(os.listdir(jdir)) == names
    assert "replicate complete: model" in printed and "replicate complete" \
        in want_out
    jn = _numbers(want_out.split("replicate complete")[1])
    # "(loss L0 -> L1, ingest DTW d)" of the JAX line
    l0, l1, dtw = jn[-3], jn[-2], jn[-1]
    assert abs(got["dtw"] - dtw) <= 1e-4           # printed with 4 decimals
    jprep = np.load(jdir / "step_x_1.npz")
    kprep = np.load(kdir / "step_x_1.npz")
    np.testing.assert_array_equal(kprep["controls"], jprep["controls"])
    assert np.abs(kprep["traj"] - jprep["traj"]).max() < 1e-9
    est_w = np.load(jdir / "step_x_1_estimated.npz")["traj"]
    est_g = np.load(kdir / "step_x_1_estimated.npz")["traj"]
    assert est_g.shape == est_w.shape and est_g.shape[1:] == (25, 10)
    assert np.abs(est_g - est_w).max() < 1e-10
    np.testing.assert_allclose([got["loss_initial"], got["loss_final"]],
                               [l0, l1], rtol=2e-2)
    assert got["loss_final"] < got["loss_initial"] and l1 < l0
    assert sorted(got["seconds"]) == ["estimate", "prepare", "record",
                                      "train"]


def test_simulate_assembly(tmp_path, capsys):
    """2 rods, 6 nodes, 5 steps, an overpulled rod and a contact plane: the
    .npz keys and shapes and the printout of the JAX CLI, and the rollout
    of simulate_assembly at the same configuration."""
    from knode_cosserat_tpu_torch.controls import calc_controls
    from knode_cosserat_tpu_torch.core.assembly import (make_ring_assembly,
                                                        simulate_assembly,
                                                        with_contact_plane)
    path = tmp_path / "a" / "assembly.npz"
    out = cli.main(["simulate-assembly", "--rods", "2", "--nodes", "6",
                    "--steps", "5", "--pull_rod", "1", "--contact_plane",
                    "0", "0", "1", "0.3", "--device", "cpu", "--save",
                    str(path)])
    printed = capsys.readouterr().out
    d = np.load(path)
    assert sorted(d.files) == ["controls", "plate_pose", "traj"]
    assert d["traj"].shape == (5, 2, 6, 50) and d["plate_pose"].shape == (5, 7)
    assert d["controls"].shape == (5, 2, 4) and d["traj"].dtype == np.float32
    np.testing.assert_allclose(d["controls"][:, 1, 0] - d["controls"][:, 0, 0],
                               3.0, rtol=1e-12)
    assert f"saved {path}: traj (5, 2, 6, 50), plate_pose (5, 7)" in printed
    assert "max Newton iters" in printed
    asm = with_contact_plane(make_ring_assembly(
        n_rods=2, N=6, dtype=torch.float32, device="cpu"), [0, 0, 1], 0.3)
    want = simulate_assembly(asm, d["controls"])
    assert torch.equal(out.traj, want.traj)
    ctl = calc_controls("sine", 1.0, float(asm.rods[0].del_t), 5)
    np.testing.assert_array_equal(d["controls"][:, 0], ctl)


# ------------------------------------------------------------ sysid, design

_FLOAT = r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?"


def _numbers(text):
    import re
    return [float(x) for x in re.findall(_FLOAT, text)]


def _jax_cli(monkeypatch, argv, capsys):
    """The JAX package's command in-process on the CPU in float64 (its
    sysid / design pick float64 under KNODE_PLATFORM=cpu)."""
    from knode_cosserat_tpu import cli as jcli

    monkeypatch.setenv("KNODE_PLATFORM", "cpu")
    monkeypatch.setenv("KNODE_NO_COMPILE_CACHE", "1")
    jcli.main(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["sysid", "--length", "6", "--steps", "3"],
    ["sysid", "--objective", "rollout", "--length", "4", "--steps", "2"],
    ["sysid", "--assembly", "2", "--length", "4", "--steps", "2"],
], ids=["teacher", "rollout", "assembly"])
def test_sysid_matches_the_jax_command(monkeypatch, capsys, argv):
    """The same lines as the JAX command (float64 on the CPU: ``--dtype
    auto`` with ``--device cpu``), every printed number within rtol 1e-6."""
    want = _jax_cli(monkeypatch, argv, capsys)
    res = cli.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert [ln.split(":")[0] for ln in got.splitlines()] == [
        ln.split(":")[0] for ln in want.splitlines()]
    np.testing.assert_allclose(_numbers(got), _numbers(want), rtol=1e-6)
    hist = res.loss_history
    assert hist.dtype == torch.float64 and hist.shape == (int(argv[-1]),)
    assert float(hist[-1]) < float(hist[0])


def test_sysid_restarts_run_as_one_batch(monkeypatch, capsys):
    """``sysid --n_starts 3``: the JAX command's lines (its starts come from
    its PRNG, the port's from a torch.Generator, so the labels are
    compared), three start losses, and the returned winner's objective
    their minimum."""
    from knode_cosserat_tpu_torch.core.params import apply_mod
    from knode_cosserat_tpu_torch.core.stepper import simulate_scan
    from knode_cosserat_tpu_torch.controls import calc_controls
    from knode_cosserat_tpu_torch.models.mlp import MLPSpec
    from knode_cosserat_tpu_torch.training import sysid as ks

    argv = ["sysid", "--length", "6", "--steps", "3", "--n_starts", "3"]
    want = _jax_cli(monkeypatch, argv, capsys)
    res = cli.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert [ln.split(":")[0] for ln in got.splitlines()] == [
        ln.split(":")[0] for ln in want.splitlines()]
    printed = _numbers(got.splitlines()[0])
    assert got.startswith("start losses:") and len(printed) == 3
    np.testing.assert_allclose(printed, res.start_losses.numpy(),
                               rtol=1e-3)         # printed with 4 digits
    plant = apply_mod(None, device="cpu")
    ctl = torch.tensor(calc_controls("sine", 1.0, float(plant.del_t), 6))
    traj = simulate_scan(plant, ctl).traj[None, :, :, :25]
    p0 = apply_mod("youngs", device="cpu")
    objective = ks._make_objective(p0, traj, ctl[None], "teacher",
                                   ks.DEFAULT_KEYPOINTS_FAST,
                                   MLPSpec.for_knode(), "euler", None, 50)
    with torch.no_grad():
        won = float(objective(res.theta))
    assert won == pytest.approx(float(res.start_losses.min()), rel=1e-12)
    assert float(res.loss_history[-1]) < float(res.loss_history[0])


def test_design_matches_jax(monkeypatch, capsys, tmp_path):
    """``design`` starts from logits drawn from a torch.Generator seeded
    with 0 (the JAX command draws from its PRNG key), so it is held to the
    JAX package's design_experiment started from the same schedule: the
    printed information before and after, and the saved file."""
    import jax.numpy as jnp

    from knode_cosserat_tpu.core.params import apply_mod
    from knode_cosserat_tpu.training.sysid import design_experiment

    path = tmp_path / "d" / "designed.npz"
    res = cli.main(["design", "--horizon", "3", "--steps", "2", "--device",
                    "cpu", "--save", str(path)])
    printed = capsys.readouterr().out
    logits0 = 0.01 * torch.randn((3, 4), generator=torch.Generator()
                                 .manual_seed(0), dtype=torch.float64)
    u0 = 10.0 * torch.sigmoid(logits0).numpy()
    want = design_experiment(apply_mod(None, dtype=jnp.float64),
                             fields=("E",), horizon=3, steps=2, lr=0.2,
                             u_init=u0)
    assert printed.startswith("log det Fisher: ")
    np.testing.assert_allclose([res.info_initial, res.info_final],
                               [want.info_initial, want.info_final],
                               rtol=1e-6)
    np.testing.assert_allclose(_numbers(printed.splitlines()[0])[:2],
                               [res.info_initial, res.info_final], rtol=0,
                               atol=5e-4)     # printed with 3 decimals
    assert res.info_final > res.info_initial
    d = np.load(path)
    np.testing.assert_allclose(d["controls"], np.asarray(want.controls),
                               rtol=1e-6)
    assert d["objective_history"].shape == (2,)


def test_sysid_data_layouts_and_dtype(tmp_path, capsys, monkeypatch):
    """``--data`` in either layout (and ``--trim``) fits what the generated
    plant fits; coerce_traj_layout refuses what the JAX one refuses; the
    dtype policy; and without a card both commands raise."""
    from knode_cosserat_tpu.cli import coerce_traj_layout as jcoerce
    from knode_cosserat_tpu_torch.core.params import apply_mod
    from knode_cosserat_tpu_torch.core.stepper import simulate

    from knode_cosserat_tpu_torch.controls import calc_controls

    p = apply_mod(None, device="cpu")
    ctl = calc_controls("sine", 1.0, float(p.del_t), 7)
    traj = simulate(p, ctl).numpy()
    paths = {}
    for layout, t in (("state-last", traj),
                      ("reference", np.moveaxis(traj, 1, 2))):
        paths[layout] = tmp_path / f"{layout}.npz"
        np.savez(paths[layout], traj=t, controls=ctl)
    fits = [cli.main(["sysid", "--data", str(paths[lay]), "--trim", "1",
                      "--steps", "2", "--layout", lay, "--device", "cpu"])
            for lay in ("state-last", "reference")]
    assert torch.equal(fits[0].loss_history, fits[1].loss_history)
    assert "(true" not in capsys.readouterr().out
    for shape in ((5, 25, 25), (5, 7, 9), (5, 10)):
        for fn in (cli.coerce_traj_layout, jcoerce):
            with pytest.raises(SystemExit):
                fn(np.zeros(shape), shape[1])
    assert cli._sysid_dtype("auto", torch.device("cpu")) == torch.float64
    assert cli._sysid_dtype("auto", torch.device("cuda")) == torch.float32
    assert cli._sysid_dtype("float64", torch.device("cuda")) == torch.float64
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["sysid", "--steps", "1"], ["design", "--steps", "1"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)
