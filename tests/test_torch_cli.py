"""The port's reduced CLI on the CPU, at a tiny size: ``multitrain`` trains
the grid, writes one checkpoint per cell and the eval records, and prints
the table and its phases; ``graphs`` reads the records back into the same
table; ``simulate-assembly`` writes the coupled rollout the JAX CLI
writes."""
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
    with pytest.raises(NotImplementedError, match="Queue 1, item 7$"):
        cli.main(["multitrain", "--mesh", "1,1,1", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="viz"):
        cli.main(["graphs", "--tipx", "--evals_dir", str(tmp_path)])
    with pytest.raises(NotImplementedError, match="Queue 1, item 7$"):
        cli.main(["train", "sine", "0.5", "--mesh", "1,1,1", "--device",
                  "cpu"])
    with pytest.raises(NotImplementedError, match="Queue 1, item 4$"):
        cli.main(["simulate", "--segments", "3", "--steps", "3", "--device",
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
                 ["train-real", "--data_dir", missing]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)
    assert os.listdir(tmp_path) == []


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
