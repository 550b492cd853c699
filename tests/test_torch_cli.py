"""The port's reduced CLI on the CPU, at a tiny size: ``multitrain`` trains
the grid, writes one checkpoint per cell and the eval records, and prints
the table and its phases; ``graphs`` reads the records back into the same
table."""
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


def test_unported_options_raise(tiny, tmp_path):
    with pytest.raises(NotImplementedError, match="item 17"):
        cli.main(["multitrain", "--mesh", "1,1,1", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="viz"):
        cli.main(["graphs", "--tipx", "--evals_dir", str(tmp_path)])
