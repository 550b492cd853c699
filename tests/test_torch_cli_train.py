"""The port's ``train`` and ``simulate`` commands against the JAX package's,
in-process on the CPU in float64 at a tiny size: a checkpoint written by
either package's ``train`` rolls out under either package's ``simulate
--model`` to the goldens' bar, both name the same file and write the same
experiment metadata; plain and ``--fast`` rollouts and ``--energy`` match
too."""
import os

import numpy as np
import pytest
import torch

from knode_cosserat_tpu import cli as jcli
from knode_cosserat_tpu_torch import cli as tcli
from knode_cosserat_tpu_torch import training as ttraining
from knode_cosserat_tpu_torch.training.checkpoint import load_checkpoint

torch.set_num_threads(1)
RMSE_BAR = 1e-7              # the goldens' bar (tests/test_parity.py:26-38)
TRAIN = ["sine", "sine", "0.5", "1.0", "--mod", "nsw", "--epochs", "5",
         "--layers", "16", "--train_len", "5", "--dtype", "float64",
         "--no-eval"]
NAME = "physics_sine-sine_0_5-1_0_nsw_trainlen_5_5_epoch_0.npz"
STEPS = "15"


@pytest.fixture(autouse=True, scope="module")
def _no_cli_compile_cache():
    """The JAX CLI's main() points JAX's compile cache under $HOME unless
    told not to; these tests keep the suite's own cache (tests/conftest)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KNODE_NO_COMPILE_CACHE", "1")
        yield


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpts")
    jcli.main(["train", *TRAIN, "--save_dir", str(d / "jax")])
    res = tcli.main(["train", *TRAIN, "--device", "cpu", "--save_dir",
                     str(d / "torch")])
    return {"jax": str(d / "jax" / NAME), "torch": str(d / "torch" / NAME),
            "result": res}


def test_train_writes_the_jax_checkpoint(ckpts):
    (tj, mj), (tt, mt) = (load_checkpoint(ckpts[k]) for k in ("jax", "torch"))
    assert mt == mj                      # the ExperimentConfig, as a dict
    assert mt["train"]["hidden"] == 16 and mt["rod"]["mod"] == "nsw"
    assert sorted(tt) == sorted(tj) == ["dtw", "loss", "params"]
    for a, b in zip(tt["params"], tj["params"]):
        assert a["w"].shape == b["w"].shape and a["w"].dtype == b["w"].dtype
    lh = ckpts["result"].loss_history
    assert len(lh) == 6 and np.isfinite(lh).all() and lh[-1] < lh[0]
    np.testing.assert_array_equal(tt["loss"], lh)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_simulate_model_rolls_out_either_checkpoint(ckpts, writer, tmp_path):
    out_j, out_t = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    args = ["simulate", "--model", ckpts[writer], "--mod", "nsw", "--steps",
            STEPS]
    jcli.main([*args, "--save", out_j])
    traj = tcli.main([*args, "--dtype", "float64", "--device", "cpu",
                      "--save", out_t])
    a, b = np.load(out_t), np.load(out_j)
    assert np.array_equal(a["traj"], traj)
    assert a["traj"].shape == b["traj"].shape == (int(STEPS), 10, 50)
    assert a["traj"].dtype == b["traj"].dtype == np.float64
    assert np.array_equal(a["controls"], b["controls"])
    assert _rmse(a["traj"], b["traj"]) < RMSE_BAR


@pytest.mark.parametrize("flags", [["--energy"], ["--fast"]])
def test_simulate_matches_jax(flags, tmp_path, capsys):
    out_j, out_t = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    args = ["simulate", "--type", "step", "--arg", "1.5", "--steps", STEPS,
            *flags]
    jcli.main([*args, "--save", out_j])
    tcli.main([*args, "--dtype", "float64", "--device", "cpu", "--save",
               out_t])
    printed = capsys.readouterr().out
    a, b = np.load(out_t), np.load(out_j)
    assert sorted(a.files) == sorted(b.files)
    assert a["traj"].dtype == b["traj"].dtype == np.float64
    assert _rmse(a["traj"], b["traj"]) < RMSE_BAR
    if "--energy" in flags:
        assert printed.count("energy [J]") == 2
        for k in ("elastic", "kinetic", "potential", "total"):
            np.testing.assert_allclose(a[f"energy_{k}"], b[f"energy_{k}"],
                                       rtol=1e-6, atol=1e-9)


def test_train_with_validation_keeps_the_best_net(tmp_path, monkeypatch,
                                                  capsys):
    """The --eval path on a short validation schedule: the DTW history is
    saved and the checkpoint holds the best-DTW net."""
    short = ttraining.make_validation_reference
    monkeypatch.setattr(ttraining, "make_validation_reference",
                        lambda rod, v: short(rod, v, eval_len=8))
    res = tcli.main(["train", "sine", "0.5", "--mod", "nsw", "--epochs", "4",
                     "--layers", "8", "--train_len", "4", "--dtype",
                     "float64", "--device", "cpu", "--save_dir",
                     str(tmp_path)])
    assert "best DTW" in capsys.readouterr().out
    tree, meta = load_checkpoint(str(tmp_path / os.listdir(tmp_path)[0]))
    assert meta["eval"]["validation"] == ["sine", 1.25]
    assert [tuple(x) for x in tree["dtw"]] == [
        tuple(x) for x in res.dtw_history]
    assert np.isfinite(res.best_dtw)
    assert res.best_dtw == min(d for _, d in res.dtw_history)
    for (w, b), layer in zip(res.best_params.weights(), tree["params"]):
        assert np.array_equal(w.detach().numpy(), layer["w"])


def test_simulate_gif(tmp_path, capsys):
    """--gif animates the rollout with the ported visualizer."""
    gif = str(tmp_path / "a" / "rod.gif")
    tcli.main(["simulate", "--steps", "3", "--device", "cpu", "--save",
               str(tmp_path / "s.npz"), "--gif", gif])
    assert f"saved {gif}" in capsys.readouterr().out
    assert os.path.getsize(gif) > 0
