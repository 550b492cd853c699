"""The port's real-world pipeline against the JAX package's on the same
inputs: the framework-free copies (ingestion, preprocessing, curve
refitting) bit for bit, the estimator and the pairwise angular velocity in
float64, and the prepare / estimate / train-real commands."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import knode_cosserat_tpu as J
import knode_cosserat_tpu.realworld as JR
import knode_cosserat_tpu_torch as K
import knode_cosserat_tpu_torch.realworld as TR
from knode_cosserat_tpu import cli as jcli
from knode_cosserat_tpu.ops.quaternion import \
    pairwise_angular_velocity as j_pav
from knode_cosserat_tpu_torch import cli as tcli
from knode_cosserat_tpu_torch.ops.quaternion import \
    pairwise_angular_velocity as t_pav

torch.set_num_threads(1)
FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
CSV_DIR = os.path.join(FIX, "sil_step_1100")
BAG = os.path.join(FIX, "sil_step_1100.bag")
DEL_T = 0.05                 # the measured-hardware rod's step (prepare's)
EST_RTOL = 1e-10             # estimator, port vs JAX, float64
RMSE_BAR = 1e-7              # the goldens' bar (tests/test_parity.py)


@pytest.fixture(autouse=True, scope="module")
def _no_cli_compile_cache():
    """The JAX CLI's main() points JAX's compile cache under $HOME unless
    told not to; these tests keep the suite's own cache (tests/conftest)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KNODE_NO_COMPILE_CACHE", "1")
        yield


def _assert_same(a, b):
    """Equal ingestion outputs: every array bit for bit."""
    assert sorted(a) == sorted(b)
    for k in a:
        if a[k] is None:
            assert b[k] is None, k
        elif isinstance(a[k], list):
            assert len(a[k]) == len(b[k])
            for x, y in zip(a[k], b[k]):
                assert np.array_equal(x, y), k
        else:
            assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("source", ["csv", "bag"])
def test_ingestion_equals_jax(source):
    if source == "csv":
        want = JR.read_topic_csvs(CSV_DIR, DEL_T, CSV_DIR)
        got = TR.read_topic_csvs(CSV_DIR, DEL_T, CSV_DIR)
    else:
        want = JR.read_bag(BAG, DEL_T)
        got = TR.read_bag(BAG, DEL_T)
    assert len(got["t"]) > 50 and got["interpolated"].shape[1:] == (7, 10)
    _assert_same(got, want)


def _mocap_table(T=40, flip_at=20, seed=1):
    """Columns of a Vicon recording (a dict, as preprocess's data model
    allows) with a quarter-turn relabel flip mid-stream."""
    from scipy.spatial.transform import Rotation
    g = np.random.default_rng(seed)
    data = {"Time": np.arange(T) * 0.01}
    base = Rotation.from_euler("z", np.linspace(0, 10, T)[:, None],
                               degrees=True)
    flip = Rotation.from_matrix(np.array([[0, 1, 0], [-1, 0, 0], [0, 0, 1]],
                                         float))
    for li, link in enumerate(JR.LINKS):
        quat = base.as_quat()
        quat[flip_at:] = (base * flip).as_quat()[flip_at:]
        pos = np.stack([np.full(T, 0.01 * li), 1e-3 * g.normal(size=T),
                        np.full(T, 0.1 * li)], axis=1)
        for k, axis in enumerate("xyzw"):
            data[f"{link}.pose.orientation.{axis}"] = quat[:, k]
        for k, axis in enumerate("xyz"):
            data[f"{link}.pose.position.{axis}"] = pos[:, k]
    return data


@pytest.mark.parametrize("resample", [False, True])
def test_preprocessed_equals_jax(resample):
    data = _mocap_table()
    ts = np.arange(0.0, 0.35, 0.05) if resample else None
    want = JR.preprocessed(data, ts)
    got = TR.preprocessed(data, ts)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[2], want[2])
    for a, b in zip(got[1], want[1]):
        assert np.array_equal(a.as_quat(), b.as_quat())


@pytest.mark.parametrize("scalar_first_out", [False, True])
def test_fit_curve_equals_jax(scalar_first_out):
    g = np.random.default_rng(0)
    poses = np.zeros((5, 7, 5))
    poses[:, :3] = np.cumsum(g.normal(size=(5, 3, 5)) * 0.01, axis=-1)
    q = g.normal(size=(5, 4, 5))
    poses[:, 3:] = q / np.linalg.norm(q, axis=1, keepdims=True)
    loc = tcli.MARKER_LOC
    want = JR.fit_curve(poses, loc, 10, scalar_first_out)
    got = TR.fit_curve(poses, loc, 10, scalar_first_out)
    assert np.array_equal(got, want)


def test_pairwise_angular_velocity_matches_jax():
    g = np.random.default_rng(2)
    q1, q2 = g.normal(size=(2, 6, 10, 4))
    want = np.asarray(j_pav(jnp.asarray(q1), jnp.asarray(q2), 0.05))
    got = t_pav(torch.from_numpy(q1), torch.from_numpy(q2), 0.05).numpy()
    np.testing.assert_allclose(got, want, rtol=EST_RTOL, atol=0)


def _poses(T, N=10, seed=0, period=1.0, dt=DEL_T):
    """Rod-grid poses (T, 7, N), reference layout: a rod bending in x-z
    under a sine, its frames' quaternions (scalar first) turning with the
    tangent, plus 1e-4 noise on the positions."""
    g = np.random.default_rng(seed)
    s = np.linspace(0.0, 0.5, N)
    amp = 0.05 * np.sin(2 * np.pi * np.arange(T) * dt / period)[:, None]
    out = np.zeros((T, 7, N))
    out[:, 0] = amp * s ** 2 + 1e-4 * g.normal(size=(T, N))
    out[:, 2] = s
    theta = np.arctan(2 * amp * s)            # the tangent's angle from z
    out[:, 3] = np.cos(theta / 2)
    out[:, 5] = np.sin(theta / 2)
    return out


def test_estimate_state_matches_jax():
    poses = _poses(12)
    ctl = 6.0 + np.random.default_rng(3).normal(size=(12, 4))
    want, vstar_j = JR.estimate_state(poses, ctl, J.make_rod(
        dtype=jnp.float64))
    rod = K.make_rod(device="cpu")
    assert rod.dtype == torch.float64
    got, vstar = TR.estimate_state(poses, ctl, rod)
    assert got.shape == (12, 25, 10) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=EST_RTOL, atol=1e-12)
    np.testing.assert_allclose(vstar, vstar_j, rtol=EST_RTOL, atol=1e-12)
    # a float32 rod gives the same host float64 estimate of its own values
    got32, _ = TR.estimate_state(poses, ctl, K.make_rod(
        dtype=torch.float32, device="cpu"))
    np.testing.assert_allclose(got32, want, rtol=1e-5, atol=1e-6)


def test_prepare_matches_jax(tmp_path, capsys):
    """The prepare command on the CSV fixture (~71 steps): t, controls,
    interpolated and positions equal, traj within the goldens' bar, both
    float64 (the port's rod default; the JAX package's under x64)."""
    out_j, out_t = tmp_path / "jax", tmp_path / "torch"
    jcli.main(["prepare", CSV_DIR, "--out_dir", str(out_j)])
    path = tcli.main(["prepare", CSV_DIR, "--out_dir", str(out_t),
                      "--device", "cpu"])
    printed = capsys.readouterr().out
    assert path == str(out_t / "sil_step_1100.npz")
    assert printed.count("DTW Distance XYZ") == 2
    a, b = np.load(path), np.load(out_j / "sil_step_1100.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in ("t", "controls", "interpolated", "positions"):
        assert np.array_equal(a[k], b[k]), k
    assert a["traj"].dtype == b["traj"].dtype == np.float64
    assert a["traj"].shape == b["traj"].shape == (len(a["t"]), 10, 50)
    rmse = float(np.sqrt(np.mean((a["traj"] - b["traj"]) ** 2)))
    assert rmse < RMSE_BAR, rmse


def _write_prepared(d, name, T, seed, period):
    np.savez_compressed(os.path.join(d, name + ".npz"),
                        interpolated=_poses(T, seed=seed, period=period),
                        controls=6.0 + np.sin(np.arange(T)[:, None] * 0.3
                                              + np.arange(4)))


def test_estimate_and_train_real(tmp_path):
    """estimate on two prepared files equals the JAX command's output; a
    tiny train-real on them (the sinesine preset) lowers its loss."""
    d = str(tmp_path)
    names = tcli.REAL_PRESETS["sinesine"]
    for i, name in enumerate(names):
        _write_prepared(d, name, 108, i, (1.0, 3.0)[i])
        out = tcli.main(["estimate", name, "--data_dir", d, "--device",
                         "cpu"])
        got = dict(np.load(out))
        os.rename(out, os.path.join(d, "torch_est.npz"))
        jcli.main(["estimate", name, "--data_dir", d])
        want = np.load(out)
        np.testing.assert_allclose(got["traj"], want["traj"], rtol=EST_RTOL,
                                   atol=1e-12)
        np.testing.assert_allclose(got["vstar"], want["vstar"],
                                   rtol=EST_RTOL, atol=1e-12)
        assert np.array_equal(got["controls"], want["controls"])
    res = tcli.main(["train-real", "--data", "sinesine", "--data_dir", d,
                     "--epochs", "6", "--layers", "8", "--train_len", "6",
                     "--mod", "nsw", "--dtype", "float64", "--device", "cpu",
                     "--save_path", str(tmp_path / "real")])
    lh = res.loss_history
    assert len(lh) == 7 and np.isfinite(lh).all() and lh[-1] < lh[0]
    assert res.config.keypoints == K.training.DEFAULT_KEYPOINTS_REAL
    tree, _ = K.training.load_checkpoint(str(tmp_path / "real"))
    assert tree["params"][0]["w"].shape == (8, 28)
    np.testing.assert_array_equal(tree["loss"], lh)


def test_playback_writes_a_gif(tmp_path):
    d = str(tmp_path)
    T = 4
    interp = _poses(T)
    np.savez_compressed(os.path.join(d, "exp.npz"), interpolated=interp,
                        positions=interp[:, :3, tcli.MARKER_NODES].transpose(
                            0, 2, 1))
    out = tcli.main(["playback", os.path.join(d, "exp.npz"), "--gif",
                     os.path.join(d, "pb.gif"), "--max_frames", "2",
                     "--device", "cpu"])
    assert os.path.getsize(out) > 0
