"""The port's parallel stack against the JAX package, float64 on the CPU:
a gloo world of two processes (tests/torch_parallel_worker.py, started
once for the file through a file store) builds the meshes (2,1,1), (1,2,1)
and (1,1,2) in turn and runs every case; this process makes the inputs and
the JAX references (the JAX package on two of the conftest's virtual CPU
devices, or on one) and holds the ranks' results to them:

  * the mesh helpers: shapes, coordinates, the slices each rank gets under
    data_sharding / shard_params_tp (against JAX's addressable shards), the
    gathers' round trips, make_mesh's refusals;
  * init_distributed() without an environment does nothing;
  * grid_train(mesh=) at data=2 equals the unsharded grid bit for bit (K5's
    plain version, and the plain epoch loop), a grid of 3 cells padded;
  * train_knode(mesh=) under DP, SP and TP against JAX's single-device
    train_knode from the same initial weights: losses within 1e-10
    relative, weights within 1e-9 (JAX: mesh equals one device up to the
    order of the reductions, tests/test_interop_parallel.py), the
    validation DTWs as tests/test_torch_train_knode.py holds them, the
    same on both ranks, and rank 0's checkpoints (under DP and TP, where
    gathering the net is a collective of the "model" ranks); resume under
    a mesh from the JAX trainer's checkpoint;
  * ShardedTrainer warns, trains and is single-shot;
  * simulate_scan_ms(mesh=) and simulate_scan_ms_halo on N=17, S=4, 4
    steps, D=2 and D=1, within 1e-9 of JAX's halo rollout on a 2-device
    mesh and of the unsharded structured solver (tests/test_spatial_halo.py);
  * the CLI's multitrain --mesh 2,1,1 against the command without a mesh.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import knode_cosserat_tpu as J
from knode_cosserat_tpu.controls import calc_controls
from knode_cosserat_tpu.core import multiple_shooting as jms
from knode_cosserat_tpu.core import params as jp
from knode_cosserat_tpu.models import mlp as jmlp
from knode_cosserat_tpu.parallel import mesh as jmesh
from knode_cosserat_tpu.parallel.spatial import simulate_scan_ms_halo
from knode_cosserat_tpu.training import checkpoint as jckpt
from knode_cosserat_tpu.training import data as jdata
from knode_cosserat_tpu.training import train as jtrain

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_parallel_worker.py")
TRAIN_KW = dict(hidden=16, dtype="float64", fused="off", log_every=1000,
                plateau_patience=3)
LOSS_RTOL, PARAM_TOL, DTW_RTOL, MS_TOL = 1e-10, 1e-9, 1e-7, 1e-9
SHAPES = ((2, 1, 1), (1, 2, 1), (1, 1, 2))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Inputs written by the JAX package, the world of two run once, and
    both ranks' results ({case: result} each)."""
    d = tmp_path_factory.mktemp("world")
    inp, out = d / "in", d / "out"
    inp.mkdir()
    out.mkdir()
    ref = J.apply_mod(None)
    trajs, ctls = jdata.make_training_data(
        ref, [("sine", 0.5), ("sine", 1.0)], train_len=6)
    vc, vr = jdata.make_validation_reference(ref, ("sine", 1.25), 6)
    np.savez(inp / "data.npz", trajs=np.asarray(trajs), ctls=np.asarray(ctls),
             vc=np.asarray(vc), vr=np.asarray(vr))
    spec = jtrain.TrainConfig(**TRAIN_KW).spec()
    init = jmlp.init_mlp(spec, jax.random.PRNGKey(0), jnp.float64)
    jckpt.save_checkpoint(str(inp / "init"),
                          {"params": jax.tree.map(np.asarray, init)})
    jtrain.train_knode(J.apply_mod("nsw"), trajs, ctls,
                       jtrain.TrainConfig(**dict(TRAIN_KW, epochs=2,
                                                 checkpoint_every=3)),
                       log=None, resume_from=str(inp / "init"),
                       checkpoint_path=str(inp / "trained"))
    g = np.random.RandomState(0)
    np.savez(inp / "tp_params.npz", w0=g.randn(8, 28), b0=g.randn(8),
             w1=g.randn(6, 8), b1=g.randn(6), w2=g.randn(25, 6),
             b2=g.randn(25))
    rod = jp.make_rod(N=17, dtype=jnp.float64)
    np.savez(inp / "ms.npz", ctl=calc_controls("sine", 0.5,
                                               float(rod.del_t), 4))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), "2", str(d / "store"), str(inp),
         str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    return dict(ranks=ranks, inp=inp, trajs=trajs, ctls=ctls, vc=vc, vr=vr,
                rod=rod)


def _case(world, name):
    got = [r.get(name) for r in world["ranks"]]
    for r, g in enumerate(got):
        assert g is not None, f"rank {r} did not reach case {name}"
        assert "error" not in g, f"rank {r}, case {name}:\n{g['error']}"
    return got


def _jax_mesh(shape):
    return jmesh.make_mesh(data=shape[0], seq=shape[1], model=shape[2],
                           devices=jax.devices()[:2])


def _shard_of(arr, mesh, rank):
    """JAX's shard of ``arr`` on the mesh's rank-th device (row-major)."""
    dev = mesh.devices.reshape(-1)[rank]
    (s,) = [s for s in arr.addressable_shards if s.device == dev]
    return np.asarray(s.data)


# ------------------------------------------------------------------ mesh

@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_mesh_placements_match_jax(world, shape):
    ranks = _case(world, "mesh_helpers")
    jm = _jax_mesh(shape)
    x = np.arange(24.0).reshape(4, 6)
    jx = jax.device_put(jnp.asarray(x), jmesh.data_sharding(jm, 2, seq_axis=1))
    tp = np.load(world["inp"] / "tp_params.npz")
    params = ({"w": tp["w0"], "b": tp["b0"]}, {"w": tp["w1"], "b": tp["b1"]},
              {"w": tp["w2"], "b": tp["b2"]})
    placed = jax.device_put(jax.tree.map(jnp.asarray, params),
                            jmesh.shard_params_tp(jm, params))
    for rank, res in enumerate(ranks):
        got = res[shape]
        assert got["shape"] == dict(jm.shape)
        assert got["coord"] == dict(zip(("data", "seq", "model"),
                                        np.argwhere(jm.devices == jm.devices
                                                    .reshape(-1)[rank])[0]))
        np.testing.assert_array_equal(got["data"], _shard_of(jx, jm, rank))
        np.testing.assert_array_equal(got["rep"], x)
        want = [_shard_of(leaf, jm, rank) for layer in placed
                for leaf in (layer["w"], layer["b"])]
        for a, b in zip(got["tp"], want):
            np.testing.assert_array_equal(a, b)
        assert got["roundtrip"] and got["tp_roundtrip"]


def test_mesh_errors_match_jax(world):
    ranks = _case(world, "mesh_helpers")
    devs = jax.devices()[:2]
    for kw in (dict(data=4), dict(data=-1, model=3)):
        with pytest.raises(ValueError) as e:
            jmesh.make_mesh(devices=devs, **kw)
        for res in ranks:
            assert res["errors"][str(kw)] == str(e.value)
    for res in ranks:
        # a torch mesh spans the whole world (JAX takes the first devices)
        assert "spans the whole world" in res["errors"][str(dict(data=1))]
        assert res["fill"] == {"data": 1, "seq": 1, "model": 2}


def test_init_distributed_without_environment(monkeypatch):
    import torch.distributed as dist

    from knode_cosserat_tpu_torch.parallel import (init_distributed,
                                                   is_multihost,
                                                   process_summary)
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert init_distributed() is False
    assert not dist.is_initialized() and not is_multihost()
    assert "no process group" in process_summary()
    with pytest.raises(ValueError, match="number of processes"):
        init_distributed(coordinator_address="127.0.0.1:1")
    with pytest.raises(RuntimeError, match="torchrun"):
        from knode_cosserat_tpu_torch.parallel import make_mesh
        make_mesh(data=2, devices="cpu")
    assert not dist.is_initialized()


# ------------------------------------------------------------------ grid

@pytest.mark.parametrize("case", ["grid4", "grid3", "grid4_off"])
def test_sharded_grid_equals_unsharded(world, case):
    for res in _case(world, case):
        n = int(case[4])
        assert res["loss"].shape == (2, n)
        np.testing.assert_array_equal(res["loss"], res["loss_one"])
        assert len(res["params"]) == n
        for a, b in zip(res["params"], res["params_one"]):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


# ------------------------------------------------------------- training

@pytest.fixture(scope="module")
def jax_train(world):
    kw = dict(TRAIN_KW, epochs=3)
    plain = jtrain.train_knode(J.apply_mod("nsw"), world["trajs"],
                               world["ctls"], jtrain.TrainConfig(**kw),
                               log=None,
                               resume_from=str(world["inp"] / "init"))
    kw.update(eval_every=2, eval_len=6, checkpoint_every=2)
    evald = jtrain.train_knode(J.apply_mod("nsw"), world["trajs"],
                               world["ctls"], jtrain.TrainConfig(**kw),
                               world["vc"], world["vr"], log=None,
                               resume_from=str(world["inp"] / "init"))
    resumed = jtrain.train_knode(J.apply_mod("nsw"), world["trajs"],
                                 world["ctls"],
                                 jtrain.TrainConfig(**dict(TRAIN_KW,
                                                           epochs=2)),
                                 log=None,
                                 resume_from=str(world["inp"] / "trained"))
    return {"plain": plain, "eval": evald, "resumed": resumed}


def _leaves(params):
    return [np.asarray(layer[k]) for layer in params for k in ("w", "b")]


def _check_run(res, want, rtol_loss=LOSS_RTOL):
    np.testing.assert_allclose(res["loss"], want.loss_history,
                               rtol=rtol_loss, atol=0)
    for a, b in zip(res["params"], _leaves(want.params)):
        np.testing.assert_allclose(a, b, rtol=PARAM_TOL, atol=1e-14)


@pytest.mark.parametrize("case", ["train_dp", "train_sp", "train_tp",
                                  "train_tp_eval"])
def test_sharded_train_knode_matches_jax(world, jax_train, case):
    ranks = _case(world, case)
    evaluated = case in ("train_dp", "train_tp_eval")
    want = jax_train["eval" if evaluated else "plain"]
    for res in ranks:
        assert res["loss"].shape == (4,)
        _check_run(res, want)
    for a, b in zip(ranks[0]["params"], ranks[1]["params"]):
        np.testing.assert_array_equal(a, b)
    if evaluated:
        for res in ranks:
            np.testing.assert_allclose(res["dtw"],
                                       [d for _, d in want.dtw_history],
                                       rtol=DTW_RTOL)
            np.testing.assert_allclose(res["best"], want.best_dtw,
                                       rtol=DTW_RTOL)
            for a, b in zip(res["best_params"], _leaves(want.best_params)):
                np.testing.assert_allclose(a, b, rtol=PARAM_TOL, atol=1e-14)
            # rank 0 wrote the checkpoint from the gathered run
            np.testing.assert_array_equal(res["ckpt_loss"], res["loss"])
        assert ranks[0]["dtw"] == ranks[1]["dtw"]


@pytest.mark.parametrize("case", ["resume_tp", "resume_sp"])
def test_sharded_resume_from_jax_checkpoint(world, jax_train, case):
    for res in _case(world, case):
        want = jax_train["resumed"]
        assert res["loss"].shape == want.loss_history.shape == (6,)
        _check_run(res, want)


def test_sharded_trainer_alias(world):
    for res in _case(world, "sharded_trainer"):
        assert res["warned"] and "train_knode" in res["warned"][0]
        assert len(res["losses"]) == 2 and np.all(np.isfinite(res["losses"]))
        assert "single-shot" in res["again"]
        assert res["n_params"] == 4


# --------------------------------------------------- multiple shooting

@pytest.fixture(scope="module")
def jax_ms(world):
    rod, ctl = world["rod"], jnp.asarray(
        np.load(world["inp"] / "ms.npz")["ctl"])
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:2]), ("seq",))
    return {"halo": np.asarray(simulate_scan_ms_halo(rod, ctl, 4, mesh,
                                                     tol=1e-24).traj),
            "structured": np.asarray(jms.simulate_scan_ms(
                rod, ctl, 4, tol=1e-24, solver="structured").traj)}


@pytest.mark.parametrize("case", ["ms_d2", "ms_d1"])
@pytest.mark.parametrize("which", ["structured", "dense", "halo"])
def test_segment_sharding_and_halo_match_jax(world, jax_ms, case, which):
    for res in _case(world, case):
        got = res[which]
        assert got.shape == jax_ms["halo"].shape == (4, 17, 50)
        assert np.abs(got - jax_ms["halo"]).max() < MS_TOL
        assert np.abs(got - jax_ms["structured"]).max() < MS_TOL
        assert res["halo_res"].max() < 1e-10


# ------------------------------------------------------------------ cli

def test_cli_multitrain_mesh(world):
    ranks = _case(world, "cli")
    for rank, res in enumerate(ranks):
        m, one = res["mesh"], res["one"]
        np.testing.assert_array_equal(m["loss"], one["loss"])
        for a, b in zip(m["params"], one["params"]):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        # only rank 0 prints and writes under the mesh
        assert (m["saved"] == one["saved"]) == (rank == 0)
        assert ("phases:" in m["printed"]) == (rank == 0)
    assert ranks[0]["mesh"]["table"] == ranks[0]["one"]["table"]
    assert len(ranks[0]["mesh"]["saved"]) == 4
