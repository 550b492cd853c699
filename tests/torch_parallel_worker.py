"""One rank of the gloo world that tests/test_torch_parallel.py starts (two
processes on the CPU; this module imports no JAX).

    python tests/torch_parallel_worker.py RANK WORLD STORE IN_DIR OUT_DIR

It joins the world through the file store STORE, reads the inputs the test
wrote to IN_DIR (data, nets and checkpoints made by the JAX package),
builds the meshes (2,1,1), (1,2,1) and (1,1,2) in turn, runs every case of
CASES on them, and writes what each case returned (or the error it raised)
to OUT_DIR/rank<RANK>.pt. A rank stops at its first failed case (the other
rank then fails on its next collective, at the group's timeout).
"""
import datetime
import os
import sys
import traceback
import warnings

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import knode_cosserat_tpu_torch as K  # noqa: E402
from knode_cosserat_tpu_torch.core import params as kparams  # noqa: E402
from knode_cosserat_tpu_torch.parallel import mesh as kmesh  # noqa: E402

torch.set_num_threads(1)
IN = OUT = None
MESHES = {}


def mesh(shape):
    if shape not in MESHES:
        MESHES[shape] = kmesh.make_mesh(*shape[:1], model=shape[2],
                                        seq=shape[1])
    return MESHES[shape]


def inp(name):
    return np.load(os.path.join(IN, name + ".npz"))


def _tree(net):
    return [t.detach().numpy().copy() for t in net.parameters()]


# ------------------------------------------------------------------ cases

def case_mesh_helpers():
    """Each mesh's shape and this rank's coordinates, its slices of a
    (4, 6) array under data_sharding (leading axis over data, axis 1 over
    seq) and of a net under shard_params_tp, the gathers' round trips, and
    make_mesh's refusals."""
    out = {}
    x = torch.arange(24.0).reshape(4, 6)
    tp = inp("tp_params")
    params = [{"w": tp["w0"], "b": tp["b0"]}, {"w": tp["w1"], "b": tp["b1"]},
              {"w": tp["w2"], "b": tp["b2"]}]
    for shape in ((2, 1, 1), (1, 2, 1), (1, 1, 2)):
        m = mesh(shape)
        pl = kmesh.data_sharding(m, 2, seq_axis=1)
        loc = pl.shard(x)
        shards = kmesh.load_params_tp(m, params, device="cpu")
        pls = [p_[k] for p_ in kmesh.shard_params_tp(m, params)
               for k in ("w", "b")]
        back = [pl_.gather(t) for pl_, t in zip(pls, shards)]
        out[shape] = dict(
            shape=dict(m.shape), coord={a: m.index(a) for a in kmesh.AXES},
            data=loc.numpy(), roundtrip=bool(torch.equal(pl.gather(loc), x)),
            rep=kmesh.replicated(m).shard(x).numpy(),
            tp=[t.numpy() for t in shards],
            tp_roundtrip=all(np.array_equal(b.numpy(), np.asarray(a))
                             for b, a in zip(back, [v for layer in params
                                                    for v in layer.values()])))
    errs = {}
    for kw in (dict(data=4), dict(data=-1, model=3), dict(data=1)):
        try:
            kmesh.make_mesh(**kw)
            errs[str(kw)] = None
        except ValueError as e:
            errs[str(kw)] = str(e)
    out["errors"] = errs
    out["fill"] = dict(kmesh.make_mesh(data=-1, model=2).shape)
    return out


def case_grid(n_cells, fused):
    """grid_train under mesh (2,1,1) and unsharded in this process."""
    from knode_cosserat_tpu_torch.parallel.grid import build_grid, grid_train

    cells = build_grid(["sine 0.5"], ["nsw", "youngs"], 2)[:n_cells]
    cfg = K.TrainConfig(epochs=2, hidden=16, dtype="float32", fused=fused,
                        log_every=1)
    ref = K.apply_mod(None, device="cpu")
    one = grid_train(cells, cfg, reference_rod=ref, train_len=6)
    sh = grid_train(cells, cfg, reference_rod=ref, train_len=6,
                    mesh=mesh((2, 1, 1)))
    return dict(loss=sh.loss_history, loss_one=one.loss_history,
                params=[_tree(n) for n in sh.params],
                params_one=[_tree(n) for n in one.params])


TRAIN_KW = dict(hidden=16, dtype="float64", fused="off", log_every=1000,
                plateau_patience=3)


def case_train(shape, evaluate):
    """train_knode(mesh=) from the JAX-written initial checkpoint."""
    from knode_cosserat_tpu_torch.training.checkpoint import load_checkpoint
    from knode_cosserat_tpu_torch.training.train import (TrainConfig,
                                                         train_knode)

    d = inp("data")
    kw = dict(TRAIN_KW, epochs=3)
    val = {}
    if evaluate:
        kw.update(eval_every=2, eval_len=6, checkpoint_every=2)
        val = dict(validation_controls=d["vc"],
                   validation_reference=d["vr"])
    ck = os.path.join(OUT, f"ckpt_{'x'.join(map(str, shape))}")
    res = train_knode(K.apply_mod("nsw", device="cpu"), d["trajs"],
                      d["ctls"], TrainConfig(**kw), log=None,
                      resume_from=os.path.join(IN, "init"),
                      checkpoint_path=ck if evaluate else None,
                      mesh=mesh(shape), **val)
    out = dict(loss=res.loss_history, params=_tree(res.params),
               dtw=[v for _, v in res.dtw_history], best=res.best_dtw,
               best_params=_tree(res.best_params))
    if evaluate:
        dist.barrier()
        out["ckpt_loss"] = np.asarray(load_checkpoint(ck)[0]["loss"])
    return out


def case_resume(shape):
    """Resume under the mesh from the JAX trainer's checkpoint (weights,
    Adam moments, plateau state, loss history)."""
    from knode_cosserat_tpu_torch.training.train import (TrainConfig,
                                                         train_knode)

    d = inp("data")
    res = train_knode(K.apply_mod("nsw", device="cpu"), d["trajs"],
                      d["ctls"], TrainConfig(**dict(TRAIN_KW, epochs=2)),
                      log=None, resume_from=os.path.join(IN, "trained"),
                      mesh=mesh(shape))
    return dict(loss=res.loss_history, params=_tree(res.params))


def case_sharded_trainer():
    from knode_cosserat_tpu_torch.parallel import ShardedTrainer
    from knode_cosserat_tpu_torch.training.train import TrainConfig

    d = inp("data")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        st = ShardedTrainer(mesh((2, 1, 1)), K.apply_mod("nsw", device="cpu"),
                            TrainConfig(epochs=2, hidden=16, dtype="float32",
                                        log_every=1000))
    losses = st.fit(d["trajs"].astype(np.float32),
                    d["ctls"].astype(np.float32), epochs=2)
    try:
        st.fit(d["trajs"].astype(np.float32), d["ctls"].astype(np.float32),
               epochs=2)
        again = None
    except RuntimeError as e:
        again = str(e)
    return dict(warned=[str(x.message) for x in w
                        if issubclass(x.category, DeprecationWarning)],
                losses=losses, again=again,
                n_params=len(list(st.gathered_params().parameters())))


def case_ms(shape):
    """simulate_scan_ms(mesh=) (structured and dense) and the halo solver,
    N=17, S=4, float64, on the mesh's seq axis."""
    from knode_cosserat_tpu_torch.core.multiple_shooting import (
        simulate_scan_ms)
    from knode_cosserat_tpu_torch.parallel.spatial import (
        simulate_scan_ms_halo)

    d = inp("ms")
    p = kparams.make_rod(N=17, device="cpu")
    m = mesh(shape)
    out = {}
    for solver in ("structured", "dense"):
        o = simulate_scan_ms(p, d["ctl"], 4, tol=1e-24, solver=solver,
                             mesh=m)
        out[solver] = o.traj.numpy()
    o = simulate_scan_ms_halo(p, d["ctl"], 4, m, tol=1e-24)
    out["halo"] = o.traj.numpy()
    out["halo_res"] = o.residuals.numpy()
    return out


def case_cli():
    """multitrain --mesh 2,1,1 against multitrain without a mesh, on the
    CLI's function at a tiny grid."""
    import contextlib
    import io

    from knode_cosserat_tpu_torch import cli

    cli.DATAS[False] = ["sine 0.5", "sine sine 0.5 1.0"]
    cli.EVAL_SETS[False] = ["sine 1.5"]
    cli.MODS = ["nsw", "short"]
    cli.TRAIN_LEN, cli.EVAL_LEN = 5, 6
    rank = dist.get_rank()
    out = {}
    for tag, extra in (("mesh", ["--mesh", "2,1,1"]), ("one", [])):
        base = os.path.join(OUT, f"cli_{tag}_{rank}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            r = cli.main(["multitrain", "--epochs", "2", "--layers", "8",
                          "--device", "cpu",
                          "--save_dir", os.path.join(base, "saved"),
                          "--evals_dir", os.path.join(base, "evals"),
                          *extra])
        printed = buf.getvalue()
        out[tag] = dict(loss=r["result"].loss_history,
                        params=[_tree(n) for n in r["result"].params],
                        printed=printed,
                        table=printed.split("phases:")[0],
                        saved=sorted(os.listdir(os.path.join(base, "saved")))
                        if os.path.isdir(os.path.join(base, "saved")) else [])
    return out


CASES = {
    "mesh_helpers": case_mesh_helpers,
    "grid4": lambda: case_grid(4, "plain"),
    "grid3": lambda: case_grid(3, "plain"),
    "grid4_off": lambda: case_grid(4, "off"),
    "train_dp": lambda: case_train((2, 1, 1), True),
    "train_sp": lambda: case_train((1, 2, 1), False),
    "train_tp": lambda: case_train((1, 1, 2), False),
    "train_tp_eval": lambda: case_train((1, 1, 2), True),
    "resume_tp": lambda: case_resume((1, 1, 2)),
    "resume_sp": lambda: case_resume((1, 2, 1)),
    "sharded_trainer": case_sharded_trainer,
    "ms_d2": lambda: case_ms((1, 2, 1)),
    "ms_d1": lambda: case_ms((2, 1, 1)),
    "cli": case_cli,
}


def main():
    global IN, OUT
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store, IN, OUT = sys.argv[3], sys.argv[4], sys.argv[5]
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    results = {}
    for name, fn in CASES.items():
        try:
            results[name] = fn()
        except Exception:                # reported by the test, per case
            results[name] = {"error": traceback.format_exc()}
            break
    torch.save(results, os.path.join(OUT, f"rank{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
