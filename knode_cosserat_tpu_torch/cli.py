"""Command-line interface of the port, reduced to three commands:

  multitrain         (data x mod x seed) grid + eval table
                     (physics_multitrain.py)
  graphs             cross-seed aggregation tables (physics_multigraphs.py)
  simulate-assembly  coupled multi-rod (parallel continuum robot) rollout

Run as ``python -m knode_cosserat_tpu_torch <cmd> ...``. Arguments,
defaults, files and printouts are those of the JAX package's commands of
the same names (knode_cosserat_tpu/cli.py). The run takes the CUDA card;
``--device cpu`` runs it on the CPU (the JAX package's
``KNODE_PLATFORM=cpu``). The other commands (train, simulate, ...) are not
ported yet (ROADMAP.md, Queue 1, item 10).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

# the study's grid and schedules (knode_cosserat_tpu/cli.py:cmd_multitrain)
DATAS = {False: ["sine sine 0.5 1.0", "sine sine random 0.5 1.0 0.0"],
         True: ["sine sine 0.05 0.15", "sine sine random 0.05 0.15 0.0"]}
EVAL_SETS = {False: ["sine 1.5", "step 1.5"], True: ["sine 0.2", "step 1.5"]}
MODS = ["nsw", "short", "youngs", "lengthstiff"]
TRAIN_LEN = 30      # grid_train's default
EVAL_LEN = 100      # evaluate_cells' default


def cmd_multitrain(args) -> dict:
    """Train the grid, save each cell's net, evaluate, print the table and
    the phases. Returns {"result", "records", "seconds"} for callers that
    time the run (chip_smoke.py)."""
    import torch

    from .core.params import apply_mod
    from .evaluation.tables import evaluate_cells, format_table
    from .parallel.grid import build_grid, grid_train
    from .training.checkpoint import save_checkpoint
    from .training.train import TrainConfig, _net_tree

    if args.mesh:
        raise NotImplementedError(
            "--mesh: the sharded grid waits for torch.distributed; see "
            "ROADMAP.md, Queue 1, item 17")
    cells = build_grid(DATAS[args.original], MODS, args.n_seeds)
    cfg = TrainConfig(epochs=args.epochs, hidden=args.layers,
                      dtype=args.dtype)
    # the rods in the run's dtype: the JAX CLI's are float32 unless
    # KNODE_X64 turns on JAX's 64-bit mode
    ref = apply_mod(None, original=args.original,
                    dtype=getattr(torch, args.dtype), device=args.device)
    cuda = ref.device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(ref.device)) if cuda else (
        lambda: None)
    t0 = time.perf_counter()
    res = grid_train(cells, cfg, reference_rod=ref, train_len=TRAIN_LEN,
                     original=args.original,
                     log=print if args.verbose else None)
    sync()
    t1 = time.perf_counter()
    os.makedirs(args.save_dir, exist_ok=True)
    for cell, net in zip(res.cells, res.params):
        name = (f"{cell.data}_{cell.mod}_{cell.seed}").replace(" ", "-")
        save_checkpoint(os.path.join(args.save_dir, name),
                        {"params": _net_tree(net)})
    t2 = time.perf_counter()
    records = None
    if args.eval:
        records = evaluate_cells(res.cells, res.params, res.spec,
                                 EVAL_SETS[args.original], reference_rod=ref,
                                 eval_len=EVAL_LEN, original=args.original,
                                 save_dir=args.evals_dir)
        sync()
        print(format_table(records))
    t3 = time.perf_counter()
    phases = (f"phases: datagen+train {t1 - t0:.1f}s, save {t2 - t1:.1f}s"
              + (f", eval {t3 - t2:.1f}s" if args.eval else ""))
    print(phases)
    return {"result": res, "records": records,
            "seconds": {"datagen+train": t1 - t0, "save": t2 - t1,
                        "eval": t3 - t2}}


def cmd_graphs(args):
    from .evaluation.metrics import pose_mse, tip_dtw
    from .evaluation.tables import EvalRecord, aggregate_seeds, format_table

    if args.tipx:
        raise NotImplementedError(
            "--tipx: the figures need viz/, which is not ported yet; see "
            "ROADMAP.md, Queue 1, item 16")
    records = []
    for fname in sorted(os.listdir(args.evals_dir)):
        if not fname.endswith(".npz"):
            continue
        d = np.load(os.path.join(args.evals_dir, fname))
        stem = fname[:-4]
        evall, label = stem.split("+", 1)
        evall = evall.replace("physics_original_", "").replace(
            "physics_", "").replace("_", " ")
        label = label.replace("_", " ")
        records.append(EvalRecord(
            label=label, eval_name=evall,
            dtw=tip_dtw(d["predicted"], d["reference"]),
            mse=pose_mse(d["predicted"], d["reference"])))
    table = format_table(aggregate_seeds(records))
    print(table)
    return table


def cmd_simulate_assembly(args):
    """Coupled multi-rod rollout (core/assembly.py) in float32 (the JAX
    CLI's default dtype) with the plain coupled Newton, as the JAX CLI
    runs it. Writes traj, plate_pose and controls to ``--save``. Returns
    the AssemblySimOutput."""
    import torch

    from .controls import calc_controls
    from .core.assembly import (make_ring_assembly, simulate_assembly,
                                with_contact_plane)

    asm = make_ring_assembly(n_rods=args.rods, base_radius=args.base_radius,
                             plate_mass=args.plate_mass, N=args.nodes,
                             dtype=torch.float32, device=args.device)
    if args.contact_plane is not None:
        nx, ny, nz, off = args.contact_plane
        asm = with_contact_plane(asm, [nx, ny, nz], off)
    ctl1 = calc_controls(args.type, args.arg, float(asm.rods[0].del_t),
                         args.steps)
    controls = np.tile(np.asarray(ctl1)[:, None, :], (1, args.rods, 1))
    if args.pull_rod >= 0:
        controls[:, args.pull_rod, 0] += args.pull_extra
    out = simulate_assembly(asm, controls)
    traj = out.traj.cpu().numpy()
    plate = out.plate_pose.cpu().numpy()
    os.makedirs(os.path.dirname(args.save) or ".", exist_ok=True)
    np.savez_compressed(args.save, traj=traj, plate_pose=plate,
                        controls=controls)
    print(f"saved {args.save}: traj {traj.shape}, plate_pose {plate.shape}")
    print(f"plate tip: start {plate[0, :3]}, end {plate[-1, :3]}; "
          f"max Newton iters {int(out.newton_iters.max())}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="knode-cosserat-tpu-torch",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("multitrain", help="experiment grid + eval table")
    sp.add_argument("--epochs", type=int, default=1000)
    sp.add_argument("--n_seeds", type=int, default=1)
    sp.add_argument("--layers", type=int, default=512)
    sp.add_argument("--original", action="store_true")
    sp.add_argument("--eval", action=argparse.BooleanOptionalAction,
                    default=True)
    sp.add_argument("--verbose", action="store_true")
    sp.add_argument("--save_dir", type=str, default="saved_models")
    sp.add_argument("--evals_dir", type=str, default="evals")
    sp.add_argument("--dtype", type=str, default="float32")
    sp.add_argument("--mesh", type=str, default=None,
                    help="multi-chip mesh: not ported (raises)")
    sp.add_argument("--device", type=str, default=None,
                    help="torch device of the run (default: the CUDA card; "
                         "'cpu' runs on the CPU)")
    sp.set_defaults(fn=cmd_multitrain)

    sp = sub.add_parser("graphs", help="aggregate eval records")
    sp.add_argument("--evals_dir", type=str, default="evals")
    sp.add_argument("--tipx", action="store_true",
                    help="tip-X figures: not ported (raises)")
    sp.add_argument("--figs_dir", type=str, default="figures")
    sp.set_defaults(fn=cmd_graphs)

    sp = sub.add_parser("simulate-assembly",
                        help="coupled multi-rod (parallel continuum) rollout")
    sp.add_argument("--rods", type=int, default=3)
    sp.add_argument("--base_radius", type=float, default=0.05)
    sp.add_argument("--plate_mass", type=float, default=0.0)
    sp.add_argument("--nodes", type=int, default=10)
    sp.add_argument("--type", type=str, default="sine")
    sp.add_argument("--arg", type=float, default=1.0)
    sp.add_argument("--steps", type=int, default=100)
    sp.add_argument("--pull_rod", type=int, default=-1,
                    help="index of a rod to overpull (tendon 0)")
    sp.add_argument("--pull_extra", type=float, default=3.0)
    sp.add_argument("--contact_plane", type=float, nargs=4, default=None,
                    metavar=("NX", "NY", "NZ", "OFFSET"),
                    help="rigid plane n.x = offset the plate can touch "
                         "(smoothed penalty contact)")
    sp.add_argument("--save", type=str, default="data/assembly.npz")
    sp.add_argument("--device", type=str, default=None,
                    help="torch device of the run (default: the CUDA card; "
                         "'cpu' runs on the CPU)")
    sp.set_defaults(fn=cmd_simulate_assembly)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
