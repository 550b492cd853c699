"""Command-line interface of the port:

  simulate           rollout + save + optional energy / animation
                     (simulate.py)
  train              sim-data KNODE training (physics_train.py)
  multitrain         (data x mod x seed) grid + eval table
                     (physics_multitrain.py)
  graphs             cross-seed aggregation tables (physics_multigraphs.py)
  simulate-assembly  coupled multi-rod (parallel continuum robot) rollout
  prepare            experiment ingestion -> datas/*.npz (prepare.py)
  playback           3D mocap playback gif (plot_bag.py)
  estimate           pose-only -> full-state estimation (estimate_state.py)
  train-real         real-data KNODE training (train_segment.py)
  sysid              gradient-based physical-parameter identification
                     (training/sysid.py; --assembly M: per-rod, from the
                     end plate)
  design             Fisher-optimal input design for sysid
  replicate          the physical workflow from synthetic hardware: teleop
                     SIL -> firmware PID -> rosbag -> prepare -> estimate
                     -> train-real (hw/sil.py)

Run as ``python -m knode_cosserat_tpu_torch <cmd> ...``. Arguments,
defaults, files and printouts are those of the JAX package's commands of
the same names (knode_cosserat_tpu/cli.py). The run takes the CUDA card;
``--device cpu`` runs it on the CPU (the JAX package's
``KNODE_PLATFORM=cpu``). ``--dtype`` of train, train-real and simulate is
the rods' and the net's precision, float32 by default as in the JAX
package outside its 64-bit mode. The noise of ``--noise_traj`` /
``--noise_controls`` is drawn from a ``torch.Generator`` seeded with
``--seed``, so its values differ from the JAX package's PRNG draws.
``--dtype auto`` of sysid and design is float64 with ``--device cpu`` and
float32 on the card; an explicit ``--dtype float64`` runs on the card (the
H100 has float64; the JAX command pins the CPU for it because the TPU has
none). design's start is drawn from a ``torch.Generator`` seeded with 0.
``simulate --segments S`` rolls out by multiple shooting
(core/multiple_shooting.py). ``replicate --dtype`` is the rods' precision
(float32 by default; the training runs in float32). The JAX package's
``bench`` command is not ported: it runs the benchmark's own file, and
waits for the port's first benchmark. ``train --mesh`` and ``multitrain
--mesh d,s,m`` run over a ("data", "seq", "model") mesh of every rank of
the process group (parallel/mesh.py): start one rank per card with
``torchrun --nproc_per_node <cards>`` (NCCL), or CPU ranks with
``--device cpu`` (gloo); without a launcher the mesh is a world of one.
Only rank 0 prints and writes files.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from .device import default_device


def _parse_mesh(spec, device=None):
    """'data,seq,model' -> a parallel.mesh.Mesh over the process group that
    torchrun's environment describes, or a world of one on ``device``
    without one (None passes through)."""
    if not spec:
        return None
    from .parallel import init_distributed, make_mesh
    try:
        d, s, m = (int(x) for x in spec.split(","))
    except ValueError:
        raise SystemExit(f"--mesh {spec!r}: expected data,seq,model, e.g. "
                         "2,1,1") from None
    init_distributed()
    return make_mesh(data=d, seq=s, model=m, devices=device)


def _writer(mesh) -> bool:
    """Whether this process prints and writes files: no mesh, or rank 0."""
    if mesh is None:
        return True
    import torch.distributed as dist
    return dist.get_rank() == 0

# the study's grid and schedules (knode_cosserat_tpu/cli.py:cmd_multitrain)
DATAS = {False: ["sine sine 0.5 1.0", "sine sine random 0.5 1.0 0.0"],
         True: ["sine sine 0.05 0.15", "sine sine random 0.05 0.15 0.0"]}
EVAL_SETS = {False: ["sine 1.5", "step 1.5"], True: ["sine 0.2", "step 1.5"]}
MODS = ["nsw", "short", "youngs", "lengthstiff"]
TRAIN_LEN = 30      # grid_train's default
EVAL_LEN = 100      # evaluate_cells' default


# train-real's data sets (knode_cosserat_tpu/cli.py:cmd_train_real)
REAL_PRESETS = {
    "sinesine": ["sin_1_0_amp_300", "sin_3_0_amp_300"],
    "sinesinerand": ["sin_1_0_amp_300", "sin_3_0_amp_300", "rand_0_60s"],
    "sinesinestep": ["sin_1_0_amp_300", "sin_3_0_amp_300",
                     "dir_a_tension_950"],
    "sinesinestepstep": ["sin_1_0_amp_300", "sin_3_0_amp_300",
                         "dir_a_tension_950", "dir_a_tension_1250"],
}
REAL_TRIM = 100                   # train_segment.py:36
# the marker nodes of the rod grid and their arc positions
# (estimate_state.py:258)
MARKER_NODES = [0, 3, 5, 7, 9]
MARKER_LOC = [0, 3.23, 5.13, 7.07, 9]
DEVICE_HELP = ("torch device of the run (default: the CUDA card; 'cpu' runs "
               "on the CPU)")


def _add_train_args(sp):
    sp.add_argument("control_type_arg", nargs="+",
                    help='trajectories, e.g. "sine sine 0.5 1.0"')
    sp.add_argument("--mod", type=str, default=None)
    sp.add_argument("--original", action="store_true")
    sp.add_argument("--epochs", type=int, default=2000)
    sp.add_argument("--weight_decay", type=float, default=0.0)
    sp.add_argument("--noise_traj", type=float, default=0.0)
    sp.add_argument("--noise_controls", type=float, default=0.0)
    sp.add_argument("--layers", type=int, default=512)
    sp.add_argument("--validation", type=str, default=None)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--eval", action=argparse.BooleanOptionalAction,
                    default=True)
    sp.add_argument("--save_dir", type=str, default="saved_models")
    sp.add_argument("--train_len", type=int, default=30)
    sp.add_argument("--dtype", type=str, default="float32")
    sp.add_argument("--resume", type=str, default=None,
                    help="checkpoint to resume from")
    sp.add_argument("--mesh", type=str, default=None,
                    help='multi-chip mesh "data,seq,model", e.g. "4,2,1" '
                         '(one rank per device: torchrun)')
    sp.add_argument("--device", type=str, default=None, help=DEVICE_HELP)


def cmd_train(args):
    """Sim-data KNODE training: data from the reference rod, the net on the
    modified rod, validation by tip DTW, the best net saved as
    ``<save_dir>/<short_name>.npz`` with the experiment as metadata.
    Returns the TrainResult."""
    import torch

    from .config import DataConfig, EvalConfig, ExperimentConfig, RodConfig
    from .core.params import apply_mod
    from .training import (make_training_data, make_validation_reference,
                           parse_traj_specs)
    from .training.checkpoint import save_checkpoint
    from .training.train import TrainConfig, _net_tree, train_knode

    mesh = _parse_mesh(args.mesh, args.device)
    device = mesh.device if mesh is not None else default_device(args.device)
    specs = parse_traj_specs(args.control_type_arg)
    validation = args.validation or ("sine 0.1" if args.original
                                     else "sine 1.25")
    vkind, varg = validation.split(" ")

    cfg = ExperimentConfig(
        rod=RodConfig(mod=args.mod, original=args.original),
        data=DataConfig(specs=specs, train_len=args.train_len,
                        noise_traj=args.noise_traj,
                        noise_controls=args.noise_controls),
        train=TrainConfig(epochs=args.epochs, hidden=args.layers,
                          weight_decay=args.weight_decay, seed=args.seed,
                          dtype=args.dtype),
        eval=EvalConfig(validation=(vkind, float(varg))),
    )
    dtype = getattr(torch, args.dtype)
    ref = apply_mod(None, original=args.original, dtype=dtype, device=device)
    p_mod = cfg.rod.build(dtype, device)
    trajs, ctls = make_training_data(
        ref, specs, train_len=args.train_len, noise_traj=args.noise_traj,
        noise_controls=args.noise_controls,
        generator=torch.Generator().manual_seed(args.seed))
    vc = vr = None
    if args.eval:
        vc, vr = make_validation_reference(ref, (vkind, float(varg)))
    path = os.path.join(args.save_dir, cfg.short_name())
    writer = _writer(mesh)
    res = train_knode(p_mod, trajs, ctls, cfg.train, vc, vr, eval_rod=p_mod,
                      resume_from=args.resume, checkpoint_path=path,
                      mesh=mesh, log=print if writer else None)
    if writer:
        save_checkpoint(path, {
            "params": _net_tree(res.best_params if args.eval else res.params),
            "loss": res.loss_history,
            "dtw": res.dtw_history,
        }, meta=cfg.to_dict())
        print(f"saved {path}.npz (best DTW {res.best_dtw})")
    return res


def cmd_simulate(args):
    """Forward rollout of the rod, or of the hybrid rod of a ``--model``
    checkpoint (either package's), saved as traj (T, N, 50) and controls.
    ``--fast`` on the card solves each step in kernel K2 (with the net when
    ``--model`` is given); on the CPU it takes K2's plain FD-Newton loop,
    as the JAX command takes its XLA loop there. ``--segments S`` solves
    each step by multiple shooting over S segments. Returns traj
    (numpy)."""
    import torch

    from .controls import calc_controls
    from .core.params import apply_mod
    from .core.stepper import simulate
    from .models.mlp import params_from_jax, spec_from_params
    from .training.checkpoint import load_checkpoint
    from .training.train import rollout_with_nn

    p = apply_mod(args.mod, original=args.original, N=args.nodes,
                  dtype=getattr(torch, args.dtype),
                  device=default_device(args.device))
    if args.real_data:
        data = np.load(args.real_data, allow_pickle=True)
        controls = np.asarray(data["controls"])[: args.steps]
    else:
        controls = calc_controls(args.type, args.arg, float(p.del_t),
                                 args.steps)
    # refuse silently-ignored flag combinations: the elif chain below
    # dispatches exactly one rollout implementation
    if args.segments and args.model:
        raise SystemExit("simulate: --segments (multiple shooting) does not "
                         "support --model hybrid rollouts yet; drop one")
    if args.segments and args.fast:
        raise SystemExit("simulate: --segments and --fast pick different "
                         "solvers (multiple shooting vs the fused kernel "
                         "rollout); drop one")
    cuda = p.device.type == "cuda"
    if args.model:
        ckpt, meta = load_checkpoint(args.model)
        # the net's widths from its weights (any depth; 53 inputs: the
        # history form), its activation from the training's metadata
        spec = spec_from_params(
            ckpt["params"], meta.get("train", {}).get("activation", "elu"))
        net = params_from_jax(ckpt["params"], spec, dtype=p.dtype,
                              device=p.device)
        # --model --fast composes: the hybrid rollout rides K2 (the whole
        # Newton solve per launch, the net inlined) on the card
        impl = "mega" if (args.fast and cuda) else "scan"
        traj = rollout_with_nn(p, controls, spec, net, impl=impl)
    elif args.segments:
        # parallel-in-space Newton (multiple shooting): the fine-rod
        # (N >> 100) path; see core/multiple_shooting.py
        from .core.multiple_shooting import simulate_scan_ms
        traj = simulate_scan_ms(p, controls, args.segments).traj
    elif args.fast:
        from .core.fast_rollout import make_fast_rollout
        roll = make_fast_rollout(p, impl="mega" if cuda else "plain")
        traj3, _, _ = roll(torch.as_tensor(controls, dtype=p.dtype,
                                           device=p.device)[None])
        traj = traj3[0]
    else:
        traj = simulate(p, controls)
    traj = traj.cpu().numpy()
    os.makedirs(os.path.dirname(args.save) or ".", exist_ok=True)
    extra = {}
    if args.energy:
        from .core.energy import energy_summary, rod_energies
        extra = {f"energy_{k}": v.cpu().numpy()
                 for k, v in rod_energies(p, traj).items()}
        print(energy_summary(p, traj))
    np.savez_compressed(args.save, traj=traj, controls=controls, **extra)
    print(f"saved {args.save}: traj {traj.shape}")
    if args.gif:
        from .viz.visualizer import ContinuumRobotVisualizer
        out = ContinuumRobotVisualizer(traj[:, :, :25], p).save_as_gif(
            args.gif, max_frames=100)
        print(f"saved {out}")
    return traj


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

    mesh = _parse_mesh(args.mesh, args.device)
    writer = _writer(mesh)
    cells = build_grid(DATAS[args.original], MODS, args.n_seeds)
    cfg = TrainConfig(epochs=args.epochs, hidden=args.layers,
                      dtype=args.dtype)
    # the rods in the run's dtype: the JAX CLI's are float32 unless
    # KNODE_X64 turns on JAX's 64-bit mode
    ref = apply_mod(None, original=args.original,
                    dtype=getattr(torch, args.dtype),
                    device=mesh.device if mesh is not None else args.device)
    cuda = ref.device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(ref.device)) if cuda else (
        lambda: None)
    t0 = time.perf_counter()
    res = grid_train(cells, cfg, reference_rod=ref, train_len=TRAIN_LEN,
                     original=args.original, mesh=mesh,
                     log=print if args.verbose and writer else None)
    sync()
    t1 = time.perf_counter()
    if writer:
        os.makedirs(args.save_dir, exist_ok=True)
        for cell, net in zip(res.cells, res.params):
            name = (f"{cell.data}_{cell.mod}_{cell.seed}").replace(" ", "-")
            save_checkpoint(os.path.join(args.save_dir, name),
                            {"params": _net_tree(net)})
    t2 = time.perf_counter()
    records = None
    if args.eval and writer:
        records = evaluate_cells(res.cells, res.params, res.spec,
                                 EVAL_SETS[args.original], reference_rod=ref,
                                 eval_len=EVAL_LEN, original=args.original,
                                 save_dir=args.evals_dir)
        sync()
        print(format_table(records))
    t3 = time.perf_counter()
    phases = (f"phases: datagen+train {t1 - t0:.1f}s, save {t2 - t1:.1f}s"
              + (f", eval {t3 - t2:.1f}s" if args.eval else ""))
    if writer:
        print(phases)
    return {"result": res, "records": records,
            "seconds": {"datagen+train": t1 - t0, "save": t2 - t1,
                        "eval": t3 - t2}}


def cmd_graphs(args):
    """The cross-seed table of the eval records; ``--tipx`` also writes the
    tip-X generalization figures (needs matplotlib). Returns the table."""
    from .evaluation.metrics import pose_mse, tip_dtw
    from .evaluation.tables import EvalRecord, aggregate_seeds, format_table

    records = []
    evals, labels = set(), set()
    for fname in sorted(os.listdir(args.evals_dir)):
        if not fname.endswith(".npz"):
            continue
        d = np.load(os.path.join(args.evals_dir, fname))
        stem = fname[:-4]
        evall, label = stem.split("+", 1)
        evall = evall.replace("physics_original_", "").replace(
            "physics_", "").replace("_", " ")
        label = label.replace("_", " ")
        evals.add(evall)
        labels.add(label)
        records.append(EvalRecord(
            label=label, eval_name=evall,
            dtw=tip_dtw(d["predicted"], d["reference"]),
            mse=pose_mse(d["predicted"], d["reference"])))
    table = format_table(aggregate_seeds(records))
    print(table)

    if args.tipx:
        # tip-X generalization figures (physics_multigraphs.py:186-231);
        # mods/datas inferred from the trained-cell record labels
        from .viz.visualizer import tip_generalization_plot
        mods, datas = set(), set()
        for label in labels:
            if label.startswith("baseline"):
                mods.add(label.split(" ", 1)[1])
            else:
                parts = label.split(" ")
                datas.add(" ".join(parts[:-2]))
        for evall in sorted(evals):
            out = os.path.join(args.figs_dir,
                               f"tipx_{evall.replace(' ', '_')}.png")
            tip_generalization_plot(args.evals_dir, evall, sorted(mods),
                                    sorted(datas), save=out)
            print(f"saved {out}")
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


def cmd_prepare(args):
    """Ingest an experiment (a .bag, or a directory of per-topic CSVs),
    simulate the measured tensions on the measured-hardware rod and save
    ``<out_dir>/<name>.npz``. Returns the saved path."""
    from .core.params import apply_mod
    from .core.stepper import simulate
    from .evaluation.metrics import fastdtw
    from .realworld.bag import read_bag, read_topic_csvs

    p = apply_mod(None, device=default_device(args.device))
    if os.path.isdir(args.experiment):
        data = read_topic_csvs(args.experiment, float(p.del_t),
                               args.experiment)
    else:
        data = read_bag(args.experiment, float(p.del_t))
    traj = simulate(p, data["controls"]).cpu().numpy()
    name = os.path.basename(args.experiment.rstrip("/"))
    os.makedirs(args.out_dir, exist_ok=True)
    out = os.path.join(args.out_dir, f"{name}.npz")
    np.savez_compressed(out, t=data["t"], traj=traj,
                        controls=data["controls"],
                        interpolated=data["interpolated"],
                        positions=data["positions"])
    tip = data["interpolated"][:, 0:3, 9]
    T = min(len(traj), len(tip))
    print("DTW Distance XYZ", fastdtw(traj[:T, -1, :3], tip[:T])[0])
    print(f"saved {out}")
    return out


def cmd_playback(args):
    """Animated 3D playback of ingested mocap data (plot_bag.py parity)."""
    from .viz.mocap import MocapPlayback

    default_device(args.device)         # the package's contract; host work
    d = np.load(args.data, allow_pickle=True)
    positions = np.asarray(d["positions"])          # (T, n_links, 3)
    quats = None
    if "interpolated" in d:
        interp = np.asarray(d["interpolated"])      # (T, 7, N)
        quats = np.stack([interp[:, 3:7, i] for i in MARKER_NODES], axis=1)
    out = MocapPlayback(positions, quats).save_as_gif(
        args.gif, max_frames=args.max_frames)
    print(f"saved {out}")
    return out


def cmd_estimate(args):
    """Full-state estimation of ``<data_dir>/<data_name>.npz`` (prepare's
    layout) into ``<data_name>_estimated.npz``: traj (T, 25, N), controls,
    vstar. Host float64; the rod is built on ``--device``. Returns the
    saved path."""
    from .core.params import make_rod
    from .realworld.curve import fit_curve
    from .realworld.estimate import estimate_state

    # the reference uses CosseratRod() defaults here
    rod = make_rod(device=default_device(args.device))
    d = np.load(os.path.join(args.data_dir, args.data_name + ".npz"),
                allow_pickle=True)
    interpolated = d["interpolated"]
    controls = d["controls"]
    partial = np.stack([interpolated[:, :, i] for i in MARKER_NODES],
                       axis=2)
    full_grid = fit_curve(partial, MARKER_LOC, rod.N)
    est, vstar = estimate_state(full_grid, controls, rod)
    out = os.path.join(args.data_dir, args.data_name + "_estimated.npz")
    np.savez_compressed(out, traj=est, controls=controls, vstar=vstar)
    print(f"saved {out}")
    return out


def cmd_train_real(args):
    """Real-data KNODE training on estimated states (``estimate``'s files of
    a ``--data`` preset), trimmed by REAL_TRIM steps, noised by
    ``--noise_traj``; saves the final net to ``--save_path``. Returns the
    TrainResult."""
    import torch

    from .core.params import apply_mod
    from .training.checkpoint import save_checkpoint
    from .training.loss import DEFAULT_KEYPOINTS_REAL
    from .training.train import TrainConfig, _net_tree, train_knode

    device = default_device(args.device)
    names = REAL_PRESETS.get(args.data, [args.data])
    trajs, ctls = [], []
    for n in names:
        d = np.load(os.path.join(args.data_dir, n + "_estimated.npz"),
                    allow_pickle=True)
        t = d["traj"][REAL_TRIM:args.train_len + REAL_TRIM, :25]
        trajs.append(np.moveaxis(t, 1, 2))       # -> (T, N, 25)
        ctls.append(d["controls"][REAL_TRIM:args.train_len + REAL_TRIM])
    trajs = torch.as_tensor(np.stack(trajs))
    ctls = torch.as_tensor(np.stack(ctls))
    gen = torch.Generator().manual_seed(args.seed)
    trajs = trajs + args.noise_traj * torch.randn(
        trajs.shape, generator=gen, dtype=trajs.dtype)

    dtype = getattr(torch, args.dtype)
    p = apply_mod(args.mod, dtype=dtype, device=device)
    cfg = TrainConfig(epochs=args.epochs, hidden=args.layers,
                      weight_decay=args.weight_decay, seed=args.seed,
                      keypoints=DEFAULT_KEYPOINTS_REAL, dtype=args.dtype)
    res = train_knode(p, trajs, ctls, cfg)
    save_checkpoint(args.save_path, {"params": _net_tree(res.params),
                                     "loss": res.loss_history})
    print(f"saved {args.save_path} (final loss {res.loss_history[-1]:.3e})")
    return res


def cmd_replicate(args) -> dict:
    """One command, the whole physical workflow, no hardware: teleop
    joystick experiment -> C++ firmware PID -> simulated winch plant ->
    rosbag recording -> bag ingestion -> state estimation -> KNODE
    training (hw/sil.py::replicate_workflow). Returns its summary."""
    import torch

    from .hw.sil import replicate_workflow

    summary = replicate_workflow(
        args.out_dir, experiment=args.experiment, parameter=args.parameter,
        mod=args.mod, epochs=args.epochs, hidden=args.layers,
        trim=args.trim, train_len=args.train_len, seed=args.seed,
        settle=args.settle, tail=args.tail, noise_traj=args.noise_traj,
        device=default_device(args.device),
        dtype=getattr(torch, args.dtype))
    print(f"replicate complete: model {summary['model']} "
          f"(loss {summary['loss_initial']:.3e} -> "
          f"{summary['loss_final']:.3e}, ingest DTW {summary['dtw']:.4f})")
    return summary


def coerce_traj_layout(t, N, layout="auto"):
    """Return ``t`` in state-last (T, N, C) layout, C in (25, 50).

    layout: "state-last", "reference" ((T, C, N), transposed), or "auto".
    Auto-detection refuses the ambiguous case: a rod with N in (25, 50)
    nodes matches both patterns."""
    if t.ndim != 3:
        raise SystemExit(f"sysid: traj must be 3-D, got {t.shape}")
    state_last = t.shape[1] == N and t.shape[2] in (25, 50)
    ref_layout = t.shape[1] in (25, 50) and t.shape[2] == N
    if layout == "auto" and state_last and ref_layout:
        raise SystemExit(
            f"sysid: traj shape {t.shape} is ambiguous for a rod with "
            f"N={N} nodes (both layouts match); pass --layout "
            "state-last or --layout reference")
    if layout == "state-last" or (layout == "auto" and state_last):
        if not state_last:
            raise SystemExit(f"sysid: traj shape {t.shape} is not "
                             f"state-last (T, N={N}, 25|50)")
        return t
    if layout == "reference" or (layout == "auto" and ref_layout):
        if not ref_layout:
            raise SystemExit(f"sysid: traj shape {t.shape} is not "
                             f"reference layout (T, 25|50, N={N})")
        return np.moveaxis(t, 1, 2)
    raise SystemExit(
        f"sysid: traj shape {t.shape} matches neither (T, N={N}, "
        f"25|50) nor (T, 25|50, N={N}); check the file or --mod/"
        "--original node count")


def _sysid_dtype(requested: str, device):
    """``--dtype`` of sysid / design: "auto" is float64 on the CPU and
    float32 on the card; an explicit float64 runs where ``device`` is."""
    import torch

    if requested == "auto":
        requested = "float64" if device.type == "cpu" else "float32"
    return getattr(torch, requested)


def cmd_sysid(args):
    """Identify physical rod parameters: by default the plant is the true
    rod under ``--type/--arg/--length`` controls and the fit starts at the
    ``--mod`` fault; ``--data`` fits recorded trajectories instead;
    ``--assembly M`` localizes a fault in rod 0 of an M-rod ring from its
    end plate. Prints the JAX command's lines; returns the SysIdResult
    (AssemblySysIdResult)."""
    import torch

    from .controls import calc_controls
    from .core.params import apply_mod
    from .core.stepper import simulate_scan
    from .training.sysid import fit_rod_params, theta_init, theta_values

    device = default_device(args.device)
    dtype = _sysid_dtype(args.dtype, device)
    if args.assembly:
        return _sysid_assembly(args, dtype, device)
    p0 = apply_mod(args.mod, original=args.original, dtype=dtype,
                   device=device)
    truth = None
    if args.data:
        data = np.load(args.data, allow_pickle=True)
        t = coerce_traj_layout(np.asarray(data["traj"]), int(p0.N),
                               args.layout)
        traj = torch.as_tensor(t[args.trim:, :, :25].copy(), dtype=dtype,
                               device=device)
        controls = torch.as_tensor(
            np.asarray(data["controls"])[args.trim:].copy(), dtype=dtype,
            device=device)
    else:
        # the plant is the true rod; the model starts at the faulted mod
        plant = apply_mod(None, original=args.original, dtype=dtype,
                          device=device)
        controls = torch.as_tensor(
            calc_controls(args.type, args.arg, float(plant.del_t),
                          args.length), dtype=dtype, device=device)
        traj = simulate_scan(plant, controls).traj[:, :, :25]
        truth = theta_values(theta_init(plant, args.fit))

    # the JAX command's chunk policy (50 for rollout fits on the chip);
    # the port's eager loop gives the same result for every chunk
    chunk = args.chunk
    if chunk == 0:
        chunk = (50 if args.objective == "rollout" and device.type != "cpu"
                 and dtype != torch.float64 else None)
    # external windows start mid-motion: drop the fabricated first
    # transition from the teacher loss there
    res = fit_rod_params(p0, traj, controls, fields=tuple(args.fit),
                         objective=args.objective, steps=args.steps,
                         lr=args.lr, n_starts=args.n_starts,
                         skip_first=bool(args.data), chunk=chunk)
    if args.n_starts > 1:
        print("start losses:",
              " ".join(f"{v:.3e}" for v in res.start_losses.cpu().numpy()))
    start = theta_values(theta_init(p0, args.fit))
    print(f"objective {args.objective}: loss "
          f"{float(res.loss_history[0]):.3e} -> "
          f"{float(res.loss_history[-1]):.3e} in {args.steps} steps")
    for name in args.fit:
        line = f"  {name}: {start[name]} -> {res.values[name]}"
        if truth is not None:
            line += f"  (true {truth[name]})"
        print(line)
    return res


def _sysid_assembly(args, dtype, device):
    """``sysid --assembly M``: per-rod fault localization on an M-rod ring
    whose rod 0 carries the ``--mod`` fault, from end-plate poses alone
    (training/sysid.fit_assembly_params)."""
    import torch

    from .controls import calc_controls
    from .core.assembly import (make_ring_assembly, simulate_assembly,
                                stack_rods)
    from .core.params import apply_mod
    from .training.sysid import (apply_theta, fit_assembly_params,
                                 theta_init, theta_values)

    M = int(args.assembly)
    if M < 2:
        raise SystemExit("--assembly needs M >= 2 rods")
    asm_nom = make_ring_assembly(n_rods=M, dtype=dtype, device=device)
    rods = list(asm_nom.rods)
    faulted = apply_mod(args.mod, original=args.original, dtype=dtype,
                        device=device)
    rods_true = [apply_theta(rods[0], theta_init(faulted, args.fit))]
    rods_true += rods[1:]
    asm_true = asm_nom.replace(rods=stack_rods(rods_true))

    del_t = float(rods[0].del_t)
    # per-rod phase-shifted excitation separates the rods
    ctl = np.stack([np.asarray(calc_controls(args.type,
                                             args.arg * (1 + 0.5 * i),
                                             del_t, args.length))
                    for i in range(M)], axis=1)
    obs = simulate_assembly(asm_true, ctl)
    res = fit_assembly_params(asm_nom, obs.plate_pose, ctl,
                              fields=tuple(args.fit), steps=args.steps,
                              lr=args.lr, w_ori=args.w_ori,
                              chunk=args.chunk or None)
    stacked = lambda rs: theta_values({
        k: torch.stack([theta_init(r, args.fit)[k] for r in rs])
        for k in args.fit})
    truth, start = stacked(rods_true), stacked(rods)
    print(f"assembly sysid (M={M}, fault in rod 0 via mod "
          f"{args.mod!r}): loss {float(res.loss_history[0]):.3e} -> "
          f"{float(res.loss_history[-1]):.3e} in {args.steps} steps")
    for name in args.fit:
        fit_v = np.asarray(res.values[name])
        true_v = np.asarray(truth[name])
        rel = np.abs(fit_v - true_v) / np.maximum(np.abs(true_v), 1e-30)
        print(f"  {name} per rod: start {start[name]}")
        print(f"  {name} fit : {fit_v}")
        print(f"  {name} true: {true_v}  (max rel err {rel.max():.2e})")
        start_v = np.asarray(start[name])
        dev = np.abs(fit_v - start_v) / np.maximum(np.abs(start_v), 1e-30)
        flat = dev.reshape(M, -1).sum(axis=1)
        print(f"  localization: rod {int(np.argmax(flat))} moved most "
              f"(expected 0)")
    return res


def cmd_design(args):
    """Fisher-optimal input design around the ``--mod`` rod; saves the
    designed controls to ``--save``. Returns the DesignResult."""
    from .core.params import apply_mod
    from .training.sysid import design_experiment

    device = default_device(args.device)
    dtype = _sysid_dtype(args.dtype, device)
    p = apply_mod(args.mod, original=args.original, dtype=dtype,
                  device=device)
    res = design_experiment(p, fields=tuple(args.fit), horizon=args.horizon,
                            criterion=args.criterion, u_min=args.u_min,
                            u_max=args.u_max, steps=args.steps, lr=args.lr)
    crit = ("log det Fisher" if args.criterion == "D"
            else "min Fisher eigenvalue")
    print(f"{crit}: {res.info_initial:.3f} -> {res.info_final:.3f} "
          f"({args.steps} steps, fields {' '.join(args.fit)})")
    os.makedirs(os.path.dirname(args.save) or ".", exist_ok=True)
    controls = res.controls.cpu().numpy()
    np.savez_compressed(args.save, controls=controls,
                        objective_history=res.objective_history.cpu().numpy())
    print(f"saved {args.save}: controls {controls.shape} — run it with "
          f"`simulate --real_data {args.save}` or on the physical rig, "
          "then `sysid --data ...`")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(prog="knode-cosserat-tpu-torch",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("train", help="sim-data KNODE training")
    _add_train_args(sp)
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("simulate", help="forward rollout")
    sp.add_argument("--type", type=str, default="sine")
    sp.add_argument("--arg", type=float, default=1.0)
    sp.add_argument("--steps", type=int, default=100)
    sp.add_argument("--mod", type=str, default=None)
    sp.add_argument("--original", action="store_true")
    sp.add_argument("--model", type=str, default=None)
    sp.add_argument("--real_data", type=str, default=None)
    sp.add_argument("--nodes", type=int, default=10,
                    help="rod node count N (default 10)")
    sp.add_argument("--segments", type=int, default=0,
                    help="multiple shooting over this many rod segments "
                         "(divides nodes - 1; 0 = single shooting)")
    sp.add_argument("--fast", action="store_true",
                    help="the whole Newton step per launch of kernel K2 on "
                         "the card; composes with --model for hybrid "
                         "rollouts")
    sp.add_argument("--save", type=str, default="data/quick_test.npz")
    sp.add_argument("--gif", type=str, default=None)
    sp.add_argument("--energy", action="store_true",
                    help="print + save mechanical-energy budgets "
                         "(core/energy.py)")
    sp.add_argument("--dtype", type=str, default="float32",
                    help="the rod's precision (and the net's with --model)")
    sp.add_argument("--device", type=str, default=None, help=DEVICE_HELP)
    sp.set_defaults(fn=cmd_simulate)

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
                    help='multi-chip mesh "data,seq,model": the grid axis '
                         'splits over "data" (one rank per device: '
                         'torchrun)')
    sp.add_argument("--device", type=str, default=None, help=DEVICE_HELP)
    sp.set_defaults(fn=cmd_multitrain)

    sp = sub.add_parser("graphs", help="aggregate eval records")
    sp.add_argument("--evals_dir", type=str, default="evals")
    sp.add_argument("--tipx", action="store_true",
                    help="also write tip-X generalization figures")
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
    sp.add_argument("--device", type=str, default=None, help=DEVICE_HELP)
    sp.set_defaults(fn=cmd_simulate_assembly)

    sp = sub.add_parser("prepare", help="ingest physical experiment data")
    sp.add_argument("experiment", type=str)
    sp.add_argument("--out_dir", type=str, default="datas")
    sp.add_argument("--device", type=str, default=None, help=DEVICE_HELP)
    sp.set_defaults(fn=cmd_prepare)

    sp = sub.add_parser("playback", help="3D mocap playback gif")
    sp.add_argument("data", type=str, help="datas/<name>.npz from prepare")
    sp.add_argument("--gif", type=str, default="animations/playback.gif")
    sp.add_argument("--max_frames", type=int, default=200)
    sp.add_argument("--device", type=str, default=None,
                    help=DEVICE_HELP + "; the playback itself is host work")
    sp.set_defaults(fn=cmd_playback)

    sp = sub.add_parser("estimate", help="full-state estimation")
    sp.add_argument("data_name", type=str)
    sp.add_argument("--data_dir", type=str, default="datas")
    sp.add_argument("--device", type=str, default=None, help=DEVICE_HELP)
    sp.set_defaults(fn=cmd_estimate)

    sp = sub.add_parser("train-real", help="real-data KNODE training")
    sp.add_argument("--data", type=str, default="sinesine")
    sp.add_argument("--data_dir", type=str, default="datas")
    sp.add_argument("--epochs", type=int, default=300)
    sp.add_argument("--layers", type=int, default=512)
    sp.add_argument("--weight_decay", type=float, default=1e-1)
    sp.add_argument("--train_len", type=int, default=120)
    sp.add_argument("--noise_traj", type=float, default=0.01)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--mod", type=str, default=None)
    sp.add_argument("--save_path", type=str,
                    default="saved_models/quick_test")
    sp.add_argument("--dtype", type=str, default="float32")
    sp.add_argument("--device", type=str, default=None, help=DEVICE_HELP)
    sp.set_defaults(fn=cmd_train_real)

    sp = sub.add_parser(
        "sysid", help="gradient-based physical-parameter identification")
    sp.add_argument("--fit", nargs="+", default=["E"],
                    help="base parameters to fit (E L r rho Bbt C g ...)")
    sp.add_argument("--mod", type=str, default="youngs",
                    help="faulted starting point (the mods registry)")
    sp.add_argument("--original", action="store_true")
    sp.add_argument("--objective", choices=("teacher", "rollout"),
                    default="teacher")
    sp.add_argument("--steps", type=int, default=300)
    sp.add_argument("--lr", type=float, default=0.1)
    sp.add_argument("--n_starts", type=int, default=1,
                    help=">1: random-restart fits, best wins")
    sp.add_argument("--type", type=str, default="sine",
                    help="plant control signal (when no --data)")
    sp.add_argument("--arg", type=float, default=1.0)
    sp.add_argument("--length", type=int, default=60,
                    help="plant trajectory steps (when no --data)")
    sp.add_argument("--data", type=str, default=None,
                    help="npz with traj+controls (from `simulate`, prepare, "
                         "or estimate) instead of the generated plant; both "
                         "state-last and reference (T, C, N) layouts accepted")
    sp.add_argument("--trim", type=int, default=0,
                    help="drop the first TRIM steps (estimated real data "
                         "uses 100, train_segment.py:36)")
    sp.add_argument("--layout", choices=("auto", "state-last", "reference"),
                    default="auto",
                    help="traj axis layout of --data: state-last (T, N, C) "
                         "or reference (T, C, N); required explicitly when "
                         "N is 25 or 50 (ambiguous)")
    sp.add_argument("--dtype", choices=("auto", "float32", "float64"),
                    default="auto",
                    help="auto (default): float32 on the card, float64 with "
                         "--device cpu; float64 runs on the card too")
    sp.add_argument("--chunk", type=int, default=0,
                    help="the JAX command's fit-scan chunk size (no effect "
                         "on the port's result); 0 = auto")
    sp.add_argument("--assembly", type=int, default=0, metavar="M",
                    help="fault localization on an M-rod parallel "
                         "continuum robot: the plant carries the --mod "
                         "fault in ROD 0 only, the fit recovers per-rod "
                         "values from END-PLATE pose alone "
                         "(training/sysid.fit_assembly_params)")
    sp.add_argument("--w_ori", type=float, default=1.0,
                    help="plate-orientation observation weight for "
                         "--assembly (0 = positions only; orientation is "
                         "what separates symmetric rods)")
    sp.add_argument("--device", type=str, default=None, help=DEVICE_HELP)
    sp.set_defaults(fn=cmd_sysid)

    sp = sub.add_parser(
        "design", help="Fisher-optimal input design for sysid")
    sp.add_argument("--fit", nargs="+", default=["E"],
                    help="parameters the experiment should inform")
    sp.add_argument("--mod", type=str, default=None,
                    help="nominal rod the design linearizes around")
    sp.add_argument("--original", action="store_true")
    sp.add_argument("--horizon", type=int, default=30)
    sp.add_argument("--criterion", choices=("D", "E"), default="D")
    sp.add_argument("--u_min", type=float, default=0.0)
    sp.add_argument("--u_max", type=float, default=10.0)
    sp.add_argument("--steps", type=int, default=100)
    sp.add_argument("--lr", type=float, default=0.2)
    sp.add_argument("--save", type=str, default="data/designed_controls.npz")
    sp.add_argument("--dtype", choices=("auto", "float32", "float64"),
                    default="auto", help="see sysid --dtype")
    sp.add_argument("--device", type=str, default=None, help=DEVICE_HELP)
    sp.set_defaults(fn=cmd_design)

    sp = sub.add_parser(
        "replicate",
        help="full physical workflow from synthetic hardware: teleop SIL "
             "-> firmware PID -> rosbag -> prepare -> estimate -> "
             "train-real, one command")
    sp.add_argument("--out_dir", type=str, default="runs/replicate")
    sp.add_argument("--experiment", type=str, default="sine",
                    choices=["step_x", "step_y", "sine", "random"],
                    help="joystick experiment (motor_joy_teleop:60-109)")
    sp.add_argument("--parameter", type=int, default=0,
                    help="experiment variant 0-15 (trigger/bumper bits)")
    sp.add_argument("--mod", type=str, default="nsw",
                    help="faulted physics the KNODE residual must correct")
    sp.add_argument("--epochs", type=int, default=30)
    sp.add_argument("--layers", type=int, default=32)
    sp.add_argument("--trim", type=int, default=5)
    sp.add_argument("--train_len", type=int, default=40)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--settle", type=float, default=1.0)
    sp.add_argument("--tail", type=float, default=1.0)
    sp.add_argument("--noise_traj", type=float, default=0.0)
    sp.add_argument("--dtype", type=str, default="float32",
                    help="the rods' precision (the training runs float32)")
    sp.add_argument("--device", type=str, default=None, help=DEVICE_HELP)
    sp.set_defaults(fn=cmd_replicate)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
