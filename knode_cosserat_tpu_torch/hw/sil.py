"""Full software-in-the-loop closure of the reference hardware loop
(SURVEY.md section 3.5) — entirely in software:

  joystick pattern -> TeleopNode -> serial protocol -> C++ firmware PID ->
  simulated winch plant -> CSV telemetry -> bagpy-format topic CSVs ->
  realworld ingestion (prepare) -> state estimation -> KNODE training.

The "Vicon" topics come from the Cosserat simulator itself: the tensions
the PID loop actually achieved (telemetry readings, grams) are ZOH-resampled
onto the solver grid and drive a rod rollout whose marker poses are exported
exactly as a real mocap capture would be (5 markers at the arc fractions,
base-height offset un-applied, mocap [x,y,z,w] quaternions) — the inverse
of realworld/preprocess.py's adjustments.

Reference chain being closed: motor_joy_teleop (teleop) -> firmware.ino
(PID) -> rosbag record -> prepare.py:173-297 -> estimate_state.py ->
train_segment.py.

PyTorch counterpart of ``knode_cosserat_tpu/hw/sil.py``: the rod rollouts,
the state estimation and the training run on the port (on the rod's
device: the CUDA card unless the caller passes a CPU rod or
``device="cpu"``); the firmware, the plant and the recording are host code.
``replicate_workflow``'s ``noise_traj`` draw comes from a
``torch.Generator`` seeded with ``seed``, so its values differ from the JAX
package's PRNG draw.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .bridge import SimulatedWinchPlant
from .teleop import JoyState, TeleopNode, VirtualFirmwareSerial

__all__ = ["run_sil_experiment", "export_csv_bundle", "export_bag",
           "sil_pipeline", "joy_for", "replicate_workflow"]

MARKER_NODES = (0, 3, 5, 7, 9)
LINK_TOPICS = ("vicon-continuum_base-pose", "vicon-continuum_0-pose",
               "vicon-continuum_1-pose", "vicon-continuum_2-pose",
               "vicon-continuum_3-pose")
BASE_MARKER_HEIGHT = 0.0635        # preprocess.py:12


def run_sil_experiment(joy: JoyState, settle: float = 1.0,
                       tail: float = 1.0, dt: float = 0.002,
                       plant: Optional[SimulatedWinchPlant] = None,
                       log=lambda *_: None) -> VirtualFirmwareSerial:
    """Drive one joystick experiment through the teleop node against the
    virtual firmware; returns the VirtualFirmwareSerial holding the
    telemetry and command logs.

    The node's sleeps advance the firmware clock (sleep_fn pumps the
    plant), so the run is deterministic and faster than real time.
    """
    vs = VirtualFirmwareSerial(plant=plant, dt=dt)
    node = TeleopNode(vs, log=log, sleep_fn=vs.pump_for, start_reader=False)
    vs.pump_for(settle)            # tare/settle time before the experiment
    node.get_joy(joy)              # experiment generators send in-callback
    node.run_once()                # step/direct commands send on change
    vs.pump_for(tail)
    return vs


def collect_topic_frames(vs: VirtualFirmwareSerial, rod=None):
    """Assemble the run's recorded topics as bagpy-style flattened-column
    DataFrames (keyed by filename-style topic), plus the ground-truth
    rollout driven by the PID loop's ACHIEVED tensions.

    ``rod`` defaults to the measured-hardware rod on the CUDA card.
    Returns (frames, {controls (T,4) N, traj (T,50,N) numpy, ts}).
    """
    import pandas as pd
    from ..core.params import apply_mod
    from ..core.stepper import simulate
    from ..realworld.bag import interpolate_zoh

    if rod is None:
        rod = apply_mod(None)

    tel_t = np.array([t for t, _, _ in vs.telemetry_log])
    tel_g = np.array([r for _, r, _ in vs.telemetry_log])    # grams
    tel_pwm = np.array([p for _, _, p in vs.telemetry_log])

    # solver-grid controls from ACHIEVED tensions (grams -> N)
    del_t = float(rod.del_t)
    ts = np.arange(tel_t[0], tel_t[-1], del_t)
    grams = np.stack([interpolate_zoh(ts, tel_t, tel_g[:, i])
                      for i in range(4)], axis=1)
    controls = grams / 1000.0 * 9.81
    traj = simulate(rod, controls, reference_layout=True).cpu().numpy()

    frames = {}
    # --- mocap topics from the rollout (inverse of preprocess.adj_pos) ---
    links_ts = ts - ts[0]
    for topic, node in zip(LINK_TOPICS, MARKER_NODES):
        pos = traj[:, :3, node].copy()
        if node != 0:
            pos[:, 2] -= BASE_MARKER_HEIGHT
        quat_sf = traj[:, 3:7, node]
        quat_xyzw = quat_sf[:, [1, 2, 3, 0]]
        frames[topic] = pd.DataFrame({
            "Time": links_ts,
            "pose.position.x": pos[:, 0],
            "pose.position.y": pos[:, 1],
            "pose.position.z": pos[:, 2],
            "pose.orientation.x": quat_xyzw[:, 0],
            "pose.orientation.y": quat_xyzw[:, 1],
            "pose.orientation.z": quat_xyzw[:, 2],
            "pose.orientation.w": quat_xyzw[:, 3],
        })

    # --- /tension, /pwm: QuaternionStamped channel quirk [y,z,w,x] ------
    for name, vals in (("tension", tel_g), ("pwm", tel_pwm)):
        frames[name] = pd.DataFrame({
            "Time": tel_t - ts[0],
            "quaternion.x": vals[:, 3],
            "quaternion.y": vals[:, 0],
            "quaternion.z": vals[:, 1],
            "quaternion.w": vals[:, 2],
        })

    # --- /rosout command log (motor_joy_teleop:146 format) --------------
    frames["rosout"] = pd.DataFrame({
        "Time": [t - ts[0] for t, _ in vs.command_log],
        "msg": [f"Serial Command: {cmd}" for _, cmd in vs.command_log],
    })
    return frames, {"controls": controls, "traj": traj, "ts": ts}


def export_csv_bundle(vs: VirtualFirmwareSerial, out_dir: str,
                      rod=None) -> dict:
    """Write the run as a bagpy-style per-topic CSV bundle readable by
    realworld.bag.read_topic_csvs.

    The rod rollout driven by the achieved tensions provides the mocap
    topics. Returns {controls (T,4) N, traj (T,50,N)} of that rollout.
    """
    frames, truth = collect_topic_frames(vs, rod=rod)
    os.makedirs(out_dir, exist_ok=True)
    for topic, df in frames.items():
        df.to_csv(os.path.join(out_dir, topic + ".csv"), index=False)
    return truth


def export_bag(vs: VirtualFirmwareSerial, path: str, rod=None) -> dict:
    """Record the run as a genuine rosbag v2.0 file — the exact artifact a
    real `rosbag record` session produces in the reference workflow
    (SURVEY.md section 3.5) — readable by realworld.bag.read_bag (and by
    standard ROS tooling). Returns the ground-truth rollout dict."""
    from ..realworld.rosbag_io import BagWriter

    frames, truth = collect_topic_frames(vs, rod=rod)
    ros_topic = {t: "/" + t.replace("-pose", "/pose").replace("-", "/")
                 for t in LINK_TOPICS}
    with BagWriter(path) as w:
        for topic, df in frames.items():
            if topic in ros_topic:
                for _, r in df.iterrows():
                    w.write_pose(ros_topic[topic], r["Time"],
                                 [r["pose.position.x"], r["pose.position.y"],
                                  r["pose.position.z"]],
                                 [r["pose.orientation.x"],
                                  r["pose.orientation.y"],
                                  r["pose.orientation.z"],
                                  r["pose.orientation.w"]])
            elif topic in ("tension", "pwm"):
                for _, r in df.iterrows():
                    w.write_quaternion("/" + topic, r["Time"],
                                       [r["quaternion.x"], r["quaternion.y"],
                                        r["quaternion.z"],
                                        r["quaternion.w"]])
            elif topic == "rosout":
                for _, r in df.iterrows():
                    w.write_log(r["Time"], r["msg"])
    return truth


def joy_for(experiment: str, parameter: int = 0) -> JoyState:
    """JoyState encoding one of the reference joystick experiments
    (motor_joy_teleop:60-109): ``step_x``/``step_y`` (A/B buttons),
    ``sine`` (X), ``random`` (Y). ``parameter`` selects the experiment
    variant via the trigger/bumper bit encoding (:64-67)."""
    buttons = {"step_x": (1, 0, 0, 0), "step_y": (0, 1, 0, 0),
               "sine": (0, 0, 1, 0), "random": (0, 0, 0, 1)}
    if experiment not in buttons:
        raise ValueError(f"unknown experiment {experiment!r}; choose from "
                         f"{sorted(buttons)}")
    if not 0 <= parameter <= 15:
        raise ValueError(f"parameter must be in [0, 15], got {parameter}")
    axes = [0.0, 0.0, 1.0, 0.0, 0.0, 1.0]
    if parameter & 1:
        axes[2] = 0.0                 # left trigger pressed
    if parameter & 2:
        axes[5] = 0.0                 # right trigger pressed
    return JoyState(axes=tuple(axes),
                    buttons=buttons[experiment][:2]
                    + (buttons[experiment][2], buttons[experiment][3],
                       (parameter >> 2) & 1, (parameter >> 3) & 1))


def replicate_workflow(out_dir: str, experiment: str = "sine",
                       parameter: int = 0, mod: str = "nsw",
                       epochs: int = 30, hidden: int = 32,
                       trim: int = 5, train_len: int = 40, seed: int = 0,
                       settle: float = 1.0, tail: float = 1.0,
                       noise_traj: float = 0.0,
                       log=print, device=None,
                       dtype: torch.dtype = torch.float32) -> dict:
    """The reference's full physical workflow, one call, no hardware:
    teleop joystick experiment -> C++ firmware PID against the simulated
    winch plant -> a genuine rosbag v2.0 recording (BagWriter) -> bag
    ingestion + mocap preprocessing (prepare.py:173-297 parity) ->
    full-state estimation (estimate_state.py) -> KNODE training on the
    estimated states (train_segment.py parity).

    The rods are built on ``device`` (default: the CUDA card) in ``dtype``
    (float32, the JAX package's default outside its 64-bit mode); the
    training runs TrainConfig's float32 (K4 on the card). Artifacts land in
    ``out_dir``: ``<name>.bag``, ``<name>.npz``, ``<name>_estimated.npz``,
    ``<name>_model.npz``. Returns a summary dict with the bag path, the
    ingest DTW, the training loss curve endpoints and the seconds of each
    stage (``seconds``: record, prepare, estimate, train; the device
    synchronised at the end of each).
    """
    import time

    from ..core.params import apply_mod, make_rod
    from ..core.stepper import simulate
    from ..device import default_device
    from ..evaluation.metrics import fastdtw
    from ..realworld.bag import read_bag
    from ..realworld.curve import fit_curve
    from ..realworld.estimate import estimate_state
    from ..training import DEFAULT_KEYPOINTS_REAL, TrainConfig, train_knode
    from ..training.checkpoint import save_checkpoint
    from ..training.train import _net_tree

    device = default_device(device)
    name = f"{experiment}_{parameter}"
    os.makedirs(out_dir, exist_ok=True)
    rod = apply_mod(None, dtype=dtype, device=device)
    seconds = {}
    clock = [time.perf_counter()]

    def lap(stage):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        seconds[stage] = now - clock[0]
        clock[0] = now

    # L7: joystick -> teleop -> firmware PID -> plant, recorded as a bag
    vs = run_sil_experiment(joy_for(experiment, parameter),
                            settle=settle, tail=tail)
    bag_path = os.path.join(out_dir, name + ".bag")
    truth = export_bag(vs, bag_path, rod=rod)
    log(f"[replicate] recorded {bag_path}: "
        f"{len(vs.telemetry_log)} telemetry frames, "
        f"{len(vs.command_log)} commands")
    lap("record")

    # L5a: prepare: ingest the bag, re-simulate, report DTW
    data = read_bag(bag_path, float(rod.del_t))
    traj = simulate(rod, data["controls"]).cpu().numpy()   # (T, N, 50)
    tip = data["interpolated"][:, 0:3, 9]
    T = min(len(traj), len(tip))
    dtw = float(fastdtw(traj[:T, -1, :3], tip[:T])[0])
    prep_path = os.path.join(out_dir, name + ".npz")
    np.savez_compressed(prep_path, t=data["t"], traj=traj,
                        controls=data["controls"],
                        interpolated=data["interpolated"],
                        positions=data["positions"])
    log(f"[replicate] prepared {prep_path}: DTW Distance XYZ {dtw:.4f}")
    lap("prepare")

    # L5b: full-state estimation on the refit grid
    est_rod = make_rod(dtype=dtype, device=device)   # the reference's
    measured_loc = [0, 3.23, 5.13, 7.07, 9]          # estimate_state.py:258
    interp = data["interpolated"]
    partial = np.stack([interp[:, :, i] for i in [0, 3, 5, 7, 9]], axis=2)
    full_grid = fit_curve(partial, measured_loc, est_rod.N)
    m = min(len(full_grid), len(data["controls"]))
    est, vstar = estimate_state(full_grid[:m], data["controls"][:m],
                                est_rod)
    est_path = os.path.join(out_dir, name + "_estimated.npz")
    np.savez_compressed(est_path, traj=est, controls=data["controls"][:m],
                        vstar=vstar)
    log(f"[replicate] estimated {est_path}: traj {est.shape}")
    lap("estimate")

    # L3: KNODE training on the estimated states (train_segment.py role)
    stop = min(trim + train_len, len(est))
    if stop - trim < 3:
        raise ValueError(
            f"run too short to train on: {stop - trim} frames after "
            f"trim={trim} (lengthen the experiment or lower --trim)")
    trajs = torch.as_tensor(np.moveaxis(est[trim:stop, :25], 1, 2)[None])
    ctls = torch.as_tensor(np.asarray(data["controls"])[trim:stop][None])
    if noise_traj:
        gen = torch.Generator().manual_seed(seed)
        trajs = trajs + noise_traj * torch.randn(trajs.shape, generator=gen,
                                                 dtype=trajs.dtype)
    cfg = TrainConfig(epochs=epochs, hidden=hidden, seed=seed,
                      keypoints=DEFAULT_KEYPOINTS_REAL,
                      log_every=max(epochs // 4, 1))
    res = train_knode(apply_mod(mod, dtype=dtype, device=device), trajs,
                      ctls, cfg,
                      log=(lambda s: log(f"[replicate]   {s}"))
                      if log else None)
    model_path = os.path.join(out_dir, name + "_model")
    save_checkpoint(model_path, {"params": _net_tree(res.params),
                                 "loss": res.loss_history})
    loss0 = float(res.loss_history[0])
    lossN = float(res.loss_history[-1])
    log(f"[replicate] trained {model_path}.npz: "
        f"loss {loss0:.3e} -> {lossN:.3e} over {epochs} epochs")
    lap("train")
    return {"bag": bag_path, "prepared": prep_path, "estimated": est_path,
            "model": model_path + ".npz", "dtw": dtw,
            "loss_initial": loss0, "loss_final": lossN,
            "telemetry_frames": len(vs.telemetry_log),
            "sil_truth": truth, "seconds": seconds}


def sil_pipeline(joy: JoyState, out_dir: str, settle: float = 1.0,
                 tail: float = 1.0, rod=None, log=lambda *_: None) -> dict:
    """One call: teleop experiment -> firmware/plant -> CSV bundle ->
    realworld ingestion. Returns the ingested data dict (read_topic_csvs
    output) plus the ground-truth rollout under "sil_truth". ``rod``
    defaults to the measured-hardware rod on the CUDA card."""
    from ..core.params import apply_mod
    from ..realworld.bag import read_topic_csvs

    if rod is None:
        rod = apply_mod(None)
    vs = run_sil_experiment(joy, settle=settle, tail=tail, log=log)
    truth = export_csv_bundle(vs, out_dir, rod=rod)
    data = read_topic_csvs(out_dir, float(rod.del_t), out_dir)
    data["sil_truth"] = truth
    return data
