"""Visualization: rod snapshots, 3D centerline+tendon animation, tip/root
time-series grids. Parity rebuild of Utils/visualizer.py:9-179 and the
plot_bag.py mocap playback, accepting either the state-last (T, N, state)
layout or the reference (T, state, N). Matplotlib, host-side; all figure
producers take/return fig+axes so tests can run headless (Agg).
Framework-free copy of ``knode_cosserat_tpu/viz/visualizer.py``; matplotlib
is imported at use."""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

__all__ = ["visualize_2d", "ContinuumRobotVisualizer", "plot_2d",
           "plot_training_curves", "tip_generalization_plot"]


def _state_last(traj: np.ndarray) -> np.ndarray:
    """Normalize layout to (T, N, state)."""
    traj = np.asarray(traj)
    if traj.ndim == 2:
        traj = traj[None]
    if traj.shape[-1] < traj.shape[-2]:     # (T, state, N) -> (T, N, state)
        traj = np.swapaxes(traj, -1, -2)
    return traj


def _mpl():
    import matplotlib
    if not os.environ.get("DISPLAY"):
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def visualize_2d(rod, y, i: int, out_dir: str = "images"):
    """X-Z snapshot of one frame (Utils/visualizer.py:9-26)."""
    plt = _mpl()
    y = _state_last(y)[0]
    L = float(rod.L)
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.plot(y[:, 2], y[:, 0])
    ax.set_title("CantileverRod")
    ax.set_xlabel("z(m)")
    ax.set_ylabel("x(m)")
    ax.axis([0, 1.1 * L, -0.55 * L, 0.55 * L])
    ax.text(0.05 * L, 0.5 * L, f"Step: {i}", fontsize=12,
            bbox=dict(facecolor="white", alpha=0.5))
    ax.grid(True)
    ax.set_aspect("equal", adjustable="box")
    os.makedirs(out_dir, exist_ok=True)
    filename = os.path.join(out_dir, f"frame_{i:04d}.png")
    fig.savefig(filename)
    plt.close(fig)
    return filename


class ContinuumRobotVisualizer:
    """3D centerline + tendon animation (Utils/visualizer.py:28-119)."""

    def __init__(self, results, rod):
        self.results = _state_last(results)
        self.rod = rod

    def plot_robot_3d(self, ax, timestep: int):
        ax.cla()
        r = self.results
        x, y, z = r[timestep, :, 0], r[timestep, :, 1], r[timestep, :, 2]
        ax.plot(x, y, z, label="Centerline", color="b")
        L = float(self.rod.L)
        ax.text(0.05 * L, 0.5 * L, L, f"Step: {timestep}", fontsize=12,
                bbox=dict(facecolor="white", alpha=0.5))
        n_t = int(self.rod.n_tendons)
        off = float(self.rod.tendon_offset)
        for i in range(n_t):
            ang = 2 * np.pi * i / n_t
            ax.plot(x + off * np.cos(ang), y + off * np.sin(ang), z,
                    linestyle="--", color="r")
        for dim, setter in enumerate([ax.set_xlim, ax.set_ylim, ax.set_zlim]):
            setter([r[:, :, dim].min() - 0.1, r[:, :, dim].max() + 0.1])
        ax.set_xlabel("X"); ax.set_ylabel("Y"); ax.set_zlabel("Z")

    def save_as_gif(self, filename: str = "animations/robot_motion_3d.gif",
                    fps: int = 5, max_frames: Optional[int] = None):
        plt = _mpl()
        from matplotlib.animation import FuncAnimation, PillowWriter
        os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
        fig = plt.figure()
        ax = fig.add_subplot(111, projection="3d")
        frames = len(self.results) if max_frames is None \
            else min(max_frames, len(self.results))
        ani = FuncAnimation(fig, lambda n: self.plot_robot_3d(ax, n),
                            frames=frames, repeat=False)
        ani.save(filename, writer=PillowWriter(fps=fps))
        plt.close(fig)
        return filename

    def visualize(self):
        plt = _mpl()
        from matplotlib.animation import FuncAnimation
        fig = plt.figure()
        ax = fig.add_subplot(111, projection="3d")
        FuncAnimation(fig, lambda n: (self.plot_robot_3d(ax, n), ax)[1:],
                      frames=len(self.results), repeat=False)
        plt.show()


def plot_2d(data_arr: Sequence, data_arr2=None, legend=None, markers=None,
            title: str = "rod tip position", tip_node: int = 5,
            root_node: int = 2, save: bool = True):
    """Tip/root xyz time-series grid (Utils/visualizer.py:121-166)."""
    plt = _mpl()
    data_arr = [_state_last(d) for d in data_arr]
    markers = markers or [None] * len(data_arr)
    fig = plt.figure(figsize=(15, 12))
    labels = ["x[m]", "y[m]", "z[m]"]
    for half, node in enumerate([tip_node, root_node]):
        for idx in range(3):
            ax = fig.add_subplot(3, 2, 2 * idx + 1 + half)
            if idx == 0:
                ax.set_title(title + (" - tip" if half == 0 else " - root"))
            for i, d in enumerate(data_arr):
                lab = legend[i] if legend is not None else None
                if data_arr2 is not None:
                    d2 = _state_last(data_arr2[i])
                    ax.plot(d[:, node, idx], d2[:, node, idx], label=lab,
                            marker=markers[i])
                else:
                    ax.plot(d[:, node, idx], label=lab, marker=markers[i])
                ax.grid(True)
                ax.set_xlabel("t")
                ax.set_ylabel(labels[idx])
    plt.legend()
    if save:
        fig.savefig(title + ".png", format="png", dpi=150,
                    bbox_inches="tight", pad_inches=0.1)
    return fig


def plot_training_curves(loss_histories, labels=None, title="Training loss"):
    """Mean/min/max loss bands across seeds (physics_multigraphs.py:154-183)."""
    plt = _mpl()
    losses = np.asarray(loss_histories)
    if losses.ndim == 1:
        losses = losses[None]
    epochs = np.arange(losses.shape[1])
    fig, ax = plt.subplots()
    ax.plot(epochs, losses.mean(axis=0), label="Loss mean")
    ax.fill_between(epochs, losses.min(axis=0), losses.max(axis=0),
                    alpha=0.3, label="Loss range")
    ax.set_xlabel("Epochs")
    ax.set_title(title)
    ax.legend()
    return fig


# color/linestyle coding per training set (physics_multigraphs.py:203-222)
_TIPX_STYLES = (
    ("sine random", ("blue", "solid")),
    ("sine sine", ("green", "solid")),
    ("random", ("cyan", "dashed")),
    ("sine", ("lime", "dashed")),
    ("step", ("pink", "dashed")),
)


def _tipx_style(label: str):
    if "baseline" in label:
        return "red", "solid"
    for key, style in _TIPX_STYLES:
        if key in label:
            return style
    return "gray", "solid"


def tip_generalization_plot(evals_dir: str, eval_name: str,
                            mods: Sequence[str], datas: Sequence[str],
                            seed: int = 0, original: bool = False,
                            del_t: float = 0.05, save: Optional[str] = None):
    """Per-mod tip-X generalization figure (physics_multigraphs.py:186-231):
    for one unseen eval schedule, overlay the tip X(t) predicted by models
    trained on each training set (color-coded) plus the no-NN baseline (red)
    and the reference rollout (black).

    Reads the evals/*.npz records written by evaluation.tables.evaluate_cells
    ({tensions, reference, predicted}, state-last layout).
    """
    plt = _mpl()
    prefix = "physics_original" if original else "physics"
    ncols = 2
    nrows = (len(mods) + 1) // 2
    fig, axes = plt.subplots(nrows, ncols, figsize=(12, 4 * nrows / 2 + 2))
    fig.suptitle(f"Model generalization to {eval_name} Trajectory: "
                 "Tip X axis")
    axes = np.atleast_1d(axes).ravel()
    tip_x = lambda a: a[:, -1, 0] if a.shape[-1] >= 19 else a[:, 0, 9]

    for ax, mod in zip(axes, mods):
        ax.set_title(str(mod))
        result = None
        for data in [*datas, "baseline"]:
            label = (f"baseline {mod}" if data == "baseline"
                     else f"{data} {mod} {seed}")
            fname = os.path.join(
                evals_dir, f"{prefix}_" + eval_name.replace(" ", "_")
                + "+" + label.replace(" ", "_") + ".npz")
            if not os.path.exists(fname):
                continue
            result = np.load(fname)
            ts = np.arange(result["tensions"].shape[0]) * del_t
            color, linestyle = _tipx_style(data)
            ax.plot(ts, tip_x(result["predicted"]), color,
                    linestyle=linestyle, label=data)
        if result is not None:
            ts = np.arange(result["tensions"].shape[0]) * del_t
            ax.plot(ts, tip_x(result["reference"]), "k-", label="Reference")
        ax.legend(loc="upper right", ncol=3, fontsize=7)
        ax.set_xlabel("Time (s)")
        ax.set_ylabel("Tip Position X (m)")
    fig.tight_layout(pad=0.5)
    if save:
        os.makedirs(os.path.dirname(save) or ".", exist_ok=True)
        fig.savefig(save, dpi=120)
    return fig
