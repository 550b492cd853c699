"""Mocap playback: animated 3D view of preprocessed marker poses with
orientation triads — parity rebuild of reference
knode_cosserat_realworld/plot_bag.py:43-94.

PyTorch-port copy of ``knode_cosserat_tpu/viz/mocap.py``: the triads'
rotations go through the port's ``ops.quaternion.quat_to_rotmat`` on the
host; matplotlib is imported at use."""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

__all__ = ["MocapPlayback"]


def _mpl():
    import matplotlib
    if not os.environ.get("DISPLAY"):
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


class MocapPlayback:
    """positions: (T, n_links, 3); quats: (T, n_links, 4) scalar-first or
    scipy Rotations per link; triad_len: axis-arrow length in meters."""

    def __init__(self, positions: np.ndarray, quats=None,
                 triad_len: float = 0.05):
        self.positions = np.asarray(positions)
        self.quats = None
        if quats is not None:
            self.quats = np.asarray(quats)
        self.triad_len = triad_len

    def _frame(self, ax, t: int):
        import torch

        from ..ops.quaternion import quat_to_rotmat
        ax.cla()
        p = self.positions[t]
        ax.plot(p[:, 0], p[:, 1], p[:, 2], "o-", color="b")
        if self.quats is not None:
            R = quat_to_rotmat(torch.from_numpy(
                np.asarray(self.quats[t], np.float64))).numpy()
            for i in range(p.shape[0]):
                for axis, color in enumerate("rgb"):
                    d = R[i][:, axis] * self.triad_len
                    ax.plot([p[i, 0], p[i, 0] + d[0]],
                            [p[i, 1], p[i, 1] + d[1]],
                            [p[i, 2], p[i, 2] + d[2]], color=color)
        lim = self.positions.reshape(-1, 3)
        for dim, setter in enumerate([ax.set_xlim, ax.set_ylim, ax.set_zlim]):
            setter([lim[:, dim].min() - 0.1, lim[:, dim].max() + 0.1])
        ax.set_title(f"frame {t}")

    def save_as_gif(self, filename: str, fps: int = 10,
                    max_frames: Optional[int] = None) -> str:
        plt = _mpl()
        from matplotlib.animation import FuncAnimation, PillowWriter
        os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
        fig = plt.figure()
        ax = fig.add_subplot(111, projection="3d")
        frames = len(self.positions) if max_frames is None \
            else min(max_frames, len(self.positions))
        ani = FuncAnimation(fig, lambda n: self._frame(ax, n), frames=frames,
                            repeat=False)
        ani.save(filename, writer=PillowWriter(fps=fps))
        plt.close(fig)
        return filename

    def show(self):
        plt = _mpl()
        from matplotlib.animation import FuncAnimation
        fig = plt.figure()
        ax = fig.add_subplot(111, projection="3d")
        FuncAnimation(fig, lambda n: self._frame(ax, n),
                      frames=len(self.positions), repeat=False)
        plt.show()
