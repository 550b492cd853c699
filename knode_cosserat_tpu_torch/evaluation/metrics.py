"""Evaluation metrics: DTW tip-trajectory distance and pose MSE.

A copy of ``knode_cosserat_tpu/evaluation/metrics.py``, which uses only
numpy and scipy (importing it from there would run the JAX package's
``__init__``).

The reference computes fastdtw(pred_tip_xyz, ref_tip_xyz) on traj[:, :3, 9]
(physics_train.py:156-161, physics_multitrain.py:213) and a pose MSE of
squared position error + squared zyx-Euler error x1000
(physics_multitrain.py:215-222). fastdtw isn't in this environment, so we
implement both the published FastDTW approximation (radius=1, identical
algorithm) and exact DTW.

Point-distance parity: the reference calls fastdtw(x, y) with dist=None on
2-D (T, 3) tip arrays, and the fastdtw package's dist=None default on
multi-dimensional points is the MANHATTAN (1-norm) distance — not
euclidean. We default to ord=1 to match the reference's numbers; pass
``dist_ord=2`` for euclidean.
Host-side numpy: metrics are tiny (T ~ 100) and off the hot path.
"""
from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation

__all__ = ["dtw", "fastdtw", "tip_dtw", "pose_mse", "pct_error", "traj_mse"]


def _as2d(x):
    x = np.asarray(x, np.float64)
    return x[:, None] if x.ndim == 1 else x


def _dtw_windowed(x, y, window, dist_ord=1):
    """DP over an explicit cell window; returns (distance, path)."""
    D = {(0, 0): (0.0, (0, 0))}
    for i, j in window:
        dist = float(np.linalg.norm(x[i - 1] - y[j - 1], ord=dist_ord))
        best = None
        for prev in ((i - 1, j), (i, j - 1), (i - 1, j - 1)):
            if prev in D and (best is None or D[prev][0] < best[0]):
                best = (D[prev][0], prev)
        if best is None:
            continue
        D[(i, j)] = (best[0] + dist, best[1])
    n, m = len(x), len(y)
    path = []
    node = (n, m)
    while node != (0, 0):
        path.append((node[0] - 1, node[1] - 1))
        node = D[node][1]
    path.reverse()
    return D[(n, m)][0], path


def dtw(x, y, dist_ord=1):
    """Exact DTW. Point distance defaults to the 1-norm (fastdtw-package
    parity, see module docstring). Returns (distance, path)."""
    x, y = _as2d(x), _as2d(y)
    n, m = len(x), len(y)
    window = [(i, j) for i in range(1, n + 1) for j in range(1, m + 1)]
    return _dtw_windowed(x, y, window, dist_ord)


def _reduce_by_half(x):
    even = x[: (len(x) // 2) * 2]
    return (even[0::2] + even[1::2]) / 2.0


def _expand_window(path, len_x, len_y, radius):
    path_set = set(path)
    for i, j in path:
        for a in range(-radius, radius + 1):
            for b in range(-radius, radius + 1):
                path_set.add((i + a, j + b))
    window_set = set()
    for i, j in path_set:
        for a, b in ((i * 2, j * 2), (i * 2, j * 2 + 1),
                     (i * 2 + 1, j * 2), (i * 2 + 1, j * 2 + 1)):
            window_set.add((a, b))
    window = []
    start_j = 0
    for i in range(len_x):
        new_start_j = None
        for j in range(start_j, len_y):
            if (i, j) in window_set:
                window.append((i + 1, j + 1))
                if new_start_j is None:
                    new_start_j = j
            elif new_start_j is not None:
                break
        start_j = new_start_j if new_start_j is not None else start_j
    return window


def fastdtw(x, y, radius: int = 1, dist_ord=1):
    """The published FastDTW approximation (Salvador & Chan 2007) — the same
    algorithm AND the same default point distance (1-norm) as the fastdtw
    package the reference calls, default radius=1.
    Returns (distance, path)."""
    x, y = _as2d(x), _as2d(y)
    min_ts = radius + 2
    if len(x) < min_ts or len(y) < min_ts:
        return dtw(x, y, dist_ord)
    shrunk = fastdtw(_reduce_by_half(x), _reduce_by_half(y), radius, dist_ord)
    window = _expand_window(shrunk[1], len(x), len(y), radius)
    return _dtw_windowed(x, y, window, dist_ord)


def tip_dtw(pred_traj, ref_traj, node: int = -1, exact: bool = False):
    """DTW of tip xyz trajectories. Accepts (T, N, >=3) state-last or the
    reference (T, >=3, N) layout (auto-detected by axis size)."""
    def tip(t):
        t = np.asarray(t)
        if t.shape[-1] >= 19:        # (T, N, state)
            return t[:, node, :3]
        return t[:, :3, node]        # (T, state, N)
    d, _ = (dtw if exact else fastdtw)(tip(pred_traj), tip(ref_traj))
    return d


def pose_mse(pred_traj, ref_traj):
    """Pose MSE x1000 (physics_multitrain.py:215-222): mean of squared
    position errors over all nodes/timesteps concatenated with squared
    zyx-Euler orientation errors. Inputs in either layout (see tip_dtw)."""
    def split(t):
        t = np.asarray(t)
        if t.shape[-1] >= 19:
            pos = t[..., :3].reshape(-1, 3)
            quat = t[..., 3:7].reshape(-1, 4)
        else:
            pos = np.moveaxis(t[:, :3], 1, 2).reshape(-1, 3)
            quat = np.moveaxis(t[:, 3:7], 1, 2).reshape(-1, 4)
        # scipy Rotation requires writable buffers; jax-backed views are not
        return np.array(pos), np.array(quat)

    ppos, pquat = split(pred_traj)
    rpos, rquat = split(ref_traj)
    se_pos = (ppos - rpos) ** 2

    def euler(quat):
        # A diverged rollout can carry zero/NaN quaternions; scipy raises
        # on those where the reference's pure-numpy euler conversion would
        # propagate NaN (Utils/transformations.py). Degrade the same way:
        # NaN euler rows -> NaN MSE, not a crash.
        norm = np.linalg.norm(quat, axis=-1)
        bad = ~np.isfinite(norm) | (norm < 1e-12)
        safe = np.where(bad[:, None], [1.0, 0.0, 0.0, 0.0], quat)
        e = Rotation.from_quat(safe, scalar_first=True).as_euler("zyx")
        e[bad] = np.nan
        return e

    se_euler = (euler(pquat) - euler(rquat)) ** 2
    return float(np.mean(np.concatenate([se_euler.ravel(), se_pos.ravel()])) * 1000)


def pct_error(new, old):
    """Percent change vs a baseline (physics_multitrain.py:163-166)."""
    if old == 0:
        return 0.0 if new == 0 else float("inf")
    return (new - old) / old * 100


def traj_mse(a, b):
    """Plain trajectory MSE (Utils/visualizer.py:168-179)."""
    return float(np.mean((np.asarray(a) - np.asarray(b)) ** 2))
