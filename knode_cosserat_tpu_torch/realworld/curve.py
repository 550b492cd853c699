"""Spatial curve refitting: sparse marker poses -> dense rod grid.

Deduplicated rewrite of the reference's two near-identical copies
(interpolate_curve.py:5-97 and preprocess.py:111-203): natural cubic spline
for positions, SLERP for quaternions, optional 5th-order polynomial tangent
estimation (computed by the reference but unused by callers — exposed here
as a separate function). Host-side numpy/scipy: this is offline data prep.

Framework-free copy of ``knode_cosserat_tpu/realworld/curve.py``.
"""
from __future__ import annotations

import numpy as np
from scipy.interpolate import CubicSpline
from scipy.spatial.transform import Rotation, Slerp

__all__ = ["fit_curve", "compute_tangents", "interpolate_quaternions"]


def compute_tangents(positions: np.ndarray, new_grid: np.ndarray,
                     order: int = 5) -> np.ndarray:
    """Tangent vectors via polynomial fit (interpolate_curve.py:5-29).
    positions: (T, 3, n) -> (T, 3, len(new_grid))."""
    T, _, n = positions.shape
    s = np.linspace(0, 1, n)
    tangents = np.zeros((T, 3, new_grid.size))
    for t in range(T):
        for i in range(3):
            p = np.polyfit(s, positions[t, i, :], order)
            tangents[t, i, :] = np.polyval(np.polyder(p), new_grid)
    return tangents


def interpolate_quaternions(quats: np.ndarray, loc, new_grid: np.ndarray,
                            scalar_first_out: bool = True) -> np.ndarray:
    """SLERP quaternion interpolation (interpolate_curve.py:31-56).

    quats: (T, 4, n). NOTE the reference has an input/output convention skew
    we replicate: inputs are consumed as scipy [x,y,z,w]; outputs are emitted
    scalar-first [w,x,y,z] by the preprocess.py copy (as_quat(scalar_first=
    True), preprocess.py:156) but NOT by the interpolate_curve.py copy
    (:50). ``scalar_first_out`` selects; the estimate-state pipeline uses
    the interpolate_curve variant (scalar_first_out=False)."""
    T, _, n = quats.shape
    out = np.zeros((T, 4, new_grid.size))
    for t in range(T):
        rot = Rotation.from_quat(quats[t].T)
        slerp = Slerp(loc, rot)
        r = slerp(new_grid)
        if scalar_first_out:
            q = r.as_quat(scalar_first=True, canonical=True)
        else:
            q = r.as_quat()
        q = q / np.linalg.norm(q, axis=-1, keepdims=True)
        out[t] = q.T
    return out


def fit_curve(measured_poses: np.ndarray, measurement_loc, N: int,
              scalar_first_out: bool = False) -> np.ndarray:
    """Fit (T, 7, n) sparse poses onto an N-point grid -> (T, 7, N)
    (interpolate_curve.py:58-97). Positions: natural cubic splines;
    quaternions: SLERP."""
    measured_poses = np.asarray(measured_poses, np.float64)
    T, _, n = measured_poses.shape
    loc = np.asarray(measurement_loc, np.float64)
    new_grid = np.linspace(loc[0], loc[-1], N)

    out = np.zeros((T, 7, N))
    # vectorized spline fit: CubicSpline supports multiple columns
    pos = measured_poses[:, :3, :]                       # (T, 3, n)
    cs = CubicSpline(loc, pos.reshape(T * 3, n).T, bc_type="natural")
    out[:, :3, :] = cs(new_grid).T.reshape(T, 3, N)

    out[:, 3:, :] = interpolate_quaternions(
        measured_poses[:, 3:, :], loc, new_grid,
        scalar_first_out=scalar_first_out)
    return out
