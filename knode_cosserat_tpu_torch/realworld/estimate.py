"""Full-state estimation: pose-only mocap -> all 25 rod states.

Vectorized rewrite of reference estimate_state.py:11-242. The reference
loops in Python over time and nodes with scipy.linalg.logm; here everything
is broadcast numpy (rotation logs via Rotation.as_rotvec, mathematically the
matrix log of a proper rotation), ~100x faster and identical to solver
precision. Offline host-side stage feeding the same training API.

Pipeline (estimate_state, reference :158-242):
  q  — linear velocities by np.gradient of positions        (:180-181)
  w  — angular velocities from quaternion finite differences (:95-122)
  v,u — strains from spatial derivatives of p and R          (:11-93)
  n,m — internal forces/moments back-integrated tip -> root
        from the dynamics (:125-156)
  v,u — re-solved through the constitutive law with BDF-2
        history for solver consistency                       (:228-236)
Quirks replicated: base x/y pinned to 0 (:176), base quaternion vector part
zeroed (:237), tip n/m left at 0 (:224-226), vstar reset to the initial
estimated base strain (:201) — returned so the caller can update the rod.

PyTorch-port copy of ``knode_cosserat_tpu/realworld/estimate.py``: the same
float64 host computation. The rotations go through the port's
``ops.quaternion.quat_to_rotmat`` on CPU float64 tensors (the reference's
non-normalising formula), and the rod's fields, which may live on the
card, are copied to the host as float64 numpy arrays.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from ..core.params import RodParams, _host   # a field on the host, f64
from ..ops.quaternion import quat_to_rotmat

__all__ = ["estimate_state", "compute_v_u", "angular_velocities",
           "internal_forces_moments"]


def _rotmats(quats: np.ndarray) -> np.ndarray:
    """(..., 4) scalar-first quats -> (..., 3, 3) with the reference's
    non-normalizing formula (cosserat_ode.py:132-137), in float64 on the
    host."""
    q = torch.from_numpy(np.asarray(quats, np.float64))
    return quat_to_rotmat(q).numpy()


def _rot_log(Rrel: np.ndarray) -> np.ndarray:
    """Matrix log of proper rotations, as skew matrices (N, 3, 3).
    Equals scipy.linalg.logm for orthogonal input (estimate_state.py:29-37)."""
    rv = Rotation.from_matrix(Rrel).as_rotvec()       # (N, 3)
    out = np.zeros(Rrel.shape)
    out[..., 0, 1], out[..., 0, 2] = -rv[..., 2], rv[..., 1]
    out[..., 1, 0], out[..., 1, 2] = rv[..., 2], -rv[..., 0]
    out[..., 2, 0], out[..., 2, 1] = -rv[..., 1], rv[..., 0]
    return out


def compute_v_u(positions: np.ndarray, quaternions: np.ndarray,
                arc_lengths: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Strains from spatial derivatives at one time step
    (estimate_state.py:47-93). positions (3, N), quaternions (4, N)."""
    N = len(arc_lengths)
    ds = np.diff(arc_lengths)
    p_s = np.zeros_like(positions)
    p_s[:, :-1] = (positions[:, 1:] - positions[:, :-1]) / ds
    p_s[:, -1] = p_s[:, -2]

    R = _rotmats(quaternions.T)                    # (N, 3, 3)
    Rrel = np.einsum("nij,nkj->nik", R[1:], R[:-1])  # R_next @ R_cur^T
    logs = _rot_log(Rrel) / ds[:, None, None]
    R_s = np.einsum("nij,njk->nik", R[:-1], logs)  # (N-1, 3, 3)
    R_s = np.concatenate([R_s, R_s[-1:]], axis=0)  # last = second-to-last

    v = np.einsum("nji,jn->in", R, p_s)
    u_hat = np.einsum("nji,njk->nik", R, R_s)
    u = np.stack([u_hat[:, 2, 1], u_hat[:, 0, 2], u_hat[:, 1, 0]], axis=0)

    v[0:2, 0] = 0.0
    v[2, 0] = 1.0
    return v, u


def angular_velocities(quats: np.ndarray, del_t: float) -> np.ndarray:
    """(T, 4, N) scalar-first quats -> (T, 3, N) body angular velocities
    (estimate_state.py:95-122); w[0] copied from w[1]."""
    q1 = quats[:-1]
    q2 = quats[1:]
    a0, a1, a2, a3 = q1[:, 0], q1[:, 1], q1[:, 2], q1[:, 3]
    b0, b1, b2, b3 = q2[:, 0], q2[:, 1], q2[:, 2], q2[:, 3]
    w = (2.0 / del_t) * np.stack([
        a0 * b1 - a1 * b0 - a2 * b3 + a3 * b2,
        a0 * b2 + a1 * b3 - a2 * b0 - a3 * b1,
        a0 * b3 - a1 * b2 + a2 * b1 - a3 * b0], axis=1)
    return np.concatenate([w[:1], w], axis=0)


def internal_forces_moments(p, arc_lengths, Rs, q, w, qt, wt, tensions,
                            rod: RodParams) -> Tuple[np.ndarray, np.ndarray]:
    """Back-integrate n, m tip -> root from the dynamics at one time step
    (estimate_state.py:125-156). Rs: (3, 3, N) reference layout.

    Replicates the reference's integration exactly, including its use of
    step L/N (not ds = L/(N-1)) and the frozen-at-zero tip values."""
    N = rod.N
    tendon_forces = np.asarray(tensions, np.float64) @ _host(rod.tendon_dirs)
    rhoAg = _host(rod.rhoAg)
    C = _host(rod.C)
    rhoA = float(_host(rod.rhoA))
    rhoJ = _host(rod.rhoJ)
    L = float(_host(rod.L))

    ds = np.diff(arc_lengths)
    p_s = np.zeros((3, N))
    p_s[:, :-1] = (p[:, 1:] - p[:, :-1]) / ds
    p_s[:, -1] = p_s[:, -2]

    n = np.zeros((3, N))
    m = np.zeros((3, N))
    step = L / N
    for i in range(N - 1):          # i indexes from the tip inward
        j = N - i - 1
        f = rhoAg - Rs[:, :, j] @ (C * q[:, j] * np.abs(q[:, j])) + tendon_forces
        ns = rhoA * Rs[:, :, j] @ (np.cross(w[:, j], q[:, j]) + qt[:, j]) - f
        n[:, j - 1] = n[:, j] - ns * step
    for i in range(N - 1):
        j = N - i - 1
        ms = Rs[:, :, j] @ (np.cross(w[:, j], rhoJ @ w[:, j]) + rhoJ @ wt[:, j]) \
            - np.cross(p_s[:, j], n[:, j])
        m[:, j - 1] = m[:, j] - ms * step
    return n, m


def estimate_state(data: np.ndarray, tensions: np.ndarray, rod: RodParams
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(T, 7, N) poses + (T, 4) tensions -> (T, 25, N) full states
    (reference layout, matching estimate_state.py:158-242).

    Returns (estimated_state, vstar): the reference mutates robot.vstar to
    the initial base strain (:201); we return it for the caller to fold into
    RodParams (params are immutable pytrees here).
    """
    data = np.asarray(data, np.float64)
    T, _, n = data.shape
    N = rod.N
    arc_lengths = np.linspace(0, float(_host(rod.L)), N)
    del_t = float(_host(rod.del_t))

    est = np.zeros((T, 25, N))
    est[:, 21, :] = 1.0
    est[:, :3, :] = data[:, :3, :]
    est[:, :2, 0] = 0.0
    est[:, 3:7, :] = data[:, 3:7, :]

    velocities = np.gradient(est[:, :3, :], del_t, axis=0, edge_order=1)
    est[:, 13:16, :] = velocities
    w = angular_velocities(est[:, 3:7, :], del_t)
    est[:, 16:19, :] = w
    qt = np.gradient(velocities, del_t, axis=0, edge_order=2)
    wt = np.gradient(w, del_t, axis=0, edge_order=2)

    Kse_inv = _host(rod.Kse_c0Bse_inv)
    Kbt_inv = _host(rod.Kbt_c0Bbt_inv)
    Bse = _host(rod.Bse)
    Bbt = _host(rod.Bbt)
    Kse_vstar = _host(rod.Kse_vstar)
    c1, c2 = float(_host(rod.c1)), float(_host(rod.c2))

    vstar = None
    v_prev = u_prev = None
    for t in range(T):
        positions = est[t, :3, :]
        quaternions = est[t, 3:7, :]
        v, u = compute_v_u(positions, quaternions, arc_lengths)
        if t == 0:
            v_prev, u_prev = v, u
        est[t, 19:22, 0] = v[:, 0]

        Rs = np.moveaxis(_rotmats(quaternions.T), 0, -1)   # (3, 3, N)
        nF, mM = internal_forces_moments(
            positions, arc_lengths, Rs, velocities[t], w[t], qt[t], wt[t],
            tensions[t], rod)
        est[t, 7:10, :-1] = nF[:, :-1]
        est[t, 10:13, :-1] = mM[:, :-1]

        # constitutive re-solve with BDF-2 history (reference :228-236);
        # note the reference uses the ORIGINAL rod.Kse_vstar here (vstar was
        # only stored, intermediate terms not recomputed)
        vh = c1 * v + c2 * v_prev
        uh = c1 * u + c2 * u_prev
        RsT = np.moveaxis(Rs, -1, 0).transpose(0, 2, 1)     # (N, 3, 3) R^T
        v = (Kse_inv @ (np.einsum("nij,jn->in", RsT, est[t, 7:10, :])
                        + Kse_vstar[:, None] - Bse @ vh))
        u = (Kbt_inv @ (np.einsum("nij,jn->in", RsT, est[t, 10:13, :])
                        - Bbt @ uh))
        est[t, 19:22, :] = v
        est[t, 22:, :] = u
        est[t, 4:7, 0] = 0.0
        v_prev, u_prev = v, u

    # Reference aliasing quirk (estimate_state.py:200-201,235): robot.vstar
    # is bound to a VIEW of estimated_state[0, 19:22, 0], which the t=0
    # constitutive re-solve then overwrites — so the effective vstar is the
    # RE-SOLVED initial base strain, not the geometric one. Replicated.
    vstar = est[0, 19:22, 0].copy()
    return est, vstar
