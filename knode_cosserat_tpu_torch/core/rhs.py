"""The semi-discretized Cosserat-rod right-hand side.

PyTorch counterpart of ``knode_cosserat_tpu/core/rhs.py`` (reference
cosserat_ode.py:114-186). All inputs carry the state on the LAST axis, so
the same code runs per node, per rod or over any leading batch axes.

The 3-wide physics contractions are written as elementwise products and
sums, never as matmuls: O(1e5) stiffness entries meet O(1) states there,
and a float32 matmul could run in TF32 (the JAX package pins these
contractions to ``Precision.HIGHEST`` for the same reason).

State layout: y (..., 19) = [p, h, n, m, q, w]; z (..., 6) = [v, u].
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..ops.quaternion import quat_spatial_derivative, quat_to_rotmat
from .params import RodParams

__all__ = ["rhs", "nn_input_features"]


def _mv(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(3,3) or (..., 3, 3) matrices times (..., 3) vectors."""
    return (M * x.unsqueeze(-2)).sum(-1)


def _mv_t(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """M^T @ x with M (..., 3, 3), x (..., 3)."""
    return (M * x.unsqueeze(-1)).sum(-2)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a1, a2, a3 = a.unbind(-1)
    b1, b2, b3 = b.unbind(-1)
    return torch.stack([a2 * b3 - a3 * b2, a3 * b1 - a1 * b3,
                        a1 * b2 - a2 * b1], dim=-1)


def nn_input_features(y, yh, z, zh, tendon_forces, history: bool):
    """Assemble the KNODE MLP input (cosserat_ode.py:171-175):
    28 = [y(19), z(6), tf(3)] or 53 = [y, yh, z, zh, tf] with history."""
    tf = tendon_forces.expand(y.shape[:-1] + (3,))
    if history:
        return torch.cat([y, yh.expand_as(y), z, zh.expand_as(z), tf], dim=-1)
    return torch.cat([y, z, tf], dim=-1)


def rhs(
    p: RodParams,
    y: torch.Tensor,
    yh: torch.Tensor,
    zh: torch.Tensor,
    tendon_forces: torch.Tensor,
    nn_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    nn_history: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Evaluate the spatial RHS ``ys = dy/ds`` and the strain state ``z``.

    Steps (cosserat_ode.py:114-186): quat->R; constitutive solve for
    (v, u) through the pre-inverted stiffness plus ``v_rest``; BDF-2 time
    derivatives yt = c0*y + yh; body force (gravity + square-law drag +
    tendons); rod derivatives; quaternion derivative; optional MLP residual
    added to both ys and z.

    Args:
      y/yh: (..., 19); zh: (..., 6); tendon_forces: (3,) or (..., 3).
      nn_fn: optional callable mapping (..., 28|53) -> (..., 25).
    Returns:
      (ys, z): (..., 19), (..., 6).
    """
    h = y[..., 3:7]
    n = y[..., 7:10]
    m = y[..., 10:13]
    q = y[..., 13:16]
    w = y[..., 16:19]
    vh = zh[..., 0:3]
    uh = zh[..., 3:6]

    R = quat_to_rotmat(h)

    v = _mv(p.Kse_c0Bse_inv, _mv_t(R, n) - _mv(p.Bse, vh)) + p.v_rest
    u = _mv(p.Kbt_c0Bbt_inv, _mv_t(R, m) - _mv(p.Bbt, uh))
    z = torch.cat([v, u], dim=-1)

    # BDF-2 time derivatives (cosserat_ode.py:145-148)
    vt = p.c0 * v + vh
    ut = p.c0 * u + uh
    qt = p.c0 * q + yh[..., 13:16]
    wt = p.c0 * w + yh[..., 16:19]

    # weight + square-law drag + tendon body force (cosserat_ode.py:150-151)
    f = p.rhoAg - _mv(R, p.C * q * q.abs()) + tendon_forces

    # rod state derivatives (cosserat_ode.py:153-158)
    ps = _mv(R, v)
    ns = p.rhoA * _mv(R, _cross(w, q) + qt) - f
    ms = (_mv(R, _cross(w, _mv(p.rhoJ, w)) + _mv(p.rhoJ, wt))
          - _cross(ps, n))
    qs = vt - _cross(u, q) + _cross(w, v)
    ws = ut - _cross(u, w)
    hs = quat_spatial_derivative(u, h)

    ys = torch.cat([ps, hs, ns, ms, qs, ws], dim=-1)

    if nn_fn is not None:
        out = nn_fn(nn_input_features(y, yh, z, zh, tendon_forces,
                                      nn_history))
        ys = ys + out[..., :19]
        z = z + out[..., 19:]
    return ys, z
