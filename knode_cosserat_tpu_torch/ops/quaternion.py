"""Quaternion operations, broadcast-native (state on the last axis).

PyTorch counterpart of ``knode_cosserat_tpu/ops/quaternion.py`` for the
operations the rod physics and the training loss use:
  - quat -> rotation matrix (cosserat_ode.py:132-137, non-normalized form
    R = I + 2/(h.h) * [[...]]),
  - quaternion spatial derivative hs = 0.5 * Omega(u) h
    (cosserat_ode.py:160-165),
  - the training loss's quaternion -> Euler angles
    (Utils/transformations.py:3-31),
  - pairwise angular velocity between quaternions (estimate_state.py:95-103).
"""
from __future__ import annotations

import torch

__all__ = ["quat_to_rotmat", "quat_spatial_derivative",
           "quaternion_to_euler", "pairwise_angular_velocity"]


def quat_to_rotmat(h: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) [w,x,y,z] -> rotation matrix (..., 3, 3), with
    the reference's non-unit-safe formula R = I + 2/(h.h) * M(h)."""
    h1, h2, h3, h4 = h.unbind(-1)
    s = 2.0 / (h * h).sum(-1)
    row0 = torch.stack([1.0 + s * (-h3 ** 2 - h4 ** 2),
                        s * (h2 * h3 - h4 * h1),
                        s * (h2 * h4 + h3 * h1)], dim=-1)
    row1 = torch.stack([s * (h2 * h3 + h4 * h1),
                        1.0 + s * (-h2 ** 2 - h4 ** 2),
                        s * (h3 * h4 - h2 * h1)], dim=-1)
    row2 = torch.stack([s * (h2 * h4 - h3 * h1),
                        s * (h3 * h4 + h2 * h1),
                        1.0 + s * (-h2 ** 2 - h3 ** 2)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def quat_spatial_derivative(u: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """hs = 0.5 * Omega(u) @ h. u: (..., 3), h: (..., 4) -> (..., 4)."""
    u1, u2, u3 = u.unbind(-1)
    h1, h2, h3, h4 = h.unbind(-1)
    return 0.5 * torch.stack([
        -u1 * h2 - u2 * h3 - u3 * h4,
        u1 * h1 + u3 * h3 - u2 * h4,
        u2 * h1 - u3 * h2 + u1 * h4,
        u3 * h1 + u2 * h2 - u1 * h3,
    ], dim=-1)


def quaternion_to_euler(h: torch.Tensor) -> torch.Tensor:
    """The training-loss Euler transform (Utils/transformations.py:3-31).

    Input (..., 4) [w,x,y,z]; output (..., 3). This is the reference's own
    (nonstandard) convention, kept so that losses match:
    roll = atan2(2(wy+xz), 1-2(y^2+z^2)), pitch = asin(clip(2(wz-xy))),
    yaw = atan2(2(wx+yz), 1-2(x^2+z^2))."""
    hn = h / torch.linalg.vector_norm(h, dim=-1, keepdim=True)
    w, x, y, z = hn.unbind(-1)
    roll = torch.atan2(2 * (w * y + x * z), 1 - 2 * (y ** 2 + z ** 2))
    pitch = torch.asin(torch.clamp(2 * (w * z - x * y), -1.0, 1.0))
    yaw = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x ** 2 + z ** 2))
    return torch.stack([roll, pitch, yaw], dim=-1)


def pairwise_angular_velocity(q1: torch.Tensor, q2: torch.Tensor,
                              dt) -> torch.Tensor:
    """Angular velocity between quaternion pairs (estimate_state.py:95-103).
    q1, q2: (..., 4) [w,x,y,z] -> (..., 3)."""
    a0, a1, a2, a3 = q1.unbind(-1)
    b0, b1, b2, b3 = q2.unbind(-1)
    return (2.0 / dt) * torch.stack([
        a0 * b1 - a1 * b0 - a2 * b3 + a3 * b2,
        a0 * b2 + a1 * b3 - a2 * b0 - a3 * b1,
        a0 * b3 - a1 * b2 + a2 * b1 - a3 * b0,
    ], dim=-1)
