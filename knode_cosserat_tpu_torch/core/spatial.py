"""Spatial (arc-length) integration of the rod, base -> tip.

PyTorch counterpart of ``knode_cosserat_tpu/core/spatial.py``
(getResidualEuler cosserat_ode.py:188-213, getResidualRK4 :215-255). The
node recurrence is a Python loop over N-1 nodes; every function takes any
number of leading batch axes (rods, Newton probes) in front of the node and
state axes, and broadcasts G's leading axes against the histories'. A stack
of rods (core/params.py) lines up with G's last batch axis: G (..., R, 6)
against histories (R, N, 19). Nothing
here updates a tensor in place, so autograd runs through it
(core/shooting.py builds its Jacobian that way).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .params import RodParams
from .rhs import rhs

__all__ = [
    "base_state",
    "integrate_euler",
    "integrate_rk4",
    "tip_residual",
    "residual_euler",
    "residual_rk4",
    "next_segment_euler",
]


def base_state(p: RodParams, G: torch.Tensor) -> torch.Tensor:
    """Base boundary node y[0] = [p0, h0, n0(G), m0(G), q0, w0]
    (cosserat_ode.py:194). G (..., 6) -> (..., 19)."""
    lead = G.shape[:-1]
    e = lambda a: a.expand(lead + a.shape[-1:])
    return torch.cat([e(p.p0), e(p.h0), G, e(p.q0), e(p.w0)], dim=-1)


def integrate_euler(
    p: RodParams,
    G: torch.Tensor,
    yh: torch.Tensor,
    zh: torch.Tensor,
    tendon_forces: torch.Tensor,
    nn_fn: Optional[Callable] = None,
    nn_history: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Explicit-Euler spatial sweep (cosserat_ode.py:197-201).

    Args:
      G: (..., 6) guessed base reaction [n0, m0].
      yh: (..., N, 19) BDF-2 history per node; zh: (..., N, 6);
      tendon_forces: (..., 3).
    Returns:
      y: (..., N, 19) integrated rod; z: (..., N-1, 6) strains at nodes
      0..N-2 (the reference never writes z at the tip node).
    """
    y = base_state(p, G)
    ys, zs = [y], []
    for j in range(p.N - 1):
        dy, zj = rhs(p, y, yh[..., j, :], zh[..., j, :], tendon_forces,
                     nn_fn, nn_history)
        y = y + p.ds * dy
        ys.append(y)
        zs.append(zj)
    return torch.stack(ys, dim=-2), torch.stack(zs, dim=-2)


def integrate_rk4(
    p: RodParams,
    G: torch.Tensor,
    yh: torch.Tensor,
    zh: torch.Tensor,
    yh_int: torch.Tensor,
    zh_int: torch.Tensor,
    tendon_forces: torch.Tensor,
    nn_fn: Optional[Callable] = None,
    nn_history: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """4th-order Runge-Kutta spatial sweep (cosserat_ode.py:222-242) with
    history midpoints yh_int/zh_int (..., N-1, ...) between consecutive
    nodes (linear interpolations in the rollout, knode.py:80-81)."""
    ds = p.ds
    y = base_state(p, G)
    ys, zs = [y], []
    for j in range(p.N - 1):
        yhj, yhj1, yhm = yh[..., j, :], yh[..., j + 1, :], yh_int[..., j, :]
        zhj, zhj1, zhm = zh[..., j, :], zh[..., j + 1, :], zh_int[..., j, :]
        k1, zj = rhs(p, y, yhj, zhj, tendon_forces, nn_fn, nn_history)
        k2, _ = rhs(p, y + k1 * (ds / 2), yhm, zhm, tendon_forces, nn_fn,
                    nn_history)
        k3, _ = rhs(p, y + k2 * (ds / 2), yhm, zhm, tendon_forces, nn_fn,
                    nn_history)
        k4, _ = rhs(p, y + k3 * ds, yhj1, zhj1, tendon_forces, nn_fn,
                    nn_history)
        y = y + ds * (k1 + 2 * (k2 + k3) + k4) / 6
        ys.append(y)
        zs.append(zj)
    return torch.stack(ys, dim=-2), torch.stack(zs, dim=-2)


def tip_residual(p: RodParams, y: torch.Tensor) -> torch.Tensor:
    """Cantilever tip boundary mismatch [F_tip - nL, M_tip - mL]
    (cosserat_ode.py:204-211). y (..., N, 19) -> (..., 6)."""
    return torch.cat([p.F_tip - y[..., -1, 7:10], p.M_tip - y[..., -1, 10:13]],
                     dim=-1)


def residual_euler(p, G, yh, zh, tendon_forces, nn_fn=None, nn_history=False):
    """Vector residual of the Euler sweep (cosserat_ode.py:188-213)."""
    y, _ = integrate_euler(p, G, yh, zh, tendon_forces, nn_fn, nn_history)
    return tip_residual(p, y)


def residual_rk4(p, G, yh, zh, yh_int, zh_int, tendon_forces,
                 nn_fn=None, nn_history=False):
    """Vector residual of the RK4 sweep (cosserat_ode.py:215-255)."""
    y, _ = integrate_rk4(p, G, yh, zh, yh_int, zh_int, tendon_forces,
                         nn_fn, nn_history)
    return tip_residual(p, y)


def next_segment_euler(
    p: RodParams,
    y_next_truth: torch.Tensor,
    yh: torch.Tensor,
    zh: torch.Tensor,
    tendon_forces: torch.Tensor,
    nn_fn: Optional[Callable] = None,
    nn_history: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced one-Euler-step per node: the training hot path
    (getNextSegmentEuler, cosserat_ode_torch.py:370-399).

    The rod state is the ground-truth NEXT step (the implicit BDF-2
    evaluation point), the history terms come from the current step, and
    the nodes are deliberately not chained (cosserat_ode_torch.py:391), so
    this is one broadcast RHS evaluation over every node and leading axis.

    Args:
      y_next_truth: (..., M, 19) truth next state at the evaluated nodes.
      yh/zh: (..., M, 19)/(..., M, 6) current-step history at those nodes.
      tendon_forces: (3,), or (..., 3) per leading index and shared across
        the node axis, or already aligned with ``y_next_truth``'s batch.
    Returns:
      y_grown (..., M, 19) = y + ds * ODE(y), and z_new (..., M, 6).
    """
    tf = tendon_forces
    if tf.dim() > 1 and tf.shape[:-1] == y_next_truth.shape[:-2]:
        # per-(batch) forces shared across the node axis -> insert it
        tf = tf.unsqueeze(-2)
    dy, z_new = rhs(p, y_next_truth, yh, zh, tf, nn_fn, nn_history)
    return y_next_truth + p.ds * dy, z_new
