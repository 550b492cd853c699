"""Shooting-method boundary solve for the base reaction G = [n0, m0].

PyTorch counterpart of ``knode_cosserat_tpu/core/shooting.py``'s
``newton_solve``, batched over rods: each rod runs the same damped Newton
with a backtracking line search and Levenberg-Marquardt stall escalation as
the JAX solver, under its own active mask, so a rod that has converged (or
stalled out) holds its state while the others iterate.

The 6x6 Jacobian is exact, from one reverse-mode AD pass: G is replicated
along a leading axis of 6, copy i's residual keeps only its component i,
and one backward of their sum gives row i of every rod's Jacobian in copy
i's gradient (the rods, and the copies, are independent). The JAX solver
uses forward mode (``jax.jacfwd``); PyTorch's forward mode on the CPU takes
a slow decomposed path for every op that mixes a dual tensor with a
constant (measured 0.2-0.4 ms per op), several times the cost of this
pass. The residual function broadcasts over leading axes in front of the
rod axis, so the Jacobian and all step sizes of the line search each take
one residual call.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..ops.linalg import solve_small, solve_spd_small

__all__ = ["newton_solve", "NewtonStats"]


class NewtonStats(NamedTuple):
    """Per-rod solver statistics, each of shape (B,)."""
    iterations: torch.Tensor
    residual_norm: torch.Tensor
    converged: torch.Tensor
    lm_retries: torch.Tensor


def newton_solve(
    residual_fn: Callable[[torch.Tensor], torch.Tensor],
    G0: torch.Tensor,
    tol: float = 1e-12,
    max_iter: int = 50,
    max_backtracks: int = 6,
    damping: float = 0.0,
    lm_lambda0: float = 1e-4,
    lm_growth: float = 10.0,
    lm_decay: float = 0.0,
    max_escalations: int = 8,
):
    """Solve residual_fn(G) = 0 for a batch of rods by damped Newton with a
    backtracking line search and Levenberg-Marquardt stall escalation.

    When no step size improves a rod's residual, its iterate holds and the
    next iteration solves with (J + lambda*D), D = diag(max(|J_ii|, 1)),
    lambda escalating by ``lm_growth`` per consecutive failure; a success
    resets lambda to ``lm_decay * lambda``. After ``max_escalations``
    consecutive failures the rod is declared stalled. A non-finite Newton
    step is replaced by the damped least-squares step.

    Args:
      residual_fn: (..., B, 6) -> (..., B, 6), broadcasting over the
        leading axes; row b may depend on G[..., b, :] only.
      G0: (B, 6) warm-start guess.
      tol: a rod stops when sum(r^2) <= tol.
    Returns:
      (G (B, 6), NewtonStats).
    """
    dtype, device = G0.dtype, G0.device
    B, n = G0.shape
    eye = torch.eye(n, dtype=dtype, device=device)
    alphas = 0.5 ** torch.arange(max_backtracks + 1, dtype=dtype,
                                 device=device)

    def jacobian(G):
        with torch.enable_grad():
            Gr = G.detach().expand(n, B, n).clone().requires_grad_(True)
            r = residual_fn(Gr)                     # copy i -> component i
            (g,) = torch.autograd.grad(
                torch.diagonal(r, dim1=0, dim2=2).sum(), Gr)
        return g.transpose(0, 1)                    # J[b, i, k] = dr_i/dG_k

    G = G0
    r = residual_fn(G)
    r2 = (r * r).sum(-1)
    it = torch.zeros(B, dtype=torch.int32, device=device)
    lam = torch.zeros(B, dtype=dtype, device=device)
    fails = torch.zeros(B, dtype=torch.int32, device=device)
    retries = torch.zeros(B, dtype=torch.int32, device=device)

    while True:
        active = (r2 > tol) & (it < max_iter) & (fails <= max_escalations)
        if not bool(active.any()):
            break
        J = jacobian(G)
        if damping:
            J = J + damping * eye
        D = torch.diagonal(J, dim1=-2, dim2=-1).abs().clamp_min(1.0)
        J = J + torch.diag_embed(lam[:, None] * D)
        dG = solve_small(J, -r)
        bad = ~torch.isfinite(dG).all(-1, keepdim=True)
        if bool(bad.any()):
            dG = torch.where(bad, solve_spd_small(J, -r, damping=1e-8), dG)

        G_cand = G + alphas[:, None, None] * dG     # (A, B, 6)
        r_cand = residual_fn(G_cand)
        r2_cand = (r_cand * r_cand).sum(-1)
        improves = r2_cand < r2
        found = improves.any(0)
        pick = torch.where(found, improves.int().argmax(0), 0)  # first improver
        rows = torch.arange(B, device=device)
        step = active & found
        G = torch.where(step[:, None], G_cand[pick, rows], G)
        r = torch.where(step[:, None], r_cand[pick, rows], r)
        r2 = torch.where(step, r2_cand[pick, rows], r2)
        lam = torch.where(active, torch.where(
            found, lm_decay * lam, torch.clamp_min(lam * lm_growth, lm_lambda0)),
            lam)
        fails = torch.where(active, torch.where(found, 0, fails + 1), fails)
        retries = retries + (active & ~found).int()
        it = it + active.int()
    return G, NewtonStats(it, r2.sqrt(), r2 <= tol, retries)
