"""The shared damped-Newton loop of the coupled solves.

PyTorch counterpart of three functions of
``knode_cosserat_tpu/core/multiple_shooting.py``: ``_newton_loop`` (the
backtracking line search and the Levenberg-Marquardt stall ladder),
``_lm_damped_solve`` and ``_newton_dense``. The assembly solver
(core/assembly.py) drives them. The multiple-shooting solvers of that
module (``ms_solve_step``, ``simulate_scan_ms``) are not ported yet
(ROADMAP.md, Queue 1, item 1).

Unlike the rod-batched ``core/shooting.newton_solve``, these drive ONE
system X (U,); the residual function broadcasts over leading axes, so the
line search's candidates take one residual call. The loop decides on the
host each iteration (one synchronisation per iteration on a CUDA device).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..ops.linalg import solve_small
from .shooting import NewtonStats

__all__ = ["jacobian", "_newton_loop", "_lm_damped_solve", "_newton_dense"]


def jacobian(fn: Callable[[torch.Tensor], torch.Tensor],
             x: torch.Tensor, m: int | None = None) -> torch.Tensor:
    """J[i, k] = d fn(x)_i / d x_k for fn: (..., n) -> (..., m) that
    broadcasts over leading axes, from ONE reverse pass: x is replicated m
    times along a new leading axis, copy i keeps component i of its output,
    and the gradient of their sum holds row i in copy i (the trick of
    core/shooting.py). ``m`` defaults to n (a square system). Returns
    (m, n), detached."""
    with torch.enable_grad():
        x0 = x.detach()
        m = x0.shape[-1] if m is None else m
        xr = x0.expand((m,) + x0.shape).clone().requires_grad_(True)
        r = fn(xr)
        (g,) = torch.autograd.grad(torch.diagonal(r).sum(), xr)
    return g


def _newton_loop(residual_fn, direction_fn, X0, tol, max_iter,
                 max_backtracks=6, lm_lambda0=1e-4, lm_growth=30.0,
                 max_escalations=4):
    """Damped Newton with a backtracking line search and an LM stall ladder.

    ``direction_fn(X, r, lam) -> dX`` gives the (LM-damped) Newton
    direction; the loop owns the rest: the candidates X + 0.5^k dX
    (k = 0..max_backtracks) in one residual call, the first improving
    one taken; a stall holds X and sets lam = max(lam * lm_growth,
    lm_lambda0), a success resets lam to 0; a non-finite dX falls back
    to -r; the loop runs while r2 > tol, it < max_iter and
    fails <= max_escalations. Returns (X, NewtonStats) with scalar stats.
    """
    dtype, device = X0.dtype, X0.device
    alphas = (0.5 ** torch.arange(max_backtracks + 1, dtype=torch.float64)
              ).to(device=device, dtype=dtype)
    X = X0
    r = residual_fn(X)
    r2 = (r * r).sum()
    it = lam = fails = retries = 0
    while bool(r2 > tol) and it < max_iter and fails <= max_escalations:
        dX = direction_fn(X, r, lam)
        if not bool(torch.isfinite(dX).all()):
            dX = -r
        X_cand = X + alphas[:, None] * dX
        r_cand = residual_fn(X_cand)
        r2_cand = (r_cand * r_cand).sum(-1)
        improves = r2_cand < r2
        if bool(improves.any()):
            k = int(improves.int().argmax())    # the first (largest) alpha
            X, r, r2 = X_cand[k], r_cand[k], r2_cand[k]
            lam, fails = 0.0, 0
        else:
            lam = max(lam * lm_growth, lm_lambda0)
            fails += 1
            retries += 1
        it += 1
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=device)
    return X, NewtonStats(i32(it), r2.sqrt(), r2 <= tol, i32(retries))


def _lm_damped_solve(J, r, lam, eye):
    """LM-damped LU solve of J dX = -r with Marquardt diagonal scaling
    D = max(|diag J|, 1). A singular system gives NaN (ops/linalg.py),
    which the loop's non-finite fallback catches."""
    D = torch.diagonal(J).abs().clamp_min(1.0)
    return solve_small(J + lam * D * eye, -r)


def _newton_dense(residual_fn, X0, tol, max_iter, **kw):
    """The shared loop with the exact dense Jacobian of ``residual_fn``
    (one replicated reverse pass, :func:`jacobian`) and an LU solve."""
    eye = torch.eye(X0.shape[-1], dtype=X0.dtype, device=X0.device)

    def direction(X, r, lam):
        return _lm_damped_solve(jacobian(residual_fn, X), r, lam, eye)

    return _newton_loop(residual_fn, direction, X0, tol, max_iter, **kw)
