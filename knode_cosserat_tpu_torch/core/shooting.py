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

``implicit_root`` is the JAX package's ``lax.custom_root`` as a
``torch.autograd.Function``: the root's gradients come from the
implicit function theorem at the solved root, never from the Newton
iterations, so any solver (``newton_solve``, the coupled assembly's,
kernels K2 and K7) may supply the root.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..ops.linalg import solve_small, solve_spd_small

__all__ = ["newton_solve", "implicit_root", "block_jacobian",
           "NewtonStats"]


class NewtonStats(NamedTuple):
    """Per-rod solver statistics, each of shape (B,)."""
    iterations: torch.Tensor
    residual_norm: torch.Tensor
    converged: torch.Tensor
    lm_retries: torch.Tensor


def block_jacobian(fn: Callable[[torch.Tensor], torch.Tensor],
                   X: torch.Tensor) -> torch.Tensor:
    """J[..., i, k] = d fn(X)[..., i] / d X[..., k] for fn: (..., n) ->
    (..., n) whose rows at each leading index depend on X at that index
    alone (independent rods), and which broadcasts over a new leading axis:
    X is replicated n times along it, copy i keeps component i, and ONE
    reverse pass gives row i in copy i's gradient. Detached."""
    n = X.shape[-1]
    with torch.enable_grad():
        Xr = X.detach().expand((n,) + X.shape).clone().requires_grad_(True)
        r = fn(Xr)                                  # copy i -> component i
        (g,) = torch.autograd.grad(
            torch.diagonal(r, dim1=0, dim2=-1).sum(), Xr)
    return g.movedim(0, -2)


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
        J = block_jacobian(residual_fn, G)
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


class _ImplicitRoot(torch.autograd.Function):
    """Identity on the solved root X* (and on the auxiliary outputs at it);
    the backward pass applies the implicit function theorem.

    Inputs: X*, ``neg_r`` = -r(X*) with the explicit ``args`` detached (it
    carries the residual's closure; None with auxiliary outputs), the
    residual function, the auxiliary outputs' values at X* (a tuple, maybe
    empty), and ``args``. ``fn(X, *args)`` returns r, or (r, aux) with aux
    a tuple of tensors that depend on X and args (e.g. the swept rod).

    For cotangents g of X and g_aux of aux: one evaluation of fn over n + 1
    copies of X (n = X's last axis) and one reverse pass give J = dr/dX
    (copy i keeps component i) and g_aux^T d aux/dX (copy n); then
    lambda = J^-T (g + g_aux^T d aux/dX), ``neg_r`` gets lambda (autograd
    takes it on to the closure's tensors) and a second reverse pass over
    the same evaluation gives each arg g_aux^T d aux/d(arg) -
    lambda^T dr/d(arg).

    Under ``create_graph`` the backward is itself differentiable: it is
    taken at the saved OUTPUT, which stays attached to this node, so
    derivatives of every order with respect to ``args`` are exact (those
    with respect to closure tensors are first-order exact only)."""

    @staticmethod
    def forward(ctx, X_star, neg_r, fn, aux_values, *args):
        ctx.set_materialize_grads(False)
        X = X_star.clone()
        ctx.fn, ctx.n_aux = fn, len(aux_values)
        ctx.save_for_backward(X, *args)
        if not aux_values:
            return X
        return (X,) + tuple(a.clone() for a in aux_values)

    @staticmethod
    def backward(ctx, g, *g_aux):
        X, *args = ctx.saved_tensors
        create = torch.is_grad_enabled()          # under create_graph only
        n = X.shape[-1]
        need = [i for i in range(len(args)) if ctx.needs_input_grad[4 + i]]
        k = n + int(bool(need) or ctx.n_aux > 0)  # copy n: X itself
        with torch.enable_grad():
            Xr = X.expand((k,) + X.shape)
            Xr = (Xr.clone() if create and X.requires_grad
                  else Xr.detach().clone().requires_grad_(True))
            # fresh nodes: the gradients are the partial ones
            xs = [(a.clone() if i in need else a) if create
                  else a.detach().requires_grad_(i in need)
                  for i, a in enumerate(args)]
            out = ctx.fn(Xr, *xs)
            r, aux = (out[0], out[1]) if ctx.n_aux else (out, ())
            used = [(a[n], ga) for a, ga in zip(aux, g_aux) if ga is not None]
            diag = torch.diagonal(r[:n], dim1=0, dim2=-1).sum()
            (gXr,) = torch.autograd.grad(
                [diag] + [a for a, _ in used],
                Xr, [torch.ones_like(diag)] + [ga for _, ga in used],
                retain_graph=bool(need), create_graph=create)
        J = gXr[:n].movedim(0, -2)
        gX = torch.zeros_like(X) if g is None else g
        if used:
            gX = gX + gXr[n]
        # solve_ex: no host synchronisation for its check, and a singular
        # system (a diverged rod of a batch) gives non-finite values in its
        # own rows instead of an error for every rod
        lam = torch.linalg.solve_ex(J.transpose(-1, -2),
                                    gX.unsqueeze(-1))[0].squeeze(-1)
        grads = [None] * len(args)
        if need:
            with torch.enable_grad():
                got = torch.autograd.grad(
                    [r[n]] + [a for a, _ in used], [xs[i] for i in need],
                    [-lam] + [ga for _, ga in used], create_graph=create,
                    allow_unused=True)
            for i, t in zip(need, got):
                grads[i] = t
        return (None, lam if ctx.needs_input_grad[1] else None, None, None,
                *grads)


def implicit_root(residual_fn: Callable, G0: torch.Tensor,
                  tol: float = 1e-12, max_iter: int = 50, args=(),
                  root: torch.Tensor | None = None, aux: bool = False,
                  at_root=None):
    """Differentiable shooting solve (the JAX package's ``implicit_root``,
    ``lax.custom_root``): the value is the root of
    ``residual_fn(X, *args) = 0`` and its gradients flow through the
    implicit function theorem, dX = -J^-1 dr, not through the iterations.

    residual_fn: (..., n) -> (..., n), broadcasting over a new leading
      axis (:func:`block_jacobian`); tensors it closes over get exact first
      derivatives, the explicit ``args`` exact derivatives of every order
      (pass there whatever a Hessian must see, e.g. rod parameters).
    root: an already solved root (K2's, K7's, the coupled Newton's); by
      default :func:`newton_solve` from the warm start ``G0`` (B, 6).
    aux: residual_fn returns (r, aux), aux a tuple of tensors computed on
      the way to r (the swept rod); they are returned at the root,
      differentiable, and their backward shares the root's (one
      evaluation of residual_fn over n + 1 copies, two reverse passes).
      With aux every tensor that needs a gradient must be in ``args``.
    at_root: (r2, aux values) at ``root`` from the solver that found it
      (K2 records both), which spares their evaluation here.
    Returns (X, NewtonStats), or (X, aux, NewtonStats), with the JAX
    package's stats under the implicit path: iterations and lm_retries 0
    (unavailable), converged from the actual residual at X.
    """
    fixed = [a.detach() for a in args]
    fixed_fn = ((lambda x: residual_fn(x, *fixed)[0]) if aux
                else (lambda x: residual_fn(x, *fixed)))
    if root is None:
        with torch.no_grad():
            root, _ = newton_solve(fixed_fn, G0.detach(), tol=tol,
                                   max_iter=max_iter)
    X = root.detach()
    grad = torch.is_grad_enabled()
    if aux:
        if at_root is None:
            with torch.no_grad():
                r, values = residual_fn(X, *fixed)
            r2 = (r * r).sum(-1)
        else:
            r2, values = at_root
        values = tuple(values)
        if grad and any(a.requires_grad for a in args):
            X, *values = _ImplicitRoot.apply(X, None, residual_fn, values,
                                             *args)
    else:
        r = residual_fn(X, *fixed)        # carries the closure's graph
        if grad and (r.requires_grad or any(a.requires_grad for a in args)):
            X = _ImplicitRoot.apply(X, -r, residual_fn, (), *args)
        r2 = (r.detach() ** 2).sum(-1)
    zero = torch.zeros(r2.shape, dtype=torch.int32, device=r2.device)
    stats = NewtonStats(zero, r2.sqrt(), r2 <= tol, zero)
    return (X, tuple(values), stats) if aux else (X, stats)
