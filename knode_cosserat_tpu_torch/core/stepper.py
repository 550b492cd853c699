"""BDF-2 time stepping: the closed-loop rollout ``simulate``.

PyTorch counterpart of ``knode_cosserat_tpu/core/stepper.py`` (reference
rollout driver knode.py:55-102): a Python loop over control steps, each
step a warm-started, rod-batched Newton shooting solve (core/shooting.py),
differentiable by the implicit function theorem on request. A batch of
rollouts is a leading axis on ``controls``; a stack of R rods
(core/params.stack_params) rolls out as one more leading axis, every rod
under every schedule (the JAX package's ``jax.vmap(simulate_scan,
in_axes=(0, None))``).

Reference quirks kept as they are:
  * trajectory[0] is the initial straight rod recorded as [y, z, y, z];
    the final control step's result is dropped (knode.py:68,102), so
    len(traj) == len(controls).
  * z at the tip node is never written by the spatial sweep
    (cosserat_ode.py:198-201), so it stays at its initial value
    [0,0,1,0,0,0] for the whole rollout.
  * the Newton warm start is extrapolated as 2G - G_prev
    (``extrapolate=False`` gives the reference's plain warm start).
  * history midpoints for RK4 are linear interpolations (knode.py:80-81).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..models.mlp import mlp_forward
from .params import RodParams, repeat_rods
from .shooting import implicit_root, newton_solve
from .spatial import integrate_euler, integrate_rk4, tip_residual

__all__ = ["initial_state", "simulate", "simulate_scan", "SimOutput",
           "tendon_forces", "step_residual"]


class SimOutput(NamedTuple):
    """Rollout output (a leading batch axis when controls had one).

    traj: (..., T, N, 50) with last axis = [y(19), z(6), yh(19), zh(6)].
    G: (..., T, 6) solved base reactions.
    newton_iters / residuals / lm_retries: (..., T) per-step solver stats.
    """
    traj: torch.Tensor
    G: torch.Tensor
    newton_iters: torch.Tensor
    residuals: torch.Tensor
    lm_retries: torch.Tensor


def initial_state(p: RodParams):
    """Straight-rod initial condition (knode.py:58-64): z positions linearly
    spaced, identity quaternion, v = e_z, everything else zero. (N, 19),
    (N, 6); (R, N, 19), (R, N, 6) for a stack of R rods."""
    N = p.N
    lead = () if p.n_rods is None else (p.n_rods,)
    zpos = torch.arange(N, dtype=p.dtype, device=p.device) * (p.L / (N - 1))
    y = torch.zeros(lead + (N, 19), dtype=p.dtype, device=p.device)
    y[..., 2] = zpos
    y[..., 3] = 1.0
    z = torch.zeros(lead + (N, 6), dtype=p.dtype, device=p.device)
    z[..., 2] = 1.0
    return y, z


def tendon_forces(p: RodParams, tensions: torch.Tensor) -> torch.Tensor:
    """(..., n_tendons) tensions -> (..., 3) body force, summed elementwise
    (full precision; no TF32 matmul)."""
    return (tensions.unsqueeze(-1) * p.tendon_dirs).sum(-2)


def _sweep(p: RodParams, G, yh, zh, tf, nn_fn, nn_history, method):
    """The spatial sweep of one BDF-2 step at G: (y, z_body)."""
    if method == "euler":
        return integrate_euler(p, G, yh, zh, tf, nn_fn, nn_history)
    yh_int = 0.5 * (yh[..., :-1, :] + yh[..., 1:, :])
    zh_int = 0.5 * (zh[..., :-1, :] + zh[..., 1:, :])
    return integrate_rk4(p, G, yh, zh, yh_int, zh_int, tf, nn_fn, nn_history)


def step_residual(p: RodParams, yh, zh, tf, nn_fn=None,
                  nn_history: bool = False, method: str = "euler",
                  net=None, with_state: bool = False):
    """The tip residual of one BDF-2 step as ``(fn, args)`` for
    shooting.implicit_root: fn(G, *args), args = (yh, zh, tf, the rod's
    leaves that require grad, and ``net``'s weights), so derivatives of
    every order with respect to rod parameters (training/sysid.
    identifiability) are exact. ``nn_fn`` is the closure's net; ``net`` (a
    KnodeMLP, in place of nn_fn) is called with its weights as arguments.
    with_state: fn returns (r, (y, z_body)), the swept rod beside it
    (implicit_root's ``aux``)."""
    names = [n for n, v in p.leaves() if v.requires_grad]
    weights = list(net.parameters()) if net is not None else []

    def fn(G, yh, zh, tf, *vals):
        q = p.replace(**dict(zip(names, vals))) if names else p
        f = nn_fn
        if net is not None:
            ws = vals[len(names):]
            f = lambda x: mlp_forward(net.spec, ws, x)
        y, z = _sweep(q, G, yh, zh, tf, f, nn_history, method)
        r = tip_residual(q, y)
        return (r, (y, z)) if with_state else r

    return fn, (yh, zh, tf, *(getattr(p, n) for n in names), *weights)


def simulate_scan(
    p: RodParams,
    controls: torch.Tensor,
    nn_fn: Optional[Callable] = None,
    nn_history: bool = False,
    method: str = "euler",
    tol: Optional[float] = None,
    max_iter: int = 50,
    differentiable: bool = False,
    remat: bool = False,
    extrapolate: bool = True,
    initial: Optional[tuple] = None,
) -> SimOutput:
    """Rollout over a (T, 4) or (B, T, 4) tension schedule.

    initial: optional (y0 (N, 19), z0 (N, 6)) starting state instead of the
    at-rest straight rod; the BDF-2 history seeds from the state itself.
    With a batch, (B, N, 19), (B, N, 6) start each schedule from its own.

    A stack of R rods (core/params.stack_params) runs every rod under every
    schedule and puts the rod axis in front of every output: traj (R, T,
    N, 50) or (R, B, T, N, 50). It is one rollout of R * B rows, rod-major,
    each rod's leaves repeated per schedule; each row runs its own Newton
    solve, so row (i, b) is the rollout of rod i alone under schedule b.
    ``initial`` then broadcasts to (R, B, N, 19), (R, B, N, 6).

    Per step (knode.py:70-100): BDF-2 history yh = c1*y + c2*y_prev, Newton
    shooting solve for G warm-started from the previous step, then one
    final spatial sweep at the solved G to produce the recorded state.

    differentiable=True: each step's root carries implicit-function-theorem
    gradients (shooting.implicit_root at the root newton_solve found), so
    the rollout differentiates with respect to the controls, the initial
    state, the rod's parameters and the net's weights; stats report
    iterations 0 and ``converged`` from the actual residual. Otherwise the
    rollout records no graph. remat=True checkpoints each time step
    (torch.utils.checkpoint, non-reentrant): the backward pass recomputes
    the step, its Newton solve included, which is deterministic, so the
    gradient equals the plain path's.
    """
    if method not in ("euler", "rk4"):
        raise ValueError(f"unknown method {method!r}")
    if tol is None:
        # sum(r^2) < 1e-16 is unreachable in f32; pick by dtype
        tol = 1e-16 if p.dtype == torch.float64 else 1e-10
    controls = torch.as_tensor(controls, dtype=p.dtype, device=p.device)
    batched = controls.dim() == 3
    if not batched:
        controls = controls[None]
    B, T = controls.shape[0], controls.shape[1]
    R = p.n_rods
    lead = (B,) if R is None else (R, B)
    if R is not None:
        controls = controls.repeat(R, 1, 1)
        p = repeat_rods(p, B)
    rows = controls.shape[0]
    if initial is None:
        y0, z0 = initial_state(p)
    else:
        y0 = torch.as_tensor(initial[0], dtype=p.dtype, device=p.device)
        z0 = torch.as_tensor(initial[1], dtype=p.dtype, device=p.device)
        y0 = y0.expand(lead + y0.shape[-2:]).reshape((rows,) + y0.shape[-2:])
        z0 = z0.expand(lead + z0.shape[-2:]).reshape((rows,) + z0.shape[-2:])
    y0 = y0.expand(rows, -1, -1)
    z0 = z0.expand(rows, -1, -1)
    z_tip = z0[:, -1:]                      # frozen forever (see docstring)
    G0 = torch.zeros((rows, 6), dtype=p.dtype, device=p.device)
    # the BDF-2 coefficients against (rows, N, k) states: a stack's (rows,
    # 1) leaves need the node axis
    c1, c2 = (p.c1, p.c2) if R is None else (p.c1[..., None], p.c2[..., None])

    def step(y, z, y_prev, z_prev, G, G_prev, u):
        yh = c1 * y + c2 * y_prev
        zh = c1 * z + c2 * z_prev
        G_guess = 2.0 * G - G_prev if extrapolate else G
        tf = tendon_forces(p, u)
        if differentiable:
            fn, args = step_residual(p, yh, zh, tf, nn_fn, nn_history,
                                     method)
            G_new, stats = implicit_root(fn, G_guess, tol, max_iter, args)
        else:
            G_new, stats = newton_solve(
                lambda Gx: tip_residual(p, _sweep(p, Gx, yh, zh, tf, nn_fn,
                                                  nn_history, method)[0]),
                G_guess, tol=tol, max_iter=max_iter)
        y_new, z_body = _sweep(p, G_new, yh, zh, tf, nn_fn, nn_history,
                               method)
        z_new = torch.cat([z_body, z_tip], dim=-2)
        return (y_new, z_new, G_new, torch.cat([y_new, z_new, yh, zh], -1),
                stats.iterations, stats.residual_norm, stats.lm_retries)

    if remat and differentiable and torch.is_grad_enabled():
        run = lambda *a: checkpoint(step, *a, use_reentrant=False)
    else:
        run = step
    y, z, y_prev, z_prev, G, G_prev = y0, z0, y0, z0, G0, G0
    records = [torch.cat([y0, z0, y0, z0], dim=-1)]
    Gs, iters, res, lm = [G0], [], [], []
    with torch.set_grad_enabled(differentiable and torch.is_grad_enabled()):
        for t in range(T - 1):
            y_new, z_new, G_new, record, it, rn, lmr = run(
                y, z, y_prev, z_prev, G, G_prev, controls[:, t])
            records.append(record)
            Gs.append(G_new)
            iters.append(it)
            res.append(rn)
            lm.append(lmr)
            y, z, y_prev, z_prev, G, G_prev = y_new, z_new, y, z, G_new, G

    zero_i = torch.zeros(rows, dtype=torch.int32, device=p.device)
    zero_f = torch.zeros(rows, dtype=p.dtype, device=p.device)
    out = SimOutput(torch.stack(records, dim=1), torch.stack(Gs, dim=1),
                    torch.stack([zero_i] + iters, dim=1),
                    torch.stack([zero_f] + res, dim=1),
                    torch.stack([zero_i] + lm, dim=1))
    shape = lead if batched else lead[:-1]
    return SimOutput(*(a.reshape(shape + a.shape[1:]) for a in out))


@torch.no_grad()
def simulate(
    p: RodParams,
    controls,
    nn_fn: Optional[Callable] = None,
    nn_history: bool = False,
    method: str = "euler",
    tol: Optional[float] = None,
    max_iter: int = 50,
    reference_layout: bool = False,
):
    """Trajectory of the rollout, matching the reference
    ``simulate(robot, ctl)`` contract (knode.py:55-102).

    reference_layout=True returns (T, 50, N) like the reference; the default
    is (T, N, 50)."""
    traj = simulate_scan(p, controls, nn_fn=nn_fn, nn_history=nn_history,
                         method=method, tol=tol, max_iter=max_iter).traj
    if reference_layout:
        traj = traj.transpose(-1, -2)
    return traj
