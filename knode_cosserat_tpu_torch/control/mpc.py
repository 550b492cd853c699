"""Gradient-based MPC over tendon tensions through the differentiable rollout.

PyTorch counterpart of ``knode_cosserat_tpu/control/mpc.py``. The planner
finds a tension schedule u (H, 4) that tracks a tip trajectory:

  u* = argmin_u  mean ||tip_t(u) - target_t||^2
                 + w_du * mean ||u_t - u_{t-1}||^2,
       u in [u_min, u_max] through a sigmoid of logits.

Each horizon step is one implicit BDF-2 step (:func:`_bdf2_step`). Its
forward root comes from kernel K2 (ops/step.make_step_kernel: the whole
damped Newton solve of one step, per rod, in one launch) on a CUDA rod,
and from core/shooting.newton_solve (the JAX package's algorithm) on a CPU
rod; either way the gradient reaches the logits through the implicit
function theorem on the plain residual (core/shooting.implicit_root at
that root), so the backward pass launches no K2. The multi-start planner
runs its restarts as K2's rods: one launch per horizon step for all of
them, where the JAX package vmaps.

optax.adam(opt_lr) is training/train.AdamPlateau's Adam with a patience
longer than the run (as in control/assembly_mpc.py); the JAX package's
``lax.scan`` over Adam steps is a Python loop, its PRNG key a
``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from ..core.params import RodParams
from ..core.shooting import implicit_root
from ..core.stepper import initial_state, step_residual, tendon_forces
from ..models.mlp import MLPSpec

__all__ = ["PlanState", "PlanResult", "make_planner",
           "make_multistart_planner", "MPCController", "rollout_tips"]


class PlanState(NamedTuple):
    """BDF-2 carry of the controlled rod (core/stepper's loop carry):
    current and previous node states plus the last two solved base
    reactions (G, G_prev) for the extrapolated Newton warm start. Every
    leaf may carry a leading batch axis (the multi-start's restarts)."""
    y: torch.Tensor        # (N, 19)
    z: torch.Tensor        # (N, 6)
    y_prev: torch.Tensor
    z_prev: torch.Tensor
    G: torch.Tensor        # (6,)
    G_prev: torch.Tensor

    @staticmethod
    def initial(p: RodParams) -> "PlanState":
        y0, z0 = initial_state(p)
        G0 = torch.zeros(6, dtype=p.dtype, device=p.device)
        return PlanState(y0, z0, y0, z0, G0, G0)


class PlanResult(NamedTuple):
    tensions: torch.Tensor      # (H, 4) optimized schedule
    logits: torch.Tensor        # (H, 4) reparam point (warm start for next)
    cost: torch.Tensor          # scalar final cost
    cost_history: torch.Tensor  # (opt_iters,)
    tips: torch.Tensor          # (H, 3) predicted tip track under tensions


def _root_solver(p: RodParams, spec: Optional[MLPSpec], tol: float,
                 max_iter: int, root):
    """The forward root's solver: K2's wrapper (``"k2"``; on a CPU rod its
    plain version, ops/step.step_reference) or None for newton_solve
    (``"newton"``); ``"auto"`` takes K2 on a CUDA rod. The wrapper caches
    the rod's constants at its first launch, so it serves this rod only."""
    if root == "auto":
        root = "k2" if p.device.type == "cuda" else "newton"
    if root == "newton":
        return None
    if root != "k2":
        raise ValueError(f"unknown root solver {root!r}")
    from ..ops.step import make_step_kernel
    return make_step_kernel(p, spec, tol=tol, max_iter=max_iter)


def _bdf2_step(p: RodParams, state: PlanState, tensions, spec, nn_params,
               tol: float, max_iter: int, step_fn=None) -> PlanState:
    """One implicit BDF-2 step from any carry (batched over a leading axis
    or not). With ``step_fn`` (K2) its root is one K2 launch for every rod
    of the batch, else newton_solve's. When a gradient is wanted, the root
    and the swept state come out of implicit_root on the plain residual
    (the state as its auxiliary output: the backward is one sweep over 7
    copies and two reverse passes, no K2); otherwise K2's own recorded
    state is used."""
    y, z, y_prev, z_prev, G, G_prev = state
    one = y.dim() == 2
    if one:
        state = PlanState(*(a[None] for a in state))
        y, z, y_prev, z_prev, G, G_prev = state
        tensions = tensions[None]
    yh = p.c1 * y + p.c2 * y_prev
    zh = p.c1 * z + p.c2 * z_prev
    tf = tendon_forces(p, torch.as_tensor(tensions, dtype=p.dtype,
                                          device=p.device))
    warm = 2.0 * G - G_prev
    nn_history = bool(spec.history) if spec is not None else False
    weights = list(nn_params.parameters()) if nn_params is not None else []
    want_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (yh, zh, tf, warm, *weights,
                                  *(v for _, v in p.leaves())))
    root = at_root = None
    if step_fn is not None:
        with torch.no_grad():
            root, y_k, z_k, r2, _ = step_fn(
                warm.detach().contiguous(), yh.detach().contiguous(),
                zh.detach().contiguous(), tf.detach().contiguous(),
                nn_params)
        at_root = (r2, (y_k, z_k))
    if root is not None and not want_grad:
        G_new, y_new, z_body = root, y_k, z_k
    else:
        fn, args = step_residual(p, yh, zh, tf, nn_history=nn_history,
                                 net=nn_params, with_state=True)
        G_new, (y_new, z_body), _ = implicit_root(
            fn, warm, tol, max_iter, args, root=root, aux=True,
            at_root=at_root)
    z_new = torch.cat([z_body, z[..., -1:, :]], dim=-2)
    out = PlanState(y_new, z_new, y, z, G_new, G)
    return PlanState(*(a[0] for a in out)) if one else out


def rollout_tips(p: RodParams, state: PlanState, tensions,
                 spec: Optional[MLPSpec] = None, nn_params=None,
                 tol: float = 1e-10, max_iter: int = 30,
                 _root="auto"):
    """Differentiable H-step rollout from ``state`` under a (H, 4) tension
    schedule (or (R, H, 4) from a batched state); returns (tips (H, 3),
    final PlanState). Gradients with respect to ``tensions`` (and the
    state, and ``nn_params``) flow through every implicit solve. On a CUDA
    rod each step's root is one K2 launch (``_root``: "auto", "k2",
    "newton", or a K2 wrapper already made for this rod)."""
    step_fn = (_root if callable(_root)
               else _root_solver(p, spec, tol, max_iter, _root))
    tensions = torch.as_tensor(tensions, dtype=p.dtype, device=p.device)
    tips = []
    for t in range(tensions.shape[-2]):
        state = _bdf2_step(p, state, tensions[..., t, :], spec, nn_params,
                           tol, max_iter, step_fn)
        tips.append(state.y[..., -1, 0:3])
    return torch.stack(tips, dim=-2), state


def make_planner(
    p: RodParams,
    horizon: int,
    spec: Optional[MLPSpec] = None,
    opt_iters: int = 60,
    opt_lr: float = 0.5,
    u_min: float = 0.0,
    u_max: float = 20.0,
    w_du: float = 1e-4,
    tol: float = 1e-10,
    max_iter: int = 30,
    _root="auto",
) -> Callable[..., PlanResult]:
    """Build the plan function.

    Returns ``plan(state, target_tips, logits_init=None, nn_params=None,
    u_last=None)`` -> PlanResult. ``target_tips``: (horizon, 3) tip
    positions to track. ``logits_init``: (horizon, 4) warm start in the
    sigmoid reparam space; zeros = mid-range tensions. Tensions are
    u = u_min + (u_max - u_min) * sigmoid(logits). ``_root`` picks the
    forward roots' solver (:func:`rollout_tips`); a CPU test passes "k2"
    to run K2's plain version through this code.
    """
    batched = _make_batched_planner(p, horizon, spec, opt_iters, opt_lr,
                                    u_min, u_max, w_du, tol, max_iter, _root)
    kw = dict(dtype=p.dtype, device=p.device)

    def plan(state: PlanState, target_tips, logits_init=None,
             nn_params=None, u_last=None) -> PlanResult:
        if logits_init is None:
            logits_init = torch.zeros((horizon, 4), **kw)
        logits_init = torch.as_tensor(logits_init, **kw)
        r = batched(state, target_tips, logits_init[None], nn_params, u_last)
        return PlanResult(r.tensions[0], r.logits[0], r.cost[0],
                          r.cost_history[:, 0], r.tips[0])

    plan.batched = batched        # the multi-start's restarts as one batch
    return plan


def _make_batched_planner(p, horizon, spec, opt_iters, opt_lr, u_min, u_max,
                          w_du, tol, max_iter, root):
    """plan(state, target, logits_init (R, H, 4), nn_params, u_last) ->
    PlanResult with a leading restart axis R on every leaf (the cost
    history (opt_iters, R)): R independent Adam descents, every horizon
    step of every iteration one root solve (one K2 launch) for all R."""
    span, lo = float(u_max) - float(u_min), float(u_min)
    kw = dict(dtype=p.dtype, device=p.device)
    step_fn = _root_solver(p, spec, tol, max_iter, root)

    def to_u(logits):
        return lo + span * torch.sigmoid(logits)

    def cost_fn(logits, state, target, nn_params, u_last):
        u = to_u(logits)
        tips, _ = rollout_tips(p, state, u, spec, nn_params, tol, max_iter,
                               _root=step_fn if step_fn else "newton")
        track = ((tips - target) ** 2).sum(-1).mean(-1)
        du = torch.diff(torch.cat([u_last[:, None], u], dim=1), dim=1)
        return track + w_du * (du * du).sum(-1).mean(-1), tips

    def plan(state, target_tips, logits_init, nn_params=None, u_last=None):
        from ..training.train import AdamPlateau

        R = logits_init.shape[0]
        target = torch.as_tensor(target_tips, **kw)
        state = PlanState(*(torch.as_tensor(a, **kw).detach().expand(
            (R,) + tuple(a.shape)) for a in state))
        if u_last is None:
            u_last = to_u(logits_init[:, 0])
        u_last = torch.as_tensor(u_last, **kw).detach().expand(R, 4)
        logits = logits_init.detach().clone().requires_grad_(True)
        adam = AdamPlateau([logits], lr=opt_lr, patience=opt_iters + 1)
        costs = []
        for _ in range(opt_iters):
            with torch.enable_grad():
                cost, _ = cost_fn(logits, state, target, nn_params, u_last)
                (logits.grad,) = torch.autograd.grad(cost.sum(), logits)
            adam.step(cost.sum().detach())
            costs.append(cost.detach())
        with torch.no_grad():
            u = to_u(logits)
            _, tips = cost_fn(logits, state, target, nn_params, u_last)
            final, _ = cost_fn(logits, state, target, nn_params, u_last)
        history = (torch.stack(costs) if costs
                   else torch.zeros((0, R), **kw))
        return PlanResult(u, logits.detach(), final, history, tips)

    return plan


def make_multistart_planner(p: RodParams, horizon: int,
                            restarts: int = 8, init_scale: float = 2.0,
                            **kw) -> Callable[..., PlanResult]:
    """Multi-start variant of make_planner: ``restarts`` Adam descents, run
    together as one batch (every horizon step one K2 launch for all
    restarts on a CUDA rod). Restart 0 starts from ``logits_init`` (the
    receding-horizon warm start), the others from it plus init_scale *
    N(0, 1) noise drawn from ``generator``; the best final cost wins (a
    NaN cost, a diverged restart, never does), so the result is never worse
    than the single plan.

    Returns ``plan(state, target_tips, generator, logits_init=None,
    nn_params=None, u_last=None)`` -> the winning restart's PlanResult;
    ``generator`` is a CPU ``torch.Generator`` (the JAX package's PRNG
    key)."""
    batched = make_planner(p, horizon, **kw).batched

    def plan(state: PlanState, target_tips, generator: torch.Generator,
             logits_init=None, nn_params=None, u_last=None) -> PlanResult:
        if logits_init is None:
            logits_init = torch.zeros((horizon, 4), dtype=p.dtype,
                                      device=p.device)
        noise = init_scale * torch.randn((restarts - 1, horizon, 4),
                                         generator=generator,
                                         dtype=p.dtype).to(p.device)
        inits = torch.cat([logits_init[None], logits_init[None] + noise])
        r = batched(state, target_tips, inits, nn_params, u_last)
        # a diverged restart's NaN cost counts as +inf
        best = int(torch.argmin(torch.nan_to_num(r.cost, nan=math.inf)))
        return PlanResult(r.tensions[best], r.logits[best], r.cost[best],
                          r.cost_history[:, best], r.tips[best])

    return plan


class MPCController:
    """Receding-horizon controller over the (hybrid) rod model.

    Each ``act`` plans ``horizon`` steps from the CURRENT model state,
    applies the first tension vector to the internal model (one step, its
    root one K2 launch on a CUDA rod, no graph) and shifts the optimized
    logits one step for the next call's warm start. ``nn_params`` may be
    replaced between calls (e.g. by training/online.OnlineAdapter)."""

    def __init__(self, p: RodParams, horizon: int = 10,
                 spec: Optional[MLPSpec] = None, nn_params=None,
                 replan_iters: int = 25, first_iters: int = 80, **kw):
        self.p = p
        self.horizon = horizon
        self.spec = spec
        self.nn_params = nn_params
        self._kw = kw
        self._plan_first = make_planner(p, horizon, spec,
                                        opt_iters=first_iters, **kw)
        self._plan_warm = make_planner(p, horizon, spec,
                                       opt_iters=replan_iters, **kw)
        self._tol = kw.get("tol", 1e-10)
        self._max_iter = kw.get("max_iter", 30)
        self._step_fn = _root_solver(p, spec, self._tol, self._max_iter,
                                     kw.get("_root", "auto"))
        self.reset()

    def reset(self):
        self.state = PlanState.initial(self.p)
        self._logits = None
        self._u_applied = None

    @torch.no_grad()
    def _step(self, state: PlanState, u, nn_params) -> PlanState:
        return _bdf2_step(self.p, state, u, self.spec, nn_params, self._tol,
                          self._max_iter, self._step_fn)

    def act(self, target_tips) -> tuple:
        """Plan against (horizon, 3) targets; apply and return the first
        tension vector. Returns (tensions (4,), info dict)."""
        planner = self._plan_first if self._logits is None else self._plan_warm
        result = planner(self.state, target_tips, self._logits,
                         self.nn_params, self._u_applied)
        u0 = result.tensions[0]
        self.state = self._step(self.state, u0, self.nn_params)
        self._logits = torch.cat([result.logits[1:], result.logits[-1:]])
        self._u_applied = u0
        return u0, {"cost": float(result.cost),
                    "predicted_tips": result.tips,
                    "tip": self.state.y[-1, 0:3]}
