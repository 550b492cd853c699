"""Gradient-based MPC over a multi-rod assembly: plate-pose tracking.

PyTorch counterpart of ``knode_cosserat_tpu/control/assembly_mpc.py``. A
parallel continuum robot is steered by its rigid end plate; the planner
finds per-rod tension schedules u (H, M, n_tendons) that track a plate
position (and optionally orientation) trajectory:

  u* = argmin_u  mean ||p_plate_t(u) - p_target_t||^2
                 + w_ori * mean |quat_err(h_plate_t(u), h_target_t)|^2
                 + w_du  * mean ||u_t - u_{t-1}||^2,
       u in [u_min, u_max] through a sigmoid of logits.

Every horizon step is one coupled assembly solve (core/assembly.
assembly_step_carry with ``differentiable=True``): the gradient reaches the
logits through each (6M+7)-dim solve by the implicit function theorem.
With ``fused=True`` kernel K7 (ops/assembly.py) solves each step's root.

optax.adam(opt_lr) is training/train.AdamPlateau's Adam (optax's update:
m_hat / (sqrt(v_hat) + 1e-8), no eps_root) with a patience longer than
the run, so its plateau never scales the rate; the JAX package's
``lax.scan`` over Adam steps is a Python loop. The multi-start's vmap over
restarts is a batch: the R restarts' logits (R, H, M, n_tendons) go
through one batched rollout (every horizon step one coupled solve, one K7
launch with ``fused=True``, for all of them, and one batched implicit
root in the backward), and Adam steps on the gradient of the sum of
their costs, so each restart's logits get exactly their own gradient.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..core.assembly import (AssemblyCarry, RodAssembly, _quat_conj,
                             _quat_mul, assembly_step_carry)

__all__ = ["AssemblyPlanResult", "rollout_plate", "make_assembly_planner",
           "make_multistart_assembly_planner", "AssemblyMPCController"]


class AssemblyPlanResult(NamedTuple):
    """A plan over a batch of logits (R restarts) has a leading R on every
    field."""
    tensions: torch.Tensor      # (H, M, n_tendons) optimized schedule
    logits: torch.Tensor        # (H, M, n_tendons) reparam warm start
    cost: torch.Tensor          # scalar final cost
    cost_history: torch.Tensor  # (opt_iters,)
    plate_poses: torch.Tensor   # (H, 7) predicted [p, h] under tensions


def rollout_plate(asm: RodAssembly, carry: AssemblyCarry, tensions,
                  nn_fn=None, nn_history: bool = False, nn_spec=None,
                  nn_params=None, tol: float = 1e-8, max_iter: int = 30,
                  solve_fn=None):
    """Differentiable H-step assembly rollout from ``carry`` under a
    (H, M, n_tendons) tension schedule: (plate poses (H, 7), final carry).
    Tensions (R, H, M, n_tendons) roll R schedules out as one batch, from
    a batched carry or from one carry broadcast to all R: plate poses
    (R, H, 7), each horizon step one batched solve.
    solve_fn: a fused root solver (K7, ops/assembly.py); the gradients
    still come through the plain residual (assembly_step_carry)."""
    tensions = torch.as_tensor(tensions, dtype=asm.dtype, device=asm.device)
    if tensions.dim() == 4 and carry.y.dim() == 3:
        carry = carry.expand(tensions.shape[0])
    plates = []
    for t in range(tensions.shape[-3]):
        carry, _, plate7, _, _ = assembly_step_carry(
            asm, carry, tensions[..., t, :, :], nn_fn, nn_history, tol,
            max_iter, differentiable=True, nn_spec=nn_spec,
            nn_params=nn_params, solve_fn=solve_fn)
        plates.append(plate7)
    return torch.stack(plates, dim=-2), carry


def _quat_err(h: torch.Tensor, h_target: torch.Tensor) -> torch.Tensor:
    """Vector part of h_target^-1 * h, sign-corrected (antipode-safe);
    ~ rotvec / 2 for small errors. (..., 4) -> (..., 3). The flip is
    ``>= 0``, not sign(): sign(0) = 0 would zero the error at exactly 180
    degrees."""
    rel = _quat_mul(_quat_conj(h_target), h)
    return torch.where(rel[..., 0:1] >= 0, rel[..., 1:4], -rel[..., 1:4])


def make_assembly_planner(
    asm: RodAssembly,
    horizon: int,
    nn_spec=None,
    opt_iters: int = 40,
    opt_lr: float = 0.4,
    u_min: float = 0.0,
    u_max: float = 20.0,
    w_du: float = 1e-4,
    w_ori: float = 0.0,
    tol: float = 1e-8,
    max_iter: int = 30,
    fused: bool = False,
) -> Callable[..., AssemblyPlanResult]:
    """Build the assembly plan function:
    ``plan(carry, target_pos, target_quat=None, logits_init=None,
    nn_params=None, u_last=None)`` -> AssemblyPlanResult.

    target_pos: (horizon, 3) plate positions; target_quat: (horizon, 4)
    (used when w_ori > 0). nn_params: per-rod nets (a sequence of M, with
    ``nn_spec``). fused: solve each horizon step's root with K7 (no net).
    logits_init (R, horizon, M, n_tendons) runs R independent plans as
    one batch (the multi-start's restarts, the JAX package's vmap): every
    field of the result, and u_last when it defaults, gains a leading R
    (the cost history (R, opt_iters)).
    """
    span, lo = float(u_max) - float(u_min), float(u_min)
    M, n_t = asm.M, int(asm.rods[0].n_tendons)
    kw = dict(dtype=asm.dtype, device=asm.device)
    solve_fn = None
    if fused:
        if nn_spec is not None:
            raise NotImplementedError("fused planning does not support "
                                      "KNODE residuals yet")
        from ..ops.assembly import make_assembly_step_kernel
        solve_fn = make_assembly_step_kernel(asm, tol=tol, max_iter=max_iter)

    def to_u(logits):
        return lo + span * torch.sigmoid(logits)

    def cost_fn(logits, carry, target_pos, target_quat, nn_params, u_last):
        """The cost ([R],), tensions and plate poses of logits ([R,] H, M,
        n_t)."""
        u = to_u(logits)
        plates, _ = rollout_plate(asm, carry, u, nn_spec=nn_spec,
                                  nn_params=nn_params, tol=tol,
                                  max_iter=max_iter, solve_fn=solve_fn)
        track = ((plates[..., :3] - target_pos) ** 2).sum(-1).mean(-1)
        if w_ori > 0.0:
            e = _quat_err(plates[..., 3:7], target_quat)
            track = track + w_ori * (e * e).sum(-1).mean(-1)
        du = torch.diff(torch.cat([u_last.unsqueeze(-3), u], dim=-3), dim=-3)
        return (track + w_du * (du * du).sum((-2, -1)).mean(-1), u, plates)

    def plan(carry: AssemblyCarry, target_pos, target_quat=None,
             logits_init=None, nn_params=None,
             u_last=None) -> AssemblyPlanResult:
        from ..training.train import AdamPlateau

        target_pos = torch.as_tensor(target_pos, **kw)
        if target_quat is None:
            target_quat = torch.tensor([1.0, 0.0, 0.0, 0.0], **kw).expand(
                horizon, 4)
        else:
            target_quat = torch.as_tensor(target_quat, **kw)
        if logits_init is None:
            logits_init = torch.zeros((horizon, M, n_t), **kw)
        logits_init = torch.as_tensor(logits_init, **kw)
        lead = tuple(logits_init.shape[:-3])    # (R,) for a batch, else ()
        if u_last is None:
            u_last = to_u(logits_init[..., 0, :, :])
        u_last = torch.as_tensor(u_last, **kw).detach().expand(
            lead + (M, n_t))
        carry = AssemblyCarry(*(t.detach() for t in carry))
        logits = logits_init.detach().clone().requires_grad_(True)
        # a patience past the last step: the plateau never scales the
        # rate, so the restarts of a batch, which share its state, stay
        # uncoupled (Adam's moments are elementwise)
        adam = AdamPlateau([logits], lr=opt_lr, patience=opt_iters + 1)
        costs = []
        for _ in range(opt_iters):
            with torch.enable_grad():
                cost, _, _ = cost_fn(logits, carry, target_pos, target_quat,
                                     nn_params, u_last)
                # restart r's logits reach cost[r] alone
                (logits.grad,) = torch.autograd.grad(cost.sum(), logits)
            adam.step(cost.sum().detach())
            costs.append(cost.detach())
        with torch.no_grad():
            final, u, plates = cost_fn(logits, carry, target_pos, target_quat,
                                       nn_params, u_last)
        history = (torch.stack(costs, dim=-1) if costs
                   else torch.zeros(lead + (0,), **kw))
        return AssemblyPlanResult(u, logits.detach(), final, history, plates)

    return plan


def make_multistart_assembly_planner(asm: RodAssembly, horizon: int,
                                     nn_spec=None, restarts: int = 8,
                                     init_scale: float = 2.0,
                                     **kw) -> Callable[..., AssemblyPlanResult]:
    """Multi-start variant of make_assembly_planner: ``restarts`` Adam
    descents run as ONE batch (every horizon step one coupled solve for
    all restarts: one K7 launch with ``fused=True``), restart 0 from
    ``logits_init`` (the receding-horizon warm start) and the others from
    it plus init_scale * N(0, 1) noise drawn from ``generator``; the best
    final cost wins (a NaN cost, a diverged restart, never does), so the
    result is never worse than the single plan.

    Returns ``plan(carry, target_pos, generator, target_quat=None,
    logits_init=None, nn_params=None, u_last=None)``; ``generator`` is a
    CPU ``torch.Generator`` (the JAX package's PRNG key)."""
    batched = make_assembly_planner(asm, horizon, nn_spec, **kw)
    M, n_t = asm.M, int(asm.rods[0].n_tendons)

    def plan(carry: AssemblyCarry, target_pos, generator: torch.Generator,
             target_quat=None, logits_init=None, nn_params=None,
             u_last=None) -> AssemblyPlanResult:
        if logits_init is None:
            logits_init = torch.zeros((horizon, M, n_t), dtype=asm.dtype,
                                      device=asm.device)
        noise = init_scale * torch.randn((restarts - 1, horizon, M, n_t),
                                         generator=generator,
                                         dtype=asm.dtype).to(asm.device)
        inits = torch.cat([logits_init[None], logits_init[None] + noise])
        r = batched(carry, target_pos, target_quat, inits, nn_params, u_last)
        best = int(torch.argmin(torch.nan_to_num(r.cost, nan=math.inf)))
        return AssemblyPlanResult(*(t[best] for t in r))

    return plan


class AssemblyMPCController:
    """Receding-horizon plate-pose controller over the coupled assembly.

    Each ``act`` plans ``horizon`` steps from the CURRENT assembly carry,
    applies the first (M, n_tendons) tension matrix to the internal model
    (the plain coupled solve) and shifts the optimized logits for the next
    call's warm start."""

    def __init__(self, asm: RodAssembly, horizon: int = 8, nn_spec=None,
                 nn_params=None, replan_iters: int = 20,
                 first_iters: int = 60, **kw):
        self.asm = asm
        self.horizon = horizon
        self.nn_spec = nn_spec
        self.nn_params = nn_params
        self._plan_first = make_assembly_planner(
            asm, horizon, nn_spec, opt_iters=first_iters, **kw)
        self._plan_warm = make_assembly_planner(
            asm, horizon, nn_spec, opt_iters=replan_iters, **kw)
        self._tol = kw.get("tol", 1e-8)
        self._max_iter = kw.get("max_iter", 30)
        self.reset()

    def reset(self):
        self.carry = AssemblyCarry.initial(self.asm)
        self._logits = None
        self._u_applied = None

    def act(self, target_pos, target_quat=None) -> tuple:
        """Plan against (horizon, 3) plate-position targets (and optional
        (horizon, 4) quaternion targets); apply and return the first
        (M, n_tendons) tension matrix. Returns (tensions, info dict)."""
        planner = (self._plan_first if self._logits is None
                   else self._plan_warm)
        result = planner(self.carry, target_pos, target_quat, self._logits,
                         self.nn_params, self._u_applied)
        u0 = result.tensions[0]
        with torch.no_grad():
            self.carry, _, plate7, _, _ = assembly_step_carry(
                self.asm, self.carry, u0, tol=self._tol,
                max_iter=self._max_iter, nn_spec=self.nn_spec,
                nn_params=self.nn_params)
        self._logits = torch.cat([result.logits[1:], result.logits[-1:]])
        self._u_applied = u0
        return u0, {"cost": float(result.cost),
                    "predicted_plates": result.plate_poses,
                    "plate_pose": plate7}
