"""Failure detection: rollout health and a training-loss watchdog.

PyTorch counterpart of ``knode_cosserat_tpu/utils/health.py``:
  * ``check_rollout`` turns a SimOutput's per-step Newton stats into a
    structured report (non-converged steps, non-finite states, LM rescues);
  * ``GuardedTraining`` watches a loss stream for NaN or divergence and
    restores the last good snapshot. The port's weights and optimizer
    state are updated in place, so a snapshot is a clone of their tensors
    (a module's ``state_dict``, an optimizer's ``state_dict``, or the
    tensors of a dict or a list), and a rollback copies it back into the same
    objects (the JAX package's ``jax.tree.map`` copies of immutable trees).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import List

import numpy as np
import torch

__all__ = ["RolloutReport", "check_rollout", "GuardedTraining"]


@dataclasses.dataclass
class RolloutReport:
    ok: bool
    n_steps: int
    bad_steps: List[int]          # residual above tolerance
    nan_steps: List[int]          # non-finite state
    max_residual: float
    max_newton_iters: int
    lm_retry_steps: List[int] = dataclasses.field(default_factory=list)

    def __str__(self):
        s = "OK" if self.ok else "UNHEALTHY"
        return (f"rollout {s}: {self.n_steps} steps, "
                f"max residual {self.max_residual:.2e}, "
                f"max newton iters {self.max_newton_iters}, "
                f"{len(self.bad_steps)} non-converged, "
                f"{len(self.nan_steps)} non-finite, "
                f"{len(self.lm_retry_steps)} LM-rescued")


def _host(a) -> np.ndarray:
    return (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a))


def check_rollout(sim_output, residual_tol: float = 1e-4) -> RolloutReport:
    """Inspect one rollout's SimOutput (traj (T, N, 50)) for solver
    failures."""
    res = _host(sim_output.residuals)
    iters = _host(sim_output.newton_iters)
    traj = _host(sim_output.traj)
    finite = np.isfinite(traj).all(axis=(1, 2))
    bad = np.where(res > residual_tol)[0]
    nans = np.where(~finite)[0]
    lm = (_host(sim_output.lm_retries)
          if getattr(sim_output, "lm_retries", None) is not None
          else np.zeros(0, np.int32))
    return RolloutReport(
        ok=(len(bad) == 0 and len(nans) == 0),
        n_steps=traj.shape[0],
        bad_steps=bad.tolist(),
        nan_steps=nans.tolist(),
        max_residual=float(res.max()) if len(res) else 0.0,
        max_newton_iters=int(iters.max()) if len(iters) else 0,
        lm_retry_steps=np.where(lm > 0)[0].tolist(),
    )


def _snapshot(obj):
    """A detached copy of what ``obj`` holds (see the module docstring)."""
    if isinstance(obj, torch.nn.Module):
        return {k: v.detach().clone() for k, v in obj.state_dict().items()}
    if isinstance(obj, torch.optim.Optimizer):
        return copy.deepcopy(obj.state_dict())
    if isinstance(obj, dict):
        return {k: _snapshot(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_snapshot(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        return obj.detach().clone()
    return copy.deepcopy(obj)


@torch.no_grad()
def _restore(obj, snap):
    """Copy ``snap`` back into ``obj`` in place; returns ``obj``."""
    if isinstance(obj, torch.nn.Module):
        obj.load_state_dict(snap)
    elif isinstance(obj, torch.optim.Optimizer):
        obj.load_state_dict(copy.deepcopy(snap))
    elif isinstance(obj, dict):
        for k in obj:
            obj[k] = _restore(obj[k], snap[k])
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            obj[i] = _restore(v, snap[i])
    elif isinstance(obj, torch.Tensor):
        obj.copy_(snap)
    else:
        return copy.deepcopy(snap)
    return obj


class GuardedTraining:
    """Loss-stream watchdog with parameter rollback.

    Usage:
        guard = GuardedTraining(net, optimizer)
        for ...:
            loss = step(net, ...)
            net, optimizer, reset = guard.update(net, optimizer, loss)

    ``params`` and ``opt_state`` are what the training step updates in
    place: a module, an optimizer, or dicts / lists of tensors.
    """

    def __init__(self, params, opt_state, divergence_factor: float = 1e3,
                 snapshot_every: int = 50, forget: float = 1.0):
        self._snap = (_snapshot(params), _snapshot(opt_state))
        self.best_loss = np.inf
        self.divergence_factor = divergence_factor
        self.snapshot_every = snapshot_every
        # ``forget`` > 1 relaxes the divergence reference geometrically on
        # every rolled-back update: online streams may change for a reason
        # (the plant itself drifts), and a lifetime-best reference would
        # then veto every later update. With forget=f a sustained J-fold
        # rise over the best is accepted after ceil(log(J/factor)/log(f))
        # rollbacks; a single NaN or explosion still rolls back first.
        self.forget = forget
        self._since_snap = 0
        self.resets = 0

    def update(self, params, opt_state, loss):
        loss = float(loss)
        diverged = (not np.isfinite(loss)) or (
            np.isfinite(self.best_loss)
            and loss > self.best_loss * self.divergence_factor)
        if diverged:
            self.resets += 1
            if np.isfinite(self.best_loss):
                self.best_loss *= self.forget
            params = _restore(params, self._snap[0])
            opt_state = _restore(opt_state, self._snap[1])
            return params, opt_state, True
        self.best_loss = min(self.best_loss, loss)
        self._since_snap += 1
        if self._since_snap >= self.snapshot_every:
            self._snap = (_snapshot(params), _snapshot(opt_state))
            self._since_snap = 0
        return params, opt_state, False
