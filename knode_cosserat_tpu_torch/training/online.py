"""Online KNODE adaptation: streaming residual learning.

PyTorch counterpart of ``knode_cosserat_tpu/training/online.py``.
Telemetry streams in one step at a time (full-state records and the
applied tendon tensions), a ring buffer keeps the last ``window`` steps,
and every ``update()`` takes a few optimizer steps of the trainer's
teacher-forced loss (training/train.make_train_step, ``skip_first=True``)
on that window. The adapted net can be handed to control/mpc.py's
``MPCController`` while it runs; :class:`OnlineSysId` tracks physical
parameters the same way (training/sysid.py).

Design notes:
  - Window sizes are bucketed to powers of two from min_fill up to window
    and never padded (a repeated frame would teach "this mid-swing state
    stays put").
  - The buffer is a host numpy ring; an update moves one (window, N, 25)
    block to the rod's device.
  - The optimizer state persists across updates (plain Adam or AdamW:
    AdamPlateau with a plateau that never fires), so adaptation composes
    across windows like one long stream.
  - The handoff guard's probe is control.mpc.rollout_tips, so on a CUDA
    rod its forward roots are K2 launches.
  - The initial net is init_mlp from a ``torch.Generator`` seeded with
    ``cfg.seed``; its values differ from the JAX package's PRNG draws
    (models.mlp.params_from_jax carries a JAX net across).
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.params import RodParams
from ..models.mlp import MLPSpec, init_mlp
from ..utils.health import GuardedTraining
from .loss import DEFAULT_KEYPOINTS_FAST, teacher_forced_loss
from .sysid import apply_theta, theta_init, theta_values
from .train import AdamPlateau, make_train_step

__all__ = ["OnlineConfig", "OnlineAdapter", "OnlineSysIdConfig",
           "OnlineSysId"]


class _TelemetryRing:
    """Host-side telemetry ring buffer shared by the online learners:
    full-state records and applied tensions, with power-of-two window
    bucketing (see OnlineAdapter)."""

    def __init__(self, p: RodParams, window: int, min_fill: int):
        if min_fill < 3:
            raise ValueError("min_fill must be >= 3 (the first transition "
                             "is dropped — see skip_first — so the loss "
                             "needs at least two)")
        if min_fill > window:
            raise ValueError("min_fill cannot exceed window")
        self._window = window
        self._min_fill = min_fill
        N = int(p.N)
        self._n_tendons = int(getattr(p, "n_tendons", 4))
        self._dtype = torch.empty(0, dtype=p.dtype).numpy().dtype
        self._device = p.device
        self._traj = np.zeros((window, N, 25), self._dtype)
        self._ctrl = np.zeros((window, self._n_tendons), self._dtype)
        self._head = 0              # next write slot
        self._count = 0             # total observed (saturates at window)

    def observe(self, record, control) -> None:
        """Append one telemetry step.

        record: (N, >=25) full state [y(19), z(6), ...] (extra channels,
          e.g. yh / zh of 50-wide records, are ignored).
        control: (n_tendons,) applied tendon tensions for this step.
        """
        rec = np.asarray(_host(record), self._dtype)
        if rec.ndim != 2 or rec.shape[0] != self._traj.shape[1] \
                or rec.shape[1] < 25:
            raise ValueError(f"record shape {rec.shape} incompatible with "
                             f"(N={self._traj.shape[1]}, >=25)")
        u = np.asarray(_host(control), self._dtype)
        if u.shape != (self._n_tendons,):
            raise ValueError(f"control shape {u.shape} != "
                             f"({self._n_tendons},) — a scalar would "
                             "silently broadcast into every tendon slot")
        self._traj[self._head] = rec[:, :25]
        self._ctrl[self._head] = u
        self._head = (self._head + 1) % self._window
        self._count = min(self._count + 1, self._window)

    def reset_buffer(self) -> None:
        """Drop buffered telemetry (e.g. across a known discontinuity)
        without touching learned state."""
        self._head = 0
        self._count = 0

    @property
    def ready(self) -> bool:
        return self._count >= self._min_fill

    def _bucket(self) -> int:
        """Largest power-of-two multiple of min_fill that fits the current
        fill (capped at window)."""
        if self._count >= self._window:
            return self._window
        b = self._min_fill
        while b * 2 <= self._count:
            b *= 2
        return min(b, self._window)

    def _ordered_window(self):
        """The most recent ``_bucket()`` frames, oldest first (numpy)."""
        W = self._window
        b = self._bucket()
        if self._count < W:
            t = self._traj[self._count - b: self._count]
            c = self._ctrl[self._count - b: self._count]
        else:
            idx = (np.arange(W - b, W) + self._head) % W
            t, c = self._traj[idx], self._ctrl[idx]
        return t, c

    def _device_window(self):
        """The window as tensors on the rod's device."""
        t, c = self._ordered_window()
        return (torch.from_numpy(t.copy()).to(self._device),
                torch.from_numpy(c.copy()).to(self._device))


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a


@dataclasses.dataclass
class OnlineConfig:
    """Knobs for streaming adaptation (smaller than TrainConfig: no eval
    loop, no plateau schedule, no checkpoints)."""
    window: int = 64            # ring-buffer length (time steps)
    min_fill: int = 8           # steps required before update() trains
    steps_per_update: int = 4   # optimizer steps per update() call
    lr: float = 1e-3
    # decoupled weight decay (AdamW): a small residual off-distribution
    # keeps the hybrid's free rollouts stable
    weight_decay: float = 1e-4
    hidden: int = 64
    keypoints: Tuple[int, ...] = DEFAULT_KEYPOINTS_FAST
    history: bool = False
    activation: str = "elu"
    clamp_weights: bool = True
    seed: int = 0
    # handoff safety: guard=True wires a GuardedTraining watchdog into the
    # loss stream (NaN / divergence -> rollback) AND certifies weights
    # before they reach ``certified_params`` / ``handoff_to``: an H-step
    # free rollout of the hybrid from the newest telemetry must stay finite
    # with the tip inside tip_radius_factor * L, and the window loss must
    # beat the physics-only baseline (times certify_margin).
    guard: bool = True
    probe_horizon: int = 10
    tip_radius_factor: float = 2.0
    certify_margin: float = 1.0
    divergence_factor: float = 1e3
    snapshot_every: int = 8
    # relax the divergence reference 10x per rollback: the plant may
    # legitimately change; certification keeps bad weights from the
    # controller
    guard_forget: float = 10.0

    def spec(self) -> MLPSpec:
        return MLPSpec.for_knode(self.hidden, self.history, self.activation)


# a plateau patience no stream reaches: AdamPlateau as plain Adam / AdamW
_NO_PLATEAU = 2 ** 62


class OnlineAdapter(_TelemetryRing):
    """Streaming KNODE residual learner over a sliding window.

    >>> adapter = OnlineAdapter(model_rod, OnlineConfig())
    >>> for record, u in telemetry:          # record: (N, >=25), u: (4,)
    ...     adapter.observe(record, u)
    ...     if adapter.ready:
    ...         loss = adapter.update()
    >>> adapter.handoff_to(controller)       # the last certified net

    ``model_rod`` is the controller's (imperfect) physics; the residual
    learns what the telemetry source does that the model does not.
    ``params`` is the net being trained (updated in place);
    ``certified_params`` a copy of the last net that passed certification.
    ``params`` may be given (a KnodeMLP of ``cfg.spec()``, e.g. a JAX net
    through models.mlp.params_from_jax); by default it is init_mlp from a
    generator seeded with ``cfg.seed``.
    """

    def __init__(self, p: RodParams, cfg: Optional[OnlineConfig] = None,
                 params=None):
        self.p = p
        self.cfg = cfg = cfg or OnlineConfig()
        if cfg.steps_per_update < 1:
            raise ValueError("steps_per_update must be >= 1")
        super().__init__(p, cfg.window, cfg.min_fill)
        self.spec = cfg.spec()
        self.params = params if params is not None else init_mlp(
            self.spec, torch.Generator().manual_seed(cfg.seed),
            device=p.device)
        self.opt_state = AdamPlateau(self.params.parameters(), lr=cfg.lr,
                                     weight_decay=cfg.weight_decay,
                                     patience=_NO_PLATEAU)
        # skip_first: a window's first transition runs on a fabricated
        # self-prev BDF-2 history; drop it
        self._step, self._total_loss = make_train_step(
            p, self.spec, self.opt_state, cfg.keypoints, cfg.clamp_weights,
            skip_first=True)
        self.updates = 0
        self.last_loss: Optional[float] = None
        self._guard = (GuardedTraining(self.params, self.opt_state,
                                       cfg.divergence_factor,
                                       cfg.snapshot_every,
                                       forget=cfg.guard_forget)
                       if cfg.guard else None)
        self._certified = None
        self.certified_updates = 0
        self.rejected_updates = 0
        self.last_reject_reason: Optional[str] = None

    def _loss(self, net, t, c) -> float:
        with torch.no_grad():
            return float(self._total_loss(net, t[None], c[None]))

    # ----------------------------------------------------- handoff guard

    @torch.no_grad()
    def _probe(self, net, last, prev, ctl) -> bool:
        """H-step free rollout of the hybrid from the newest telemetry
        frames under the window's most recent controls (what a
        receding-horizon planner consumes, control/mpc.rollout_tips). Passes
        iff every predicted tip is finite and within
        tip_radius_factor * L of the clamped base."""
        from ..control.mpc import PlanState, rollout_tips

        p = self.p
        G0 = torch.zeros(6, dtype=p.dtype, device=p.device)
        st = PlanState(last[:, :19], last[:, 19:25], prev[:, :19],
                       prev[:, 19:25], G0, G0)
        tips, _ = rollout_tips(p, st, ctl, self.spec, net)
        radius = self.cfg.tip_radius_factor * float(p.L)
        return bool(torch.isfinite(tips).all()
                    and torch.linalg.vector_norm(tips, dim=-1).max()
                    <= radius)

    def _certify(self, t, c) -> None:
        """Gate the just-trained weights behind the handoff contract."""
        win = self._loss(self.params, t, c)
        phys = self._loss(None, t, c)
        if not math.isfinite(win) or win > self.cfg.certify_margin * phys:
            self.rejected_updates += 1
            self.last_reject_reason = (
                f"window loss {win:.3e} vs physics {phys:.3e} "
                f"(margin {self.cfg.certify_margin})")
            return
        H = min(self.cfg.probe_horizon, t.shape[0] - 1)
        if not self._probe(self.params, t[-1], t[-2], c[-H:]):
            self.rejected_updates += 1
            self.last_reject_reason = (
                f"free-rollout probe failed over {H} steps "
                f"(non-finite or tip outside "
                f"{self.cfg.tip_radius_factor} * L)")
            return
        self._certified = copy.deepcopy(self.params)
        self.certified_updates += 1
        self.last_reject_reason = None

    @property
    def certified_params(self):
        """The last net that PASSED certification (None until one does):
        the sanctioned controller handoff. Requires cfg.guard."""
        return self._certified

    def handoff_to(self, controller) -> bool:
        """Give the last certified net to a controller (anything with an
        ``nn_params`` attribute, e.g. control.mpc.MPCController). Returns
        False, and leaves the controller untouched, if none is certified."""
        if self._certified is None:
            return False
        controller.nn_params = self._certified
        return True

    # ----------------------------------------------------------- learn

    def update(self) -> Optional[float]:
        """cfg.steps_per_update optimizer steps on the current window.
        Returns the last step's loss (None if the buffer is not ready)."""
        if not self.ready:
            return None
        t, c = self._device_window()
        for _ in range(self.cfg.steps_per_update):
            loss = self._step(self.params, t[None], c[None])
        self.updates += 1
        self.last_loss = float(loss)
        if self._guard is not None:
            _, _, reset = self._guard.update(self.params, self.opt_state,
                                             self.last_loss)
            if reset:
                self.rejected_updates += 1
                self.last_reject_reason = (
                    f"loss stream diverged ({self.last_loss:.3e}); "
                    "rolled back to snapshot")
            else:
                self._certify(t, c)
        return self.last_loss

    def window_loss(self) -> Optional[float]:
        """Teacher-forced loss of the current net on the current window,
        without training."""
        if not self.ready:
            return None
        return self._loss(self.params, *self._device_window())

    def physics_loss(self) -> Optional[float]:
        """The no-net baseline loss on the current window."""
        if not self.ready:
            return None
        return self._loss(None, *self._device_window())


@dataclasses.dataclass
class OnlineSysIdConfig:
    """Knobs for streaming physical-parameter tracking."""
    fields: Tuple[str, ...] = ("E",)
    window: int = 64
    min_fill: int = 8
    steps_per_update: int = 4
    lr: float = 0.05            # log-space Adam: relative steps
    keypoints: Tuple[int, ...] = DEFAULT_KEYPOINTS_FAST
    seed: int = 0
    # loss-stream watchdog (NaN / divergence -> roll theta back)
    guard: bool = True
    divergence_factor: float = 1e3
    snapshot_every: int = 8
    # the plant drifting is the use case here: accept a sustained jump
    # after a few rollbacks (see OnlineConfig.guard_forget)
    guard_forget: float = 10.0


class OnlineSysId(_TelemetryRing):
    """Streaming PHYSICAL-PARAMETER tracking over the telemetry window,
    the grey-box sibling of :class:`OnlineAdapter` (training/sysid.py's
    differentiable derive and log-space Adam on the skip_first teacher
    loss).

    >>> tracker = OnlineSysId(model_rod, OnlineSysIdConfig(fields=("E",)))
    >>> for record, u in telemetry:
    ...     tracker.observe(record, u)
    ...     if tracker.ready:
    ...         tracker.update()
    >>> tracker.values()["E"]        # live estimate
    >>> p_now = tracker.rod          # fully derived fitted RodParams

    Consumers that built something for one rod (MPCController, K2's
    wrapper) must be rebuilt to adopt ``rod``.
    """

    def __init__(self, p: RodParams, cfg: Optional[OnlineSysIdConfig] = None):
        self.p = p
        self.cfg = cfg = cfg or OnlineSysIdConfig()
        if cfg.steps_per_update < 1:
            raise ValueError("steps_per_update must be >= 1")
        super().__init__(p, cfg.window, cfg.min_fill)
        self.theta = {k: v.requires_grad_(True)
                      for k, v in theta_init(p, cfg.fields).items()}
        self.opt_state = AdamPlateau([self.theta[k] for k in sorted(
            self.theta)], lr=cfg.lr, patience=_NO_PLATEAU)
        self._spec = MLPSpec.for_knode()
        self._guard = (GuardedTraining(self.theta, self.opt_state,
                                       cfg.divergence_factor,
                                       cfg.snapshot_every,
                                       forget=cfg.guard_forget)
                       if cfg.guard else None)
        self.updates = 0
        self.last_loss: Optional[float] = None
        self.rollbacks = 0

    def _loss_fn(self, t, c):
        return teacher_forced_loss(apply_theta(self.p, self.theta),
                                   self._spec, None, t, c,
                                   tuple(self.cfg.keypoints), skip_first=True)

    def update(self) -> Optional[float]:
        """cfg.steps_per_update log-space Adam steps on the current window;
        the optimizer state persists across calls."""
        if not self.ready:
            return None
        t, c = self._device_window()
        for _ in range(self.cfg.steps_per_update):
            self.opt_state.zero_grad(set_to_none=True)
            with torch.enable_grad():
                loss = self._loss_fn(t, c)
                loss.backward()
            self.opt_state.step(loss.detach())
        self.updates += 1
        self.last_loss = float(loss.detach())
        if self._guard is not None:
            _, _, reset = self._guard.update(self.theta, self.opt_state,
                                             self.last_loss)
            self.rollbacks += int(reset)
        return self.last_loss

    def values(self):
        """Current physical-space estimates per tracked field."""
        return theta_values(self.theta)

    @property
    def rod(self) -> RodParams:
        """Fully derived RodParams at the current estimate."""
        with torch.no_grad():
            return apply_theta(self.p, self.theta)

    def window_loss(self) -> Optional[float]:
        """Loss of the current estimate on the window, without training."""
        if not self.ready:
            return None
        with torch.no_grad():
            return float(self._loss_fn(*self._device_window()))
