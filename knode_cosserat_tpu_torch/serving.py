"""Serving: fixed-shape BDF-2 steppers for control loops.

PyTorch counterpart of ``knode_cosserat_tpu/serving.py``. A deployment
calls one BDF-2 step (or a short horizon) at fixed shapes inside a
real-time loop: model-predictive control of the physical robot, or a
digital twin next to the firmware. There is no ahead-of-time compile here:
the constructor resolves the step function, and the CUDA kernels are built
at their first launch (ops/_build.py).

``fast=True`` serves through the fast step: on a CUDA rod that is the K2
kernel (``impl="mega"``), on a CPU rod the plain FD-Newton driver
(``impl="plain"``). The choice is made by the rod's device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import torch

from .core.params import RodParams
from .core.shooting import newton_solve
from .core.spatial import integrate_euler, tip_residual
from .core.stepper import initial_state, tendon_forces
from .models.mlp import KnodeMLP, MLPSpec
from .utils.profiling import annotate, new_call

__all__ = ["StepState", "CompiledStepper"]


@dataclasses.dataclass
class StepState:
    """Carry of the BDF-2 recurrence for one (possibly batched) rod."""
    y: torch.Tensor        # (..., N, 19)
    z: torch.Tensor        # (..., N, 6)
    y_prev: torch.Tensor
    z_prev: torch.Tensor
    G: torch.Tensor        # (..., 6)


class CompiledStepper:
    """A single BDF-2 step of the (hybrid) rod at fixed shapes.

    Args:
      p: rod parameters; their device is where the stepper runs.
      spec/nn_params: optional KNODE residual (a KnodeMLP on the rod's
        device and dtype).
      batch: None for a single rod or an int for a batch of rods stepping
        together (e.g. MPC candidate rollouts).
      fast: serve through the fast step (module docstring); fast_impl
        overrides its impl ("mega", "sweep" or "plain").
    """

    def __init__(self, p: RodParams, spec: Optional[MLPSpec] = None,
                 nn_params: Optional[KnodeMLP] = None,
                 batch: Optional[int] = None, tol: float = 1e-10,
                 max_iter: int = 20, fast: bool = False,
                 fast_impl: Optional[str] = None):
        self.p = p
        self.spec = spec
        self.batch = batch
        self._nn_params = nn_params if spec is not None else None

        if fast:
            from .core.fast_rollout import make_fast_step

            impl = fast_impl or ("mega" if p.device.type == "cuda"
                                 else "plain")
            inner = make_fast_step(p, spec, tol=tol, max_iter=max_iter,
                                   impl=impl)

            def one_step(nn_params, y, z, y_prev, z_prev, G, tensions):
                y_n, z_n, G_n, r2, _ = inner(y, z, y_prev, z_prev, G,
                                             tensions, nn_params)
                return y_n, z_n, G_n, r2.max().sqrt()
        else:
            def one_step(nn_params, y, z, y_prev, z_prev, G, tensions):
                nn_fn = nn_params
                history = spec.history if spec is not None else False
                yh = p.c1 * y + p.c2 * y_prev
                zh = p.c1 * z + p.c2 * z_prev
                tf = tendon_forces(p, tensions)

                def res(Gx):
                    yi, _ = integrate_euler(p, Gx, yh, zh, tf, nn_fn, history)
                    return tip_residual(p, yi)

                G_new, stats = newton_solve(res, G, tol=tol,
                                            max_iter=max_iter)
                y_new, z_body = integrate_euler(p, G_new, yh, zh, tf, nn_fn,
                                                history)
                z_new = torch.cat([z_body, z[:, -1:]], dim=1)
                return y_new, z_new, G_new, stats.residual_norm

        self._fn = one_step

    def reset(self) -> StepState:
        y0, z0 = initial_state(self.p)
        G0 = torch.zeros(6, dtype=self.p.dtype, device=self.p.device)
        if self.batch is not None:
            rep = lambda a: a.expand((self.batch,) + a.shape).contiguous()
            y0, z0, G0 = rep(y0), rep(z0), rep(G0)
        return StepState(y=y0, z=z0, y_prev=y0, z_prev=z0, G=G0)

    @torch.no_grad()
    def step(self, state: StepState, tensions) -> Tuple[StepState, dict]:
        """Advance one del_t. tensions: (4,) or (batch, 4) newtons."""
        new_call()
        with annotate("serve.step"):
            tensions = torch.as_tensor(tensions, dtype=self.p.dtype,
                                       device=self.p.device)
            one = self.batch is None
            up = (lambda a: a[None]) if one else (lambda a: a)
            down = (lambda a: a[0]) if one else (lambda a: a)
            y_new, z_new, G_new, res = self._fn(
                self._nn_params, up(state.y), up(state.z), up(state.y_prev),
                up(state.z_prev), up(state.G), up(tensions))
            res = res if res.dim() == 0 else down(res)
            new = StepState(y=down(y_new), z=down(z_new), y_prev=state.y,
                            z_prev=state.z, G=down(G_new))
        return new, {"residual": res}

    def benchmark(self, n: int = 100, reps: int = 3) -> dict:
        """Steady-state step latency: best of ``reps`` loops of ``n`` chained
        steps. On a CUDA rod the loop is timed with CUDA events and ends in
        ``torch.cuda.synchronize()``; on a CPU rod with the host clock. The
        result names the device it was measured on."""
        state = self.reset()
        shape = (4,) if self.batch is None else (self.batch, 4)
        tensions = torch.full(shape, 5.0, dtype=self.p.dtype,
                              device=self.p.device)
        state, _ = self.step(state, tensions)            # warm (and build)
        cuda = self.p.device.type == "cuda"
        dt = float("inf")
        for _ in range(reps):
            if cuda:
                torch.cuda.synchronize(self.p.device)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(n):
                    state, _ = self.step(state, tensions)
                end.record()
                torch.cuda.synchronize(self.p.device)
                dt = min(dt, start.elapsed_time(end) / 1e3 / n)
            else:
                t0 = time.perf_counter()
                for _ in range(n):
                    state, _ = self.step(state, tensions)
                dt = min(dt, (time.perf_counter() - t0) / n)
        device = (torch.cuda.get_device_name(self.p.device) if cuda
                  else "cpu")
        return {"latency_ms": dt * 1e3,
                "steps_per_sec": (self.batch or 1) / dt,
                "realtime_factor": float(self.p.del_t) / dt,
                "device": device}
