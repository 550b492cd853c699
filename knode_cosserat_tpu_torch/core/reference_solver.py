"""Reference-solver emulation: the rollout driven by scipy's MINPACK
``fsolve`` (Powell hybrid trust region) on the host.

PyTorch counterpart of ``knode_cosserat_tpu/core/reference_solver.py``.
The product rollouts (core/stepper.simulate, the K2 rollout) use the
damped-Newton/LM solver and converge to the same roots to solver
tolerance. Studies that need the REFERENCE'S exact solver behaviour
(knode.py:85-94 calls scipy.optimize.fsolve with its default
xtol=1.49e-8 and a warm start at the previous step's G, then falls back
to L-BFGS-B when fsolve reports non-convergence) use this mode: the same
MINPACK algorithm over this package's float64 residual.

The residual runs on the rod's device; MINPACK runs on the host, so every
residual call copies G (6 numbers) to the device and the residual (6)
back: one synchronisation per call on a CUDA device. Deliberately
host-bound and slow (one fsolve per time step, like the reference): a
validation oracle, not a production path.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .params import RodParams
from .spatial import integrate_euler, integrate_rk4, tip_residual
from .stepper import initial_state

__all__ = ["simulate_fsolve"]


@torch.no_grad()
def simulate_fsolve(
    p: RodParams,
    controls,
    nn_fn: Optional[Callable] = None,
    nn_history: bool = False,
    method: str = "euler",
    reference_layout: bool = False,
    lbfgsb_fallback: bool = True,
) -> np.ndarray:
    """Rollout with scipy.optimize.fsolve as the shooting solver: the
    reference's exact solver stack (knode.py:55-102), including the
    [:-1]-drop / frozen-tip-z / [y, z, yh, zh] record quirks and the
    L-BFGS-B rescue on fsolve non-convergence (knode.py:91-94).

    Requires a float64 rod (MINPACK is double precision). Returns the
    (T, N, 50) trajectory as a numpy array (or (T, 50, N) with
    reference_layout=True).
    """
    from scipy.optimize import fsolve, minimize

    if p.dtype != torch.float64:
        raise ValueError("simulate_fsolve requires a float64 rod "
                         "(MINPACK hybrd is double precision)")
    if method == "euler":
        def integrate(G, yh, zh, tf):
            return integrate_euler(p, G, yh, zh, tf, nn_fn, nn_history)
    elif method == "rk4":
        def integrate(G, yh, zh, tf):
            yh_int = 0.5 * (yh[:-1] + yh[1:])
            zh_int = 0.5 * (zh[:-1] + zh[1:])
            return integrate_rk4(p, G, yh, zh, yh_int, zh_int, tf, nn_fn,
                                 nn_history)
    else:
        raise ValueError(f"unknown method {method!r}")

    controls = np.asarray(controls, np.float64)
    T = controls.shape[0]
    dev = p.device
    y, z = initial_state(p)
    y_prev, z_prev = y, z
    z_tip = z[-1:]
    G = np.zeros(6)
    dirs = p.tendon_dirs.detach().cpu().numpy().astype(np.float64)
    on_dev = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)

    records = [torch.cat([y, z, y, z], dim=-1).cpu()]
    for t in range(T - 1):
        yh = p.c1 * y + p.c2 * y_prev
        zh = p.c1 * z + p.c2 * z_prev
        tf = on_dev(controls[t] @ dirs)

        def res(Gx):
            r = tip_residual(p, integrate(on_dev(Gx), yh, zh, tf)[0])
            return r.cpu().numpy()

        G_new, _, ier, _ = fsolve(res, G, full_output=True)
        if ier != 1 and lbfgsb_fallback:
            # knode.py:91-94: minimize ||r||^2 with L-BFGS-B from the
            # fsolve result when MINPACK gives up
            out = minimize(lambda Gx: float(np.sum(res(Gx) ** 2)), G_new,
                           method="L-BFGS-B")
            G_new = out.x
        y_new, z_body = integrate(on_dev(G_new), yh, zh, tf)
        z_new = torch.cat([z_body, z_tip], dim=0)
        records.append(torch.cat([y_new, z_new, yh, zh], dim=-1).cpu())
        y_prev, z_prev = y, z
        y, z, G = y_new, z_new, G_new

    traj = torch.stack(records).numpy()
    if reference_layout:
        traj = np.swapaxes(traj, 1, 2)
    return traj
