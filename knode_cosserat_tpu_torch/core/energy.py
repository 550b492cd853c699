"""Mechanical energy budgets of a rod trajectory — a validation subsystem
the reference does not have (its only physics checks are
residual-at-a-known-root ``__main__`` blocks).

PyTorch counterpart of ``knode_cosserat_tpu/core/energy.py``. For the
tendon-driven Cosserat rod (state conventions cosserat_ode.py:114-130;
25-state rows [p, h, n, m, q, w | v, u]):

  elastic   E_e = 1/2 integral (v - v*)^T Kse (v - v*) + u^T Kbt u  ds
  kinetic   E_k = 1/2 integral rho A |q|^2 + w^T (rho J) w          ds
            (q, w are LOCAL-frame velocities; the rotation drops out of
            the quadratic forms)
  potential E_p = - integral rho A g . p                            ds

Integrals use trapezoidal weights over the N nodes. With tendons slack
(zero tension) the only non-conservative terms are the material damping
(Bse/Bbt) and square-law air drag (C), both strictly dissipative — so
total mechanical energy must decrease monotonically on an unforced
rollout. Results are tensors on the rod's device.
"""
from __future__ import annotations

from typing import Dict

import torch

from .params import RodParams

__all__ = ["rod_energies", "assembly_energies", "energy_summary"]


def _trapezoid_weights(N: int, dtype, device) -> torch.Tensor:
    w = torch.ones((N,), dtype=dtype, device=device)
    w[0] = w[-1] = 0.5
    return w


def _rod_energy_terms(p: RodParams, x: torch.Tensor):
    """(elastic, kinetic, potential) (T,) tensors for x (T, N, 25)."""
    ppos = x[..., 0:3]
    q = x[..., 13:16]
    w = x[..., 16:19]
    v = x[..., 19:22]
    u = x[..., 22:25]

    wts = _trapezoid_weights(x.shape[1], x.dtype, x.device) * p.ds

    dv = v - p.vstar
    elastic = 0.5 * torch.einsum("n,tni,ij,tnj->t", wts, dv, p.Kse, dv)
    elastic = elastic + 0.5 * torch.einsum(
        "n,tni,ij,tnj->t", wts, u, p.Kbt, u)
    kinetic = 0.5 * p.rhoA * torch.einsum("n,tni,tni->t", wts, q, q)
    kinetic = kinetic + 0.5 * torch.einsum("n,tni,ij,tnj->t", wts, w,
                                           p.rhoJ, w)
    potential = -p.rhoA * torch.einsum("n,tni,i->t", wts, ppos, p.g)
    return elastic, kinetic, potential


def rod_energies(p: RodParams, traj) -> Dict[str, torch.Tensor]:
    """Energy time series of a trajectory.

    Args:
      traj: (T, N, >=25) state-last rollout rows (SimOutput.traj works
        directly; extra history channels are ignored); a tensor or array.
    Returns:
      dict of (T,) tensors: elastic, kinetic, potential, total
      (total = elastic + kinetic + potential).
    """
    traj = torch.as_tensor(traj)
    if traj.ndim != 3 or traj.shape[-1] < 25:
        raise ValueError(f"traj must be (T, N, >=25), got {tuple(traj.shape)}")
    x = traj[..., :25].to(device=p.device, dtype=p.dtype)
    elastic, kinetic, potential = _rod_energy_terms(p, x)
    return {
        "elastic": elastic,
        "kinetic": kinetic,
        "potential": potential,
        "total": elastic + kinetic + potential,
    }


def assembly_energies(asm, traj, plate_pose) -> Dict[str, torch.Tensor]:
    """Energy time series of a coupled-assembly rollout
    (core/assembly.simulate_assembly output).

    Rod budgets sum the single-rod terms over the M rods (each with its own
    parameters); the plate's velocities are reconstructed with the SAME
    BDF-2 backward differences the coupled solver uses internally (exact
    for t >= 2; t < 2 uses rest / first-order), so the dissipation identity
    holds to solver precision, not finite-difference precision.

    Args:
      traj: (T, M, N, >=25); plate_pose: (T, 7) [p, h].
    Returns:
      dict of (T,) tensors: elastic, kinetic, potential, total (assembly-
      wide sums) plus plate_kinetic / plate_potential for introspection.
    """
    from .assembly import _body_angular_velocity

    rods = asm.rods
    dtype, device = rods[0].dtype, rods[0].device
    traj = torch.as_tensor(traj)
    plate_pose = torch.as_tensor(plate_pose)
    if traj.ndim != 4 or traj.shape[-1] < 25:
        raise ValueError(f"traj must be (T, M, N, >=25), got "
                         f"{tuple(traj.shape)}")
    if asm.plate.has_contact:
        # the smoothed penalty k*softplus(-beta*gap)/beta stores energy
        # whose antiderivative is a dilogarithm — not counted here, so the
        # dissipation identity would be silently wrong during contact
        raise ValueError(
            "assembly_energies does not support contact assemblies: the "
            "smoothed plane-contact springs store energy this budget "
            "does not count (non-elementary potential). Evaluate the "
            "contact-free system, or a far plane before contact.")
    x = traj[..., :25].to(device=device, dtype=dtype)
    terms = [_rod_energy_terms(p, x[:, m]) for m, p in enumerate(rods)]
    elastic, kinetic, potential = (torch.stack(t).sum(0)
                                   for t in zip(*terms))

    # plate kinematics via the solver's BDF-2 combination
    p0 = rods[0]
    c0, c1, c2, del_t = p0.c0, p0.c1, p0.c2, p0.del_t
    pp = plate_pose[:, 0:3].to(device=device, dtype=dtype)
    hp = plate_pose[:, 3:7].to(device=device, dtype=dtype)

    def bdf2_rate(a):
        r = c0 * a[2:] + c1 * a[1:-1] + c2 * a[:-2]
        r1 = ((a[1] - a[0]) / del_t)[None]
        r0 = torch.zeros_like(a[:1])
        return torch.cat([r0, r1, r], dim=0)

    vp = bdf2_rate(pp)                                     # (T, 3)
    hdot = bdf2_rate(hp)                                   # (T, 4)
    wb = _body_angular_velocity(hp, hdot)                  # (T, 3)

    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    m = as_t(asm.plate.mass)
    inertia = as_t(asm.plate.inertia)
    g = as_t(asm.plate.g)
    plate_kin = (0.5 * m * torch.einsum("ti,ti->t", vp, vp)
                 + 0.5 * torch.einsum("ti,ij,tj->t", wb, inertia, wb))
    plate_pot = -m * torch.einsum("ti,i->t", pp, g)
    kinetic = kinetic + plate_kin
    potential = potential + plate_pot
    return {
        "elastic": elastic,
        "kinetic": kinetic,
        "potential": potential,
        "plate_kinetic": plate_kin,
        "plate_potential": plate_pot,
        "total": elastic + kinetic + potential,
    }


def energy_summary(p: RodParams, traj) -> str:
    """One-line human summary (CLI `simulate --energy`)."""
    e = rod_energies(p, traj)
    tot = e["total"]
    return (f"energy [J]: elastic {float(e['elastic'][-1]):.3e}, "
            f"kinetic {float(e['kinetic'][-1]):.3e}, "
            f"potential {float(e['potential'][-1]):.3e}; "
            f"total {float(tot[0]):.3e} -> {float(tot[-1]):.3e}")
