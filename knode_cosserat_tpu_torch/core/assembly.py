"""Multi-rod assemblies: parallel continuum robots.

PyTorch counterpart of ``knode_cosserat_tpu/core/assembly.py``. M
Cosserat rods are clamped to a fixed base and attached to one rigid END
PLATE; each BDF-2 time step solves the coupled boundary-value problem as
ONE damped Newton iteration over

  unknowns  X = [G_1 .. G_M (6 each), p_plate (3), h_plate (4)]  (U = 6M+7)
  residual  R = [tip position constraints    (3 per rod)
                 tip orientation constraints (3 per rod)
                 plate Newton (force) balance (3)
                 plate Euler (moment) balance (3)
                 plate quaternion unit norm   (1)]

The JAX package stacks the rods' parameters on a leading axis and vmaps
the sweeps. Here ``RodAssembly.rods`` is a tuple of M rods (one
RodParams each, as the rest of the port uses them), and
``RodAssembly.stacked_rods()`` stacks their leaves once so that
core/rhs.py advances all M rods together (rods with their own nets run
one by one). Every other axis broadcasts: the residual takes any number
of leading axes in front of X's, so the Jacobians (one replicated
reverse pass, core/multiple_shooting.jacobian) and the line search's
candidates each take one residual call.

A batch of B systems of the same assembly (the JAX package's
``jax.vmap`` over simulate_assembly, the planners' restarts): X (B, U)
against histories (B, M, N, 19), (B, M, N, 6), tendon forces (B, M, 3)
and plate histories (B, 3 | 4); a probe or candidate axis sits in front
of B, so histories pair with their own system only. The rods, the plate
and the nets are shared. ``controls`` (B, T, M, n_tendons) gives every
output of simulate_assembly a leading B; each system's Newton runs under
its own mask (core/multiple_shooting._newton_loop_batched), so system b's
results are its unbatched solve's.

Solvers: ``"structured"`` builds the arrowhead Jacobian from the per-rod
tip Jacobians (13 x 6 each) and the plate algebra's; ``"dense"``
differentiates the whole residual; ``"auto"`` takes structured on the CPU
and dense on any other device (the JAX package's rule, by backend there).
``fused=True`` solves each step with kernel K7 (ops/assembly.py).

Physics conventions as in the JAX package: y[7:10] = n, y[10:13] = m are
world-frame internal force/moment, so rod i pushes on the plate with
(-n_i(L), -m_i(L)) at its attachment point; tendon tension is a
distributed body force only; the plate's translation and rotation use the
rods' BDF-2 history scheme with rod 0's coefficients c0/c1/c2.
"""
from __future__ import annotations

import dataclasses
import types
from functools import partial
from typing import Any, Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..device import default_device
from ..models.mlp import ACTIVATIONS
from ..ops.quaternion import quat_to_rotmat
from .multiple_shooting import (_lm_damped_solve, _newton_dense, _newton_loop,
                                jacobian)
from .params import RodParams, make_rod, rod_from_numpy, stack_params
from .rhs import _cross, _mv, _mv_t, rhs
from .shooting import NewtonStats, implicit_root
from .spatial import integrate_euler

__all__ = ["PlateParams", "RodAssembly", "make_ring_assembly", "stack_rods",
           "with_contact_plane", "assembly_solve_step", "assembly_step_carry",
           "AssemblyCarry", "simulate_assembly", "AssemblySimOutput",
           "assembly_from_jax", "carry_from_jax", "MAX_FUSED_RODS"]

#: the most rods K7 takes (the JAX kernel's 2(6M+7)+1 <= 128 probe lanes)
MAX_FUSED_RODS = 9


# ------------------------------------------------------------ quaternions

def _quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product, [w, x, y, z] convention (ops/quaternion)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def _quat_conj(a: torch.Tensor) -> torch.Tensor:
    return torch.cat([a[..., :1], -a[..., 1:]], dim=-1)


def _body_angular_velocity(h: torch.Tensor, hdot: torch.Tensor):
    """omega_body = 2 * vec(conj(h) * hdot) for (near-)unit h."""
    return 2.0 * _quat_mul(_quat_conj(h), hdot)[..., 1:4]


# ------------------------------------------------------------- parameters

@dataclasses.dataclass(frozen=True)
class PlateParams:
    """Rigid end plate: mass/inertia + per-rod attachment geometry.

    attach_offsets: (M, 3) attachment points in the PLATE body frame,
      relative to the plate's center of mass. attach_quats: (M, 4) fixed
      rotation from the plate frame to each rod's tip frame. mass = 0 and
      inertia = 0 model a massless coupler (static plate equilibrium).

    Contact (``has_contact``): one rigid plane n . x = c (contact_plane =
    [n (unit), c]) touched through contact_points (Kc, 3, plate frame) by
    a smoothed penalty: k * softplus(-beta * gap) / beta plus approach-rate
    damping gated by sigmoid(-beta * gap)."""
    mass: Any
    inertia: Any            # (3, 3), plate body frame
    attach_offsets: Any     # (M, 3)
    attach_quats: Any       # (M, 4)
    g: Any                  # (3,) gravity (world)
    contact_plane: Any = None
    contact_points: Any = None
    contact_k: Any = None
    contact_d: Any = None
    contact_beta: Any = None
    has_contact: bool = False

    def replace(self, **kw) -> "PlateParams":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class RodAssembly:
    """M rods + the rigid plate coupling them. ``rods`` is a tuple of M
    RodParams sharing N, n_tendons and del_t (see :func:`stack_rods`)."""
    M: int
    rods: tuple
    plate: PlateParams
    p_plate0: Any           # (3,) plate initial pose
    h_plate0: Any           # (4,)
    # the rods' leaves stacked (stacked_rods), made at first use
    _cache: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False, compare=False)

    def replace(self, **kw) -> "RodAssembly":
        return dataclasses.replace(self, **kw)

    @property
    def dtype(self) -> torch.dtype:
        return self.p_plate0.dtype

    @property
    def device(self) -> torch.device:
        return self.p_plate0.device

    @property
    def N(self) -> int:
        return self.rods[0].N

    def stacked_rods(self) -> RodParams:
        """The rods as one stack (core/params.stack_params: scalars (M, 1),
        vectors (M, k), matrices (M, 3, 3)), so core/rhs.py evaluates all
        M rods in one call (the JAX package's vmap over stacked rods)."""
        if "rods" not in self._cache:
            self._cache["rods"] = stack_params(self.rods)
        return self._cache["rods"]


def stack_rods(rods: Sequence[RodParams]) -> tuple:
    """The rods of an assembly, checked: all must share N, n_tendons and
    del_t (the coupled step applies rod 0's BDF-2 coefficients to every
    rod and the plate, so a del_t mismatch would converge to an
    inconsistent time discretization). The JAX package stacks the leaves
    on a leading axis; the port keeps the tuple (module docstring)."""
    r0 = rods[0]
    dt0 = float(r0.del_t)
    for r in rods[1:]:
        if r.N != r0.N or r.n_tendons != r0.n_tendons:
            raise ValueError("all rods in an assembly must share N and "
                             "n_tendons")
        if float(r.del_t) != dt0:
            raise ValueError("all rods in an assembly must share del_t "
                             f"(got {float(r.del_t)} vs {dt0})")
    return tuple(rods)


def make_ring_assembly(
    n_rods: int = 3,
    base_radius: float = 0.05,
    plate_mass: float = 0.0,
    plate_inertia: Optional[np.ndarray] = None,
    N: int = 10,
    dtype: torch.dtype = torch.float64,
    rod_fn: Optional[Callable[..., RodParams]] = None,
    device=None,
    **rod_overrides,
) -> RodAssembly:
    """M identical vertical rods on a base circle of ``base_radius``, tips
    attached to a rigid plate in the same radial pattern (the canonical
    parallel-continuum-robot geometry). rod_fn(N=, dtype=, device=, p0=,
    **rod_overrides) -> RodParams defaults to core.params.make_rod (the
    paper rod). Builds on the CUDA card unless ``device`` says otherwise."""
    device = default_device(device)
    rod_fn = rod_fn or make_rod
    ang = 2.0 * np.pi * np.arange(n_rods) / n_rods
    bases = np.stack([base_radius * np.cos(ang), base_radius * np.sin(ang),
                      np.zeros(n_rods)], axis=-1)
    rods = stack_rods([rod_fn(N=N, dtype=dtype, device=device, p0=bases[i],
                              **rod_overrides) for i in range(n_rods)])
    L = float(rods[0].L)
    inertia = (np.zeros((3, 3)) if plate_inertia is None
               else np.asarray(plate_inertia, np.float64))
    cast = lambda x: torch.as_tensor(np.asarray(x, np.float64)).to(
        device=device, dtype=rods[0].dtype)
    plate = PlateParams(mass=cast(plate_mass), inertia=cast(inertia),
                        attach_offsets=cast(bases),
                        attach_quats=cast(np.tile([1.0, 0.0, 0.0, 0.0],
                                                  (n_rods, 1))),
                        g=rods[0].g.clone())
    return RodAssembly(M=n_rods, rods=rods, plate=plate,
                       p_plate0=cast([0.0, 0.0, L]),
                       h_plate0=cast([1.0, 0.0, 0.0, 0.0]))


def with_contact_plane(asm: RodAssembly, normal, offset: float, points=None,
                       k: float = 1e4, d: float = 50.0,
                       beta: float = 2000.0) -> RodAssembly:
    """A copy of ``asm`` whose plate can touch the rigid plane
    n . x = offset. points: (Kc, 3) contact points in the plate frame
    (default: the attachment ring); k / d: penalty stiffness / approach
    damping per point; beta: smoothing sharpness (1/m)."""
    n = np.asarray(normal, np.float64)
    norm = np.linalg.norm(n)
    if n.shape != (3,) or not np.isfinite(norm) or norm < 1e-12:
        raise ValueError(f"contact plane normal {normal!r} must be a "
                         "finite nonzero 3-vector (a zero normal would "
                         "silently poison the solve with NaNs)")
    cast = lambda x: torch.as_tensor(np.asarray(x, np.float64)).to(
        device=asm.device, dtype=asm.dtype)
    pts = (asm.plate.attach_offsets if points is None
           else cast(np.asarray(points, np.float64)))
    plate = asm.plate.replace(
        contact_plane=cast(np.concatenate([n / norm, [float(offset)]])),
        contact_points=pts, contact_k=cast(k), contact_d=cast(d),
        contact_beta=cast(beta), has_contact=True)
    return asm.replace(plate=plate)


def assembly_from_jax(asm, dtype: torch.dtype | None = None,
                      device=None) -> RodAssembly:
    """The JAX package's RodAssembly -> the port's, leaf for leaf (no
    re-derivation). Every leaf is read through ``np.asarray``; ``dtype``
    defaults to the leaves' own, ``device`` to the CUDA card."""
    device = default_device(device)
    M = int(asm.M)
    names = [f.name for f in dataclasses.fields(RodParams)]
    rods = []
    for i in range(M):
        leaves = {}
        for name in names:
            v = getattr(asm.rods, name)
            leaves[name] = (v if name in ("N", "n_tendons") or v is None
                            else np.asarray(v)[i])
        rods.append(rod_from_numpy(types.SimpleNamespace(**leaves), dtype,
                                   device))
    rods = stack_rods(rods)
    dt = rods[0].dtype
    cast = lambda v: None if v is None else torch.from_numpy(
        np.array(v)).to(device=device, dtype=dt)
    pl = asm.plate
    plate = PlateParams(
        mass=cast(pl.mass), inertia=cast(pl.inertia),
        attach_offsets=cast(pl.attach_offsets),
        attach_quats=cast(pl.attach_quats), g=cast(pl.g),
        contact_plane=cast(pl.contact_plane),
        contact_points=cast(pl.contact_points), contact_k=cast(pl.contact_k),
        contact_d=cast(pl.contact_d), contact_beta=cast(pl.contact_beta),
        has_contact=bool(pl.has_contact))
    return RodAssembly(M=M, rods=rods, plate=plate,
                       p_plate0=cast(asm.p_plate0),
                       h_plate0=cast(asm.h_plate0))


# --------------------------------------------------------------- residual

def _sweep_all(asm: RodAssembly, G, yh, zh, tf, nn_fn, nn_history,
               nn_spec=None, nn_params=None):
    """All M rod sweeps: G (..., M, 6), yh ([B,] M, N, 19), zh ([B,] M,
    N, 6), tf ([B,] M, 3) -> (y (..., M, N, 19), z_body (..., M, N-1,
    6)); a batch axis B of the histories pairs with the axis of G in
    front of M.

    ``nn_fn`` applies ONE shared residual net to every rod, and the rods
    advance together node by node (asm.stacked_rods: one RHS call per
    node for all of them); ``nn_params`` (a sequence of M nets, with
    ``nn_spec``) gives each rod its own, and the rods run one by one."""
    if nn_params is not None:
        ys, zs = [], []
        for i, p in enumerate(asm.rods):
            y, z = integrate_euler(p, G[..., i, :], yh[..., i, :, :],
                                   zh[..., i, :, :], tf[..., i, :],
                                   nn_params[i], nn_history)
            ys.append(y)
            zs.append(z)
        return torch.stack(ys, dim=-3), torch.stack(zs, dim=-3)
    p = asm.stacked_rods()
    lead = G.shape[:-1]
    e = lambda a: a.expand(lead + a.shape[-1:])
    y = torch.cat([e(p.p0), e(p.h0), G, e(p.q0), e(p.w0)], dim=-1)
    ys, zs = [y], []
    for j in range(asm.N - 1):
        dy, zj = rhs(p, y, yh[..., j, :], zh[..., j, :], tf, nn_fn,
                     nn_history)
        y = y + p.ds * dy
        ys.append(y)
        zs.append(zj)
    return torch.stack(ys, dim=-2), torch.stack(zs, dim=-2)


def _residual_algebra(asm: RodAssembly, tips, plate7, pph, vph, hph, wbh):
    """Residual (..., 6M+7) as pure ALGEBRA of the sweep outputs: tips
    (..., M, 13) = tip [p, h_raw, n, m] per rod, plate7 (..., 7) =
    [pp, hp]. All the rod physics is behind ``tips``."""
    plate = asm.plate
    c0 = asm.rods[0].c0
    pp = plate7[..., :3]
    hp = plate7[..., 3:]
    n_tip = tips[..., 7:10]
    m_tip = tips[..., 10:13]

    Rp = quat_to_rotmat(hp)                         # plate world-from-body
    att_w = _mv(Rp.unsqueeze(-3), plate.attach_offsets)      # (..., M, 3)

    # tip position: each rod tip sits at its plate attachment point
    res_pos = (tips[..., 0:3] - (pp.unsqueeze(-2) + att_w)).flatten(-2)
    # tip orientation: h_tip ~ hp * attach_quat (vector part of the
    # relative quaternion)
    h_tip = tips[..., 3:7]
    h_tip = h_tip / torch.linalg.vector_norm(h_tip, dim=-1, keepdim=True)
    h_target = _quat_mul(hp.unsqueeze(-2).expand(att_w.shape[:-1] + (4,)),
                         plate.attach_quats)
    res_ori = _quat_mul(_quat_conj(h_target), h_tip)[..., 1:4].flatten(-2)

    # plate BDF-2 kinematics: velocity from pose, acceleration from velocity
    vp = c0 * pp + pph
    ap = c0 * vp + vph
    hdot = c0 * hp + hph
    wb = _body_angular_velocity(hp, hdot)
    wbdot = c0 * wb + wbh

    f_contact = tau_contact = 0.0
    if plate.has_contact:
        n = plate.contact_plane[:3]
        off = plate.contact_plane[3]
        beta = plate.contact_beta
        r_w = _mv(Rp.unsqueeze(-3), plate.contact_points)       # (..., Kc, 3)
        gap = ((pp.unsqueeze(-2) + r_w) * n).sum(-1) - off
        pen = ACTIVATIONS["softplus"](-beta * gap) / beta
        act = torch.sigmoid(-beta * gap)
        w_world = _mv(Rp, wb)
        v_pt = vp.unsqueeze(-2) + _cross(w_world.unsqueeze(-2).expand_as(r_w),
                                         r_w)
        gdot = (v_pt * n).sum(-1)
        fmag = (plate.contact_k * pen
                + plate.contact_d * act * torch.relu(-gdot))
        f_i = fmag.unsqueeze(-1) * n
        f_contact = f_i.sum(-2)
        tau_contact = _cross(r_w, f_i).sum(-2)

    # Newton: m (ap - g) = sum of rod reactions (-n_tip) + contact
    res_f = plate.mass * (ap - plate.g) + n_tip.sum(-2) - f_contact
    # Euler (plate body frame): J wbdot + wb x J wb = Rp^T (torques)
    torque_w = (_cross(att_w, -n_tip) - m_tip).sum(-2) + tau_contact
    Jw = _mv(plate.inertia, wb)
    res_m = _mv(plate.inertia, wbdot) + _cross(wb, Jw) - _mv_t(Rp, torque_w)
    res_norm = (hp * hp).sum(-1, keepdim=True) - 1.0
    return torch.cat([res_pos, res_ori, res_f, res_m, res_norm], dim=-1)


def _assembly_residual(asm: RodAssembly, X, yh, zh, tf, pph, vph, hph, wbh,
                       nn_fn=None, nn_history=False, nn_spec=None,
                       nn_params=None):
    """Stacked residual (..., 6M+7) at X (..., 6M+7). pph/vph/hph/wbh are
    the BDF-2 history combinations c1*x + c2*x_prev of the plate pose,
    velocity, quaternion and body angular velocity."""
    M = asm.M
    G = X[..., :6 * M].unflatten(-1, (M, 6))
    y, _ = _sweep_all(asm, G, yh, zh, tf, nn_fn, nn_history, nn_spec,
                      nn_params)
    return _residual_algebra(asm, y[..., -1, :13], X[..., 6 * M:], pph, vph,
                             hph, wbh)


def _tip_jacobians(asm: RodAssembly, G, yh, zh, tf, nn_fn, nn_history,
                   nn_spec=None, nn_params=None):
    """Per-rod tip Jacobians T_i = d tip_i / d G_i (tip_i depends on G_i
    alone): one replicated reverse pass over 13 copies of G covers every
    rod. G ([B,] M, 6) -> (T ([B,] M, 13, 6), tips ([B,] M, 13))."""
    with torch.enable_grad():
        Gr = G.detach().expand((13,) + G.shape).clone().requires_grad_(True)
        y, _ = _sweep_all(asm, Gr, yh, zh, tf, nn_fn, nn_history,
                          nn_spec, nn_params)
        tips = y[..., -1, :13]                         # (13, [B,] M, 13)
        (g,) = torch.autograd.grad(
            torch.diagonal(tips, dim1=0, dim2=-1).sum(), Gr)
    return g.movedim(0, -2), tips[0].detach()


def _assembly_jacobian(asm: RodAssembly, X, yh, zh, tf, pph, vph, hph, wbh,
                       nn_fn=None, nn_history=False, nn_spec=None,
                       nn_params=None):
    """STRUCTURED (6M+7)^2 Jacobian + residual. Rod constraints see only
    their own G_i (through the sweep) plus the 7 plate variables; the plate
    rows see every tip. So J[:, G_i] = (dR/d tips_i) T_i and
    J[:, plate] = dR/d plate7, with the sweeps carrying 13 copies instead
    of 6M+7. X ([B,] U) -> (J ([B,] U, U), r ([B,] U))."""
    M = asm.M
    U = 6 * M + 7
    T, tips = _tip_jacobians(asm, X[..., :6 * M].unflatten(-1, (M, 6)), yh,
                             zh, tf, nn_fn, nn_history, nn_spec, nn_params)
    flat = torch.cat([tips.flatten(-2), X[..., 6 * M:]], dim=-1)

    def alg(v):
        return _residual_algebra(asm, v[..., :13 * M].unflatten(-1, (M, 13)),
                                 v[..., 13 * M:], pph, vph, hph, wbh)

    Ja = jacobian(alg, flat, m=U)                  # ([B,] U, 13M + 7)
    Jt = Ja[..., :13 * M].unflatten(-1, (M, 13))
    JG = torch.einsum("...rmt,...mtg->...rmg", Jt, T).flatten(-2)
    return torch.cat([JG, Ja[..., 13 * M:]], dim=-1), alg(flat)


def _newton_structured(residual_fn, jac_fn, X0, tol, max_iter, **kw):
    """The shared _newton_loop with (J, r) from the structured
    ``jac_fn``."""
    eye = torch.eye(X0.shape[-1], dtype=X0.dtype, device=X0.device)

    def direction(X, r, lam):
        J, _ = jac_fn(X)
        return _lm_damped_solve(J, r, lam, eye)

    return _newton_loop(residual_fn, direction, X0, tol, max_iter, **kw)


def _residual_fn(asm, detach: bool, **kw):
    """X -> _assembly_residual(asm, X, **kw); ``detach`` detaches every
    tensor input first (the solves and Jacobians run at fixed inputs)."""
    if detach:
        kw = {k: (v.detach() if torch.is_tensor(v) else v)
              for k, v in kw.items()}
    return partial(_assembly_residual, asm, **kw)


_HISTORIES = ("yh", "zh", "tf", "pph", "vph", "hph", "wbh")


def _implicit_root(asm, X_star, tol, **kw):
    """The solved root X* with implicit-function-theorem gradients
    (shooting.implicit_root): the histories and tendon forces are its
    explicit arguments, the rods, the plate and the nets its closure."""
    rest = {k: v for k, v in kw.items() if k not in _HISTORIES}

    def res(X, *histories):
        return _assembly_residual(asm, X, *histories, **rest)

    return implicit_root(res, X_star, tol, args=[kw[k] for k in _HISTORIES],
                         root=X_star)


def assembly_solve_step(asm: RodAssembly, yh, zh, tf, X0, pph, vph, hph,
                        wbh, nn_fn=None, nn_history: bool = False,
                        tol: float = 1e-10, max_iter: int = 50,
                        differentiable: bool = False, nn_spec=None,
                        nn_params=None, solver: str = "auto"):
    """Solve one BDF-2 time step of the coupled assembly.

    yh/zh: (M, N, 19)/(M, N, 6) histories; tf: (M, 3) tendon body forces;
    X0: (6M+7,) warm start; pph/vph/hph/wbh: plate histories. A batch of
    B systems: X0 (B, 6M+7) and every history with a leading B (module
    docstring); the results then carry it too.
    differentiable: the root carries implicit-function-theorem gradients
    (shooting.implicit_root) to every tensor the residual depends on: the
    histories, the tensions behind tf, the nets' weights, the rods' and
    the plate's parameters (training/sysid.fit_assembly_params).
    solver: "structured", "dense" or "auto" (module docstring).
    Returns (y ([B,] M, N, 19), z_body ([B,] M, N-1, 6), X, stats)."""
    if solver == "auto":
        solver = "structured" if X0.device.type == "cpu" else "dense"
    if solver not in ("structured", "dense"):
        raise ValueError(f"unknown assembly solver {solver!r}")
    kw = dict(yh=yh, zh=zh, tf=tf, pph=pph, vph=vph, hph=hph, wbh=wbh,
              nn_fn=nn_fn, nn_history=nn_history, nn_spec=nn_spec,
              nn_params=nn_params)
    res_fixed = _residual_fn(asm, True, **kw)
    with torch.no_grad():
        if solver == "structured":
            jac = partial(_assembly_jacobian, asm, **res_fixed.keywords)
            X, stats = _newton_structured(res_fixed, jac, X0.detach(), tol,
                                          max_iter)
        else:
            X, stats = _newton_dense(res_fixed, X0.detach(), tol, max_iter)
    if differentiable:
        X, stats = _implicit_root(asm, X, tol, **kw)
    M = asm.M
    y, z_body = _sweep_all(asm, X[..., :6 * M].unflatten(-1, (M, 6)), yh,
                           zh, tf, nn_fn, nn_history, nn_spec, nn_params)
    return y, z_body, X, stats


# ---------------------------------------------------------------- rollout

class AssemblySimOutput(NamedTuple):
    """Every field has a leading B for a batch of schedules."""
    traj: torch.Tensor           # (T, M, N, 50) [y, z, yh, zh] per rod
    plate_pose: torch.Tensor     # (T, 7) [p_plate, h_plate]
    Gs: torch.Tensor             # (T, M, 6) converged base reactions
    newton_iters: torch.Tensor   # (T,)
    residual_norm: torch.Tensor  # (T,)


def _initial_rod_states(asm: RodAssembly):
    """Straight vertical rods from their bases: y (M, N, 19), z (M, N, 6)
    (unlike stepper.initial_state, which pins the base at the origin)."""
    N, kw = asm.N, dict(dtype=asm.dtype, device=asm.device)
    ys = []
    for p in asm.rods:
        # jnp.linspace(0, L, N): i * L / (N - 1), the last node at L exactly
        zpos = torch.arange(N, **kw) * (p.L / (N - 1))
        zpos[-1] = p.L
        y = torch.zeros((N, 19), **kw)
        y[:, 0:2] = p.p0[:2]
        y[:, 2] = p.p0[2] + zpos
        y[:, 3] = 1.0
        ys.append(y)
    z = torch.zeros((asm.M, N, 6), **kw)
    z[..., 2] = 1.0
    return torch.stack(ys), z


class AssemblyCarry(NamedTuple):
    """BDF-2 carry of the coupled assembly (the state of simulate_assembly's
    loop; also the moving-horizon state of the planners). A batch of B
    systems carries a leading B on every leaf."""
    y: torch.Tensor          # (M, N, 19)
    z: torch.Tensor          # (M, N, 6)
    y_prev: torch.Tensor
    z_prev: torch.Tensor
    G: torch.Tensor          # (M, 6)
    G_prev: torch.Tensor
    pp: torch.Tensor         # (3,) plate position
    pp_prev: torch.Tensor
    hp: torch.Tensor         # (4,) plate quaternion
    hp_prev: torch.Tensor
    vp: torch.Tensor         # (3,) plate velocity (world)
    vp_prev: torch.Tensor
    wb: torch.Tensor         # (3,) plate angular velocity (body)
    wb_prev: torch.Tensor

    @staticmethod
    def initial(asm: RodAssembly, batch: Optional[int] = None
                ) -> "AssemblyCarry":
        """The straight assembly at rest; ``batch``: B copies of it."""
        y0, z0 = _initial_rod_states(asm)
        kw = dict(dtype=asm.dtype, device=asm.device)
        G0 = torch.zeros((asm.M, 6), **kw)
        pp0, hp0 = asm.p_plate0.clone(), asm.h_plate0.clone()
        v0 = torch.zeros(3, **kw)
        carry = AssemblyCarry(y0, z0, y0, z0, G0, G0, pp0, pp0, hp0, hp0,
                              v0, v0, v0, v0)
        return carry if batch is None else carry.expand(batch)

    def expand(self, batch: int) -> "AssemblyCarry":
        """B copies of this (unbatched) carry."""
        return AssemblyCarry(*(t.expand((batch,) + t.shape).contiguous()
                               for t in self))


def carry_from_jax(carry, dtype: torch.dtype | None = None,
                   device=None) -> AssemblyCarry:
    """The JAX package's AssemblyCarry -> the port's (each leaf through
    ``np.asarray``, so a vmapped carry keeps its leading batch axis;
    ``device`` defaults to the CUDA card)."""
    device = default_device(device)
    return AssemblyCarry(*(
        torch.from_numpy(np.array(a)).to(device=device,
                                         dtype=dtype or None)
        for a in carry))


def assembly_step_carry(asm: RodAssembly, carry: AssemblyCarry, tensions,
                        nn_fn=None, nn_history: bool = False,
                        tol: float = 1e-10, max_iter: int = 50,
                        differentiable: bool = False, nn_spec=None,
                        nn_params=None, solver: str = "auto",
                        solve_fn=None):
    """One coupled BDF-2 step from any carry: the building block of
    simulate_assembly and of moving-horizon planning. tensions:
    (M, n_tendons). Returns (carry', record (M, N, 50), plate_pose (7,),
    G (M, 6), stats). A batched carry (leading B) takes tensions
    (B, M, n_tendons) and gives every output a leading B, in one solve
    (one K7 launch with solve_fn) for all B systems.

    solve_fn: a replacement for the Newton solve, e.g. kernel K7
    (ops/assembly.make_assembly_step_kernel), with the signature
    (X0, yh, zh, tf, pph, vph, hph, wbh) -> (X, y, z_body, r2, iters).
    ``differentiable`` holds with solve_fn: the kernel gives the root and
    the implicit function theorem the gradients through the plain
    residual; ``solver`` does not apply. The kernel knows no net, so
    solve_fn with nn_fn / nn_params is refused (the gradients would be
    taken of a residual whose root the kernel did not solve)."""
    if solve_fn is not None and (nn_fn is not None or nn_params is not None):
        raise ValueError(
            "solve_fn (fused kernel) cannot be combined with nn_fn/"
            "nn_params: the kernel solves the physics-only residual, so "
            "hybrid-KNODE assemblies must use the plain path "
            "(solve_fn=None / fused=False).")
    M = asm.M
    p0 = asm.rods[0]
    c0, c1, c2 = p0.c0, p0.c1, p0.c2
    (y, z, y_prev, z_prev, G, G_prev,
     pp, pp_prev, hp, hp_prev, vp, vp_prev, wb, wb_prev) = carry
    yh = c1 * y + c2 * y_prev
    zh = c1 * z + c2 * z_prev
    pph = c1 * pp + c2 * pp_prev
    hph = c1 * hp + c2 * hp_prev
    vph = c1 * vp + c2 * vp_prev
    wbh = c1 * wb + c2 * wb_prev
    tensions = torch.as_tensor(tensions, dtype=asm.dtype, device=asm.device)
    tf = (tensions.unsqueeze(-1) * asm.stacked_rods().tendon_dirs).sum(-2)
    X0 = torch.cat([(2.0 * G - G_prev).flatten(-2), pp, hp], dim=-1)
    if solve_fn is not None and differentiable:
        kw = dict(yh=yh, zh=zh, tf=tf, pph=pph, vph=vph, hph=hph, wbh=wbh)
        with torch.no_grad():
            X_star = solve_fn(*(t.detach() for t in (X0, yh, zh, tf, pph,
                                                     vph, hph, wbh)))[0]
        X, stats = _implicit_root(asm, X_star, tol, **kw)
        y_new, z_body = _sweep_all(asm, X[..., :6 * M].unflatten(-1, (M, 6)),
                                   yh, zh, tf, None, False)
    elif solve_fn is not None:
        X, y_new, z_body, r2, iters = solve_fn(X0, yh, zh, tf, pph, vph, hph,
                                               wbh)
        stats = NewtonStats(iters, r2.sqrt(), r2 <= tol,
                            torch.zeros_like(iters))
    else:
        y_new, z_body, X, stats = assembly_solve_step(
            asm, yh, zh, tf, X0, pph, vph, hph, wbh, nn_fn, nn_history, tol,
            max_iter, differentiable=differentiable, nn_spec=nn_spec,
            nn_params=nn_params, solver=solver)
    G_new = X[..., :6 * M].unflatten(-1, (M, 6))
    pp_new = X[..., 6 * M:6 * M + 3]
    hp_new = X[..., 6 * M + 3:]
    hp_new = hp_new / torch.linalg.vector_norm(hp_new, dim=-1, keepdim=True)
    z_new = torch.cat([z_body, z[..., -1:, :]], dim=-2)   # the tip z frozen
    vp_new = c0 * pp_new + pph
    wb_new = _body_angular_velocity(hp_new, c0 * hp_new + hph)
    record = torch.cat([y_new, z_new, yh, zh], dim=-1)
    new_carry = AssemblyCarry(y_new, z_new, y, z, G_new, G, pp_new, pp,
                              hp_new, hp, vp_new, vp, wb_new, wb)
    return (new_carry, record, torch.cat([pp_new, hp_new], dim=-1), G_new,
            stats)


def simulate_assembly(
    asm: RodAssembly,
    controls,
    nn_fn: Optional[Callable] = None,
    nn_history: bool = False,
    tol: Optional[float] = None,
    max_iter: int = 50,
    differentiable: bool = False,
    remat: bool = False,
    nn_spec=None,
    nn_params=None,
    solver: str = "auto",
    fused: bool = False,
) -> AssemblySimOutput:
    """Closed-loop BDF-2 rollout of the coupled assembly.

    controls: (T, M, n_tendons) per-rod tendon tensions. The record keeps
    the single-rod contract per rod ([y, z, yh, zh], the tip z frozen).
    controls (B, T, M, n_tendons): B rollouts of the same assembly at once
    (``jax.vmap`` of the JAX function), each step one batched solve (one
    K7 launch with fused=True); every output field gains a leading B.

    differentiable=True makes the rollout differentiable with respect to
    the controls (and the nets' weights) by the implicit function theorem
    at every coupled solve (assembly_solve_step). remat is accepted for
    parity and does nothing: autograd keeps each step's graph.

    nn_fn: one shared KNODE residual for every rod; nn_spec + nn_params
    (a sequence of M nets): each rod its own.

    fused=True solves every coupled step with kernel K7 (ops/assembly.py;
    its plain version for an assembly on the CPU). It takes no net and no
    contact plane and composes with differentiable=True (the kernel solves
    each root; the gradients come through the plain residual).
    """
    if tol is None:
        tol = 1e-16 if asm.dtype == torch.float64 else 1e-10
    solve_fn = None
    if fused:
        if nn_fn is not None or nn_params is not None:
            raise NotImplementedError("fused=True does not support KNODE "
                                      "residuals yet; use fused=False")
        from ..ops.assembly import make_assembly_step_kernel
        solve_fn = make_assembly_step_kernel(asm, tol=tol, max_iter=max_iter)
    controls = torch.as_tensor(controls, dtype=asm.dtype, device=asm.device)
    lead = tuple(controls.shape[:-3])           # (B,) for a batch, else ()
    ax = len(lead)                              # the time axis
    T = controls.shape[ax]
    carry = carry0 = AssemblyCarry.initial(asm, *lead)
    with torch.set_grad_enabled(differentiable and torch.is_grad_enabled()):
        records, plates, Gs, iters, res = [], [], [], [], []
        for t in range(T - 1):
            carry, record, plate7, G_new, stats = assembly_step_carry(
                asm, carry, controls.select(ax, t), nn_fn, nn_history, tol,
                max_iter,
                differentiable=differentiable, nn_spec=nn_spec,
                nn_params=nn_params, solver=solver, solve_fn=solve_fn)
            records.append(record)
            plates.append(plate7)
            Gs.append(G_new)
            iters.append(stats.iterations)
            res.append(stats.residual_norm)
        rec0 = torch.cat([carry0.y, carry0.z, carry0.y, carry0.z], dim=-1)
        zero_i = torch.zeros(lead, dtype=torch.int32, device=asm.device)
        zero_f = torch.zeros(lead, dtype=asm.dtype, device=asm.device)
        return AssemblySimOutput(
            torch.stack([rec0] + records, dim=ax),
            torch.stack([torch.cat([carry0.pp, carry0.hp], dim=-1)] + plates,
                        dim=ax),
            torch.stack([carry0.G] + Gs, dim=ax),
            torch.stack([zero_i] + [i.to(torch.int32) for i in iters],
                        dim=ax),
            torch.stack([zero_f] + res, dim=ax))
