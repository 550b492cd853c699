"""The hybrid Cosserat rod in plain PyTorch: derived constants, the
semi-discretized RHS, the Euler sweep, the BDF-2 forward-difference
Newton-shooting step, the rollout and the KNODE MLP.

Written from the reference repo's equations (cosserat_ode.py:58-78 the
derived terms, :114-186 the RHS, :188-213 the Euler sweep and tip residual;
knode.py:58-64 the straight initial rod; cosserat_ode_torch.py:53-105 the
MLP). State layout, last axis: y (19) = [p, h, n, m, q, w], z (6) = [v, u].

Every 3x3 product and both MLP layers are matrix products through
:meth:`Rod.mm`, so one flag computes the whole reference with TF32
products (the control; module ``__init__``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

# forward-difference Newton (BDF-2 shooting on the base reaction G):
# Levenberg-Marquardt stall ladder and line search
LM_LAMBDA0, LM_GROWTH, MAX_ESCALATIONS = 1e-4, 30.0, 4
N_ALPHAS = 7

# operations of one node of the RHS besides the net, counted from rhs()
# below (a multiply, add, divide or abs each one): rotation matrix 38;
# v 51 (R^T n 15, Bse vh 15, minus 3, the stiffness solve 15, v_rest 3);
# u 48; the four BDF-2 time derivatives 24; body force f 30; ps 15; ns 33;
# ms 69; qs 24; ws 12; hs 24; the net's residual added 25; the Euler
# update y + ds dy 38
NODE_OPS = 38 + 51 + 48 + 24 + 30 + 15 + 33 + 69 + 24 + 12 + 24 + 25 + 38


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits, to nearest,
    ties to even), as a tensor core reads a float32 operand."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


@dataclass
class Rod:
    """Derived constants of one rod in the dtype of the computation."""
    N: int
    c: dict                 # name -> tensor
    tf32: bool = False

    @property
    def dtype(self):
        return self.c["L"].dtype

    @property
    def device(self):
        return self.c["L"].device

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            return torch.matmul(to_tf32(a), to_tf32(b))
        return torch.matmul(a, b)

    def mv(self, M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """M (..., 3, 3) times x (..., 3)."""
        return self.mm(M, x[..., None])[..., 0]

    def mtv(self, M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """M^T x."""
        return self.mm(M.transpose(-1, -2), x[..., None])[..., 0]


def derive(base: dict, N: int, dtype: torch.dtype, device,
           tf32: bool = False) -> Rod:
    """The rod's derived terms (cosserat_ode.py:58-78), in float64 numpy,
    then cast: A, G = E / 2.6, ds, J, Kse, Kbt, the BDF-2 coefficients,
    the stiffness-plus-damping inverses and the rest strain v_rest =
    (Kse + c0 Bse)^-1 Kse v*."""
    b = {k: np.asarray(v, np.float64) for k, v in base.items()}
    L, E, r, rho, dt = (float(b[k]) for k in ("L", "E", "r", "rho", "del_t"))
    A = math.pi * r ** 2
    Gm = E / (2 * (1 + 0.3))
    J = np.diag([math.pi * r ** 4 / 4, math.pi * r ** 4 / 4,
                 math.pi * r ** 4 / 2])
    Kse = np.diag([Gm * A, Gm * A, E * A])
    Kbt = np.diag([E * J[0, 0], E * J[1, 1], Gm * J[2, 2]])
    c0, c1, c2 = 1.5 / dt, -2.0 / dt, 0.5 / dt
    Kse_inv = np.linalg.inv(Kse + c0 * b["Bse"])
    Kbt_inv = np.linalg.inv(Kbt + c0 * b["Bbt"])
    v_rest = Kse_inv @ (Kse @ b["vstar"])
    c = dict(L=L, ds=L / (N - 1), c0=c0, c1=c1, c2=c2, rhoA=rho * A,
             rhoAg=rho * A * b["g"], rhoJ=rho * J, Kse_inv=Kse_inv,
             Kbt_inv=Kbt_inv, v_rest=v_rest, Bse=b["Bse"], Bbt=b["Bbt"],
             C=b["C"], F_tip=b["F_tip"], M_tip=b["M_tip"], p0=b["p0"],
             h0=b["h0"], q0=b["q0"], w0=b["w0"],
             tendon_dirs=b["tendon_dirs"])
    t = {k: torch.as_tensor(np.asarray(v, np.float64)).to(device, dtype)
         for k, v in c.items()}
    return Rod(N, t, tf32)


def initial_state(rod: Rod):
    """The straight rod at rest (knode.py:58-64): (N, 19), (N, 6)."""
    N, c = rod.N, rod.c
    y = torch.zeros((N, 19), dtype=rod.dtype, device=rod.device)
    y[:, 2] = torch.arange(N, dtype=rod.dtype, device=rod.device) * (
        c["L"] / (N - 1))
    y[:, 3] = 1.0
    z = torch.zeros((N, 6), dtype=rod.dtype, device=rod.device)
    z[:, 2] = 1.0
    return y, z


def tendon_forces(rod: Rod, tensions: torch.Tensor) -> torch.Tensor:
    """(..., 4) tensions -> (..., 3) body force, sum_k T_k d_k."""
    return rod.mm(tensions[..., None, :], rod.c["tendon_dirs"])[..., 0, :]


def rotmat(h: torch.Tensor) -> torch.Tensor:
    """R = I + 2/(h.h) M(h) (cosserat_ode.py:132-137)."""
    h1, h2, h3, h4 = h.unbind(-1)
    s = 2.0 / (h * h).sum(-1)
    return torch.stack([
        torch.stack([1 + s * (-h3 * h3 - h4 * h4), s * (h2 * h3 - h4 * h1),
                     s * (h2 * h4 + h3 * h1)], -1),
        torch.stack([s * (h2 * h3 + h4 * h1), 1 + s * (-h2 * h2 - h4 * h4),
                     s * (h3 * h4 - h2 * h1)], -1),
        torch.stack([s * (h2 * h4 - h3 * h1), s * (h3 * h4 + h2 * h1),
                     1 + s * (-h2 * h2 - h3 * h3)], -1)], -2)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def mlp(rod: Rod, net, x: torch.Tensor) -> torch.Tensor:
    """W2 elu(W1 x + b1) + b2; net = (W1 (H, din), b1, W2 (25, H), b2)."""
    W1, b1, W2, b2 = net
    h = torch.nn.functional.elu(rod.mm(x, W1.transpose(0, 1)) + b1)
    return rod.mm(h, W2.transpose(0, 1)) + b2


def rhs(rod: Rod, y, yh, zh, tf, net=None):
    """ys = dy/ds and the strains z at one node (cosserat_ode.py:114-186),
    with the net's residual added to both when ``net`` is given."""
    c, mv, mtv = rod.c, rod.mv, rod.mtv
    h, n, m = y[..., 3:7], y[..., 7:10], y[..., 10:13]
    q, w = y[..., 13:16], y[..., 16:19]
    vh, uh = zh[..., 0:3], zh[..., 3:6]
    R = rotmat(h)
    v = mv(c["Kse_inv"], mtv(R, n) - mv(c["Bse"], vh)) + c["v_rest"]
    u = mv(c["Kbt_inv"], mtv(R, m) - mv(c["Bbt"], uh))
    vt, ut = c["c0"] * v + vh, c["c0"] * u + uh
    qt = c["c0"] * q + yh[..., 13:16]
    wt = c["c0"] * w + yh[..., 16:19]
    f = c["rhoAg"] - mv(R, c["C"] * q * q.abs()) + tf
    ps = mv(R, v)
    ns = c["rhoA"] * mv(R, cross(w, q) + qt) - f
    ms = (mv(R, cross(w, mv(c["rhoJ"], w)) + mv(c["rhoJ"], wt))
          - cross(ps, n))
    qs = vt - cross(u, q) + cross(w, v)
    ws = ut - cross(u, w)
    u1, u2, u3 = u.unbind(-1)
    h1, h2, h3, h4 = h.unbind(-1)
    hs = 0.5 * torch.stack([-u1 * h2 - u2 * h3 - u3 * h4,
                            u1 * h1 + u3 * h3 - u2 * h4,
                            u2 * h1 - u3 * h2 + u1 * h4,
                            u3 * h1 + u2 * h2 - u1 * h3], -1)
    ys = torch.cat([ps, hs, ns, ms, qs, ws], -1)
    z = torch.cat([v, u], -1)
    if net is not None:
        out = mlp(rod, net, torch.cat([y, z, tf.expand(y.shape[:-1] + (3,))],
                                      -1))
        ys = ys + out[..., :19]
        z = z + out[..., 19:]
    return ys, z


def sweep(rod: Rod, G, yh, zh, tf, net=None):
    """Euler sweep base -> tip at base reaction G (B, 6): y (B, N, 19),
    z (B, N-1, 6) (cosserat_ode.py:197-201)."""
    c = rod.c
    lead = G.shape[:-1]
    e = lambda a: a.expand(lead + a.shape[-1:])
    y = torch.cat([e(c["p0"]), e(c["h0"]), G, e(c["q0"]), e(c["w0"])], -1)
    ys, zs = [y], []
    for j in range(rod.N - 1):
        dy, zj = rhs(rod, y, yh[..., j, :], zh[..., j, :], tf, net)
        y = y + c["ds"] * dy
        ys.append(y)
        zs.append(zj)
    return torch.stack(ys, -2), torch.stack(zs, -2)


def tip_residual(rod: Rod, y):
    """[F_tip - n(L), M_tip - m(L)] (cosserat_ode.py:204-211)."""
    return torch.cat([rod.c["F_tip"] - y[..., -1, 7:10],
                      rod.c["M_tip"] - y[..., -1, 10:13]], -1)


def fd_eps(dtype) -> float:
    return 1e-8 if dtype == torch.float64 else 3e-4


@torch.no_grad()
def newton(rod: Rod, G, yh, zh, tf, net, tol: float, max_iter: int):
    """Damped Newton on the tip residual over a batch of B systems, with a
    forward-difference Jacobian refreshed every iteration, the first
    improving step of alpha = 0.5**k (k < 7), and a Levenberg-Marquardt
    term that grows by 30 on each failed line search (a system stops after
    4 in a row). Returns (G, r2, iters, sweeps): ``sweeps`` per system
    counts the sweeps this solve needs: the first residual, 6 probes an
    iteration, the line search up to its first improving candidate (all 7
    when none improves)."""
    B, dtype, dev = G.shape[0], G.dtype, G.device
    eps = fd_eps(dtype)
    eye = torch.eye(6, dtype=dtype, device=dev)
    alphas = 0.5 ** torch.arange(N_ALPHAS, dtype=dtype, device=dev)
    rep = lambda a, k: a.repeat_interleave(k, 0)

    def res(Gx, k):
        y, _ = sweep(rod, Gx, rep(yh, k), rep(zh, k), rep(tf, k), net)
        return tip_residual(rod, y)

    r = res(G, 1)
    r2 = (r * r).sum(-1)
    lam = torch.zeros(B, dtype=dtype, device=dev)
    fails = torch.zeros(B, dtype=torch.int64, device=dev)
    iters = torch.zeros(B, dtype=torch.int64, device=dev)
    sweeps = torch.ones(B, dtype=torch.int64, device=dev)
    rows = torch.arange(B, device=dev)
    for _ in range(max_iter):
        active = (r2 > tol) & (fails <= MAX_ESCALATIONS)
        if not bool(active.any()):
            break
        h = eps * (1.0 + G.abs())
        probes = G[:, None, :] + h[:, None, :] * eye
        rp = res(probes.reshape(B * 6, 6), 6).reshape(B, 6, 6)
        Jm = ((rp - r[:, None, :]) / h[:, :, None]).transpose(1, 2)
        D = torch.diagonal(Jm, dim1=-2, dim2=-1).abs().clamp_min(1.0)
        dG = torch.linalg.solve(Jm + torch.diag_embed(lam[:, None] * D),
                                -r[..., None])[..., 0]
        dG = torch.where(torch.isfinite(dG).all(-1, keepdim=True), dG, 0.0)
        cand = G[:, None, :] + alphas[None, :, None] * dG[:, None, :]
        rc = res(cand.reshape(B * N_ALPHAS, 6), N_ALPHAS).reshape(
            B, N_ALPHAS, 6)
        r2c = (rc * rc).sum(-1)
        improves = r2c < r2[:, None]
        found = improves.any(1)
        pick = torch.where(found, improves.long().argmax(1), 0)
        ok = active & found
        G = torch.where(ok[:, None], cand[rows, pick], G)
        r = torch.where(ok[:, None], rc[rows, pick], r)
        r2 = torch.where(ok, r2c[rows, pick], r2)
        stall = active & ~found
        lam = torch.where(stall, torch.clamp_min(lam * LM_GROWTH, LM_LAMBDA0),
                          torch.zeros_like(lam))
        fails = torch.where(stall, fails + 1,
                            torch.where(active, torch.zeros_like(fails),
                                        fails))
        iters = iters + active.long()
        sweeps = sweeps + active.long() * (
            6 + torch.where(found, pick + 1, torch.full_like(pick, N_ALPHAS)))
    return G, r2, iters, sweeps


def history(rod: Rod, y, z, y_prev, z_prev):
    c = rod.c
    return c["c1"] * y + c["c2"] * y_prev, c["c1"] * z + c["c2"] * z_prev


@torch.no_grad()
def step(rod: Rod, y, z, y_prev, z_prev, G, tensions, net, tol, max_iter):
    """One BDF-2 step of B rods from (y, z) (B, N, 19 | 6) and the step
    before, at the base-reaction guess G: (y', z', G', yh, zh, r2, iters,
    sweeps). The tip's z is carried (the sweep writes z at nodes 0..N-2)."""
    yh, zh = history(rod, y, z, y_prev, z_prev)
    tf = tendon_forces(rod, tensions)
    G, r2, iters, sweeps = newton(rod, G, yh, zh, tf, net, tol, max_iter)
    yn, zb = sweep(rod, G, yh, zh, tf, net)
    zn = torch.cat([zb, z[:, -1:, :]], 1)
    return yn, zn, G, yh, zh, r2, iters, sweeps + 1


@torch.no_grad()
def rollout(rod: Rod, controls, net, tol, max_iter):
    """Closed-loop rollout of B rods (knode.py's loop): controls (B, T, 4)
    -> records (B, T, N, 50) = [y, z, yh, zh] with the rest state first,
    each step's Newton started from the linear extrapolation 2 G - G_prev,
    and the per-step (r2, iters, sweeps) (T-1, B)."""
    B, T = controls.shape[:2]
    y0, z0 = initial_state(rod)
    y = y0.expand(B, -1, -1).contiguous()
    z = z0.expand(B, -1, -1).contiguous()
    yp, zp = y, z
    G = Gp = torch.zeros((B, 6), dtype=rod.dtype, device=rod.device)
    recs = [torch.cat([y, z, y, z], -1)]
    out = []
    for t in range(T - 1):
        yn, zn, Gn, yh, zh, r2, it, sw = step(
            rod, y, z, yp, zp, 2.0 * G - Gp, controls[:, t], net, tol,
            max_iter)
        recs.append(torch.cat([yn, zn, yh, zh], -1))
        out.append((r2, it, sw))
        y, z, yp, zp, G, Gp = yn, zn, y, z, Gn, G
    r2, it, sw = (torch.stack(v) for v in zip(*out))
    return torch.stack(recs, 1), r2, it, sw
