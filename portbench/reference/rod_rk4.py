"""The hybrid rod's RK4 spatial sweep in plain PyTorch, with its
forward-difference Newton step and rollout.

Written from the reference repo's getResidualRK4 (cosserat_ode.py:222-242):
a classical fourth-order Runge-Kutta step from node j to node j+1, its
middle stages at the BDF-2 history's linear midpoints 0.5 (yh_j + yh_j+1)
and 0.5 (zh_j + zh_j+1) (knode.py:80-81), its last at node j+1's; the
strains recorded at node j are the first stage's. The rod's constants, the
node's right-hand side, the MLP, the history terms, the tendon forces and
the tip residual are ``rod.py``'s, imported. The Newton solve is
``rod.py``'s (the same ladder, line search and sweep count) over this
module's sweep.

On a CUDA device the rollout replays each batch shape's sweep as a CUDA
graph (:class:`Graphed`): the same operations in the same order, without
the host dispatching each of an RK4 sweep's ~10,000 small ones anew.
"""
from __future__ import annotations

import torch

from . import rod as R


def sweep(rod: R.Rod, G, yh, zh, tf, net=None):
    """The RK4 sweep base -> tip at base reaction G (B, 6): y (B, N, 19),
    z (B, N-1, 6) (cosserat_ode.py:222-242)."""
    c, ds = rod.c, rod.c["ds"]
    lead = G.shape[:-1]
    e = lambda a: a.expand(lead + a.shape[-1:])
    y = torch.cat([e(c["p0"]), e(c["h0"]), G, e(c["q0"]), e(c["w0"])], -1)
    ys, zs = [y], []
    for j in range(rod.N - 1):
        yj, zj = yh[..., j, :], zh[..., j, :]
        yj1, zj1 = yh[..., j + 1, :], zh[..., j + 1, :]
        ym, zm = 0.5 * (yj + yj1), 0.5 * (zj + zj1)
        k1, zn = R.rhs(rod, y, yj, zj, tf, net)
        k2, _ = R.rhs(rod, y + k1 * (ds / 2), ym, zm, tf, net)
        k3, _ = R.rhs(rod, y + k2 * (ds / 2), ym, zm, tf, net)
        k4, _ = R.rhs(rod, y + k3 * ds, yj1, zj1, tf, net)
        y = y + ds * (k1 + 2 * (k2 + k3) + k4) / 6
        ys.append(y)
        zs.append(zn)
    return torch.stack(ys, -2), torch.stack(zs, -2)


def sweeper(rod: R.Rod, net):
    """sweep(G, yh, zh, tf) -> (y, z) for one net: graphed on a CUDA device
    (Graphed), eager elsewhere."""
    fn = lambda G, yh, zh, tf: sweep(rod, G, yh, zh, tf, net)
    return Graphed(fn) if rod.device.type == "cuda" else fn


class Graphed:
    """A sweep function with the sweep of each set of input shapes and
    dtypes captured once as a CUDA graph (on its first call, after a
    warm-up on a side stream) and replayed: the inputs are copied into the
    graph's own, the outputs copied out."""

    def __init__(self, fn):
        self.fn, self.graphs = fn, {}

    def __call__(self, G, yh, zh, tf):
        key = tuple((t.shape, t.dtype) for t in (G, yh, zh, tf))
        if key not in self.graphs:
            ins = [t.clone() for t in (G, yh, zh, tf)]
            side = torch.cuda.Stream(device=G.device)
            side.wait_stream(torch.cuda.current_stream(G.device))
            with torch.cuda.stream(side):
                self.fn(*ins)
            torch.cuda.current_stream(G.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                outs = self.fn(*ins)
            self.graphs[key] = (graph, ins, outs)
        graph, ins, outs = self.graphs[key]
        for a, b in zip(ins, (G, yh, zh, tf)):
            a.copy_(b)
        graph.replay()
        return tuple(o.clone() for o in outs)


@torch.no_grad()
def newton(rod: R.Rod, G, yh, zh, tf, net, tol: float, max_iter: int,
           sweep_fn=None):
    """rod.newton over this module's sweep: the same forward-difference
    Jacobian, Levenberg-Marquardt ladder and line search, and the same
    count of sweeps (the first residual, 6 probes an iteration, the line
    search up to its first improving candidate, all 7 when none improves).
    ``sweep_fn``: the sweep as ``sweeper`` gives it (eager by default).
    Returns (G, r2, iters, sweeps)."""
    B, dtype, dev = G.shape[0], G.dtype, G.device
    eps = R.fd_eps(dtype)
    eye = torch.eye(6, dtype=dtype, device=dev)
    alphas = 0.5 ** torch.arange(R.N_ALPHAS, dtype=dtype, device=dev)
    rep = lambda a, k: a.repeat_interleave(k, 0)
    sweep_fn = sweep_fn or (lambda *a: sweep(rod, *a, net))

    def res(Gx, k):
        y, _ = sweep_fn(Gx, rep(yh, k), rep(zh, k), rep(tf, k))
        return R.tip_residual(rod, y)

    r = res(G, 1)
    r2 = (r * r).sum(-1)
    lam = torch.zeros(B, dtype=dtype, device=dev)
    fails = torch.zeros(B, dtype=torch.int64, device=dev)
    iters = torch.zeros(B, dtype=torch.int64, device=dev)
    sweeps = torch.ones(B, dtype=torch.int64, device=dev)
    rows = torch.arange(B, device=dev)
    for _ in range(max_iter):
        active = (r2 > tol) & (fails <= R.MAX_ESCALATIONS)
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
        rc = res(cand.reshape(B * R.N_ALPHAS, 6), R.N_ALPHAS).reshape(
            B, R.N_ALPHAS, 6)
        r2c = (rc * rc).sum(-1)
        improves = r2c < r2[:, None]
        found = improves.any(1)
        pick = torch.where(found, improves.long().argmax(1), 0)
        ok = active & found
        G = torch.where(ok[:, None], cand[rows, pick], G)
        r = torch.where(ok[:, None], rc[rows, pick], r)
        r2 = torch.where(ok, r2c[rows, pick], r2)
        stall = active & ~found
        lam = torch.where(stall, torch.clamp_min(lam * R.LM_GROWTH,
                                                 R.LM_LAMBDA0),
                          torch.zeros_like(lam))
        fails = torch.where(stall, fails + 1,
                            torch.where(active, torch.zeros_like(fails),
                                        fails))
        iters = iters + active.long()
        sweeps = sweeps + active.long() * (
            6 + torch.where(found, pick + 1,
                            torch.full_like(pick, R.N_ALPHAS)))
    return G, r2, iters, sweeps


@torch.no_grad()
def step(rod: R.Rod, y, z, y_prev, z_prev, G, tensions, net, tol, max_iter,
         sweep_fn=None):
    """One BDF-2 step of B rods (rod.step over this module's sweep): (y',
    z', G', yh, zh, r2, iters, sweeps); the tip's z is carried."""
    yh, zh = R.history(rod, y, z, y_prev, z_prev)
    tf = R.tendon_forces(rod, tensions)
    sweep_fn = sweep_fn or (lambda *a: sweep(rod, *a, net))
    G, r2, iters, sweeps = newton(rod, G, yh, zh, tf, net, tol, max_iter,
                                  sweep_fn)
    yn, zb = sweep_fn(G, yh, zh, tf)
    zn = torch.cat([zb, z[:, -1:, :]], 1)
    return yn, zn, G, yh, zh, r2, iters, sweeps + 1


@torch.no_grad()
def rollout(rod: R.Rod, controls, net, tol, max_iter):
    """rod.rollout over this module's step: controls (B, T, 4) -> records
    (B, T, N, 50) = [y, z, yh, zh] with the rest state first, each step's
    Newton started from 2 G - G_prev, and the per-step (r2, iters, sweeps)
    (T-1, B)."""
    sweep_fn = sweeper(rod, net)
    B, T = controls.shape[:2]
    y0, z0 = R.initial_state(rod)
    y = y0.expand(B, -1, -1).contiguous()
    z = z0.expand(B, -1, -1).contiguous()
    yp, zp = y, z
    G = Gp = torch.zeros((B, 6), dtype=rod.dtype, device=rod.device)
    recs = [torch.cat([y, z, y, z], -1)]
    out = []
    for t in range(T - 1):
        yn, zn, Gn, yh, zh, r2, it, sw = step(
            rod, y, z, yp, zp, 2.0 * G - Gp, controls[:, t], net, tol,
            max_iter, sweep_fn)
        recs.append(torch.cat([yn, zn, yh, zh], -1))
        out.append((r2, it, sw))
        y, z, yp, zp, G, Gp = yn, zn, y, z, Gn, G
    r2, it, sw = (torch.stack(v) for v in zip(*out))
    return torch.stack(recs, 1), r2, it, sw


def program_residual(rod: R.Rod, traj, controls, net):
    """max over rods and steps of |r| of this module's sweep at the
    program's base reaction (node 0's n and m), on the BDF-2 history of
    the program's two previous states; one batched sweep in the rod's
    dtype. ``net``: [W1, b1, W2, b2]."""
    traj = traj.to(rod.device, rod.dtype)
    y, z = traj[..., :19], traj[..., 19:25]
    B, T = y.shape[:2]
    prev = torch.cat([y[:, :1], y[:, :-1]], 1)
    zprev = torch.cat([z[:, :1], z[:, :-1]], 1)
    yh, zh = R.history(rod, y[:, :-1], z[:, :-1], prev[:, :-1],
                       zprev[:, :-1])
    tf = R.tendon_forces(rod, controls[:, :T - 1].to(rod.dtype))
    G = y[:, 1:, 0, 7:13]
    flat = lambda a: a.reshape((-1,) + a.shape[2:])
    ys, _ = sweep(rod, flat(G), flat(yh), flat(zh), flat(tf), net)
    return float(R.tip_residual(rod, ys).norm(dim=-1).max())
