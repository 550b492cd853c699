"""Explicit halo-exchange spatial sharding for very fine rods.

PyTorch counterpart of ``knode_cosserat_tpu/parallel/spatial.py``.
``simulate_scan_ms(mesh=...)`` (core/multiple_shooting.py) splits the
segment sweeps over the mesh but gathers every segment's 19 x 19 tangent
and runs the S-long affine prefix on every rank: the wire and the memory
grow with S. Here they do not; each rank of the "seq" axis (D ranks) keeps
only its own part, and the collectives are placed by hand:

  * unknowns: each rank OWNS the 19-dim start states of its S/D segments;
    only G (6 numbers) is replicated (rank 0's first start is base_state(G));
  * continuity residual: one halo per evaluation, the next rank's first
    start travelling one hop LEFT (``_send_left``);
  * BDF-2 history: one halo per time step, the last swept node (current and
    previous step) travelling one hop RIGHT (``_send_right``);
  * Newton direction (multiple_shooting._structured_direction's
    block-bidiagonal elimination): a local inclusive prefix of the affine
    maps (multiple_shooting._chain_prefix), an ``all_gather`` of the D
    ranks' TOTAL operators (19 x 19 + 19 each, independent of S), a
    redundant exclusive compose over D, a local apply, and the damped 6 x 6
    reduced solve, replicated;
  * sweeps, tangents and line-search candidates are rank-local.

The halos are ``dist.batch_isend_irecv`` pairs, so a ring of ranks cannot
deadlock; the edge rank receives zeros. The damped-Newton loop is
multiple_shooting._newton_loop, with r2 summed over the ranks and a
direction that is finite on every rank (its fallback decided globally), so
every rank takes the same branch. Same discrete equations and damped
Newton / LM semantics as solver="structured", so trajectories match it to
solver tolerance.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..core.multiple_shooting import (_chain_prefix, _newton_loop,
                                      _segment_sweeps)
from ..core.params import RodParams
from ..core.shooting import block_jacobian
from ..core.spatial import base_state
from ..core.stepper import SimOutput, initial_state, tendon_forces
from ..ops.linalg import solve_small
from .mesh import P, Placement

__all__ = ["simulate_scan_ms_halo"]


def _rank_at(mesh, axis: str, k: int) -> int:
    """The global rank at coordinate k of ``axis``, this rank's elsewhere."""
    coord = [mesh.index(a) for a in mesh.axis_names]
    coord[mesh.axis_names.index(axis)] = k
    return int(mesh.device_mesh.mesh[tuple(coord)])


def _shift(x: torch.Tensor, mesh, axis: str, step: int) -> torch.Tensor:
    """Rank d's ``x`` to rank d + step along ``axis``; the rank with no
    sender receives zeros."""
    D, d = mesh.shape[axis], mesh.index(axis)
    out = torch.zeros_like(x)
    ops = []
    if 0 <= d + step < D:
        ops.append(dist.P2POp(dist.isend, x.contiguous(),
                              _rank_at(mesh, axis, d + step)))
    if 0 <= d - step < D:
        ops.append(dist.P2POp(dist.irecv, out, _rank_at(mesh, axis, d - step)))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def _send_right(x, mesh, axis):
    """Rank d -> d+1 (rank 0 receives zeros)."""
    return _shift(x, mesh, axis, 1)


def _send_left(x, mesh, axis):
    """Rank d -> d-1 (rank D-1 receives zeros)."""
    return _shift(x, mesh, axis, -1)


def simulate_scan_ms_halo(
    p: RodParams,
    controls,
    n_segments: int,
    mesh,
    nn_fn: Optional[Callable] = None,
    nn_history: bool = False,
    tol: Optional[float] = None,
    max_iter: int = 50,
    seq_axis: str = "seq",
    max_backtracks: int = 6,
    lm_lambda0: float = 1e-4,
    lm_growth: float = 30.0,
    max_escalations: int = 4,
) -> SimOutput:
    """The analogue of ``simulate_scan_ms(solver="structured")`` whose
    segment axis is split over ``mesh[seq_axis]`` with halo exchanges
    (module docstring). Same trajectory contract and quirks as
    core/stepper.simulate_scan ([:-1] drop, frozen tip z, [y, z, yh, zh]
    records); every rank returns the whole rollout. Records no autograd
    graph."""
    if tol is None:
        tol = 1e-16 if p.dtype == torch.float64 else 1e-10
    S = int(n_segments)
    m = (p.N - 1) // S
    if S < 1 or m * S != p.N - 1:
        raise ValueError(f"n_segments={S} must divide N-1={p.N - 1}")
    D = mesh.shape[seq_axis]
    if S % D:
        raise ValueError(f"n_segments={S} must divide over the "
                         f"{seq_axis}={D} mesh axis")
    Sd = S // D
    dtype, device = p.dtype, p.device
    kw = dict(dtype=dtype, device=device)
    didx = mesh.index(seq_axis)
    is_first, is_last = didx == 0, didx == D - 1
    eye6, eye19 = torch.eye(6, **kw), torch.eye(19, **kw)
    zeros19 = torch.zeros(19, **kw)
    # dYb/dG selector: starts[0] = base_state(G) places G at rows 7:13
    B = torch.zeros((19, 6), **kw)
    B[7:13] = eye6
    left = lambda x: _send_left(x, mesh, seq_axis)
    right = lambda x: _send_right(x, mesh, seq_axis)
    psum = lambda x: mesh.all_reduce(x, (seq_axis,))

    def split(X):
        return X[..., :6], X[..., 6:].reshape(X.shape[:-1] + (Sd, 19))

    def fix_first(G, St):
        """Rank 0's first start is derived from G, not free."""
        if not is_first:
            return St
        return torch.cat([base_state(p, G).unsqueeze(-2), St[..., 1:, :]],
                         dim=-2)

    def cont_rows(St_f, ends):
        """Local continuity rows; the boundary to the next rank comes in by
        the LEFT halo; the last rank's final row is the tip's (zero)."""
        nxt = left(St_f[..., 0, :])
        last = (ends[..., -1, :] - nxt) * (0.0 if is_last else 1.0)
        return torch.cat([ends[..., :-1, :] - St_f[..., 1:, :],
                          last.unsqueeze(-2)], dim=-2)

    def tip_of(e_last):
        if not is_last:
            return torch.zeros(e_last.shape[:-1] + (6,), **kw)
        return torch.cat([p.F_tip - e_last[..., 7:10],
                          p.M_tip - e_last[..., 10:13]], dim=-1)

    def rollout_step(yh_l, zh_l, tf, G_ws, St_ws):
        def ends_of(St_f):
            return _segment_sweeps(p, St_f, yh_l, zh_l, tf, nn_fn,
                                   nn_history, want_states=False)[2]

        def residual(X):
            G, St = split(X)
            St_f = fix_first(G, St)
            e = ends_of(St_f)
            return torch.cat([cont_rows(St_f, e).flatten(-2), tip_of(e[..., -1, :])],
                             dim=-1)

        def direction(X, r, lam):
            G, St = split(X)
            St_f = fix_first(G, St)
            A = block_jacobian(ends_of, St_f)             # (Sd, 19, 19)
            e = ends_of(St_f)
            cont = cont_rows(St_f, e)
            r_tip = psum(tip_of(e[-1]))
            scale = 1.0 / (1.0 + lam)
            ops_T, ops_t = scale * A, scale * cont
            if is_last:
                # the last rank's final map is the tip, not a continuity
                # boundary: the identity, so local prefixes compose
                ops_T = torch.cat([ops_T[:-1], eye19[None]])
                ops_t = torch.cat([ops_t[:-1], zeros19[None]])
            Tp, tp = _chain_prefix(ops_T, ops_t, eye19)
            # the D ranks' total operators, composed exclusively
            T_all = torch.stack(mesh.all_gather(Tp[-1], seq_axis))
            t_all = torch.stack(mesh.all_gather(tp[-1], seq_axis))
            if didx == 0:
                Tin, tin = eye19, zeros19
            else:
                T_inc, t_inc = _chain_prefix(T_all[:didx], t_all[:didx],
                                             eye19)
                Tin, tin = T_inc[-1], t_inc[-1]
            Tg = Tp @ Tin
            tg = (Tp @ tin.unsqueeze(-1)).squeeze(-1) + tp
            # the reduced 6x6 tip system, on the last rank's operators
            own = lambda t: t if is_last else torch.zeros_like(t)
            M_last = psum(own(Tg[-1] @ B))
            v_last = psum(own(tg[-1].clone()))
            CA = psum(own(A[-1, 7:13, :].clone()))
            K = CA @ M_last
            rhs6 = r_tip - CA @ v_last
            Dd = torch.diagonal(K).abs().clamp_min(1.0)
            dG = solve_small(K + lam * Dd * eye6, rhs6)
            # start j of this rank uses the global prefix at the boundary
            # before it: the incoming operator for j = 0
            Mrows = torch.cat([(Tin @ B)[None], Tg[:-1] @ B])
            vrows = torch.cat([tin[None], tg[:-1]])
            dSt = (Mrows @ dG.unsqueeze(-1)).squeeze(-1) + vrows
            # steepest descent where the solve went non-finite on any rank:
            # -cont shifted one row right across the boundary (RIGHT halo)
            bad = psum((~torch.isfinite(dSt)).sum().to(dtype))
            if bool(bad > 0) or not bool(torch.isfinite(dG).all()):
                dG = -r_tip
                dSt = -torch.cat([right(cont[-1])[None], cont[:-1]])
            if is_first:
                dSt = torch.cat([torch.zeros_like(dSt[:1]), dSt[1:]])
            return torch.cat([dG, dSt.reshape(-1)])

        X0 = torch.cat([G_ws, St_ws.reshape(-1)])
        X, stats = _newton_loop(
            residual, direction, X0, tol, max_iter,
            max_backtracks=max_backtracks, lm_lambda0=lm_lambda0,
            lm_growth=lm_growth, max_escalations=max_escalations,
            sumsq=lambda r: psum((r * r).sum(-1)))
        G, St = split(X)
        return G, fix_first(G, St), stats

    controls = torch.as_tensor(controls, **kw)
    T = controls.shape[0]
    y0, z0 = initial_state(p)                     # (N, 19), (N, 6)
    g0 = didx * Sd * m                            # first owned node - 1
    y_loc, z_loc = y0[g0 + 1:g0 + 1 + Sd * m], z0[g0:g0 + Sd * m]
    y_prev, z_prev = y_loc, z_loc
    y_base = y_base_prev = y0[0]
    z_tip = z0[-1]
    G = G_prev = torch.zeros(6, **kw)
    c1, c2 = p.c1, p.c2
    recs, rec0s, Gs, iters, res, lm = [], [], [], [], [], []
    with torch.no_grad():
        for t in range(T - 1):
            tf = tendon_forces(p, controls[t])
            # RIGHT halo: the last swept node (current, previous step)
            # seeds the next rank's history and warm start
            halo = right(torch.stack([y_loc[-1], y_prev[-1]]))
            halo_y = y_base if is_first else halo[0]
            halo_y_prev = y_base_prev if is_first else halo[1]
            y_in = torch.cat([halo_y[None], y_loc[:-1]])
            y_in_prev = torch.cat([halo_y_prev[None], y_prev[:-1]])
            yh_l = (c1 * y_in + c2 * y_in_prev).reshape(Sd, m, 19)
            zh_flat = c1 * z_loc + c2 * z_prev
            zh_l = zh_flat.reshape(Sd, m, 6)
            St_ws = torch.cat([halo_y[None], y_loc[m - 1:Sd * m - 1:m]])
            G_new, St_f, stats = rollout_step(yh_l, zh_l, tf, 2.0 * G - G_prev,
                                              St_ws)
            ys, zs, _ = _segment_sweeps(p, St_f, yh_l, zh_l, tf, nn_fn,
                                        nn_history)
            y_new, z_new_in = ys.reshape(Sd * m, 19), zs.reshape(Sd * m, 6)
            # records [y, z, yh, zh] of the owned nodes g0+1 .. g0+Sd*m; z
            # at the last owned node is the next rank's first input strain
            # (LEFT halo); the tip's z stays frozen (stepper quirk)
            z_halo = left(z_new_in[0])
            z_rows = torch.cat([z_new_in[1:],
                                (z_tip if is_last else z_halo)[None]])
            yh_rows = c1 * y_loc + c2 * y_prev
            zh_halo = left(zh_flat[0])
            zh_rows = torch.cat([zh_flat[1:],
                                 (c1 * z_tip + c2 * z_tip if is_last
                                  else zh_halo)[None]])
            recs.append(torch.cat([y_new, z_rows, yh_rows, zh_rows], dim=-1))
            # node 0's row is rank 0's, shared by a sum
            y_base_new = base_state(p, G_new)
            rec0 = torch.cat([y_base_new, z_new_in[0],
                              c1 * y_base + c2 * y_base_prev, zh_flat[0]])
            rec0s.append(psum(rec0 if is_first else torch.zeros_like(rec0)))
            Gs.append(G_new)
            iters.append(stats.iterations)
            res.append(stats.residual_norm)
            lm.append(stats.lm_retries)
            y_loc, z_loc, y_prev, z_prev = y_new, z_new_in, y_loc, z_loc
            y_base, y_base_prev, G, G_prev = y_base_new, y_base, G_new, G

        rec_t0 = torch.cat([y0, z0, y0, z0], dim=-1)[None]
        if T > 1:
            body = Placement(mesh, P(None, seq_axis)).gather(
                torch.stack(recs))                        # (T-1, N-1, 50)
            body = torch.cat([torch.stack(rec0s)[:, None], body], dim=1)
            traj = torch.cat([rec_t0, body])
        else:
            traj = rec_t0
    zero_i = torch.zeros((), dtype=torch.int32, device=device)
    zero_f = torch.zeros((), **kw)
    return SimOutput(traj, torch.stack([torch.zeros(6, **kw)] + Gs),
                     torch.stack([zero_i] + iters),
                     torch.stack([zero_f] + res),
                     torch.stack([zero_i] + lm))
