"""Parallel-in-space Newton: multiple shooting over rod segments.

PyTorch counterpart of ``knode_cosserat_tpu/core/multiple_shooting.py``.
The spatial sweep is a sequential recurrence over N-1 nodes; multiple
shooting splits the rod into S segments of m = (N-1)/S steps, promotes the
S-1 interior segment-start states to unknowns and solves for

    X = [ G (6),  y_seg1 (19), ..., y_seg(S-1) (19) ]

with the residual stacking state continuity at every interior boundary and
the tip force/moment boundary condition. The S segment sweeps run as ONE
loop of m steps over a width-S batch axis (the JAX package's vmap), so the
sequential depth drops S-fold. The converged solution satisfies the same
discrete equations as single shooting, so trajectories match
core/stepper.simulate_scan to Newton precision.

The damped-Newton loop (``_newton_loop``: the backtracking line search and
the Levenberg-Marquardt stall ladder) is shared with the assembly solver
(core/assembly.py) and the halo solver (parallel/spatial.py); it drives
one system X (U,), or B of them X (B, U) under per-system masks (the
batched coupled assembly, the JAX package's vmap). The residual
broadcasts over leading axes, so the line search's candidates take one
residual call. The loop decides on the host each iteration (one
synchronisation per iteration on a CUDA device). Two
direction producers use it here: ``_structured_direction`` (the
block-bidiagonal elimination: per-segment 19x19 tangents, an affine
prefix, one 6x6 solve) and the dense LU of ``_newton_dense``.

Over a device mesh (``mesh=``, parallel/mesh.py) the segment sweeps split
over its "seq" ranks: each rank sweeps its S/D segments, the segment ends
and the per-segment tangents are gathered, and the small algebra (the
19x19 prefix, the 6x6 solve, the dense LU) runs replicated on every rank,
which is what the JAX package's sharding constraints make GSPMD do. The
halo-exchange design that keeps only O(D) operators on the wire is
parallel/spatial.simulate_scan_ms_halo.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops.linalg import solve_small
from .params import RodParams
from .rhs import rhs
from .shooting import NewtonStats, block_jacobian
from .spatial import base_state
from .stepper import SimOutput, initial_state, tendon_forces

__all__ = ["ms_solve_step", "simulate_scan_ms", "jacobian", "_newton_loop",
           "_lm_damped_solve", "_newton_dense", "_chain_prefix",
           "_segment_sweeps"]

# from this many interior boundaries up the structured direction takes the
# log-depth (doubling) prefix of its affine maps, as the JAX package takes
# its associative scan
_DOUBLING_FROM = 32


def jacobian(fn: Callable[[torch.Tensor], torch.Tensor],
             x: torch.Tensor, m: int | None = None) -> torch.Tensor:
    """J[..., i, k] = d fn(x)[..., i] / d x[..., k] for fn: (..., n) ->
    (..., m) that broadcasts over leading axes, from ONE reverse pass: x
    is replicated m times along a new leading axis, copy i keeps component
    i of its output, and the gradient of their sum holds row i in copy i
    (the trick of core/shooting.py). x (n,) gives (m, n); a batch x
    (B, n), whose row b of fn's output depends on x[b] alone, gives
    (B, m, n). ``m`` defaults to n (a square system). Detached."""
    with torch.enable_grad():
        x0 = x.detach()
        m = x0.shape[-1] if m is None else m
        xr = x0.expand((m,) + x0.shape).clone().requires_grad_(True)
        r = fn(xr)
        (g,) = torch.autograd.grad(
            torch.diagonal(r, dim1=0, dim2=-1).sum(), xr)
    return g.movedim(0, -2)


def _sumsq(r):
    return (r * r).sum(-1)


def _newton_loop(residual_fn, direction_fn, X0, tol, max_iter,
                 max_backtracks=6, lm_lambda0=1e-4, lm_growth=30.0,
                 max_escalations=4, sumsq=_sumsq):
    """Damped Newton with a backtracking line search and an LM stall ladder.

    ``direction_fn(X, r, lam) -> dX`` gives the (LM-damped) Newton
    direction; the loop owns the rest: the candidates X + 0.5^k dX
    (k = 0..max_backtracks) in one residual call, the first improving
    one taken; a stall holds X and sets lam = max(lam * lm_growth,
    lm_lambda0), a success resets lam to 0; a non-finite dX falls back
    to -r; the loop runs while r2 > tol, it < max_iter and
    fails <= max_escalations. ``sumsq(r)`` is r2 over r's last axis (the
    halo solver's sums over every rank's rows). Returns (X, NewtonStats)
    with scalar stats.

    X0 (B, U) solves B independent systems at once (the JAX package's
    loop under ``jax.vmap``): :func:`_newton_loop_batched`.
    """
    if X0.dim() > 1:
        return _newton_loop_batched(residual_fn, direction_fn, X0, tol,
                                    max_iter, max_backtracks, lm_lambda0,
                                    lm_growth, max_escalations, sumsq)
    dtype, device = X0.dtype, X0.device
    alphas = (0.5 ** torch.arange(max_backtracks + 1, dtype=torch.float64)
              ).to(device=device, dtype=dtype)
    X = X0
    r = residual_fn(X)
    r2 = sumsq(r)
    it = lam = fails = retries = 0
    while bool(r2 > tol) and it < max_iter and fails <= max_escalations:
        dX = direction_fn(X, r, lam)
        if not bool(torch.isfinite(dX).all()):
            dX = -r
        X_cand = X + alphas[:, None] * dX
        r_cand = residual_fn(X_cand)
        r2_cand = sumsq(r_cand)
        improves = r2_cand < r2
        if bool(improves.any()):
            k = int(improves.int().argmax())    # the first (largest) alpha
            X, r, r2 = X_cand[k], r_cand[k], r2_cand[k]
            lam, fails = 0.0, 0
        else:
            lam = max(lam * lm_growth, lm_lambda0)
            fails += 1
            retries += 1
        it += 1
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=device)
    return X, NewtonStats(i32(it), r2.sqrt(), r2 <= tol, i32(retries))


def _newton_loop_batched(residual_fn, direction_fn, X0, tol, max_iter,
                         max_backtracks, lm_lambda0, lm_growth,
                         max_escalations, sumsq):
    """:func:`_newton_loop` over B systems X0 (B, U), as ``jax.vmap`` runs
    the JAX package's: each system keeps its own it, lam, fails and
    retries and an active mask (r2 > tol, it < max_iter, fails <=
    max_escalations), and one that is done holds its X, r and counters
    while the others iterate. residual_fn: (..., B, U) -> (..., B, U),
    row b depending on X[..., b, :] alone; direction_fn(X (B, U), r
    (B, U), lam (B,)) -> dX (B, U). One host synchronisation an
    iteration (``active.any()``). Returns (X, NewtonStats), stats (B,)."""
    dtype, device = X0.dtype, X0.device
    B = X0.shape[0]
    alphas = (0.5 ** torch.arange(max_backtracks + 1, dtype=torch.float64)
              ).to(device=device, dtype=dtype)
    rows = torch.arange(B, device=device)
    X = X0
    r = residual_fn(X)
    r2 = sumsq(r)
    it = torch.zeros(B, dtype=torch.int32, device=device)
    fails = torch.zeros_like(it)
    retries = torch.zeros_like(it)
    lam = torch.zeros(B, dtype=dtype, device=device)
    while True:
        active = (r2 > tol) & (it < max_iter) & (fails <= max_escalations)
        if not bool(active.any()):
            break
        dX = direction_fn(X, r, lam)
        dX = torch.where(torch.isfinite(dX).all(-1, keepdim=True), dX, -r)
        X_cand = X + alphas[:, None, None] * dX       # (A, B, U)
        r_cand = residual_fn(X_cand)
        r2_cand = sumsq(r_cand)
        improves = r2_cand < r2
        found = improves.any(0)
        pick = improves.int().argmax(0)       # the first improver, else 0
        step = active & found
        X = torch.where(step[:, None], X_cand[pick, rows], X)
        r = torch.where(step[:, None], r_cand[pick, rows], r)
        r2 = torch.where(step, r2_cand[pick, rows], r2)
        lam = torch.where(active, torch.where(
            found, 0.0, torch.clamp_min(lam * lm_growth, lm_lambda0)), lam)
        fails = torch.where(active, torch.where(found, 0, fails + 1), fails)
        retries = retries + (active & ~found).int()
        it = it + active.int()
    return X, NewtonStats(it, r2.sqrt(), r2 <= tol, retries)


def _lm_damped_solve(J, r, lam, eye):
    """LM-damped LU solve of J dX = -r with Marquardt diagonal scaling
    D = max(|diag J|, 1). A singular system gives NaN (ops/linalg.py),
    which the loop's non-finite fallback catches. A batch: J (B, U, U),
    r (B, U), lam (B,)."""
    D = torch.diagonal(J, dim1=-2, dim2=-1).abs().clamp_min(1.0)
    if torch.is_tensor(lam):
        return solve_small(J + lam[:, None, None] * D[:, None, :] * eye, -r)
    return solve_small(J + lam * D * eye, -r)


def _newton_dense(residual_fn, X0, tol, max_iter, **kw):
    """The shared loop with the exact dense Jacobian of ``residual_fn``
    (one replicated reverse pass, :func:`jacobian`) and an LU solve."""
    eye = torch.eye(X0.shape[-1], dtype=X0.dtype, device=X0.device)

    def direction(X, r, lam):
        return _lm_damped_solve(jacobian(residual_fn, X), r, lam, eye)

    return _newton_loop(residual_fn, direction, X0, tol, max_iter, **kw)


# ------------------------------------------------------- multiple shooting

def _segment_sweeps(p: RodParams, starts, yh_segs, zh_segs, tf, nn_fn,
                    nn_history, want_states: bool = True):
    """All S segment sweeps at once: starts (..., S, 19), yh_segs
    (S, m, 19), zh_segs (S, m, 6) -> (y_nodes (..., S, m, 19),
    z (..., S, m, 6), ends (..., S, 19)); one loop of m steps over the
    width-S batch. want_states=False returns (None, None, ends)."""
    y = starts
    ys, zs = [], []
    for j in range(yh_segs.shape[1]):
        dy, zj = rhs(p, y, yh_segs[:, j], zh_segs[:, j], tf, nn_fn,
                     nn_history)
        y = y + p.ds * dy
        if want_states:
            ys.append(y)
            zs.append(zj)
    if not want_states:
        return None, None, y
    return torch.stack(ys, dim=-2), torch.stack(zs, dim=-2), y


class _Split:
    """The segment axis over ``mesh[axis]``: this rank sweeps segments
    [lo, hi), and ``gather`` puts the ranks' pieces of a per-segment
    tensor back together along ``dim``."""

    def __init__(self, mesh, axis: str, S: int):
        from ..parallel.mesh import P, Placement

        if axis not in getattr(mesh, "shape", {}):
            raise ValueError(f"the mesh {mesh!r} has no axis {axis!r}")
        D = mesh.shape[axis]
        if S % D:
            raise ValueError(f"n_segments={S} must divide over the "
                             f"{axis}={D} mesh axis")
        self.place = lambda dim: Placement(mesh, P(*(None,) * dim, axis))
        own = self.place(0).span(S)
        self.lo, self.hi = own.start, own.stop

    def gather(self, t, dim: int):
        return self.place(dim % t.ndim).gather(t)


def _ends(p: RodParams, starts, yh_segs, zh_segs, tf, nn_fn, nn_history,
          split: _Split | None):
    """The S segments' end states (..., S, 19): every sweep here, or this
    rank's under a split, gathered."""
    if split is None:
        return _segment_sweeps(p, starts, yh_segs, zh_segs, tf, nn_fn,
                               nn_history, want_states=False)[2]
    lo, hi = split.lo, split.hi
    e = _segment_sweeps(p, starts[..., lo:hi, :], yh_segs[lo:hi],
                        zh_segs[lo:hi], tf, nn_fn, nn_history,
                        want_states=False)[2]
    return split.gather(e, -2)


def _tangents(p: RodParams, starts, yh_segs, zh_segs, tf, nn_fn, nn_history,
              split: _Split | None):
    """(A (S, 19, 19), e (S, 19)): each segment's end and its tangent with
    respect to the segment's start, from one replicated reverse pass
    (shooting.block_jacobian) over the segments this rank sweeps, gathered
    under a split."""
    lo, hi = (0, starts.shape[-2]) if split is None else (split.lo, split.hi)

    def ends(s):
        return _segment_sweeps(p, s, yh_segs[lo:hi], zh_segs[lo:hi], tf,
                               nn_fn, nn_history, want_states=False)[2]

    A = block_jacobian(ends, starts[lo:hi])
    with torch.no_grad():
        e = ends(starts[lo:hi])
    if split is not None:
        A, e = split.gather(A, 0), split.gather(e, 0)
    return A, e


def _starts(p: RodParams, X, S):
    """X (..., 6 + 19(S-1)) -> (G, Yb (..., S-1, 19), starts (..., S, 19))."""
    G = X[..., :6]
    Yb = X[..., 6:].reshape(X.shape[:-1] + (S - 1, 19))
    return G, Yb, torch.cat([base_state(p, G).unsqueeze(-2), Yb], dim=-2)


def _ms_residual(p: RodParams, X, yh_segs, zh_segs, tf, S, nn_fn,
                 nn_history, split: _Split | None = None):
    """Stacked residual [continuity (19*(S-1)), tip force/moment (6)] of
    X (..., 6 + 19(S-1))."""
    _, Yb, starts = _starts(p, X, S)
    ends = _ends(p, starts, yh_segs, zh_segs, tf, nn_fn, nn_history, split)
    cont = (ends[..., :-1, :] - Yb).reshape(X.shape[:-1] + (-1,))
    tip = torch.cat([p.F_tip - ends[..., -1, 7:10],
                     p.M_tip - ends[..., -1, 10:13]], dim=-1)
    return torch.cat([cont, tip], dim=-1)


def _chain_prefix(Ap, bp, B):
    """Sequential prefix of the affine maps x -> Ap_i x + bp_i from
    (B, 0): Ms_i = Ap_i ... Ap_0 B (S-1, 19, 6), vs_i = the maps applied
    in turn to 0 (S-1, 19)."""
    M, v = B, torch.zeros_like(bp[0])
    Ms, vs = [], []
    for A_i, b_i in zip(Ap, bp):
        M = A_i @ M
        v = A_i @ v + b_i
        Ms.append(M)
        vs.append(v)
    return torch.stack(Ms), torch.stack(vs)


def _doubling_prefix(Ap, bp, B):
    """The same prefix as :func:`_chain_prefix` in ceil(log2(S-1)) rounds
    of batched products (Hillis-Steele): in round d every map i >= d is
    composed after map i - d, (A, b)_i <- (A_i A_{i-d}, A_i b_{i-d} + b_i),
    the inclusive prefix the JAX package takes by lax.associative_scan."""
    A, b = Ap, bp
    d = 1
    while d < A.shape[0]:
        A, b = (torch.cat([A[:d], A[d:] @ A[:-d]]),
                torch.cat([b[:d], (A[d:] @ b[:-d].unsqueeze(-1)).squeeze(-1)
                           + b[d:]]))
        d *= 2
    return A @ B, b


def _structured_direction(p: RodParams, X, lam, yh_segs, zh_segs, tf, S,
                          nn_fn, nn_history, split: _Split | None = None):
    """Newton direction exploiting the block-BIDIAGONAL Jacobian.

    Row structure of _ms_residual's Jacobian:
      cont_i = e_i(s_i) - Yb_i   ->  [A_i on s_i,  -I on Yb_i]
      tip    = t - C e_S(s_S)    ->  [-C A_S on s_S]
    with s_1 = base_state(G) (the constant selector B with respect to G)
    and s_i = Yb_{i-1}. Forward elimination turns the solve into an affine
    prefix of 19x19 blocks plus ONE 6x6 reduced solve: dYb_i = M_i dG + v_i
    with (M_i, v_i) = (A_i M_{i-1}, A_i v_{i-1} + r_i). The per-segment
    tangents A_i (S, 19, 19) come from one replicated reverse pass over a
    (19, S)-copy batch (shooting.block_jacobian). LM damping scales the -I
    diagonal blocks by (1 + lam) and damps the reduced 6x6 system, as in
    the JAX package. Under a split the tangents come from each rank's
    segments, gathered (_tangents), and the rest runs replicated.
    """
    dtype, device = X.dtype, X.device
    _, Yb, starts = _starts(p, X, S)
    A, e = _tangents(p, starts, yh_segs, zh_segs, tf, nn_fn, nn_history,
                     split)                     # (S, 19, 19), (S, 19)
    r_cont = e[:-1] - Yb                        # (S-1, 19)
    r_tip = torch.cat([p.F_tip - e[-1, 7:10], p.M_tip - e[-1, 10:13]])

    B = torch.zeros((19, 6), dtype=dtype, device=device)
    B[7:13] = torch.eye(6, dtype=dtype, device=device)
    scale = 1.0 / (1.0 + lam)
    prefix = _doubling_prefix if S - 1 >= _DOUBLING_FROM else _chain_prefix
    Ms, vs = prefix(scale * A[:-1], scale * r_cont, B)
    M_last, v_last = Ms[-1], vs[-1]

    CA = A[-1, 7:13, :]                         # (6, 19)
    K = CA @ M_last                             # (6, 6)
    rhs6 = r_tip - CA @ v_last
    D = torch.diagonal(K).abs().clamp_min(1.0)
    dG = solve_small(K + lam * D * torch.eye(6, dtype=dtype, device=device),
                     rhs6)
    dYb = (Ms @ dG) + vs                        # (S-1, 19)
    return torch.cat([dG, dYb.reshape(-1)])


def _dense_from_tangents(A, S: int):
    """The dense Jacobian of _ms_residual assembled from the segment
    tangents A (S, 19, 19), its block rows as _structured_direction writes
    them: continuity row j is A_j on segment j's start (through the
    selector B of G for j = 0) and -I on Yb_{j+1}; the tip row is
    -A_{S-1}[7:13] on the last segment's start."""
    dtype, device = A.dtype, A.device
    U = 6 + 19 * (S - 1)
    J = torch.zeros((U, U), dtype=dtype, device=device)
    eye = torch.eye(19, dtype=dtype, device=device)

    def start_cols(j, rows, block):
        if j == 0:
            J[rows, :6] += block[:, 7:13]          # s_0 = base_state(G)
        else:
            J[rows, 6 + 19 * (j - 1):6 + 19 * j] += block

    for j in range(S - 1):
        rows = slice(19 * j, 19 * (j + 1))
        start_cols(j, rows, A[j])
        J[rows, 6 + 19 * j:6 + 19 * (j + 1)] -= eye
    start_cols(S - 1, slice(19 * (S - 1), U), -A[S - 1, 7:13])
    return J


def _segments(p: RodParams, n_segments) -> int:
    """The segment count S, checked: it divides N-1."""
    S = int(n_segments)
    if S < 1 or (p.N - 1) % S:
        raise ValueError(f"n_segments={S} must divide N-1={p.N - 1}")
    return S


def ms_solve_step(p: RodParams, yh, zh, tf, X0, n_segments: int,
                  nn_fn=None, nn_history: bool = False,
                  tol: float = 1e-10, max_iter: int = 50,
                  solver: str = "structured", mesh=None,
                  seq_axis: str = "seq"):
    """Solve one BDF-2 step by multiple shooting.

    Args:
      yh/zh: (N, 19)/(N, 6) BDF-2 history; tf: (3,) tendon force.
      X0: (6 + 19*(S-1),) warm start: [G_guess, boundary states].
      solver: "structured" exploits the block-bidiagonal Jacobian (per
        segment 19 tangents + a 6x6 reduced solve); "dense" materializes
        the full (6+19(S-1))^2 Jacobian. The same converged roots.
      mesh / seq_axis: a parallel.mesh.Mesh whose ``seq_axis`` the segment
        sweeps split over (S must divide over it); the tangents and ends
        are gathered and the rest runs replicated, so every rank returns
        the whole solution. The dense solver then assembles its Jacobian
        from the gathered tangents.
    Returns (y (N, 19), z_body (N-1, 6), X_solved, stats)."""
    S = _segments(p, n_segments)
    m = (p.N - 1) // S
    if solver not in ("structured", "dense"):
        raise ValueError(f"unknown solver {solver!r}")
    split = None if mesh is None else _Split(mesh, seq_axis, S)
    yh_segs = yh[:-1].reshape(S, m, 19)
    zh_segs = zh[:-1].reshape(S, m, 6)

    def res(X):
        return _ms_residual(p, X, yh_segs, zh_segs, tf, S, nn_fn, nn_history,
                            split)

    with torch.no_grad():
        if solver == "structured":
            X, stats = _newton_loop(
                res, lambda X, r, lam: _structured_direction(
                    p, X, lam, yh_segs, zh_segs, tf, S, nn_fn, nn_history,
                    split),
                X0, tol, max_iter)
        elif split is None:
            X, stats = _newton_dense(res, X0, tol, max_iter)
        else:
            eye = torch.eye(X0.shape[-1], dtype=X0.dtype, device=X0.device)

            def dense_direction(X, r, lam):
                _, _, starts = _starts(p, X, S)
                A, _ = _tangents(p, starts, yh_segs, zh_segs, tf, nn_fn,
                                 nn_history, split)
                return _lm_damped_solve(_dense_from_tangents(A, S), r, lam,
                                        eye)

            X, stats = _newton_loop(res, dense_direction, X0, tol, max_iter)
        # the full rod state from the solved unknowns
        _, _, starts = _starts(p, X, S)
        if split is None:
            ys, zs, _ = _segment_sweeps(p, starts, yh_segs, zh_segs, tf,
                                        nn_fn, nn_history)
        else:
            lo, hi = split.lo, split.hi
            ys, zs, _ = _segment_sweeps(p, starts[lo:hi], yh_segs[lo:hi],
                                        zh_segs[lo:hi], tf, nn_fn, nn_history)
            ys, zs = split.gather(ys, 0), split.gather(zs, 0)
    y = torch.cat([starts[:1], ys.reshape(p.N - 1, 19)], dim=0)
    return y, zs.reshape(p.N - 1, 6), X, stats


def simulate_scan_ms(
    p: RodParams,
    controls,
    n_segments: int,
    nn_fn: Optional[Callable] = None,
    nn_history: bool = False,
    tol: Optional[float] = None,
    max_iter: int = 50,
    solver: str = "structured",
    mesh=None,
    seq_axis: str = "seq",
) -> SimOutput:
    """Rollout over a (T, 4) tension schedule with the parallel-in-space
    solver: the drop-in analogue of core/stepper.simulate_scan (the same
    trajectory contract and quirks: [:-1] drop, frozen tip z, [y, z, yh,
    zh] records) for fine rods. Records no autograd graph.

    Warm starts: G extrapolates across time (2G - G_prev) like the
    sequential path; the boundary-state unknowns start at the CURRENT
    node states (the previous converged step). mesh / seq_axis: see
    :func:`ms_solve_step`."""
    if tol is None:
        tol = 1e-16 if p.dtype == torch.float64 else 1e-10
    S = _segments(p, n_segments)
    m = (p.N - 1) // S
    controls = torch.as_tensor(controls, dtype=p.dtype, device=p.device)
    bidx = torch.arange(1, S, device=p.device) * m   # interior boundaries

    y0, z0 = initial_state(p)
    G0 = torch.zeros(6, dtype=p.dtype, device=p.device)
    z_tip = z0[-1:]                     # frozen forever (see stepper.py)
    y, z, y_prev, z_prev, G, G_prev = y0, z0, y0, z0, G0, G0
    records = [torch.cat([y0, z0, y0, z0], dim=-1)]
    Gs, iters, res, lm = [G0], [], [], []
    for t in range(controls.shape[0] - 1):
        yh = p.c1 * y + p.c2 * y_prev
        zh = p.c1 * z + p.c2 * z_prev
        tf = tendon_forces(p, controls[t])
        X0 = torch.cat([2.0 * G - G_prev, y[bidx].reshape(-1)])
        y_new, z_body, X, stats = ms_solve_step(
            p, yh, zh, tf, X0, S, nn_fn, nn_history, tol, max_iter,
            solver=solver, mesh=mesh, seq_axis=seq_axis)
        z_new = torch.cat([z_body, z_tip], dim=0)
        records.append(torch.cat([y_new, z_new, yh, zh], dim=-1))
        Gs.append(X[:6])
        iters.append(stats.iterations)
        res.append(stats.residual_norm)
        lm.append(stats.lm_retries)
        y, z, y_prev, z_prev, G, G_prev = y_new, z_new, y, z, X[:6], G

    zero_i = torch.zeros((), dtype=torch.int32, device=p.device)
    zero_f = torch.zeros((), dtype=p.dtype, device=p.device)
    return SimOutput(torch.stack(records), torch.stack(Gs),
                     torch.stack([zero_i] + iters),
                     torch.stack([zero_f] + res),
                     torch.stack([zero_i] + lm))
