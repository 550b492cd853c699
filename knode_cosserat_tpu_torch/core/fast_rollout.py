"""Fast batched rollout: finite-difference Newton shooting over batched
sweeps, or the whole Newton step in one kernel launch.

PyTorch counterpart of ``knode_cosserat_tpu/core/fast_rollout.py``. The
``impl`` argument picks how a BDF-2 step is solved:

  "mega"   K2 (ops/step.py): the whole Newton solve in one launch per time
           step; forward differences, Jacobian refreshed every iteration.
  "sweep"  the FD-Newton driver below, one K3 launch (ops/sweep.py) per
           Newton phase — the JAX package's ``impl="pallas"``.
  "plain"  the same driver over the plain PyTorch sweep — the JAX
           package's ``impl="xla"``.

Per driver iteration: the residuals at [G + h_i e_i] for the Jacobian,
batched over (rods x 6) in one sweep, then the residuals at
[G + alpha_k dG] for the line search, batched over (rods x n_alphas).
The residual itself is exact, so the converged root matches the
autodiff-Jacobian rollout (core/stepper.py) to solver tolerance.

Every path dispatches by the rod's device: on the CPU "mega" and "sweep"
run the kernels' plain versions.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Optional

import torch

from ..models.mlp import MLPSpec, StackedMLP
from ..ops.linalg import solve_small
from ..utils.profiling import annotate, new_call
from .params import RodParams
from .stepper import initial_state, tendon_forces

__all__ = ["make_fast_rollout", "make_fast_step", "mega_rollout_cached",
           "fd_newton"]

_IMPLS = ("mega", "sweep", "plain")
_MEGA_LRU: "OrderedDict[str, object]" = OrderedDict()


def mega_rollout_cached(p: RodParams, spec=None, tol: float = 1e-10,
                        max_iter: int = 50, method: str = "euler"):
    """Shared content-keyed LRU (16 entries) of mega rollouts (each takes
    one net or a StackedMLP, see make_fast_rollout). The key
    hashes the rod's tensor bytes and device (not object identity), so
    logically identical rods built by separate ``apply_mod`` calls share
    one entry (and one set of host-side rod constants)."""
    h = hashlib.sha1()
    for name, leaf in p.leaves():
        h.update(name.encode())
        h.update(leaf.detach().cpu().numpy().tobytes())
    h.update(repr((p.N, p.n_tendons, str(p.device), spec, float(tol),
                   int(max_iter), method)).encode())
    key = h.hexdigest()
    fn = _MEGA_LRU.get(key)
    if fn is None:
        fn = make_fast_rollout(p, spec, tol=tol, max_iter=max_iter,
                               impl="mega", method=method)
        _MEGA_LRU[key] = fn
        while len(_MEGA_LRU) > 16:
            _MEGA_LRU.popitem(last=False)
    else:
        _MEGA_LRU.move_to_end(key)
    return fn


def _build_kernels(p, spec, impl, method="euler"):
    """(residual-only sweep, recording sweep) for the FD-Newton driver."""
    from ..ops.sweep import make_sweep_kernel, sweep_reference

    if impl == "sweep":
        return (make_sweep_kernel(p, spec, method=method, want_rod=False),
                make_sweep_kernel(p, spec, method=method, want_rod=True))
    if impl == "plain":
        def plain(want_rod):
            return lambda G, yh, zh, tf, nn=None: sweep_reference(
                p, G, yh, zh, tf, nn if spec is not None else None, method,
                want_rod)
        return plain(False), plain(True)
    raise ValueError(f"impl {impl!r}: use one of {_IMPLS} (the JAX package's "
                     f"'pallas' is 'sweep' here, its 'xla' is 'plain')")


def fd_newton(k_res, G, yh, zh, tf, nn_params=None, *, tol, max_iter,
              n_alphas, jacobian_refresh, fd_order, sweeps=None):
    """Rod-batched damped Newton on the tip residual with a finite-difference
    Jacobian: k_res(G (R',6), yh, zh, tf, nn) -> (R',6). Returns
    (G (R,6), r2 (R,), iters (R,) int32 — each rod's own iteration count).
    ``sweeps``: None, or an int (R,) tensor to which each rod's sweeps are
    added as K2 runs them (ops/step.py): the first residual, the probes of
    each iteration, and of the candidates (all evaluated here at once)
    alpha = 1 alone, then K2's tiles up to the first improving one.

    Lanes that stop improving hold their G and retry with a growing
    Levenberg-Marquardt term (the ladder constants live in ops/step.py).
    The loop ends when no rod is active or after ``max_iter`` iterations."""
    from ..ops.step import (_LANES, _LM_GROWTH, _LM_LAMBDA0, _MAX_ESCALATIONS,
                            fd1_eps)

    R, dtype, device = G.shape[0], G.dtype, G.device
    if fd_order == 2:
        eps = 6e-6 if dtype == torch.float64 else 5e-3
    else:
        eps = fd1_eps(dtype)
    alphas = 0.5 ** torch.arange(n_alphas, dtype=dtype, device=device)
    eye = torch.eye(6, dtype=dtype, device=device)
    n_probe = 12 if fd_order == 2 else 6
    rep = lambda a, w: a.repeat_interleave(w, dim=0)
    probe_in = (rep(yh, n_probe), rep(zh, n_probe), rep(tf, n_probe))
    cand_in = (rep(yh, n_alphas), rep(zh, n_alphas), rep(tf, n_alphas))

    def fd_jacobian(G, r):
        h = eps * (1.0 + G.abs())
        plus = G[:, None, :] + h[:, None, :] * eye
        if fd_order == 2:
            minus = G[:, None, :] - h[:, None, :] * eye
            probes = torch.cat([plus, minus], dim=1)
            r_p = k_res(probes.reshape(R * 12, 6), *probe_in,
                        nn_params).reshape(R, 12, 6)
            J = (r_p[:, :6] - r_p[:, 6:]) / (2 * h[:, :, None])
        else:
            r_p = k_res(plus.reshape(R * 6, 6), *probe_in,
                        nn_params).reshape(R, 6, 6)
            J = (r_p - r[:, None, :]) / h[:, :, None]
        return J.transpose(1, 2)

    r = k_res(G, yh, zh, tf, nn_params)
    r2 = (r * r).sum(-1)
    lam = torch.zeros(R, dtype=dtype, device=device)
    fails = torch.zeros(R, dtype=torch.int32, device=device)
    iters = torch.zeros(R, dtype=torch.int32, device=device)
    rows = torch.arange(R, device=device)
    J = None
    for it in range(max_iter):
        active = (r2 > tol) & (fails <= _MAX_ESCALATIONS)
        if not bool(active.any()):
            break
        if it % jacobian_refresh == 0:
            J = fd_jacobian(G, r)
        D = torch.diagonal(J, dim1=-2, dim2=-1).abs().clamp_min(1.0)
        dG = solve_small(J + torch.diag_embed(lam[:, None] * D), -r)
        dG = torch.where(torch.isfinite(dG).all(-1, keepdim=True), dG, 0.0)
        cand = G[:, None, :] + alphas[None, :, None] * dG[:, None, :]
        r_c = k_res(cand.reshape(R * n_alphas, 6), *cand_in,
                    nn_params).reshape(R, n_alphas, 6)
        r2_c = (r_c * r_c).sum(-1)
        improves = r2_c < r2[:, None]
        found = improves.any(1)
        pick = torch.where(found, improves.int().argmax(1), 0)
        # advance only improving rods; stalling rods HOLD position and
        # retry next iteration with an escalated lambda
        step_ok = active & found
        G = torch.where(step_ok[:, None], cand[rows, pick], G)
        r = torch.where(step_ok[:, None], r_c[rows, pick], r)
        r2 = torch.where(step_ok, r2_c[rows, pick], r2)
        no_improve = active & ~found
        lam = torch.where(no_improve,
                          torch.clamp_min(lam * _LM_GROWTH, _LM_LAMBDA0), 0.0)
        fails = torch.where(no_improve, fails + 1,
                            torch.where(active, 0, fails))
        iters = iters + active.int()
        if sweeps is not None:
            sweeps += active * (n_probe + _k2_candidates(pick, found,
                                                         n_alphas, _LANES))
    if sweeps is not None:
        sweeps += 1
    return G, r2, iters


def _k2_candidates(pick, found, n_alphas: int, tile: int):
    """The line-search sweeps K2 runs for an iteration that picks
    candidate ``pick`` (or none): alpha = 1 alone, then tiles of ``tile``
    candidates up to the tile that holds the pick, or all of them."""
    upto = 1 + tile * torch.div(pick - 1 + tile, tile, rounding_mode="floor")
    return torch.where(found & (pick == 0), 1,
                       torch.where(found, upto.clamp_max(n_alphas),
                                   n_alphas))


def _history(p, y, z, y_prev, z_prev, tensions):
    yh = p.c1 * y + p.c2 * y_prev
    zh = p.c1 * z + p.c2 * z_prev
    tf = tendon_forces(p, torch.as_tensor(tensions, dtype=y.dtype,
                                          device=y.device))
    return yh, zh, tf


def _build_step(p, k_res, k_full, tol, max_iter, n_alphas,
                jacobian_refresh, fd_order):
    """Single BDF-2 step over the FD-Newton driver: step(y, z, y_prev,
    z_prev, G, tensions, nn_params) -> (y_new, z_new, G_new, yh, zh, r2,
    iters). All leading axes are the rod batch R."""

    def step(y, z, y_prev, z_prev, G, tensions, nn_params=None):
        if isinstance(nn_params, StackedMLP):
            raise NotImplementedError("the FD-Newton loop (impl 'sweep' / "
                                      "'plain') takes one net; stacked nets "
                                      "run on impl='mega'")
        yh, zh, tf = _history(p, y, z, y_prev, z_prev, tensions)
        G_new, r2, iters = fd_newton(
            k_res, G, yh, zh, tf, nn_params, tol=tol, max_iter=max_iter,
            n_alphas=n_alphas, jacobian_refresh=jacobian_refresh,
            fd_order=fd_order)
        _, y_new, z_body = k_full(G_new, yh, zh, tf, nn_params)
        z_new = torch.cat([z_body, z[:, -1:, :]], dim=1)
        return y_new, z_new, G_new, yh, zh, r2, iters

    return step


def _build_step_mega(p: RodParams, spec, tol, max_iter, n_alphas,
                     method="euler"):
    """Inner step over K2 (ops/step.py). Same signature as _build_step's."""
    from ..ops.step import make_step_kernel

    kstep = make_step_kernel(p, spec, tol=tol, max_iter=max_iter,
                             n_alphas=n_alphas, method=method)

    def inner(y, z, y_prev, z_prev, G, tensions, nn_params=None):
        yh, zh, tf = _history(p, y, z, y_prev, z_prev, tensions)
        G_new, y_new, z_body, r2, iters = kstep(G.contiguous(), yh, zh, tf,
                                                nn_params)
        z_new = torch.cat([z_body, z[:, -1:, :]], dim=1)
        return y_new, z_new, G_new, yh, zh, r2, iters

    return inner


def _inner(p, spec, tol, max_iter, n_alphas, impl, jacobian_refresh,
           fd_order, method):
    if impl == "mega":
        return _build_step_mega(p, spec, tol, max_iter, n_alphas, method)
    k_res, k_full = _build_kernels(p, spec, impl, method)
    return _build_step(p, k_res, k_full, tol, max_iter, n_alphas,
                       jacobian_refresh, fd_order)


def make_fast_step(p: RodParams, spec: Optional[MLPSpec] = None,
                   tol: float = 1e-12, max_iter: int = 30,
                   n_alphas: int = 7, impl: str = "sweep",
                   jacobian_refresh: int = 1, fd_order: int = 2,
                   method: str = "euler"):
    """Single BDF-2 step (serving / control loops): fn(y, z, y_prev,
    z_prev, G, tensions, nn_params) -> (y_new, z_new, G_new, residual2,
    iters). Batched over a leading rod axis.

    impl "mega" solves the whole step in one kernel launch; it always
    uses forward differences refreshed every iteration, so ``fd_order``
    and ``jacobian_refresh`` apply only to "sweep" and "plain"."""
    inner = _inner(p, spec, tol, max_iter, n_alphas, impl, jacobian_refresh,
                   fd_order, method)

    def step(y, z, y_prev, z_prev, G, tensions, nn_params=None):
        y_new, z_new, G_new, _, _, r2, it = inner(
            y, z, y_prev, z_prev, G, tensions, nn_params)
        return y_new, z_new, G_new, r2, it

    return step


def make_fast_rollout(
    p: RodParams,
    spec: Optional[MLPSpec] = None,
    tol: float = 1e-12,
    max_iter: int = 30,
    n_alphas: int = 7,
    impl: str = "sweep",
    jacobian_refresh: int = 1,
    fd_order: int = 2,
    method: str = "euler",
    extrapolate: bool = True,
):
    """Build fn(controls (R, T, 4), nn_params|None) -> (traj (R, T, N, 50),
    residual norms (T-1, R), iters (T-1, R)).

    nn_params: one net for all R rods or, with impl "mega", a StackedMLP
    of R nets (rod r runs net r: the eval tables' per-cell nets, one K2
    launch per step for all of them).

    The trajectory matches core.stepper.simulate_scan over a rod batch
    (same record layout, same dropped final step, same frozen tip z).
    impl: "mega", "sweep" or "plain" (module docstring).
    jacobian_refresh: recompute the FD Jacobian every k-th iteration
    (chord/Shamanskii Newton); the residual stays exact, so converged roots
    are unchanged, only the path differs."""
    N = p.N
    inner = _inner(p, spec, tol, max_iter, n_alphas, impl, jacobian_refresh,
                   fd_order, method)

    @torch.no_grad()
    def rollout(controls, nn_params=None):
        new_call()
        controls = torch.as_tensor(controls, dtype=p.dtype, device=p.device)
        R, T = controls.shape[0], controls.shape[1]
        y0, z0 = initial_state(p)
        y0 = y0.expand(R, N, 19).contiguous()
        z0 = z0.expand(R, N, 6).contiguous()
        G0 = torch.zeros((R, 6), dtype=p.dtype, device=p.device)
        y, z, y_prev, z_prev, G, G_prev = y0, z0, y0, z0, G0, G0
        records = [torch.cat([y0, z0, y0, z0], dim=-1)]
        res, iters = [], []
        for t in range(T - 1):
            with annotate("rollout.step"):
                # linear extrapolation of the base reaction across time
                # steps starts Newton closer to the root
                G_guess = 2.0 * G - G_prev if extrapolate else G
                y_new, z_new, G_new, yh, zh, r2, it = inner(
                    y, z, y_prev, z_prev, G_guess, controls[:, t], nn_params)
                records.append(torch.cat([y_new, z_new, yh, zh], dim=-1))
                res.append(r2.sqrt())
                iters.append(it)
            y, z, y_prev, z_prev, G, G_prev = y_new, z_new, y, z, G_new, G
        traj = torch.stack(records, dim=1)                   # (R, T, N, 50)
        empty = torch.zeros((0, R), dtype=p.dtype, device=p.device)
        return (traj, torch.stack(res) if res else empty,
                torch.stack(iters) if iters else empty.int())

    return rollout
