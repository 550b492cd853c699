"""Gradient-based system identification of physical rod parameters.

PyTorch counterpart of ``knode_cosserat_tpu/training/sysid.py``. Every
derived term of a rod is a differentiable function of its base parameters
(core/params.derive), so a faulted parameter itself is recoverable by
gradient descent:

  * ``objective="teacher"``: the teacher-forced one-step loss of the KNODE
    trainer (training/loss.py), differentiated with respect to physical
    parameters instead of net weights; no solver in the graph.
  * ``objective="rollout"``: node-position MSE of the full implicit BDF-2
    rollout (core/stepper.simulate_scan(differentiable=True, remat=True)),
    differentiated through every Newton shooting solve by the implicit
    function theorem.

Positive scalars (E, L, r, rho, ...) are fitted in log-space, damping
matrices as log-diagonals, C, g and vstar linearly. ``fit_nn=True`` also
trains the residual net jointly (grey-box identification).

The port's idiom: the JAX package's jitted ``lax.scan`` over Adam steps is
a Python loop of optax's Adam (training/train.AdamPlateau, its plateau
never firing); its vmap over restarts one batch (the starts' rods a stack,
core/params.stack_params, each start's net one of a StackedMLP: one
objective evaluation a step for every start, whose backward pass takes the
SUM of the starts' losses, so the elementwise Adam over the stacked
variables is each start's own Adam); its ``jax.hessian`` two
reverse passes with ``create_graph``; its ``jax.jacfwd`` of the residual
vector the double-reverse trick (a VJP that is linear in its cotangent,
differentiated once more). The Gauss-Newton Gram J^T J is formed in native
float64 (the JAX package accumulates it in double-double float32,
ops/dd.py, because the TPU has no float64). Random restarts, design
starts and posterior draws come from a ``torch.Generator``, so their values
differ from the JAX package's PRNG draws. The fits run optax's Adam only
(the JAX functions' ``optimizer=`` transform has no caller and no port
here). ``chunk`` bounds the JAX
package's compiled program size; the eager loop has no program to bound,
so it is validated and otherwise has no effect (every chunking gives the
same result there too).
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..core.params import RodParams, derive, unstack_params
from ..core.stepper import simulate_scan
from ..models.mlp import MLPSpec, StackedMLP, bind
from .loss import (DEFAULT_KEYPOINTS_FAST, teacher_forced_loss,
                   teacher_forced_residuals)

__all__ = ["FITTABLE_FIELDS", "theta_init", "apply_theta", "theta_values",
           "SysIdResult", "fit_rod_params", "IdentifiabilityReport",
           "identifiability", "DesignResult", "design_experiment",
           "LaplacePosterior", "laplace_posterior", "sample_posterior",
           "AssemblySysIdResult", "fit_assembly_params",
           "assembly_identifiability"]

# field -> parameterization. log: positive scalar fitted as log(x);
# logdiag: (3,3) diagonal matrix fitted as log of its diagonal;
# linear: fitted as-is (fields whose physical value may be zero).
FITTABLE_FIELDS: Dict[str, str] = {
    "E": "log",
    "L": "log",
    "r": "log",
    "rho": "log",
    "tendon_offset": "log",
    "T0": "log",
    "Bbt": "logdiag",
    "Bse": "logdiag",
    "C": "linear",
    "g": "linear",
    "vstar": "linear",
}


def theta_init(p: RodParams, fields: Sequence[str]) -> Dict[str, torch.Tensor]:
    """Pack the selected base parameters of ``p`` into the optimization
    variables (a dict of tensors in the rod's dtype and device), applying
    the per-field transform."""
    theta = {}
    for name in fields:
        if name not in FITTABLE_FIELDS:
            raise ValueError(
                f"{name!r} is not fittable; choose from "
                f"{sorted(FITTABLE_FIELDS)}")
        kind = FITTABLE_FIELDS[name]
        val = getattr(p, name).detach().to("cpu", torch.float64).numpy()
        if kind == "log":
            if not np.all(val > 0):
                raise ValueError(f"{name} must be > 0 for log-space fitting "
                                 f"(got {val}); start from a positive guess")
            val = np.log(val)
        elif kind == "logdiag":
            d = np.diagonal(val)
            if not np.all(d > 0):
                raise ValueError(
                    f"{name} diagonal must be > 0 for log-space fitting "
                    f"(got {d}); start from a positive guess")
            val = np.log(d)
        theta[name] = torch.as_tensor(np.asarray(val), dtype=p.dtype,
                                      device=p.device)
    return theta


def apply_theta(p: RodParams, theta: Dict[str, torch.Tensor]) -> RodParams:
    """A fully derived rod with the fitted base parameters, differentiable
    in every theta leaf (core/params.derive). Leaves with a leading axis of
    R (scalars (R,), vectors and log-diagonals (R, 3)) give a stack of R
    rods: the JAX package's ``jax.vmap(apply_theta)``, of one rod or of a
    stack of R."""
    kw = {}
    for name, t in theta.items():
        kind = FITTABLE_FIELDS[name]
        if kind == "log":
            kw[name] = torch.exp(t)
        elif kind == "logdiag":
            kw[name] = torch.diag_embed(torch.exp(t))
        else:
            kw[name] = t
    return derive(p.replace(**kw), dtype=p.dtype, device=p.device)


def theta_values(theta: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Physical-space values of a packed theta (host float64 numpy)."""
    out = {}
    for name, t in theta.items():
        v = t.detach().to("cpu", torch.float64).numpy()
        out[name] = (np.exp(v) if FITTABLE_FIELDS[name] in ("log", "logdiag")
                     else v)
    return out


@dataclasses.dataclass
class SysIdResult:
    """Outcome of :func:`fit_rod_params`.

    params: the fitted, fully derived rod.
    theta: fitted optimization variables (transform space).
    values: physical-space fitted values per field (host numpy).
    nn_params: the fitted net when ``fit_nn=True`` (the winning start's,
      a copy; else the unchanged input).
    loss_history: (steps,) objective value per Adam step.
    start_losses: final objective per start when n_starts > 1
      (loss_history is the winning start's curve).
    """
    params: RodParams
    theta: Dict[str, torch.Tensor]
    values: Dict[str, np.ndarray]
    nn_params: object
    loss_history: torch.Tensor
    start_losses: Optional[torch.Tensor] = None


def _tensor(x, dtype, device) -> torch.Tensor:
    """x as a tensor (arrays are copied: they may be read-only)."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.array(x))
    return x.to(dtype=dtype, device=device)


def _batch(p: RodParams, traj, controls, what: str):
    """(B, T, N, 25) trajectories and (B, T, n_tendons) controls."""
    traj = _tensor(traj, p.dtype, p.device)
    controls = _tensor(controls, p.dtype, p.device)
    if traj.dim() == 3:
        traj, controls = traj[None], controls[None]
    if traj.dim() != 4 or traj.shape[-1] < 25 or controls.dim() != 3 \
            or controls.shape[0] != traj.shape[0]:
        raise ValueError(f"{what}: traj must be (T, N, >=25) or "
                         "(B, T, N, >=25) with matching controls; got "
                         f"{tuple(traj.shape)} / {tuple(controls.shape)}")
    return traj[..., :25], controls      # SimOutput rows carry 50 channels


def _rollout(p_t, traj, controls, nn_fn, nn_history, method, tol, max_iter):
    """The implicit rollouts of every trajectory from its observed first
    frame (real windows start mid-motion): positions (B, T-1, N, 3) after
    the seed frame, beside the observed ones ((R, B, T-1, N, 3) for a stack
    of R rods)."""
    sim = simulate_scan(p_t, controls, nn_fn=nn_fn, nn_history=nn_history,
                        method=method, tol=tol, max_iter=max_iter,
                        differentiable=True, remat=True,
                        initial=(traj[:, 0, :, :19], traj[:, 0, :, 19:]))
    return sim.traj[..., 1:, :, :3] - traj[:, 1:, :, :3]


def _make_objective(p, traj, controls, objective, keypoints, spec, method,
                    tol, max_iter, skip_first=False):
    """loss(phys theta, net or None) -> the objective, shared by fitting and
    the identifiability analysis: a scalar, or one per start (R,) when the
    theta leaves carry a leading axis of R starts (the net is then one net
    for all, or a StackedMLP of a net per start). The rollout objective
    seeds each rollout from the observed first frame and leaves that frame
    out of the MSE."""
    kp = tuple(keypoints)

    def loss_fn(phys, net=None):
        p_t = apply_theta(p, phys)
        stacked = isinstance(net, StackedMLP)
        if objective == "teacher":
            # a net per start: the rod axis leads the loss's inputs
            return teacher_forced_loss(
                p_t, spec, None if stacked else net, traj, controls, kp,
                skip_first=skip_first,
                nn_fn=net if stacked else None).mean(-1)
        # a net per start: the rod x trajectory rows sit behind the Newton
        # probes' copies
        nn_fn = (net.along(-2) if stacked
                 else bind(spec, net) if net is not None else None)
        d = _rollout(p_t, traj, controls, nn_fn, spec.history, method, tol,
                     max_iter)
        return (d * d).flatten(-4).mean(-1)

    return loss_fn


def _make_residual_fn(p, traj, controls, objective, keypoints, spec, method,
                      tol, max_iter, skip_first=False):
    """Residual-vector sibling of :func:`_make_objective`:
    sum(res_fn(theta)**2) == loss_fn(theta). Its Jacobian is what the
    Gauss-Newton / Fisher paths take."""
    B = traj.shape[0]

    def res_fn(phys, net=None):
        p_t = apply_theta(p, phys)
        if objective == "teacher":
            per = teacher_forced_residuals(p_t, spec, net, traj, controls,
                                           tuple(keypoints),
                                           skip_first=skip_first)
        else:
            nn_fn = bind(spec, net) if net is not None else None
            d = _rollout(p_t, traj, controls, nn_fn, spec.history, method,
                         tol, max_iter).reshape(B, -1)
            per = d / math.sqrt(d.shape[-1])
        return per.reshape(-1) / math.sqrt(B)

    return res_fn


def _check_chunk(chunk):
    if chunk is not None and chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")


def _best_start(final_losses: torch.Tensor) -> int:
    """Index of the winning restart; NaN final losses (diverged starts)
    count as +inf."""
    clean = torch.where(torch.isnan(final_losses),
                        torch.full_like(final_losses, math.inf), final_losses)
    return int(torch.argmin(clean))


def _flatten_theta(theta):
    """(vec0, labels, unpack) for a transform-space theta dict, its leaves
    in sorted-name order (the JAX package's tree order); ``unpack`` takes
    vectors (..., D) with any leading axes."""
    names = sorted(theta)
    labels = []
    for name in names:
        n = theta[name].numel() or 1
        labels += [name] if n == 1 else [f"{name}[{i}]" for i in range(n)]
    shapes = [theta[n].shape for n in names]
    sizes = [theta[n].numel() for n in names]
    vec0 = torch.cat([theta[n].reshape(-1) for n in names])

    def unpack(v):
        out, off = {}, 0
        for name, shape, n in zip(names, shapes, sizes):
            out[name] = v[..., off:off + n].reshape(v.shape[:-1] + shape)
            off += n
        return out

    return vec0, labels, unpack


def _adam_fit(loss_fn, phys, net, steps, lr, nn_lr, shape=()):
    """``steps`` Adam steps on the leaves of ``phys`` (and the net's
    weights): the JAX package's scan of optax.adam(lr) (a separate
    adam(nn_lr) on the net). ``loss_fn`` returns losses of ``shape`` (one
    per start of a batch); the backward pass takes their sum, so each
    start's variables get its own loss's gradient. Updates in place and
    returns the loss history ``shape + (steps,)``."""
    from .train import AdamPlateau

    leaves = [phys[k] for k in sorted(phys)]
    opts = [AdamPlateau(leaves, lr=lr, patience=steps + 1)]
    if net is not None:
        opts.append(AdamPlateau(net.parameters(), lr=nn_lr,
                                patience=steps + 1))
    hist = []
    for _ in range(steps):
        for o in opts:
            o.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss = loss_fn(phys, net)
            total = loss.sum()
            total.backward()
        for o in opts:
            o.step(total.detach())
        hist.append(loss.detach())
    dtype, device = leaves[0].dtype, leaves[0].device
    return (torch.stack(hist, -1) if hist
            else torch.zeros(shape + (0,), dtype=dtype, device=device))


def _jitter_starts(theta0, n_starts: int, start_scale: float,
                   generator: Optional[torch.Generator]):
    """The random restarts' starting points, every leaf stacked on a leading
    axis of R = max(n_starts, 1): start 0 is ``theta0``, the others jitter
    it (log-space fields additively, linear ones relative to their
    magnitude) by ``start_scale`` times normal draws from ``generator``
    (default seeded with 0), drawn leaf by leaf in sorted-name order."""
    batch = {k: v[None] for k, v in theta0.items()}
    if n_starts <= 1:
        return batch
    gen = (generator if generator is not None
           else torch.Generator().manual_seed(0))
    for name in sorted(theta0):
        leaf = theta0[name]
        noise = torch.randn((n_starts - 1,) + tuple(leaf.shape),
                            generator=gen, dtype=leaf.dtype).to(leaf.device)
        scale = (start_scale * (leaf.abs() + 1e-3)
                 if FITTABLE_FIELDS[name] == "linear" else start_scale)
        batch[name] = torch.cat([leaf[None], leaf + scale * noise])
    return batch


def _fit_batch(loss_fn, theta, net, steps, lr, nn_lr):
    """All starts of ``theta`` (leaves (R, ...)) fitted as one batch:
    ``loss_fn(theta, nets)`` evaluated once an Adam step for every start.
    ``net``: the net every start trains its own copy of (a StackedMLP of R
    copies), or None. Returns (theta (R, ...), the StackedMLP or None,
    history (R, steps), final objectives (R,), or None for one start)."""
    R = next(iter(theta.values())).shape[0]
    theta = {k: v.detach().clone().requires_grad_(True)
             for k, v in theta.items()}
    nets = StackedMLP([net] * R) if net is not None else None
    hist = _adam_fit(loss_fn, theta, nets, steps, lr, nn_lr, shape=(R,))
    theta = {k: v.detach() for k, v in theta.items()}
    finals = None
    if R > 1:
        with torch.no_grad():
            finals = loss_fn(theta, nets).detach()
    return theta, nets, hist, finals


def fit_rod_params(
    p: RodParams,
    traj,
    controls,
    fields: Sequence[str] = ("E",),
    *,
    objective: str = "teacher",
    steps: int = 300,
    lr: float = 0.05,
    keypoints: Sequence[int] = DEFAULT_KEYPOINTS_FAST,
    spec: Optional[MLPSpec] = None,
    nn_params=None,
    fit_nn: bool = False,
    nn_lr: float = 1e-2,
    method: str = "euler",
    tol: Optional[float] = None,
    max_iter: int = 50,
    n_starts: int = 1,
    start_scale: float = 0.25,
    generator: Optional[torch.Generator] = None,
    skip_first: bool = False,
    chunk: Optional[int] = None,
) -> SysIdResult:
    """Fit physical rod parameters to observed trajectories.

    Args:
      p: starting rod (e.g. a faulted mod, ``experimental_rod("youngs")``);
        fields not fitted keep their values in ``p``.
      traj: observed states, (T, N, >=25) or batched (B, T, N, >=25).
      controls: (T, n_tendons) or (B, T, n_tendons) applied tensions.
      fields: base parameters to fit (keys of FITTABLE_FIELDS).
      objective: "teacher" (one-step, solver-free) or "rollout" (the full
        implicit rollout).
      fit_nn: train the residual net jointly (its own Adam(nn_lr));
        ``nn_params`` (a KnodeMLP) is then required, and a fitted copy is
        returned.
      n_starts: > 1 runs random-restart fits as one batch (the JAX
        package's vmap): start 0 is the unperturbed theta, the others
        jitter it (log-space fields additively, linear ones relative to
        their magnitude) by ``start_scale`` times normal draws from
        ``generator`` (default seeded with 0); the start with the lowest
        final objective wins. With ``fit_nn`` every start trains its own
        copy of the net.
      skip_first: drop the first transition from the teacher loss (data
        that starts mid-motion).
      chunk: validated for the JAX package's interface (module docstring).
    """
    if objective not in ("teacher", "rollout"):
        raise ValueError(f"unknown objective {objective!r}")
    _check_chunk(chunk)
    spec = spec if spec is not None else MLPSpec.for_knode()
    traj, controls = _batch(p, traj, controls, "fit_rod_params")
    if fit_nn and nn_params is None:
        raise ValueError("fit_nn=True requires initial nn_params "
                         "(models.mlp.init_mlp)")
    loss_fn = _make_objective(p, traj, controls, objective, keypoints, spec,
                              method, tol, max_iter, skip_first=skip_first)
    starts = _jitter_starts(theta_init(p, fields), n_starts, start_scale,
                            generator)
    theta, nets, hist, finals = _fit_batch(
        lambda th, nt: loss_fn(th, nt if fit_nn else nn_params), starts,
        nn_params if fit_nn else None, steps, lr, nn_lr)
    best = 0 if finals is None else _best_start(finals)
    phys = {k: v[best] for k, v in theta.items()}
    with torch.no_grad():
        fitted = apply_theta(p, phys)
    return SysIdResult(params=fitted, theta=phys, values=theta_values(phys),
                       nn_params=nets.unstack()[best] if fit_nn else nn_params,
                       loss_history=hist[best], start_losses=finals)


@dataclasses.dataclass
class IdentifiabilityReport:
    """Local identifiability analysis at a parameter point, in TRANSFORM
    space (log for positive scalars and diagonals: relative perturbations).

    labels: flattened theta component names ("E", "Bbt[0]", ...).
    hessian: (D, D) curvature of the objective.
    covariance_unscaled: pinv(hessian), the Laplace covariance up to the
      observation-noise scale.
    std_unscaled: sqrt(diag(covariance_unscaled)).
    correlation: parameter correlation matrix; entries near +/-1 mean the
      data cannot tell those parameters apart.
    eigvals / eigvecs: the hessian's spectrum, ascending (column i of
      eigvecs pairs with eigvals[i]).
    loss_value: the objective at the analysis point.
    """
    labels: list
    hessian: np.ndarray
    covariance_unscaled: np.ndarray
    std_unscaled: np.ndarray
    correlation: np.ndarray
    eigvals: np.ndarray
    eigvecs: np.ndarray
    loss_value: float = 0.0


def _hessian(fn, v0: torch.Tensor, create_graph: bool = False):
    """(fn(v0), d^2 fn / dv^2 (D, D)) by two reverse passes per row;
    create_graph keeps the Hessian differentiable in what fn closes over."""
    with torch.enable_grad():
        v = v0.detach().clone().requires_grad_(True)
        L = fn(v)
        (g,) = torch.autograd.grad(L, v, create_graph=True)
        rows = [torch.autograd.grad(g[i], v, retain_graph=True,
                                    create_graph=create_graph)[0]
                for i in range(v.numel())]
    return L, torch.stack(rows)


def _jacobian_tall(fn, v0: torch.Tensor, create_graph: bool = False):
    """(r = fn(v0) (n,), J = dr/dv (n, D)) for a long residual vector and a
    few parameters: the VJP u -> J^T u is linear in u, so D reverse passes
    through it with respect to u give J's D columns (forward mode without
    forward-mode rules, through implicit_root's differentiable backward).
    create_graph keeps J differentiable in what fn closes over."""
    with torch.enable_grad():
        v = v0.detach().clone().requires_grad_(True)
        r = fn(v)
        u = torch.zeros_like(r, requires_grad=True)
        (Jtu,) = torch.autograd.grad(r, v, u, create_graph=True)
        cols = [torch.autograd.grad(Jtu[d], u, retain_graph=True,
                                    create_graph=create_graph)[0]
                for d in range(v.numel())]
    return r, torch.stack(cols, dim=-1)


def _gram(J: torch.Tensor) -> np.ndarray:
    """J^T J in float64 (the Gauss-Newton / Fisher Gram)."""
    J64 = J.detach().to(torch.float64)
    return (J64.T @ J64).cpu().numpy()


def identifiability(
    p: RodParams,
    traj,
    controls,
    fields: Sequence[str] = ("E",),
    *,
    objective: str = "teacher",
    keypoints: Sequence[int] = DEFAULT_KEYPOINTS_FAST,
    spec: Optional[MLPSpec] = None,
    nn_params=None,
    method: str = "euler",
    tol: Optional[float] = None,
    max_iter: int = 50,
    skip_first: bool = False,
    hessian: str = "auto",
) -> IdentifiabilityReport:
    """Curvature-based local identifiability of ``fields`` at ``p``
    (typically a fitted ``res.params``).

    hessian: "exact" (the autodiff Hessian of the objective; float64
    territory), "gn" (Gauss-Newton / Fisher: 2 J^T J from the residual
    vector's Jacobian, sum(r^2) == objective, the Gram formed in float64;
    exact at zero residual) or "auto" ("exact" for float64 rods, "gn" for
    float32)."""
    if objective not in ("teacher", "rollout"):
        raise ValueError(f"unknown objective {objective!r}")
    if hessian not in ("auto", "exact", "gn"):
        raise ValueError(f"unknown hessian mode {hessian!r}")
    spec = spec if spec is not None else MLPSpec.for_knode()
    traj, controls = _batch(p, traj, controls, "identifiability")
    if hessian == "auto":
        hessian = "exact" if p.dtype == torch.float64 else "gn"
    vec0, labels, unpack = _flatten_theta(theta_init(p, fields))
    if hessian == "gn":
        res_fn = _make_residual_fn(p, traj, controls, objective, keypoints,
                                   spec, method, tol, max_iter,
                                   skip_first=skip_first)
        r, J = _jacobian_tall(lambda v: res_fn(unpack(v), nn_params), vec0)
        Lval = float((r.detach().double() ** 2).sum())
        H = 2.0 * _gram(J)
    else:
        loss_fn = _make_objective(p, traj, controls, objective, keypoints,
                                  spec, method, tol, max_iter,
                                  skip_first=skip_first)
        L, H = _hessian(lambda v: loss_fn(unpack(v), nn_params), vec0)
        H = H.detach().to("cpu", torch.float64).numpy()
        Lval = float(L.detach())
    return _report_from_hessian(labels, H, Lval)


def _report_from_hessian(labels, H, Lval) -> IdentifiabilityReport:
    H = 0.5 * (H + H.T)
    cov = np.linalg.pinv(H)
    std = np.sqrt(np.clip(np.diagonal(cov), 0, None))
    denom = np.outer(std, std)
    with np.errstate(invalid="ignore", divide="ignore"):
        corr = np.where(denom > 0, cov / np.where(denom == 0, 1, denom), 0.0)
    w, V = np.linalg.eigh(H)
    return IdentifiabilityReport(labels=labels, hessian=H,
                                 covariance_unscaled=cov,
                                 std_unscaled=std, correlation=corr,
                                 eigvals=w, eigvecs=V, loss_value=Lval)


@dataclasses.dataclass
class DesignResult:
    """Outcome of :func:`design_experiment`.

    controls: (T, n_tendons) optimized tension schedule (within bounds).
    objective_history: (steps,) criterion value per Adam step (the
      MINIMIZED quantity: -logdet for "D", -min-eigenvalue for "E").
    info_initial / info_final: log det / min eigenvalue of the Fisher at
      the initial and at the designed schedule.
    """
    controls: torch.Tensor
    objective_history: torch.Tensor
    info_initial: float
    info_final: float


def design_experiment(
    p: RodParams,
    fields: Sequence[str] = ("E",),
    horizon: int = 30,
    *,
    criterion: str = "D",
    u_min: float = 0.0,
    u_max: float = 10.0,
    steps: int = 100,
    lr: float = 0.1,
    keypoints: Sequence[int] = DEFAULT_KEYPOINTS_FAST,
    method: str = "euler",
    tol: Optional[float] = None,
    max_iter: int = 50,
    u_init=None,
    generator: Optional[torch.Generator] = None,
    fisher: str = "auto",
) -> DesignResult:
    """Fisher-optimal input design: the tension schedule that makes
    ``fields`` most identifiable before the experiment runs.

    The information matrix is the Fisher of the teacher objective at the
    nominal parameters: ``p`` is simulated under the candidate schedule u
    differentiably (implicit_root through every Newton solve), the
    theta-Hessian of the teacher loss is taken on that trajectory with
    ``create_graph``, and Adam over sigmoid-bounded tensions ascends log det
    (D-optimal) or the smallest eigenvalue (E-optimal); the gradient with
    respect to the schedule flows through the Hessian and the implicit
    rollout.

    fisher: "exact" (the autodiff theta-Hessian), "gn" (the criterion from
    the singular values of the residual Jacobian J: log det(2 J^T J) =
    D log 2 + 2 sum log sigma_i, min-eig = 2 sigma_min^2) or "auto" (exact
    for float64, gn for float32). ``u_init`` (T, n_tendons) starts from a
    given schedule; otherwise the start is mid-range plus 0.01-scaled
    normal logits drawn from ``generator`` (default seeded with 0).
    """
    if criterion not in ("D", "E"):
        raise ValueError(f"unknown criterion {criterion!r} (want 'D' or 'E')")
    if fisher not in ("auto", "exact", "gn"):
        raise ValueError(f"unknown fisher mode {fisher!r}")
    if fisher == "auto":
        fisher = "exact" if p.dtype == torch.float64 else "gn"
    vec0, _, unpack = _flatten_theta(theta_init(p, fields))
    D = vec0.numel()
    spec = MLPSpec.for_knode()
    kp = tuple(keypoints)
    kw = dict(dtype=p.dtype, device=p.device)

    def nominal_traj(u):
        sim = simulate_scan(p, u, method=method, tol=tol, max_iter=max_iter,
                            differentiable=True, remat=True)
        return sim.traj[:, :, :25]

    def info_exact(u):
        traj = nominal_traj(u)
        _, H = _hessian(lambda v: teacher_forced_loss(
            apply_theta(p, unpack(v)), spec, None, traj, u, kp), vec0,
            create_graph=True)
        H = 0.5 * (H + H.T)
        if criterion == "D":
            return torch.linalg.slogdet(H)[1]
        return torch.linalg.eigvalsh(H)[0]

    def info_gn(u):
        traj = nominal_traj(u)
        _, J = _jacobian_tall(lambda v: teacher_forced_residuals(
            apply_theta(p, unpack(v)), spec, None, traj, u, kp), vec0,
            create_graph=True)
        s = torch.linalg.svdvals(J)                 # descending
        if criterion == "D":
            return D * math.log(2.0) + 2.0 * torch.log(s).sum()
        return 2.0 * s[-1] ** 2

    info = info_gn if fisher == "gn" else info_exact
    span = u_max - u_min
    if u_init is None:
        gen = (generator if generator is not None
               else torch.Generator().manual_seed(0))
        logits0 = 0.01 * torch.randn((horizon, int(p.tendon_dirs.shape[0])),
                                     generator=gen, dtype=p.dtype)
    else:
        u0 = torch.clamp((_tensor(u_init, p.dtype, "cpu") - u_min)
                         / span, 1e-4, 1 - 1e-4)
        logits0 = torch.log(u0 / (1 - u0))
    logits = logits0.to(**kw).requires_grad_(True)
    to_u = lambda lg: u_min + span * torch.sigmoid(lg)

    from .train import AdamPlateau
    adam = AdamPlateau([logits], lr=lr, patience=steps + 1)
    hist = []
    for _ in range(steps):
        with torch.enable_grad():
            val = -info(to_u(logits))
            (logits.grad,) = torch.autograd.grad(val, logits)
        adam.step(val.detach())
        hist.append(val.detach())
    u_f = to_u(logits.detach())
    with torch.enable_grad():
        info_f = float(info(u_f).detach())
    hist = torch.stack(hist) if hist else torch.zeros(0, **kw)
    return DesignResult(controls=u_f, objective_history=hist,
                        info_initial=float(-hist[0]), info_final=info_f)


@dataclasses.dataclass
class LaplacePosterior:
    """Scaled Laplace approximation of the parameter posterior at a fit.

    Under an iid Gaussian position-noise model for the rollout objective
    (MSE L over n scalar position residuals, noise variance sigma^2) the
    posterior covariance is (2 sigma^2 / n) H_L^-1, with sigma^2 estimated
    as L n / (n - d) at the minimum; theta-space quantities are in
    transform space. Locally non-identifiable eigendirections (Hessian
    eigenvalue near zero relative to the largest) get the PRIOR variance
    ``prior_std**2``; ``degenerate_directions`` lists them as
    (eigenvector, data variance) pairs.
    """
    labels: list
    theta: Dict[str, torch.Tensor]     # posterior mean (the fit)
    covariance: np.ndarray             # (D, D), transform space, SCALED
    std: np.ndarray                    # sqrt(diag)
    sigma2: float                      # estimated position-noise variance
    n_residuals: int
    prior_std: float = np.inf
    degenerate_directions: list = dataclasses.field(default_factory=list)


def laplace_posterior(
    p: RodParams,
    traj,
    controls,
    fields: Sequence[str] = ("E",),
    *,
    keypoints: Sequence[int] = DEFAULT_KEYPOINTS_FAST,
    method: str = "euler",
    tol: Optional[float] = None,
    max_iter: int = 50,
    prior_std: float = 1.0,
) -> LaplacePosterior:
    """Scaled parameter posterior at ``p`` (call on a fitted
    ``res.params``) under the ROLLOUT objective's position-noise model
    (the teacher objective sums four heterogeneous MSE terms with no single
    noise scale; its curvature is available unscaled via
    :func:`identifiability`).

    prior_std: one-sigma width (transform space) of the Gaussian prior that
    bounds the variance along locally non-identifiable directions; a
    warning names any direction that hits it.
    """
    traj, controls = _batch(p, traj, controls, "laplace_posterior")
    theta = theta_init(p, fields)
    B, T, N = traj.shape[0], traj.shape[1], traj.shape[2]
    n = B * (T - 1) * N * 3          # scored position residuals
    d = int(sum(t.numel() or 1 for t in theta.values()))
    if n <= d:
        raise ValueError(f"need more residuals ({n}) than parameters ({d})")
    rep = identifiability(p, traj, controls, fields, objective="rollout",
                          keypoints=keypoints, method=method, tol=tol,
                          max_iter=max_iter)
    sigma2 = rep.loss_value * n / (n - d)
    w = np.asarray(rep.eigvals, np.float64)
    V = np.asarray(rep.eigvecs, np.float64)
    prior_var = float(prior_std) ** 2
    data_prec = np.clip(w, 0.0, None) * n / (2.0 * sigma2)
    var = 1.0 / (1.0 / prior_var + data_prec)
    degenerate = []
    w_max = float(np.max(np.abs(w))) if w.size else 0.0
    for i in range(w.size):
        if w[i] <= 1e-10 * max(w_max, 1e-300):
            degenerate.append((V[:, i].copy(),
                               float(1.0 / max(data_prec[i], 1e-300))))
    if degenerate:
        combos = "; ".join(
            " + ".join(f"{v:+.3f}*{lb}" for v, lb in
                       zip(vec, rep.labels) if abs(v) > 0.05)
            for vec, _ in degenerate)
        warnings.warn(
            f"laplace_posterior: {len(degenerate)} locally "
            f"non-identifiable parameter direction(s) [{combos}] — the "
            f"data carries no curvature there; their posterior variance "
            f"is the prior's (prior_std={prior_std}). Re-excite (see "
            "design_experiment) or fix one of the coupled parameters.",
            stacklevel=2)
    cov = (V * var) @ V.T
    std = np.sqrt(np.clip(np.diagonal(cov), 0, None))
    return LaplacePosterior(labels=rep.labels, theta=theta,
                            covariance=cov, std=std, sigma2=sigma2,
                            n_residuals=n, prior_std=float(prior_std),
                            degenerate_directions=degenerate)


def sample_posterior(p: RodParams, post: LaplacePosterior,
                     generator: torch.Generator,
                     n_samples: int = 20) -> RodParams:
    """``n_samples`` rods drawn from the Laplace posterior (normal draws
    from ``generator``), one stack of fully derived rods
    (core/params.stack_params): ``simulate_scan`` rolls it out as a
    predictive ensemble, (n_samples, T, N, 50)."""
    vec0, _, unpack = _flatten_theta(post.theta)
    D = vec0.numel()
    cov = np.asarray(post.covariance, np.float64)
    # jittered Cholesky, the jitter relative to the covariance's scale (an
    # exactly zero covariance gives an all-mean ensemble)
    scale = float(np.trace(cov)) / max(D, 1)
    jitter = 1e-12 * scale if scale > 0 else 1e-300
    Lc = np.linalg.cholesky(cov + jitter * np.eye(D))
    eps = torch.randn((n_samples, D), generator=generator,
                      dtype=torch.float64).numpy()
    vecs = vec0.detach().cpu().double().numpy()[None] + eps @ Lc.T
    with torch.no_grad():
        return apply_theta(p, unpack(torch.as_tensor(
            vecs, dtype=vec0.dtype, device=vec0.device)))


# ------------------------------------------------- assembly identification

@dataclasses.dataclass
class AssemblySysIdResult:
    """Outcome of :func:`fit_assembly_params`.

    assembly: the fitted RodAssembly (each rod re-derived).
    theta: fitted transform-space variables, each with a leading M (rod)
      axis.
    values: physical-space values per field, shape (M, ...).
    loss_history: (steps,) objective value per Adam step.
    """
    assembly: object
    theta: Dict[str, torch.Tensor]
    values: Dict[str, np.ndarray]
    loss_history: torch.Tensor


def _assembly_theta(asm, fields):
    """Per-rod transform-space theta stacked on a leading M axis."""
    per_rod = [theta_init(r, fields) for r in asm.rods]
    return {k: torch.stack([t[k] for t in per_rod]) for k in per_rod[0]}


def _assembly_with(asm, theta):
    """The assembly with rod i re-derived at theta[...][i], all M in one
    batched apply_theta (the JAX package's jax.vmap(apply_theta))."""
    rods = apply_theta(asm.stacked_rods(), theta)
    out = asm.replace(rods=unstack_params(rods))
    out._cache["rods"] = rods
    return out


def _assembly_inputs(asm, plate_traj, controls, w_ori):
    plate_traj = _tensor(plate_traj, asm.dtype, asm.device)
    controls = _tensor(controls, asm.dtype, asm.device)
    if controls.dim() != 3 or controls.shape[1] != asm.M:
        raise ValueError(f"controls must be (T, M={asm.M}, n_tendons), "
                         f"got {tuple(controls.shape)}")
    if plate_traj.dim() != 2 or plate_traj.shape[-1] < 3:
        raise ValueError(f"plate_traj must be (T, >=3), got "
                         f"{tuple(plate_traj.shape)}")
    if plate_traj.shape[0] != controls.shape[0]:
        raise ValueError("plate_traj and controls must share T")
    if w_ori and plate_traj.shape[-1] < 7:
        raise ValueError("w_ori needs plate_traj rows [p(3), h(4)]")
    return plate_traj, controls


def _assembly_fit_loss(asm, plate_traj, controls, theta, w_ori, tol,
                       max_iter, solver):
    """Plate-pose MSE of the coupled rollout at per-rod theta, plus w_ori
    times the antipode-safe orientation term mean(1 - cos^2)."""
    from ..core.assembly import simulate_assembly

    sim = simulate_assembly(_assembly_with(asm, theta), controls, tol=tol,
                            max_iter=max_iter, differentiable=True,
                            remat=True, solver=solver)
    dp = sim.plate_pose[:, :3] - plate_traj[:, :3]
    loss = (dp * dp).mean()
    if w_ori:
        q, qt = sim.plate_pose[:, 3:7], plate_traj[:, 3:7]
        dot = ((q * qt).sum(-1)
               * torch.rsqrt((q * q).sum(-1) * (qt * qt).sum(-1) + 1e-30))
        loss = loss + w_ori * (1.0 - dot * dot).mean()
    return loss


def fit_assembly_params(
    asm,
    plate_traj,
    controls,
    fields: Sequence[str] = ("E",),
    *,
    steps: int = 200,
    lr: float = 0.05,
    w_ori: float = 0.0,
    tol: Optional[float] = None,
    max_iter: int = 50,
    solver: str = "auto",
    chunk: Optional[int] = None,
) -> AssemblySysIdResult:
    """Per-rod grey-box identification of a parallel continuum robot from
    END-PLATE pose observations alone: each field gets one transform-space
    variable per rod, and the gradients flow through the whole coupled
    rollout (core/assembly.simulate_assembly(differentiable=True): the
    implicit function theorem at every (6M+7)-dim solve, through the rods'
    and the plate's parameters).

    plate_traj: observed plate rows (T, >=3) [p_plate(3), h_plate(4)];
    controls: (T, M, n_tendons); w_ori weighs the orientation term (needs
    rows of width 7); chunk as in :func:`fit_rod_params`.
    ``values[field]`` has shape (M,) (or (M, 3) for logdiag fields).
    """
    plate_traj, controls = _assembly_inputs(asm, plate_traj, controls, w_ori)
    _check_chunk(chunk)
    theta = {k: v.detach().clone().requires_grad_(True)
             for k, v in _assembly_theta(asm, fields).items()}
    hist = _adam_fit(lambda th, _: _assembly_fit_loss(
        asm, plate_traj, controls, th, w_ori, tol, max_iter, solver),
        theta, None, steps, lr, None)
    theta = {k: v.detach() for k, v in theta.items()}
    with torch.no_grad():
        fitted = _assembly_with(asm, theta)
    return AssemblySysIdResult(assembly=fitted, theta=theta,
                               values=theta_values(theta),
                               loss_history=hist)


def assembly_identifiability(
    asm,
    plate_traj,
    controls,
    fields: Sequence[str] = ("E",),
    *,
    w_ori: float = 0.0,
    tol: Optional[float] = None,
    max_iter: int = 50,
    solver: str = "auto",
) -> IdentifiabilityReport:
    """Gauss-Newton / Fisher identifiability of per-rod parameters from
    end-plate observations, before :func:`fit_assembly_params` runs.

    Observation model: Gaussian noise on the plate position rows and (when
    w_ori > 0) on the plate quaternion, residual q - sign(<q, q_obs>) q_obs
    (antipode-safe; scaled so that sum(r^2) matches the fit objective's
    orientation term to second order). The Gram is formed in float64."""
    from ..core.assembly import simulate_assembly

    plate_traj = _tensor(plate_traj, asm.dtype, asm.device)
    controls = _tensor(controls, asm.dtype, asm.device)
    if controls.dim() != 3 or controls.shape[1] != asm.M:
        raise ValueError(f"controls must be (T, M={asm.M}, n_tendons), "
                         f"got {tuple(controls.shape)}")
    if w_ori and plate_traj.shape[-1] < 7:
        raise ValueError("w_ori needs plate_traj rows [p(3), h(4)]")
    T = int(plate_traj.shape[0])
    theta0 = _assembly_theta(asm, fields)
    vec0, _, unpack = _flatten_theta(theta0)
    # rod k // ncomp, component k % ncomp of each (M, *comp) leaf
    labels = []
    for name in sorted(theta0):
        shape = theta0[name].shape
        ncomp = int(np.prod(shape[1:])) or 1
        for k in range(int(shape[0]) * ncomp):
            suffix = "" if ncomp == 1 else f"[{k % ncomp}]"
            labels.append(f"rod{k // ncomp}:{name}{suffix}")

    def res_of_vec(v):
        sim = simulate_assembly(_assembly_with(asm, unpack(v)), controls,
                                tol=tol, max_iter=max_iter,
                                differentiable=True, remat=True,
                                solver=solver)
        dp = (sim.plate_pose[:, :3] - plate_traj[:, :3]).reshape(-1)
        parts = [dp / math.sqrt(3.0 * T)]
        if w_ori:
            q, qt = sim.plate_pose[:, 3:7], plate_traj[:, 3:7]
            q = q * torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-30)
            qt = qt * torch.rsqrt((qt * qt).sum(-1, keepdim=True) + 1e-30)
            sign = torch.sign((q * qt).sum(-1, keepdim=True))
            sign = torch.where(sign == 0, torch.ones_like(sign), sign)
            parts.append((q - sign * qt).reshape(-1) * math.sqrt(w_ori / T))
        return torch.cat(parts)

    r, J = _jacobian_tall(res_of_vec, vec0)
    H = 2.0 * _gram(J)
    return _report_from_hessian(labels, H,
                                float((r.detach().double() ** 2).sum()))
