"""The whole KNODE training run, many epochs per launch: kernel K4 and its
plain PyTorch version.

Counterpart of ``knode_cosserat_tpu/ops/pallas_train.py``
(``_make_run_one`` via ``make_fused_training_run``). The CUDA kernel is
``csrc/train.cu``; its design note is there.

The teacher-forced loss is a function of the MLP's weights through the
residual add alone: every RHS evaluation point, MLP input and target is
ground truth (physics_train.py:306-376). So the physics is computed once
per run, by :func:`precompute`, as per-cell constants (cells = trajectory x
timestep x keypoint): the MLP inputs x, the physics-grown base y_base, the
physics strains z_phys, the targets and the target Euler angles. Per epoch
a cell then needs only
    nn = W2 elu(W1 x + b1) + b2,  y = y_base + ds nn[:19],
    z = z_phys + nn[19:],
and the loss, its gradient, reduce-on-plateau, Adam(W) and the weight
clamp (training/train.py:AdamPlateau) follow.

The cells are passed cell-major, ``(C, d)`` float32; the kernel masks its
own ragged last tile (the TPU's lane-major padding and VMEM tiling model
are not ported). The optimizer state goes in and out as ``{"moments": (mu,
nu of W1, mu, nu of b1, mu, nu of W2, mu, nu of b2), "scalars": (4,)
[count, best, plateau count, scale]}``, float32 on the device, so chunked
runs compose exactly; :func:`fused_state_from_optimizer` and
:func:`load_fused_state` convert to and from the trainer's optimizer.

``train_run`` dispatches by device: cells on the CPU run
:func:`train_run_reference`, cells on a CUDA device launch K4 (or raise).
"""
from __future__ import annotations

import copy
import ctypes
import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F

from ..core.params import RodParams
from ..core.rhs import nn_input_features, rhs
from ..core.stepper import tendon_forces
from ..models.mlp import KnodeMLP, MLPSpec
from .quaternion import quaternion_to_euler

__all__ = ["make_fused_training_run", "fused_trainer_supported", "precompute",
           "train_run", "train_run_reference", "fused_state_from_optimizer",
           "load_fused_state", "Cells", "TrainHyper", "MAX_CELLS", "LAUNCHES"]

MAX_CELLS = 8192

#: K4 launches made by this module's wrapper since the count was last reset
LAUNCHES = 0

_THREADS = 512      # one block; thread j owns hidden unit j (hidden <= 512)


def fused_trainer_supported(spec: MLPSpec, n_cells: int,
                            weight_decay: float = 0.0) -> bool:
    """The JAX package's gate: a 2-layer ELU KNODE net in full float32,
    hidden <= 512, at most MAX_CELLS cells. Weight decay is supported
    (AdamW in the kernel); the argument stays so callers say what they
    checked."""
    return (len(spec.dims) == 3 and spec.activation == "elu"
            and spec.compute_dtype is None and spec.dims[0] in (28, 53)
            and spec.dims[2] == 25 and spec.dims[1] <= 512
            and 1 <= n_cells <= MAX_CELLS)


@dataclasses.dataclass
class Cells:
    """Per-cell constants of one training run, cell-major float32."""
    x: torch.Tensor        # (C, din) MLP inputs
    y_base: torch.Tensor   # (C, 19) y + ds * rhs_physics(y)
    z_phys: torch.Tensor   # (C, 6) physics strains
    tgt_y: torch.Tensor    # (C, 19)
    tgt_z: torch.Tensor    # (C, 6)
    e_tgt: torch.Tensor    # (C, 3) target Euler angles
    inv: tuple             # (pos, states, eul, z) mean denominators
    ds: float


@dataclasses.dataclass(frozen=True)
class TrainHyper:
    lr: float
    weight_decay: float
    factor: float
    patience: int
    clamp: bool


def precompute(p: RodParams, spec: MLPSpec, keypoints: Sequence[int],
               trajs: torch.Tensor, controls: torch.Tensor) -> Cells:
    """The per-cell constants on the rod's device. trajs (B, T, N, 25) and
    controls (B, T, 4) are rounded to float32 (as the JAX kernel's run
    does), the physics runs in the rod's dtype, and the slabs are cast to
    float32."""
    trajs = trajs.float().to(p.dtype)
    controls = controls.float().to(p.dtype)
    kp = torch.as_tensor(list(keypoints), device=trajs.device)
    ys = trajs[:, :-1, :, :19]
    zs = trajs[:, :-1, :, 19:]
    y_prev = torch.cat([ys[:, :1], ys[:, :-1]], dim=1)
    z_prev = torch.cat([zs[:, :1], zs[:, :-1]], dim=1)
    yh = p.c1 * ys + p.c2 * y_prev
    zh = p.c1 * zs + p.c2 * z_prev
    G = trajs[:, 1:]
    y_in = G[:, :, kp - 1, :19]                       # (B, T-1, K, 19)
    yh_in = yh[:, :, kp - 1]
    zh_in = zh[:, :, kp - 1]
    tf = tendon_forces(p, controls[:, :-1])           # (B, T-1, 3)
    tf_b = tf[:, :, None, :].expand(y_in.shape[:3] + (3,))
    dy_phys, z_phys = rhs(p, y_in, yh_in, zh_in, tf_b)
    feats = nn_input_features(y_in, yh_in, z_phys, zh_in, tf_b, spec.history)
    y_base = y_in + p.ds * dy_phys
    tgt_y = G[:, :, kp, :19]
    tgt_z = G[:, :, kp - 1, 19:]
    e_tgt = quaternion_to_euler(tgt_y[..., 3:7])

    Tm1, K = y_in.shape[1], y_in.shape[2]
    C = y_in.shape[0] * Tm1 * K
    if C > MAX_CELLS:
        raise ValueError(f"{C} cells > MAX_CELLS={MAX_CELLS}")
    cells = lambda a: a.reshape(C, a.shape[-1]).to(torch.float32).contiguous()
    # per-trajectory mean denominators (the sum over trajectories of their
    # means == the sum over all cells / one trajectory's element count)
    inv = (1.0 / (Tm1 * K * 3), 1.0 / (Tm1 * K * 12), 1.0 / (Tm1 * K * 3),
           1.0 / (Tm1 * K * 6))
    return Cells(cells(feats), cells(y_base), cells(z_phys), cells(tgt_y),
                 cells(tgt_z), cells(e_tgt), inv, float(p.ds))


def fused_state_from_optimizer(opt) -> dict:
    """The trainer's optimizer (training/train.py:AdamPlateau over a
    2-layer net) -> the kernel's state, float32 copies on its device."""
    Ps = opt.params()
    f32 = lambda t: t.detach().to(torch.float32).contiguous().clone()
    moments = tuple(f32(opt.state[P][name]) for P in Ps
                    for name in ("mu", "nu"))
    s = opt.chain
    scalars = torch.tensor([s["count"], s["best_value"], s["plateau_count"],
                            s["scale"]], dtype=torch.float32,
                           device=Ps[0].device)
    return {"moments": moments, "scalars": scalars}


def load_fused_state(opt, state: dict):
    """Pour the kernel's state back into the trainer's optimizer. The Adam
    and plateau counts are integers carried exactly in float32."""
    Ps = opt.params()
    m = state["moments"]
    with torch.no_grad():
        for i, P in enumerate(Ps):
            opt.state[P]["mu"] = m[2 * i].to(P.dtype).clone()
            opt.state[P]["nu"] = m[2 * i + 1].to(P.dtype).clone()
    count, best, pcount, scale = state["scalars"].tolist()
    opt.chain.update(count=int(round(count)), best_value=best,
                     plateau_count=int(round(pcount)), scale=scale)
    return opt


# ------------------------------------------------------------ plain version

def _cells_loss(c: Cells, W1, b1, W2, b2) -> torch.Tensor:
    """The summed teacher-forced loss of all cells (float32)."""
    nn = F.linear(F.elu(F.linear(c.x, W1, b1)), W2, b2)
    yg = c.y_base + c.ds * nn[:, :19]
    zp = c.z_phys + nn[:, 19:]
    i_pos, i_states, i_eul, i_z = c.inv
    sq = lambda a, b: ((a - b) ** 2).sum()
    return (sq(yg[:, 0:3], c.tgt_y[:, 0:3]) * i_pos
            + sq(yg[:, 7:19], c.tgt_y[:, 7:19]) * i_states
            + sq(quaternion_to_euler(yg[:, 3:7]), c.e_tgt) * i_eul
            + sq(zp, c.tgt_z) * i_z)


def train_run_reference(cells: Cells, W: Sequence[torch.Tensor], state: dict,
                        n_epochs: int, hyper: TrainHyper):
    """Plain PyTorch version of K4, any device: the same epoch loop on the
    same cells, with the gradient from autograd (not the kernel's
    hand-written backward) and the optimizer of training/train.py.
    Returns (W' [W1, b1, W2, b2], losses (n_epochs,), state')."""
    from ..training.train import AdamPlateau

    P = [w.detach().clone().requires_grad_(True) for w in W]
    opt = AdamPlateau(P, lr=hyper.lr, weight_decay=hyper.weight_decay,
                      factor=hyper.factor, patience=hyper.patience)
    load_fused_state(opt, state)
    losses = []
    for _ in range(n_epochs):
        opt.zero_grad(set_to_none=True)
        loss = _cells_loss(cells, *P)
        loss.backward()
        opt.step(loss)
        if hyper.clamp:
            with torch.no_grad():
                P[0].clamp_(min=0.0)
                P[2].clamp_(min=0.0)
        losses.append(loss.detach())
    return ([t.detach() for t in P], torch.stack(losses),
            fused_state_from_optimizer(opt))


# ------------------------------------------------------------------ kernel

def train_run(cells: Cells, W: Sequence[torch.Tensor], state: dict,
              n_epochs: int, hyper: TrainHyper):
    """K4: ``n_epochs`` epochs in one launch. Same arguments and returns as
    :func:`train_run_reference`, which runs instead for cells on the CPU."""
    dev = cells.x.device
    if dev.type == "cpu":
        return train_run_reference(cells, W, state, n_epochs, hyper)
    if dev.type != "cuda":
        raise ValueError(f"no training kernel for device {dev}")
    return _launch(cells, W, state, n_epochs, hyper)


def _check(name, t, shape, dev):
    if t.device != dev or t.dtype != torch.float32:
        raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                         f"torch.float32 on {dev}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(cells: Cells, W, state, n_epochs, hyper):
    global LAUNCHES
    from ..training.train import PLATEAU_RTOL
    from ._build import TrainArgs, library

    dev = cells.x.device
    C, din = cells.x.shape
    h = W[0].shape[0]
    if din not in (28, 53) or not 1 <= h <= _THREADS or n_epochs < 1:
        raise ValueError(f"K4 takes 28/53 inputs, hidden 1..{_THREADS} and "
                         f">= 1 epoch; got din={din}, hidden={h}, "
                         f"epochs={n_epochs}")
    if not 1 <= C <= MAX_CELLS:
        raise ValueError(f"{C} cells, K4 takes 1..{MAX_CELLS}")
    shapes = {"W1": (h, din), "b1": (h,), "W2": (25, h), "b2": (25,)}
    for (name, shape), t in zip(shapes.items(), W):
        _check(name, t, shape, dev)
    for i, t in enumerate(state["moments"]):
        _check(f"moment {i}", t, W[i // 2].shape, dev)
    _check("scalars", state["scalars"], (4,), dev)
    for name, d in (("x", din), ("y_base", 19), ("z_phys", 6), ("tgt_y", 19),
                    ("tgt_z", 6), ("e_tgt", 3)):
        _check(name, getattr(cells, name), (C, d), dev)

    W_out = [torch.empty_like(t) for t in W]
    m_out = [torch.empty_like(t) for t in state["moments"]]
    s_out = torch.empty_like(state["scalars"])
    losses = torch.empty((n_epochs,), dtype=torch.float32, device=dev)
    ptr = lambda ts: [t.data_ptr() for t in ts]
    a = TrainArgs()
    a.cells[:] = ptr([cells.x, cells.y_base, cells.z_phys, cells.tgt_y,
                      cells.tgt_z, cells.e_tgt])
    a.w_in[:] = ptr(W)
    a.m_in[:] = ptr(state["moments"])
    a.s_in = state["scalars"].data_ptr()
    a.w_out[:] = ptr(W_out)
    a.m_out[:] = ptr(m_out)
    a.s_out = s_out.data_ptr()
    a.losses = losses.data_ptr()
    a.C, a.din, a.hidden, a.n_epochs = C, din, h, n_epochs
    a.patience, a.clamp = hyper.patience, int(hyper.clamp)
    a.lr, a.weight_decay, a.factor, a.rtol = (hyper.lr, hyper.weight_decay,
                                              hyper.factor, PLATEAU_RTOL)
    a.ds = cells.ds
    a.inv[:] = list(cells.inv)
    with torch.cuda.device(dev):
        code = library().knode_train(ctypes.byref(a), _THREADS,
                                     torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        raise RuntimeError(f"K4 train launch failed: CUDA error {code}")
    LAUNCHES += 1
    return W_out, losses, {"moments": tuple(m_out), "scalars": s_out}


# ------------------------------------------------------------------ runner

def make_fused_training_run(p: RodParams, spec: MLPSpec, cfg, n_epochs: int,
                            plain: bool = False):
    """Whole-training-run runner: run(net, trajs (B,T,N,25), controls
    (B,T,4), opt_state=None) -> (net', losses (n_epochs,), opt_state'),
    matching training.train.make_epoch_scan driven by make_optimizer(cfg)
    to float32 rounding. ``net`` is left as it is; net' is a copy with the
    trained weights.

    cfg: a TrainConfig (lr, weight_decay, keypoints, clamp_weights,
    plateau_*). opt_state: None for a fresh run or the state a previous
    call returned. plain=True runs :func:`train_run_reference` on any
    device (the JAX package's interpret=True)."""
    if not (len(spec.dims) == 3 and spec.activation == "elu"
            and spec.compute_dtype is None):
        raise NotImplementedError(
            "the fused trainer takes 2-layer ELU MLPs in full float32 (the "
            "reference architecture); use the plain epoch loop otherwise")
    hyper = TrainHyper(lr=float(cfg.lr),
                       weight_decay=float(cfg.weight_decay or 0.0),
                       factor=float(cfg.plateau_factor),
                       patience=int(cfg.plateau_patience),
                       clamp=bool(cfg.clamp_weights))
    keypoints = tuple(cfg.keypoints)
    fn = train_run_reference if plain else train_run

    def run(net: KnodeMLP, trajs, controls, opt_state=None):
        cells = precompute(p, spec, keypoints, trajs, controls)
        W = [t.detach().to(torch.float32).contiguous()
             for wb in net.weights() for t in wb]
        if opt_state is None:
            from ..training.train import AdamPlateau
            opt_state = fused_state_from_optimizer(AdamPlateau(W))
        W_out, losses, state = fn(cells, W, opt_state, n_epochs, hyper)
        out = copy.deepcopy(net)
        with torch.no_grad():
            for P, w in zip(out.parameters(), W_out):
                P.copy_(w)
        return out, losses, state

    return run
