"""KNODE training: the epoch loop, the optimizer and ``train_knode``.

PyTorch counterpart of ``knode_cosserat_tpu/training/train.py`` (reference
trainers physics_train.py sim track, train_segment.py real track, with the
``--fast`` path as the only path): every (trajectory, timestep, keypoint)
cell of the batch is one fused forward/backward.

Optimizer: Adam(lr) or AdamW(lr, weight_decay) chained with
reduce-on-plateau(factor, patience, rtol=1e-4, atol=0, cooldown=0,
accumulation_size=1) (physics_train.py:199-206; the JAX package's optax
chain), then the non-negative weight clamp (physics_train.py:299-304).
:class:`AdamPlateau` writes that chain by hand with optax's formulas:
``torch.optim.Adam`` and ``ReduceLROnPlateau`` round and order differently
and keep their plateau state per epoch call, not per step.

Periodic evaluation rolls the hybrid model out on a validation schedule and
scores its tip DTW against the reference rod (physics_train.py:136-167); the
best-DTW weights are kept.

Epoch chunks run on kernel K4 (ops/train.py), or on K6 (ops/train_wide.py)
for wide nets, where the configuration and the device allow it (see
``TrainConfig.fused``), else on the plain epoch loop of
:func:`make_epoch_scan`. A fused run stays on the device for the whole
call: its cells are built once, each launch takes the last one's weights
and optimizer state, and the host reads back only where a checkpoint, a
validation, a log line or the return needs a value. The validation
rollouts of a CUDA rod run on K2 (``rollout_with_nn(impl="mega")``).
"""
from __future__ import annotations

import copy
import dataclasses
import math
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.params import RodParams
from ..core.stepper import simulate
from ..models.mlp import KnodeMLP, MLPSpec, clamp_nonnegative, init_mlp
from ..utils.profiling import annotate, count, new_call
from .loss import DEFAULT_KEYPOINTS_FAST, teacher_forced_loss

__all__ = ["TrainConfig", "TrainResult", "train_knode", "make_train_step",
           "make_epoch_scan", "make_optimizer", "rollout_with_nn",
           "AdamPlateau", "optim_state_from_jax", "optim_state_to_jax"]

# optax.adam's defaults and the plateau tolerance make_optimizer pins (K4,
# ops/train.py, takes the same values)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
PLATEAU_RTOL = 1e-4


@dataclasses.dataclass
class TrainConfig:
    epochs: int = 2000
    lr: float = 1e-2
    weight_decay: float = 0.0
    hidden: int = 512
    keypoints: Tuple[int, ...] = DEFAULT_KEYPOINTS_FAST
    history: bool = False
    activation: str = "elu"
    seed: int = 0
    clamp_weights: bool = True              # physics_train.py:26,299-304
    plateau_patience: int = 80
    plateau_factor: float = 0.5
    eval_every: int = 200                   # physics_train.py:379 (fast path)
    eval_len: int = 100
    log_every: int = 10
    checkpoint_every: int = 500             # physics_train.py:386
    dtype: str = "float32"
    # the net's matmul storage dtype ("bfloat16"; MLPSpec.compute_dtype):
    # the fused trainers decline it, "auto" takes the plain epoch loop
    nn_dtype: Optional[str] = None
    # the epoch chunks (train_knode, and grid_train's K5 for "auto" / "on"
    # / "plain" / "off"):
    #   "auto"   K4 (ops/train.py) on a CUDA rod when fused_trainer_supported,
    #            else K6 (ops/train_wide.py) on a CUDA rod from hidden 2048
    #            up when wide_trainer_supported (the JAX package's routing),
    #            else the plain epoch loop (make_epoch_scan)
    #   "on"     K4 through its wrapper (a CPU rod runs K4's plain version);
    #            raises when the configuration is not supported
    #   "plain"  K4's plain version on any device (the JAX package's
    #            "interpret", which is accepted as the same)
    #   "wide"   K6 through its wrapper (a CPU rod runs its plain version)
    #   "wide_interpret"  K6's plain version on any device
    #   "off"    the plain epoch loop
    fused: str = "auto"
    # validation DTW: "device" = exact DTW by the wavefront (ops/dtw.py) on
    # the rollout's device; "host" = the reference's fastdtw on the host
    eval_dtw: str = "device"
    # validation rollouts: "auto" = K2 ("mega") on a CUDA rod, the
    # autodiff-Newton scan ("scan", the JAX package's "xla") on a CPU rod
    eval_impl: str = "auto"
    # write checkpoints on a background thread (AsyncCheckpointWriter)
    checkpoint_async: bool = False

    def spec(self) -> MLPSpec:
        return MLPSpec.for_knode(self.hidden, self.history, self.activation,
                                 self.nn_dtype)


@dataclasses.dataclass
class TrainResult:
    params: KnodeMLP              # final weights
    best_params: KnodeMLP         # best-validation-DTW weights
    best_dtw: float
    loss_history: np.ndarray      # (epochs + 1,)
    dtw_history: list             # [(epoch, dtw)]
    spec: MLPSpec
    config: TrainConfig
    epochs_per_sec: float = 0.0
    device: str = "cpu"           # what epochs_per_sec was measured on


# --------------------------------------------------------------- optimizer

class AdamPlateau(torch.optim.Optimizer):
    """optax.chain(adam(lr) | adamw(lr, weight_decay),
    contrib.reduce_on_plateau(factor, patience, rtol=1e-4, atol=0,
    cooldown=0, accumulation_size=1)), written by hand. ``step(loss)`` takes the loss
    of the weights the gradients were taken at.

    Per step, in optax's order: the plateau sees this step's loss (an
    improvement is loss < (1 - rtol) * best; ``patience`` steps without
    one multiply the scale by ``factor``); the Adam count goes up by one;
    then every parameter P with gradient g:
        mu = (1-b1) g + b1 mu,  nu = (1-b2) g^2 + b2 nu
        u  = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) [+ wd P]
        P  = P + ((-lr) u) scale
    The moments live in ``state[P]["mu"|"nu"]``; the count and the
    plateau's best value, count and scale in ``state["chain"]``, so
    ``state_dict()`` carries them all.
    """

    def __init__(self, params, lr: float = 1e-2, weight_decay: float = 0.0,
                 factor: float = 0.5, patience: int = 80):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))
        self.factor, self.patience = factor, patience
        self.state["chain"] = dict(count=0, best_value=math.inf,
                                   plateau_count=0, scale=1.0)
        for P in self.params():
            self.state[P] = dict(mu=torch.zeros_like(P),
                                 nu=torch.zeros_like(P))

    def params(self):
        return [P for g in self.param_groups for P in g["params"]]

    @property
    def chain(self) -> dict:
        return self.state["chain"]

    @torch.no_grad()
    def step(self, loss):
        value, s = float(loss), self.chain
        # reduce_on_plateau (accumulation_size=1, cooldown=0, atol=0)
        improved = value < (1.0 - PLATEAU_RTOL) * s["best_value"]
        if improved:
            s["best_value"] = value
        cnt = 0 if improved else s["plateau_count"] + 1
        if cnt == self.patience:
            s["scale"] = max(s["scale"] * self.factor, 0.0)
            cnt = 0
        s["plateau_count"] = cnt
        s["count"] += 1
        t = s["count"]
        b1, b2, eps = ADAM_B1, ADAM_B2, ADAM_EPS
        bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        for group in self.param_groups:
            for P in group["params"]:
                g = P.grad if P.grad is not None else torch.zeros_like(P)
                st = self.state[P]
                st["mu"] = (1 - b1) * g + b1 * st["mu"]
                st["nu"] = (1 - b2) * (g * g) + b2 * st["nu"]
                u = (st["mu"] / bc1) / (torch.sqrt(st["nu"] / bc2) + eps)
                if group["weight_decay"]:
                    u = u + group["weight_decay"] * P
                P.add_(u * (-group["lr"]) * s["scale"])
        return loss


def make_optimizer(cfg: TrainConfig, net: KnodeMLP) -> AdamPlateau:
    """The trainer's optimizer over ``net``'s parameters (the JAX package's
    make_optimizer chain, built on the weights it will update)."""
    return AdamPlateau(net.parameters(), lr=cfg.lr,
                       weight_decay=cfg.weight_decay,
                       factor=cfg.plateau_factor,
                       patience=cfg.plateau_patience)


def _layer_pairs(opt: AdamPlateau):
    ps = opt.params()
    return [(ps[i], ps[i + 1]) for i in range(0, len(ps), 2)]


def optim_state_from_jax(state, opt: AdamPlateau) -> AdamPlateau:
    """Load the JAX package's optimizer state (the make_optimizer chain
    ``((adam|adamw state, ...), reduce_on_plateau state)``) into ``opt``.

    ``state`` is the optax state itself or the nested tuples that
    load_checkpoint returns for it; its leaves may be jax or numpy arrays.
    Adam's state is (count, mu, nu) with mu/nu tuples of {"w", "b"} per
    layer; the plateau's is (scale, best_value, plateau_count,
    cooldown_count, count, avg_value), where the last three are 0 between
    steps of this chain."""
    adam, plateau = state[0][0], state[1]
    count, mu, nu = adam[0], adam[1], adam[2]
    pairs = _layer_pairs(opt)
    if len(mu) != len(pairs):
        raise ValueError(f"{len(mu)} layers of moments, optimizer has "
                         f"{len(pairs)}")
    with torch.no_grad():
        for (W, b), m, v in zip(pairs, mu, nu):
            for P, key in ((W, "w"), (b, "b")):
                for name, src in (("mu", m), ("nu", v)):
                    a = torch.from_numpy(np.array(src[key]))
                    opt.state[P][name] = a.to(P.device, P.dtype).reshape(
                        P.shape).clone()
    opt.chain.update(count=int(np.asarray(count)),
                     scale=float(np.asarray(plateau[0])),
                     best_value=float(np.asarray(plateau[1])),
                     plateau_count=int(np.asarray(plateau[2])))
    return opt


def optim_state_to_jax(opt: AdamPlateau):
    """``opt``'s state as nested tuples with the JAX package's optax leaf
    order (for checkpoints that both packages load): ((count, mu, nu),),
    (scale, best_value, plateau_count, cooldown_count, count, avg_value))."""
    s = opt.chain
    host = lambda t: t.detach().cpu().numpy()
    tree = lambda name: tuple({"w": host(opt.state[W][name]),
                               "b": host(opt.state[b][name])}
                              for W, b in _layer_pairs(opt))
    np_dtype = host(opt.params()[0]).dtype
    i32 = lambda v: np.asarray(v, np.int32)
    return (((i32(s["count"]), tree("mu"), tree("nu")),),
            (np.asarray(s["scale"], np_dtype),
             np.asarray(s["best_value"], np_dtype), i32(s["plateau_count"]),
             i32(0), i32(0), np.asarray(0.0, np_dtype)))


# -------------------------------------------------------------- epoch loops

def make_train_step(p: RodParams, spec: MLPSpec, optimizer: AdamPlateau,
                    keypoints: Sequence[int], clamp: bool,
                    use_pallas: bool = False, skip_first: bool = False):
    """(step, total_loss): step(net, trajs, controls) -> loss takes one
    optimizer step on ``net`` (whose parameters ``optimizer`` holds);
    total_loss sums the per-trajectory losses (physics_train.py:313-365).

    trajs: (n_traj, T, N, 25); controls: (n_traj, T, 4). skip_first drops
    each trajectory's first transition (teacher_forced_loss). use_pallas
    routes the teacher-forced RHS through the fused next-segment op
    (kernel K8, ops/next_segment.py): one launch per step over every
    trajectory's cells (the JAX package unrolls one call per trajectory);
    its backward pass is autograd of the plain version."""
    kp = tuple(keypoints)
    fused_fn = None
    if use_pallas:
        from ..ops.next_segment import make_fused_next_segment
        fused_fn = make_fused_next_segment(p, spec)

    def total_loss(net, trajs, controls):
        return teacher_forced_loss(p, spec, net, trajs, controls, kp,
                                   fused_fn=fused_fn,
                                   skip_first=skip_first).sum()

    def step(net, trajs, controls):
        _check_bound(optimizer, net)
        optimizer.zero_grad(set_to_none=True)
        loss = total_loss(net, trajs, controls)
        loss.backward()
        optimizer.step(loss)
        if clamp:
            clamp_nonnegative(net)
        return loss.detach()

    return step, total_loss


def _check_bound(optimizer: AdamPlateau, net: KnodeMLP):
    if [id(t) for t in net.parameters()] != [id(t) for t in
                                             optimizer.params()]:
        raise ValueError("the optimizer does not hold this net's parameters")


def make_epoch_scan(p: RodParams, spec: MLPSpec, optimizer: AdamPlateau,
                    keypoints: Sequence[int], clamp: bool, n_epochs: int):
    """The plain epoch loop (the JAX package's ``lax.scan`` over epochs is a
    Python loop here): run(net, trajs, controls) -> losses (n_epochs,),
    each epoch autograd through teacher_forced_loss, ``optimizer.step``
    and the clamp. ``net`` and ``optimizer`` are updated in place."""
    step, _ = make_train_step(p, spec, optimizer, keypoints, clamp)

    def run(net, trajs, controls):
        return torch.stack([step(net, trajs, controls)
                            for _ in range(n_epochs)])

    return run


# --------------------------------------------------------------- rollouts

def _default_tol(dtype) -> float:
    """Newton tolerance on sum(r^2): 1e-16 is below float32 resolution
    (every solve would run to max_iter), so pick by dtype."""
    return 1e-16 if dtype == torch.float64 else 1e-10


def rollout_with_nn(p: RodParams, controls, spec: MLPSpec,
                    nn_params: KnodeMLP, method: str = "euler",
                    tol: Optional[float] = None, max_iter: int = 50,
                    impl: str = "scan"):
    """Closed-loop rollout (T, N, 50) of the hybrid (physics + MLP) rod.

    impl "scan" (the JAX package's "xla", accepted as the same): the
    autodiff-Newton rollout of core/stepper.py. impl "mega": the whole
    Newton solve per time step in kernel K2 (core/fast_rollout.py,
    ops/step.py; on a CPU rod its plain version); the converged trajectory
    matches the scan to solver tolerance."""
    if tol is None:
        tol = _default_tol(p.dtype)
    controls = torch.as_tensor(controls, dtype=p.dtype, device=p.device)
    if impl == "mega":
        from ..core.fast_rollout import mega_rollout_cached
        roll = mega_rollout_cached(p, spec, tol=tol, max_iter=max_iter,
                                   method=method)
        traj, _, _ = roll(controls[None], nn_params)
        return traj[0]
    if impl not in ("scan", "xla"):
        raise ValueError(f"impl {impl!r}: use 'scan' (or 'xla') or 'mega'")
    return simulate(p, controls, nn_fn=nn_params, nn_history=spec.history,
                    method=method, tol=tol, max_iter=max_iter)


# ------------------------------------------------------------ train_knode

# hidden width from which "auto" takes K6: the JAX package's threshold
# (knode_cosserat_tpu/training/train.py:148-156, set on a TPU), kept for
# parity of routing; the H100's own crossover is not yet timed
WIDE_FROM_HIDDEN = 2048


def _resolve_fused(cfg: TrainConfig, spec: MLPSpec, n_cells: int,
                   device: torch.device):
    """cfg.fused -> None (plain epoch loop), "kernel" (K4 through its
    wrapper, which runs the plain version for a CPU rod), "plain" (K4's
    plain version), "wide" (K6 through its wrapper) or "wide_plain" (K6's
    plain version). Decided by the configuration and the device alone, as
    the JAX package's _resolve_fused decides it by its backend."""
    from ..ops.train import fused_trainer_supported
    from ..ops.train_wide import wide_trainer_supported
    mode = cfg.fused
    if mode not in ("auto", "on", "plain", "interpret", "off", "wide",
                    "wide_interpret"):
        raise ValueError(f"cfg.fused={mode!r}")
    if mode == "off":
        return None
    forced = mode != "auto"
    if cfg.dtype != "float32":
        if forced:
            raise ValueError(f"cfg.fused={mode!r}: the fused trainers are "
                             "float32-only")
        return None
    if mode in ("wide", "wide_interpret"):
        if not wide_trainer_supported(spec, n_cells, cfg.weight_decay):
            raise ValueError(f"cfg.fused={mode!r} but the wide trainer "
                             f"does not support this config (spec={spec}, "
                             f"n_cells={n_cells})")
        return "wide" if mode == "wide" else "wide_plain"
    if not fused_trainer_supported(spec, n_cells, cfg.weight_decay):
        if forced:
            raise ValueError(f"cfg.fused={mode!r} but the fused trainer "
                             f"does not support this config (spec={spec}, "
                             f"n_cells={n_cells}); wide hidden widths can "
                             "force cfg.fused='wide'")
        if (spec.dims[1] >= WIDE_FROM_HIDDEN and device.type == "cuda"
                and wide_trainer_supported(spec, n_cells, cfg.weight_decay)):
            return "wide"
        return None
    if mode in ("plain", "interpret"):
        return "plain"
    if mode == "on" or device.type == "cuda":
        return "kernel"
    return None


def _decline_fused(cfg: TrainConfig):
    """cfg.fused under a mesh: the plain epoch loop, or the JAX package's
    refusal of a forced fused trainer."""
    if cfg.fused not in ("auto", "off"):
        raise ValueError(
            f"cfg.fused={cfg.fused!r}: train_knode's fused trainers are "
            "single-device (one model = no shardable batch axis); for the "
            "multi-chip fused path train a GRID - "
            "parallel.grid.grid_train(mesh=...) runs the whole-run kernel "
            "on each rank's cells of the mesh's data axis")


def _net_tree(net: KnodeMLP, host: bool = True):
    """The JAX package's params layout: ({"w", "b"}, ...) per layer."""
    f = ((lambda t: t.detach().cpu().numpy()) if host
         else (lambda t: t.detach().clone()))
    return tuple({"w": f(w), "b": f(b)} for w, b in net.weights())


def _load_net(net: KnodeMLP, tree):
    with torch.no_grad():
        for (w, b), layer in zip(net.weights(), tree):
            for P, key in ((w, "w"), (b, "b")):
                P.copy_(torch.as_tensor(np.array(layer[key])).reshape(
                    P.shape))


def _on_rod(net: KnodeMLP, rod: RodParams) -> KnodeMLP:
    """``net`` on the rod's device and dtype (a copy when they differ)."""
    w = next(net.parameters())
    if w.device == rod.device and w.dtype == rod.dtype:
        return net
    return copy.deepcopy(net).to(device=rod.device, dtype=rod.dtype)


def train_knode(
    p_mod: RodParams,
    trajs,
    controls,
    cfg: TrainConfig,
    validation_controls=None,
    validation_reference=None,
    eval_rod: Optional[RodParams] = None,
    log: Optional[Callable[[str], None]] = print,
    resume_from: Optional[str] = None,
    checkpoint_path: Optional[str] = None,
    mesh=None,
) -> TrainResult:
    """Train the KNODE residual for a (possibly perturbed) rod ``p_mod`` on
    teacher-forcing data from the reference rod, on ``p_mod``'s device.

    validation_controls/validation_reference: optional (T, 4) schedule and
    (T, N, 25) (or the reference's (T, 25, N)) reference rollout for
    DTW-based best-model selection. eval_rod: the rod of the validation
    rollouts (default p_mod). resume_from: a checkpoint (either package's)
    to take the weights, optimizer state and loss history from
    (physics_train.py:186-204). mesh: a parallel.mesh.Mesh ("data", "seq",
    "model"); the whole trainer (epoch loop, validation, best-DTW,
    checkpoints, resume) then runs sharded on every rank of it: trajectories
    DP over "data" (when their count divides it), time SP over "seq", the
    net's hidden units TP over "model" (parallel/sharded_train.py). The
    fused trainers are declined under a mesh; the result is the whole
    (gathered) net on every rank, and rank 0 writes the checkpoints.
    """
    new_call()
    if mesh is not None:
        _decline_fused(cfg)
    spec = cfg.spec()
    dtype = getattr(torch, cfg.dtype)
    device = p_mod.device
    net = init_mlp(spec, torch.Generator().manual_seed(cfg.seed), dtype,
                   device)
    optimizer = make_optimizer(cfg, net)
    resumed_loss: list = []
    if resume_from:
        from .checkpoint import load_checkpoint
        ckpt, _ = load_checkpoint(resume_from)
        _load_net(net, ckpt["params"])
        if ckpt.get("opt_state") is not None:
            optim_state_from_jax(ckpt["opt_state"], optimizer)
        if ckpt.get("loss") is not None:
            resumed_loss = [float(x) for x in np.asarray(ckpt["loss"])]

    trajs = torch.as_tensor(trajs, dtype=dtype, device=device)
    controls_t = torch.as_tensor(controls, dtype=dtype, device=device)
    sharded = None
    if mesh is not None:
        from ..parallel.sharded_train import MeshTraining
        sharded = MeshTraining.build(mesh, p_mod, spec, cfg, net, optimizer,
                                     trajs, controls_t)

    eval_rod = eval_rod if eval_rod is not None else p_mod
    do_eval = (validation_controls is not None
               and validation_reference is not None)
    eval_impl = cfg.eval_impl
    if eval_impl == "auto":
        eval_impl = "mega" if eval_rod.device.type == "cuda" else "scan"
    if do_eval:
        # both layouts, like evaluation.metrics.tip_dtw: state-last
        # (T, N, >=19) or the reference's (T, >=19, N)
        validation_reference = torch.as_tensor(validation_reference)
        if validation_reference.shape[-1] < 19:
            validation_reference = validation_reference.transpose(1, 2)
        validation_reference = validation_reference.to(eval_rod.device)
        validation_controls = torch.as_tensor(
            validation_controls, dtype=eval_rod.dtype, device=eval_rod.device)

    n_cells = int(trajs.shape[0] * (trajs.shape[1] - 1)
                  * len(cfg.keypoints))
    fused_mode = (None if sharded is not None
                  else _resolve_fused(cfg, spec, n_cells, device))
    chunk = cfg.eval_every if do_eval else max(cfg.log_every, 1)
    chunk = max(1, min(chunk, cfg.epochs + 1))
    if sharded is not None:
        make_runner = lambda n: (lambda *_: sharded.run(n))
    elif fused_mode in ("wide", "wide_plain"):
        from ..ops.train_wide import make_wide_training_run
        make_runner = lambda n: make_wide_training_run(
            p_mod, spec, cfg, n, plain=fused_mode == "wide_plain")
    elif fused_mode:
        from ..ops.train import make_fused_training_run
        make_runner = lambda n: make_fused_training_run(
            p_mod, spec, cfg, n, plain=fused_mode == "plain")
    else:
        make_runner = lambda n: make_epoch_scan(
            p_mod, spec, optimizer, cfg.keypoints, cfg.clamp_weights, n)
    run_chunk = make_runner(chunk)
    if fused_mode:
        # the run stays on the device for the whole call: each launch takes
        # the last one's weights, moments and scalars, and the cells built
        # by the first; the net, the optimizer and the loss history are
        # written back only where a checkpoint, a validation, a log line or
        # the return needs them
        from ..ops.train import (DeviceNet, fused_state_from_optimizer,
                                 load_fused_state)
        held = DeviceNet.of(net)
        fstate = fused_state_from_optimizer(optimizer)

    loss_hist = list(resumed_loss)
    pending = []          # the chunks' losses not yet read back, on device
    dtw_hist = []
    best_dtw, best_params = np.inf, net
    ckpt_writer = None
    if checkpoint_path and cfg.checkpoint_async:
        from .checkpoint import AsyncCheckpointWriter
        ckpt_writer = AsyncCheckpointWriter()
    cuda = device.type == "cuda"
    t_start = time.perf_counter()
    t0_compiled = None

    def read_back():
        with annotate("train.wait"):
            host = torch.cat(pending).cpu().numpy()
        count("train.readbacks", 1)
        loss_hist.extend(float(x) for x in host)
        pending.clear()

    epoch = 0
    while epoch <= cfg.epochs:
        with annotate("train.chunk"):
            if do_eval and epoch % cfg.eval_every == 0:
                # reference quirk: the epoch-0 eval scores the model with
                # NO NN (physics_train.py:275,380 pass None at epoch 0)
                if epoch == 0:
                    traj = simulate(eval_rod, validation_controls,
                                    tol=_default_tol(eval_rod.dtype))
                else:
                    if sharded is not None:
                        net = sharded.gathered()[0]
                    elif fused_mode:
                        held.write_to(net)
                    traj = rollout_with_nn(eval_rod, validation_controls,
                                           spec, _on_rod(net, eval_rod),
                                           impl=eval_impl)
                if cfg.eval_dtw == "device":
                    from ..ops.dtw import tip_dtw_device
                    d = float(tip_dtw_device(traj[None, :, :, :25],
                                             validation_reference)[0])
                else:
                    from ..evaluation.metrics import tip_dtw  # scipy: at use
                    d = tip_dtw(traj[:, :, :25].cpu().numpy(),
                                validation_reference.cpu().numpy())
                dtw_hist.append((epoch, d))
                if log:
                    log(f"Validation DTW Distance XYZ {d}")
                if d < best_dtw:
                    best_dtw, best_params = d, copy.deepcopy(net)

            n = min(chunk, cfg.epochs + 1 - epoch)
            runner = run_chunk if n == chunk else make_runner(n)
            if fused_mode:
                held, losses, fstate = runner(held, trajs, controls_t, fstate)
            else:
                losses = runner(net, trajs, controls_t)
            pending.append(losses.detach())
            if t0_compiled is None:
                if cuda:
                    with annotate("train.wait"):
                        torch.cuda.synchronize(device)
                t0_compiled = time.perf_counter()
            epoch += n
            due = checkpoint_path and (epoch % cfg.checkpoint_every) < n
            logged = log and (epoch // chunk) % max(
                1, cfg.log_every // chunk) == 0
            last = epoch > cfg.epochs
            if not fused_mode or due or logged or last:
                read_back()
            if fused_mode and (due or last):
                held.write_to(net)
                if due:
                    load_fused_state(optimizer, fstate)
                    count("train.readbacks", 1)
            if due and sharded is not None:
                # the gather is a collective: every rank joins it, rank 0
                # writes
                net, optimizer = sharded.gathered()
            if due and (sharded is None or sharded.writer):
                tree = {"params": _net_tree(net, host=ckpt_writer is None),
                        "opt_state": optim_state_to_jax(optimizer),
                        "loss": np.asarray(loss_hist), "dtw": list(dtw_hist)}
                if ckpt_writer is not None:
                    ckpt_writer.save(checkpoint_path, tree,
                                     meta={"epoch": epoch})
                else:
                    from .checkpoint import save_checkpoint
                    save_checkpoint(checkpoint_path, tree,
                                    meta={"epoch": epoch})
            if logged:
                log(f"Epoch {epoch - 1} of {cfg.epochs}")
                log(f"Total loss: {loss_hist[-1]:.6e}")

    if ckpt_writer is not None:
        ckpt_writer.close()   # every queued checkpoint is on disk
    if cuda:
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - (t0_compiled or t_start)
    eps = cfg.epochs / elapsed if elapsed > 0 else 0.0
    if sharded is not None:
        net = sharded.gathered()[0]      # the whole net, on every rank
    if not do_eval:
        best_dtw, best_params = np.nan, net
    return TrainResult(params=net, best_params=best_params,
                       best_dtw=float(best_dtw),
                       loss_history=np.asarray(loss_hist),
                       dtw_history=dtw_hist, spec=spec, config=cfg,
                       epochs_per_sec=eps,
                       device=(torch.cuda.get_device_name(device) if cuda
                               else "cpu"))
