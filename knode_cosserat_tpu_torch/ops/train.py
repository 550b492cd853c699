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

The kernel spreads a run's cells, in parts of 128 (:func:`parts`), over
P thread-block clusters, and folds the parts' gradients and losses in part
order each epoch, so a run's bits do not depend on P. Its shape is
:func:`launch_plan` (pure Python: din and hidden fix everything but P)
with P from :func:`clusters_per_run` (the cell count, the runs a launch
and the clusters the card holds at once); the wrapper hands it to the C
entry and the C entry checks it.

K5, the grid trainer (the JAX package's ``make_fused_grid_training_run``,
``jax.vmap`` of the run over experiment cells), is the same kernel over a
grid of runs: :func:`train_grid_run` takes G cells' constants, nets and
states stacked on a leading axis; its plain version
:func:`train_grid_reference` runs :func:`train_run_reference` per cell.
:func:`fused_state_from_jax` / :func:`fused_state_to_jax` convert the state
to and from the JAX package's ``{"moments", "scalars"}`` (biases (n, 1),
scalars (1, 128)), which K4, K5 and K6 (ops/train_wide.py) share.
"""
from __future__ import annotations

import copy
import ctypes
import dataclasses
import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..core.params import RodParams
from ..core.rhs import nn_input_features, rhs
from ..core.stepper import tendon_forces
from ..models.mlp import KnodeMLP, MLPSpec, StackedMLP
from ..utils.profiling import annotate, count
from .quaternion import quaternion_to_euler

__all__ = ["make_fused_training_run", "make_fused_grid_training_run",
           "make_sharded_grid_training_run",
           "fused_trainer_supported", "precompute", "train_run",
           "train_run_reference", "train_grid_run", "train_grid_reference",
           "fresh_state", "fused_state_from_optimizer", "load_fused_state",
           "fused_state_from_jax", "fused_state_to_jax", "Cells",
           "DeviceNet", "TrainHyper", "launch_plan", "TrainPlan",
           "max_active_clusters", "parts", "clusters_per_run",
           "resident_clusters", "scratch_floats", "MAX_CELLS", "MAX_HIDDEN",
           "LAUNCHES", "GRID_LAUNCHES"]

MAX_CELLS = 8192
MAX_HIDDEN = 512

#: K4 launches made by this module's wrapper since the count was last reset
LAUNCHES = 0
#: K5 launches made by this module's grid wrapper since the last reset
GRID_LAUNCHES = 0

# the launch shape (csrc/train.cu checks it): clusters of _CLUSTER blocks
# of _THREADS threads, cells in parts of _TILE
_THREADS = 512
_CLUSTER = 8        # the portable maximum
_TILE = 128
_OUT = 25

#: the clusters of a plan the card holds at once, by (device, plan)
_RESIDENT: dict = {}


class TrainPlan(NamedTuple):
    """K4's launch shape (mirrored by ``TrainPlan`` in csrc/train.cu):
    threads per block, blocks per cluster, hidden units owned by each
    block, unit slots per block (units rounded up to a power of two, at
    least 16; thread t is slot t % slots of cell slice t // slots), cells
    per part (one tile), dynamic shared memory in bytes, and clusters a
    run (P)."""
    threads: int
    cluster: int
    units: int
    slots: int
    tile: int
    smem_bytes: int
    clusters: int = 1


def launch_plan(din: int, hidden: int) -> TrainPlan:
    """K4's (and K5's) launch shape for ``din`` inputs and ``hidden``
    units, on one cluster a run: threads, the hidden split over the
    cluster's blocks, the slots, the part size and the shared memory
    depend on (din, hidden) alone. A launch spreads each run over
    :func:`clusters_per_run` clusters (``_replace(clusters=P)``), which
    depends on the cell count and the runs a launch too; the bits of a run
    do not depend on it, so a K5 run equals a K4 launch on it bit for bit."""
    if din not in (28, 53) or not 1 <= hidden <= MAX_HIDDEN:
        raise ValueError(f"K4 takes 28/53 inputs and hidden 1..{MAX_HIDDEN}; "
                         f"got din={din}, hidden={hidden}")
    units = -(-hidden // _CLUSTER)
    # a slice of threads takes at least one cell quad of a part
    slots = max(_THREADS // (_TILE // 4), 1 << (units - 1).bit_length())
    row = _TILE + 4                     # row stride of the cell-wide buffers
    floats = ((din + 1) * row + slots * row + 2 * _OUT * row
              + (din + 1) * slots + _OUT * slots + 4 * 32)
    return TrainPlan(_THREADS, _CLUSTER, units, slots, _TILE, 4 * floats)


def parts(C: int) -> int:
    """The parts a run's C cells are cut into (the last one ragged): a
    function of C alone, so the fold's order is the same for every P."""
    return -(-C // _TILE)


def clusters_per_run(C: int, G: int, resident: int) -> int:
    """P, the clusters each of a launch's G runs spreads its C cells over:
    as many as the card holds beside the other runs, at most one a part.
    A grid whose runs fill the card keeps one cluster a run (its clusters
    then run in waves); cells within one part keep one cluster."""
    return min(parts(C), max(1, resident // G))


def scratch_floats(plan: TrainPlan, din: int, C: int) -> int:
    """Floats of K4's scratch a run (csrc/train.cu's ``run_floats``): a
    slab a part for its partial gradient (each rank's (din + 26) x slots
    entries), db2 and loss, and one slab for the weight exchange."""
    slab = plan.cluster * (din + 1 + _OUT) * plan.slots + 32
    return (parts(C) + 1) * slab


def fused_trainer_supported(spec: MLPSpec, n_cells: int,
                            weight_decay: float = 0.0) -> bool:
    """The JAX package's gate: a 2-layer ELU KNODE net in full float32,
    hidden <= 512, at most MAX_CELLS cells. Weight decay is supported
    (AdamW in the kernel); the argument stays so callers say what they
    checked."""
    return (len(spec.dims) == 3 and spec.activation == "elu"
            and spec.compute_dtype is None and spec.dims[0] in (28, 53)
            and spec.dims[2] == 25 and spec.dims[1] <= MAX_HIDDEN
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
    # device buffers a kernel keeps across its launches on these cells (K4:
    # the parts' scratch and the run barrier), made at the first launch
    scratch: dict = dataclasses.field(default_factory=dict, repr=False,
                                      compare=False)


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


def fresh_state(W: Sequence[torch.Tensor]) -> dict:
    """The state of a run that has taken no step: zero moments, Adam count
    0, best loss inf, plateau count 0, scale 1 (float32, W's device)."""
    moments = tuple(torch.zeros_like(w, dtype=torch.float32)
                    for w in W for _ in range(2))
    scalars = torch.tensor([0.0, math.inf, 0.0, 1.0], dtype=torch.float32,
                           device=W[0].device)
    return {"moments": moments, "scalars": scalars}


def fused_state_from_jax(state, device=None) -> dict:
    """The JAX package's fused-kernel state (pallas_train / pallas_train_wide
    ``{"moments": (8 arrays, biases (n, 1)), "scalars": (1, 128)}``) -> the
    port's (biases (n,), scalars (4,)), float32 on ``device``."""
    t = lambda a: torch.from_numpy(np.array(a, np.float32)).to(device)
    moments = tuple(t(m).reshape(-1) if i in (2, 3, 6, 7) else t(m)
                    for i, m in enumerate(state["moments"]))
    return {"moments": moments,
            "scalars": t(np.asarray(state["scalars"]).reshape(-1)[:4])}


def fused_state_to_jax(state) -> dict:
    """The port's state -> the JAX package's layout (numpy, float32): the
    inverse of :func:`fused_state_from_jax` (scalars[4], the JAX kernel's
    own ds slot, is 0: its kernels set it from the rod on every call)."""
    host = lambda a: a.detach().cpu().numpy().astype(np.float32)
    moments = tuple(host(m)[:, None] if i in (2, 3, 6, 7) else host(m)
                    for i, m in enumerate(state["moments"]))
    scalars = np.zeros((1, 128), np.float32)
    scalars[0, :4] = host(state["scalars"])
    return {"moments": moments, "scalars": scalars}


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
    with annotate("train.wait"):
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
    with annotate("k4.launch"):
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


def check_run_args(cells: Cells, W, state, n_epochs: int, lead: tuple,
                   max_hidden: int, max_cells: int, what: str):
    """Raise unless a training kernel takes these arguments (float32,
    contiguous, on one CUDA device, the shapes of one run or of ``lead``
    runs stacked); returns (C, din, hidden)."""
    dev = cells.x.device
    C, din = cells.x.shape[-2:]
    h = W[0].shape[-2]
    if din not in (28, 53) or not 1 <= h <= max_hidden or n_epochs < 1:
        raise ValueError(f"{what} takes 28/53 inputs, hidden 1..{max_hidden} "
                         f"and >= 1 epoch; got din={din}, hidden={h}, "
                         f"epochs={n_epochs}")
    if not 1 <= C <= max_cells:
        raise ValueError(f"{C} cells, {what} takes 1..{max_cells}")
    shapes = {"W1": (h, din), "b1": (h,), "W2": (25, h), "b2": (25,)}
    for (name, shape), t in zip(shapes.items(), W):
        _check(name, t, lead + shape, dev)
    for i, t in enumerate(state["moments"]):
        _check(f"moment {i}", t, W[i // 2].shape, dev)
    _check("scalars", state["scalars"], lead + (4,), dev)
    for name, d in (("x", din), ("y_base", 19), ("z_phys", 6), ("tgt_y", 19),
                    ("tgt_z", 6), ("e_tgt", 3)):
        _check(name, getattr(cells, name), lead + (C, d), dev)
    return C, din, h


def _launch(cells: Cells, W, state, n_epochs, hyper, ds_grid=None):
    """K4 (one run), or K5 when ``ds_grid`` holds the G cells' ds and every
    tensor carries a leading grid axis G. Each run spreads over
    :func:`clusters_per_run` clusters; the parts' scratch and the runs'
    barriers are made at the cells' first launch and kept in
    ``cells.scratch`` (launches on one set of cells run in stream order)."""
    global LAUNCHES, GRID_LAUNCHES
    from ..training.train import PLATEAU_RTOL
    from ._build import TrainArgs, library

    dev = cells.x.device
    lead = () if ds_grid is None else (ds_grid.shape[0],)
    what = "K4 train" if ds_grid is None else "K5 grid train"
    C, din, h = check_run_args(cells, W, state, n_epochs, lead, MAX_HIDDEN,
                               MAX_CELLS, what)

    W_out = [torch.empty_like(t) for t in W]
    m_out = [torch.empty_like(t) for t in state["moments"]]
    s_out = torch.empty_like(state["scalars"])
    losses = torch.empty(lead + (n_epochs,), dtype=torch.float32, device=dev)
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
    G = lead[0] if lead else 1
    plan = launch_plan(din, h)._replace(clusters=clusters_per_run(
        C, G, resident_clusters(din, h, dev)))
    key = ("k4", plan, G)
    if key not in cells.scratch:
        cells.scratch[key] = (
            torch.empty(G * scratch_floats(plan, din, C), dtype=torch.float32,
                        device=dev),
            torch.zeros(2 * G, dtype=torch.int32, device=dev))
    part, bar = cells.scratch[key]
    a.part, a.bar = part.data_ptr(), bar.data_ptr()
    c_plan = ctypes.byref(_c_plan(plan))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if ds_grid is None:
            code = library().knode_train(ctypes.byref(a), c_plan, stream)
        else:
            a.ds_grid = ds_grid.data_ptr()
            code = library().knode_train_grid(ctypes.byref(a), G, c_plan,
                                              stream)
    raise_on(code, what)
    count("k4.clusters", plan.clusters)
    if ds_grid is None:
        LAUNCHES += 1
    else:
        GRID_LAUNCHES += 1
    return W_out, losses, {"moments": tuple(m_out), "scalars": s_out}


def raise_on(code: int, what: str):
    """Raise a RuntimeError naming the CUDA error of a training kernel's
    launch, if there was one."""
    if code != 0:
        from ._build import library
        name = library().knode_error_name(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} "
                           f"({name})")


def _c_plan(plan: TrainPlan):
    from ._build import TrainPlanC
    return TrainPlanC(*plan)


def max_active_clusters(din: int, hidden: int, device=None) -> int:
    """How many K4 / K5 clusters of :func:`launch_plan` the card holds at
    once (``cudaOccupancyMaxActiveClusters``): the clusters a launch's runs
    share (:func:`clusters_per_run`)."""
    from ._build import library
    n = ctypes.c_int(0)
    with torch.cuda.device(device or torch.cuda.current_device()):
        code = library().knode_train_clusters(
            din, hidden, ctypes.byref(_c_plan(launch_plan(din, hidden))),
            ctypes.byref(n))
    raise_on(code, "K4 occupancy query")
    return n.value


# ------------------------------------------------------------- K5 (grid)

def resident_clusters(din: int, hidden: int, device) -> int:
    """:func:`max_active_clusters` on ``device``, asked once per device and
    plan."""
    key = (str(device), launch_plan(din, hidden))
    if key not in _RESIDENT:
        _RESIDENT[key] = max_active_clusters(din, hidden, device)
    return _RESIDENT[key]


def _cell(state: dict, g: int) -> dict:
    return {"moments": tuple(m[g] for m in state["moments"]),
            "scalars": state["scalars"][g]}


def _stack_states(states) -> dict:
    return {"moments": tuple(torch.stack(ms) for ms in
                             zip(*(s["moments"] for s in states))),
            "scalars": torch.stack([s["scalars"] for s in states])}


def train_grid_reference(cells: Sequence[Cells], W: Sequence[torch.Tensor],
                         state: dict, n_epochs: int, hyper: TrainHyper):
    """Plain PyTorch version of K5: :func:`train_run_reference` on each of
    the G cells. W: [W1, b1, W2, b2], each stacked (G, ...); state: the
    cells' states stacked (moments (G, ...), scalars (G, 4)). Returns
    (W' stacked, losses (G, n_epochs), state' stacked)."""
    outs = [train_run_reference(c, [w[g] for w in W], _cell(state, g),
                                n_epochs, hyper)
            for g, c in enumerate(cells)]
    return ([torch.stack(ws) for ws in zip(*(o[0] for o in outs))],
            torch.stack([o[1] for o in outs]),
            _stack_states([o[2] for o in outs]))


def train_grid_run(cells: Sequence[Cells], W: Sequence[torch.Tensor],
                   state: dict, n_epochs: int, hyper: TrainHyper):
    """K5: the G cells' runs in one launch, each on
    :func:`clusters_per_run` clusters. Same arguments and returns as
    :func:`train_grid_reference`, which runs instead for cells on the CPU.
    The cells must share C, din and the loss denominators (one trajectory
    count per launch)."""
    dev = cells[0].x.device
    if dev.type == "cpu":
        return train_grid_reference(cells, W, state, n_epochs, hyper)
    if dev.type != "cuda":
        raise ValueError(f"no training kernel for device {dev}")
    if any(c.inv != cells[0].inv or c.x.shape != cells[0].x.shape
           for c in cells):
        raise ValueError("K5's cells must share their shape and loss "
                         "denominators (split the grid by trajectory count)")
    stacked = Cells(*(torch.stack([getattr(c, f) for c in cells])
                      for f in ("x", "y_base", "z_phys", "tgt_y", "tgt_z",
                                "e_tgt")), cells[0].inv, cells[0].ds)
    ds = torch.tensor([c.ds for c in cells], dtype=torch.float64, device=dev)
    return _launch(stacked, W, state, n_epochs, hyper, ds_grid=ds)


# ------------------------------------------------------------------ runner

def _hyper(cfg) -> TrainHyper:
    return TrainHyper(lr=float(cfg.lr),
                      weight_decay=float(cfg.weight_decay or 0.0),
                      factor=float(cfg.plateau_factor),
                      patience=int(cfg.plateau_patience),
                      clamp=bool(cfg.clamp_weights))


def _check_two_layer_elu(spec: MLPSpec):
    if not (len(spec.dims) == 3 and spec.activation == "elu"
            and spec.compute_dtype is None):
        raise NotImplementedError(
            "the fused trainers take 2-layer ELU MLPs in full float32 (the "
            "reference architecture); use the plain epoch loop otherwise")


class DeviceNet(NamedTuple):
    """A net held on the device between whole-run launches: its float32
    weights [W1, b1, W2, b2] and the cells of the run (None until the
    first launch builds them). A launch on it returns the next one."""
    W: list
    cells: Optional[Cells] = None

    @classmethod
    def of(cls, net: KnodeMLP) -> "DeviceNet":
        return cls([t.detach().to(torch.float32).contiguous()
                    for wb in net.weights() for t in wb])

    def write_to(self, net: KnodeMLP) -> KnodeMLP:
        """Copy the weights into ``net``'s parameters (on the device, no
        synchronisation)."""
        with torch.no_grad():
            for P, w in zip(net.parameters(), self.W):
                P.copy_(w)
        return net


def make_run(p: RodParams, spec: MLPSpec, cfg, n_epochs: int, fn,
             max_cells: int = MAX_CELLS):
    """run(net, trajs, controls, opt_state=None) over a whole-run function
    ``fn(cells, W, state, n_epochs, hyper)`` (K4's or K6's wrapper, or
    their plain version); see :func:`make_fused_training_run`."""
    _check_two_layer_elu(spec)
    hyper = _hyper(cfg)
    keypoints = tuple(cfg.keypoints)

    def run(net, trajs, controls, opt_state=None):
        held = net if isinstance(net, DeviceNet) else DeviceNet.of(net)
        cells = held.cells
        if cells is None:
            with annotate("k4.cells"):
                cells = precompute(p, spec, keypoints, trajs, controls)
            count("train.cells_built", 1)
            if cells.x.shape[0] > max_cells:
                raise ValueError(f"{cells.x.shape[0]} cells > {max_cells}")
        if opt_state is None:
            opt_state = fresh_state(held.W)
        W_out, losses, state = fn(cells, held.W, opt_state, n_epochs, hyper)
        out = DeviceNet(W_out, cells)
        if held is not net:
            out = out.write_to(copy.deepcopy(net))
        return out, losses, state

    return run


def make_fused_training_run(p: RodParams, spec: MLPSpec, cfg, n_epochs: int,
                            plain: bool = False):
    """Whole-training-run runner: run(net, trajs (B,T,N,25), controls
    (B,T,4), opt_state=None) -> (net', losses (n_epochs,), opt_state'),
    matching training.train.make_epoch_scan driven by make_optimizer(cfg)
    to float32 rounding. ``net`` is left as it is; net' is a copy with the
    trained weights. ``net`` may instead be a :class:`DeviceNet`: net' is
    then the DeviceNet of the trained weights, which carries the cells
    built by the first such call, so a chain of calls on the same data
    (train_knode's chunks) builds them once and copies nothing.

    cfg: a TrainConfig (lr, weight_decay, keypoints, clamp_weights,
    plateau_*). opt_state: None for a fresh run or the state a previous
    call returned. plain=True runs :func:`train_run_reference` on any
    device (the JAX package's interpret=True)."""
    return make_run(p, spec, cfg, n_epochs,
                    train_run_reference if plain else train_run)


def make_fused_grid_training_run(spec: MLPSpec, cfg, n_epochs: int,
                                 plain: bool = False):
    """Multitrain version (K5): run(rods, params, trajs, controls,
    opt_state=None) with every argument stacked on a leading grid axis G:
    rods a sequence of G RodParams, params a StackedMLP of G nets, trajs
    (G, B, T, N, 25), controls (G, B, T, 4), opt_state the G states stacked
    (or None). Returns (params' StackedMLP, losses (G, n_epochs),
    opt_state' stacked). plain=True runs :func:`train_grid_reference` on
    any device (the JAX package's interpret=True)."""
    _check_two_layer_elu(spec)
    hyper = _hyper(cfg)
    keypoints = tuple(cfg.keypoints)
    fn = train_grid_reference if plain else train_grid_run

    def run(rods, params: StackedMLP, trajs, controls, opt_state=None):
        if not len(rods) == len(params) == trajs.shape[0] == controls.shape[0]:
            raise ValueError("rods, params, trajs and controls must share "
                             "the grid axis")
        cells = [precompute(p, spec, keypoints, t, c)
                 for p, t, c in zip(rods, trajs, controls)]
        W = [t.detach().to(torch.float32).contiguous()
             for wb in params.weights() for t in wb]
        if opt_state is None:
            opt_state = _stack_states([fresh_state([w[g] for w in W])
                                       for g in range(len(params))])
        W_out, losses, state = fn(cells, W, opt_state, n_epochs, hyper)
        out = copy.deepcopy(params)
        with torch.no_grad():
            for P, w in zip(out.parameters(), W_out):
                P.copy_(w)
        return out, losses, state

    return run


def _take(state: dict, sl: slice) -> dict:
    return {"moments": tuple(m[sl] for m in state["moments"]),
            "scalars": state["scalars"][sl]}


def make_sharded_grid_training_run(spec: MLPSpec, cfg, n_epochs: int, mesh,
                                   axis: str = "data", plain: bool = False):
    """Multi-card multitrain (the JAX package's
    ``make_sharded_grid_training_run``, which shard_maps the vmapped
    whole-run kernel over the mesh): the experiment grid is embarrassingly
    parallel, so each rank of ``mesh`` runs K5 (:func:`train_grid_run`) on
    its G/n cells of the grid axis (n = mesh.shape[axis]), with no
    collective inside the training loop; the weights, losses and
    optimizer states are gathered with ``all_gather`` over ``axis`` at the
    end, so every rank returns the whole grid.

    Same signature and returns as :func:`make_fused_grid_training_run`:
    every rank passes the whole grid, whose length must divide over the
    axis (callers pad, as parallel.grid.grid_train does). plain=True runs
    :func:`train_grid_reference` on each rank instead."""
    from ..parallel.mesh import P, Placement

    inner = make_fused_grid_training_run(spec, cfg, n_epochs, plain=plain)
    grid = Placement(mesh, P(axis))

    def run(rods, params: StackedMLP, trajs, controls, opt_state=None):
        sl = grid.span(len(rods))
        local = StackedMLP(params.unstack()[sl])
        p_l, losses, state = inner(rods[sl], local, trajs[sl], controls[sl],
                                   None if opt_state is None
                                   else _take(opt_state, sl))
        out = copy.deepcopy(params)
        with torch.no_grad():
            for W, w in zip(out.parameters(), p_l.parameters()):
                W.copy_(grid.gather(w.detach()))
        return out, grid.gather(losses), {
            "moments": tuple(grid.gather(m) for m in state["moments"]),
            "scalars": grid.gather(state["scalars"])}

    return run
