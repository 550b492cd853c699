"""The whole KNODE training run at any hidden width: kernel K6.

Counterpart of ``knode_cosserat_tpu/ops/pallas_train_wide.py``
(``make_wide_training_run``, ``wide_trainer_supported``). The CUDA kernel
is ``csrc/train_wide.cu``; its design note is there. The function, the
per-cell constants (ops/train.py:precompute) and the opaque optimizer state
are K4's, so the plain version is K4's, :func:`ops.train.train_run_reference`
(an autograd epoch loop, any width), and a run can change between K4 and K6
at a chunk boundary.

The JAX package's gate is kept: a 2-layer ELU float32 net with 25 outputs
and at most ``WIDE_MAX_CELLS`` cells (one lane tile of the TPU). Its VMEM
tile model (``_pick_ht``) is the TPU's and is not ported; K6 takes any
width. Its tiles, cell slices and scratch sizes are :func:`launch_plan`
(pure Python, a function of din, hidden and the cell count), which the
wrapper allocates to and hands to the C entry, which checks it.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..core.params import RodParams
from ..models.mlp import MLPSpec
from .train import (Cells, TrainHyper, check_run_args, make_run, raise_on,
                    train_run_reference)

__all__ = ["make_wide_training_run", "wide_trainer_supported", "train_run",
           "launch_plan", "WidePlan", "WIDE_MAX_CELLS", "LAUNCHES"]

WIDE_MAX_CELLS = 4096

# the tiles of csrc/train_wide.cu (its C entry checks them)
_THREADS = 256
_FWD_UNITS, _FWD_CELLS = 128, 64     # forward tile
_LOSS_CELLS = 8                      # cells per loss block
_BWD_UNITS, _BWD_CELLS = 64, 64      # backward unit tile, cells per chunk
# blocks the plan aims for in the forward and the backward: two resident
# per SM of the H100's 132
_BLOCKS = 2 * 132
_OUT, _OUT_PAD = 25, 28
_STEP_FLOATS = 16    # room for train_common.cuh's AdamStep (44 bytes)


class WidePlan(NamedTuple):
    """K6's launch shape (mirrored by ``WidePlan`` in csrc/train_wide.cu):
    threads per block; the forward's (units x cells) tile and cell tiles
    per block; cells per loss block; the backward's unit tile, cells per
    chunk, cell slices and chunks per slice; the forward's and backward's
    dynamic shared memory (bytes); and the scratch sizes: the partial NN,
    the loss blocks' sums and the partial gradients (floats), and the loss
    blocks' arrival ticket (int32)."""
    threads: int
    fwd_units: int
    fwd_cells: int
    fwd_tiles: int
    loss_cells: int
    bwd_units: int
    bwd_cells: int
    slices: int
    chunks: int
    fwd_smem: int
    bwd_smem: int
    part_floats: int
    sums_floats: int
    grad_floats: int
    counters: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _split(n: int, tiles: int) -> tuple:
    """(items per part, parts): n items in as few parts as keep about
    ``_BLOCKS`` blocks in flight over ``tiles`` unit tiles."""
    per = _cdiv(n, min(n, max(1, _BLOCKS // tiles)))
    return per, _cdiv(n, per)


def launch_plan(din: int, hidden: int, C: int) -> WidePlan:
    """K6's launch shape for ``din`` inputs, ``hidden`` units and ``C``
    cells. The forward's blocks each take a group of cell tiles, the
    backward's a slice of the cells, as many as keep about ``_BLOCKS``
    blocks in flight; the slices' partial gradients are summed in slice
    order, so a plan gives one result bit for bit."""
    if din not in (28, 53) or hidden < 1 or not 1 <= C <= WIDE_MAX_CELLS:
        raise ValueError(f"K6 takes 28/53 inputs, hidden >= 1 and "
                         f"1..{WIDE_MAX_CELLS} cells; got din={din}, "
                         f"hidden={hidden}, C={C}")
    n_fu, n_bu = _cdiv(hidden, _FWD_UNITS), _cdiv(hidden, _BWD_UNITS)
    fwd_tiles, _ = _split(_cdiv(C, _FWD_CELLS), n_fu)
    chunks, slices = _split(_cdiv(C, _BWD_CELLS), n_bu)
    kp = (din + 1 + 3) // 4 * 4         # the inputs and the bias, to float4s
    fwd = (kp * (_FWD_UNITS + 4) + 2 * _FWD_CELLS * kp
           + _FWD_UNITS * (_FWD_CELLS + 4) + _FWD_UNITS * _OUT_PAD
           + _FWD_CELLS * _OUT)
    bwd = (kp * (_BWD_UNITS + 4) + _OUT_PAD * _BWD_UNITS
           + 2 * _BWD_CELLS * kp + 2 * _BWD_CELLS * _OUT_PAD
           + 2 * _BWD_CELLS * (_BWD_UNITS + 4))
    return WidePlan(_THREADS, _FWD_UNITS, _FWD_CELLS, fwd_tiles, _LOSS_CELLS,
                    _BWD_UNITS, _BWD_CELLS, slices, chunks, 4 * fwd, 4 * bwd,
                    n_fu * C * _OUT, _cdiv(C, _LOSS_CELLS) * (_OUT + 1),
                    slices * hidden * (din + 1 + _OUT), 1)


def scratch(plan: WidePlan, C: int, dev) -> dict:
    """The scratch buffers of a launch, sized by the plan: the partial NN
    of each forward unit tile, the cotangents of the cells, the loss
    blocks' sums, the slices' partial gradients, the arrival ticket (zero)
    and the epoch's Adam constants (csrc/train_common.cuh's AdamStep)."""
    f32 = dict(dtype=torch.float32, device=dev)
    return {"part": torch.empty((plan.part_floats,), **f32),
            "g": torch.empty((C, _OUT), **f32),
            "sums": torch.empty((plan.sums_floats,), **f32),
            "grad": torch.empty((plan.grad_floats,), **f32),
            "count": torch.zeros((plan.counters,), dtype=torch.int32,
                                 device=dev),
            "step": torch.empty((_STEP_FLOATS,), **f32)}


#: K6 launches made by this module's wrapper since the count was last reset
LAUNCHES = 0


def wide_trainer_supported(spec: MLPSpec, n_cells: int,
                           weight_decay: float = 0.0) -> bool:
    """The JAX package's gate: a 2-layer ELU net in full float32 with 25
    outputs and 1..WIDE_MAX_CELLS cells, any hidden width. Weight decay is
    supported (AdamW)."""
    return (len(spec.dims) == 3 and spec.activation == "elu"
            and spec.compute_dtype is None and spec.dims[0] in (28, 53)
            and spec.dims[2] == 25 and 0 < n_cells <= WIDE_MAX_CELLS)


def train_run(cells: Cells, W, state: dict, n_epochs: int,
              hyper: TrainHyper):
    """K6: ``n_epochs`` epochs in one call (four launches per epoch on the
    current stream, :func:`launch_plan`'s shape). Same arguments and returns as
    :func:`ops.train.train_run_reference`, which runs instead for cells on
    the CPU."""
    dev = cells.x.device
    if dev.type == "cpu":
        return train_run_reference(cells, W, state, n_epochs, hyper)
    if dev.type != "cuda":
        raise ValueError(f"no training kernel for device {dev}")
    return _launch(cells, W, state, n_epochs, hyper)


def _launch(cells: Cells, W, state, n_epochs, hyper):
    global LAUNCHES
    from ..training.train import PLATEAU_RTOL
    from ._build import WideArgs, WidePlanC, library

    dev = cells.x.device
    C, din, h = check_run_args(cells, W, state, n_epochs, (), 2 ** 31 - 1,
                               WIDE_MAX_CELLS, "K6")
    plan = launch_plan(din, h, C)

    # the kernels update weights and moments in place: on copies
    W_out = [t.clone() for t in W]
    m_out = [t.clone() for t in state["moments"]]
    s_out = torch.empty_like(state["scalars"])
    losses = torch.empty((n_epochs,), dtype=torch.float32, device=dev)
    run = state["scalars"][1:4].to(torch.float64)   # best, pcount, scale
    buf = scratch(plan, C, dev)
    ptr = lambda ts: [t.data_ptr() for t in ts]
    a = WideArgs()
    a.cells[:] = ptr([cells.x, cells.y_base, cells.z_phys, cells.tgt_y,
                      cells.tgt_z, cells.e_tgt])
    a.w[:] = ptr(W_out)
    a.m[:] = ptr(m_out)
    a.s_in = state["scalars"].data_ptr()
    a.s_out = s_out.data_ptr()
    a.losses = losses.data_ptr()
    a.g, a.sums = buf["g"].data_ptr(), buf["sums"].data_ptr()
    a.run = run.data_ptr()
    a.C, a.din, a.hidden, a.n_epochs = C, din, h, n_epochs
    a.patience, a.clamp = hyper.patience, int(hyper.clamp)
    a.lr, a.weight_decay, a.factor, a.rtol = (hyper.lr, hyper.weight_decay,
                                              hyper.factor, PLATEAU_RTOL)
    a.ds = cells.ds
    a.inv[:] = list(cells.inv)
    a.part, a.grad = buf["part"].data_ptr(), buf["grad"].data_ptr()
    a.count, a.step = buf["count"].data_ptr(), buf["step"].data_ptr()
    with torch.cuda.device(dev):
        code = library().knode_train_wide(
            ctypes.byref(a), ctypes.byref(WidePlanC(*plan)),
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on(code, "K6 wide train")
    LAUNCHES += 1
    return W_out, losses, {"moments": tuple(m_out), "scalars": s_out}


def make_wide_training_run(p: RodParams, spec: MLPSpec, cfg, n_epochs: int,
                           plain: bool = False):
    """K6's sibling of ops.train.make_fused_training_run: the same
    signature, returns and opaque ``opt_state``, for any hidden width.
    plain=True runs :func:`ops.train.train_run_reference` on any device
    (the JAX package's interpret=True)."""
    return make_run(p, spec, cfg, n_epochs,
                    train_run_reference if plain else train_run,
                    max_cells=WIDE_MAX_CELLS)
