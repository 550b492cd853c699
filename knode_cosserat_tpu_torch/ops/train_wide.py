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
width.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.params import RodParams
from ..models.mlp import MLPSpec
from .train import (Cells, TrainHyper, check_run_args, make_run,
                    train_run_reference)

__all__ = ["make_wide_training_run", "wide_trainer_supported", "train_run",
           "WIDE_MAX_CELLS", "LAUNCHES"]

WIDE_MAX_CELLS = 4096

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
    """K6: ``n_epochs`` epochs in one call (three launches per epoch on the
    current stream). Same arguments and returns as
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
    from ._build import WideArgs, library

    dev = cells.x.device
    C, din, h = check_run_args(cells, W, state, n_epochs, (), 2 ** 31 - 1,
                               WIDE_MAX_CELLS, "K6")

    # the kernels update weights and moments in place: on copies
    W_out = [t.clone() for t in W]
    m_out = [t.clone() for t in state["moments"]]
    s_out = torch.empty_like(state["scalars"])
    losses = torch.empty((n_epochs,), dtype=torch.float32, device=dev)
    g = torch.empty((C, 25), dtype=torch.float32, device=dev)
    cell_loss = torch.empty((C,), dtype=torch.float32, device=dev)
    run = state["scalars"][1:4].to(torch.float64)   # best, pcount, scale
    ptr = lambda ts: [t.data_ptr() for t in ts]
    a = WideArgs()
    a.cells[:] = ptr([cells.x, cells.y_base, cells.z_phys, cells.tgt_y,
                      cells.tgt_z, cells.e_tgt])
    a.w[:] = ptr(W_out)
    a.m[:] = ptr(m_out)
    a.s_in = state["scalars"].data_ptr()
    a.s_out = s_out.data_ptr()
    a.losses = losses.data_ptr()
    a.g, a.cell_loss = g.data_ptr(), cell_loss.data_ptr()
    a.run = run.data_ptr()
    a.C, a.din, a.hidden, a.n_epochs = C, din, h, n_epochs
    a.patience, a.clamp = hyper.patience, int(hyper.clamp)
    a.lr, a.weight_decay, a.factor, a.rtol = (hyper.lr, hyper.weight_decay,
                                              hyper.factor, PLATEAU_RTOL)
    a.ds = cells.ds
    a.inv[:] = list(cells.inv)
    with torch.cuda.device(dev):
        code = library().knode_train_wide(
            ctypes.byref(a), torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        raise RuntimeError(f"K6 wide train launch failed: CUDA error {code}")
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
