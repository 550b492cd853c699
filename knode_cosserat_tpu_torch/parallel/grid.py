"""Experiment-grid training: the (data x mod x seed) sweep, every cell at
once.

PyTorch counterpart of ``knode_cosserat_tpu/parallel/grid.py`` (the
reference orchestrator physics_multitrain.py:85-157 fanned out one
``physics_train.py`` process per cell). Every cell has its own rod (the
mods are RodParams of the same structure), its data and its seed's net.
On a CUDA rod the whole grid trains in one launch of kernel K5 per chunk
(ops/train.py:train_grid_run, one cluster per cell); ``cfg.fused="off"``
runs the plain epoch loop cell by cell. Under a mesh (parallel/mesh.py)
the grid axis splits over "data": each rank trains its cells (K5 on its
card, ops/train.py:make_sharded_grid_training_run, or the plain loop) and
the results are gathered, so every rank returns the whole grid.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.params import RodParams, apply_mod
from ..models.mlp import KnodeMLP, MLPSpec, StackedMLP, init_mlp
from ..training.data import make_training_data, parse_traj_specs
from ..training.train import (TrainConfig, _resolve_fused, make_epoch_scan,
                              make_optimizer)
from .mesh import P, Placement, data_sharding

__all__ = ["GridCell", "GridResult", "grid_train", "build_grid"]


@dataclasses.dataclass(frozen=True)
class GridCell:
    data: str            # trajectory spec string, e.g. "sine sine 0.5 1.0"
    mod: Optional[str]   # parameter perturbation
    seed: int


@dataclasses.dataclass
class GridResult:
    cells: List[GridCell]
    params: List[KnodeMLP]       # per-cell nets
    loss_history: np.ndarray     # (epochs, n_cells)
    spec: MLPSpec
    # wall seconds of the training alone (data made, the device
    # synchronised at both ends), summed over the sub-grids
    train_seconds: float = 0.0


def build_grid(datas: Sequence[str], mods: Sequence[Optional[str]],
               n_seeds: int) -> List[GridCell]:
    """Grid enumeration order matching physics_multitrain.py:144-150."""
    return [GridCell(d, m, s)
            for d in datas for m in mods for s in range(n_seeds)]


def init_cell_net(spec: MLPSpec, seed: int, dtype, device) -> KnodeMLP:
    """The net a cell starts from: init_mlp drawn from its seed."""
    return init_mlp(spec, torch.Generator().manual_seed(seed), dtype, device)


def grid_train(
    cells: Sequence[GridCell],
    cfg: TrainConfig,
    reference_rod: Optional[RodParams] = None,
    train_len: int = 30,
    mesh=None,
    original: bool = False,
    log=None,
) -> GridResult:
    """Train every grid cell, on the reference rod's device (the card by
    default).

    The data of each unique data spec are made once, on the reference rod.
    Cells whose data have different trajectory counts train as separate
    sub-grids, merged back in cell order. ``cfg.fused`` as train_knode
    reads it ("auto" takes K5 on a CUDA rod); with no ``log`` the whole run
    is one chunk, else chunks of ``cfg.log_every`` epochs, the optimizer
    state carried between them. mesh: a parallel.mesh.Mesh; the grid axis
    is padded to a multiple of its "data" axis by repeating the last cell,
    each rank trains its share, and the padded cells are dropped from the
    gathered result (the JAX package's pad and drop). Every cell equals the
    unsharded grid's."""
    if reference_rod is None:
        reference_rod = apply_mod(None, original=original)
    data_cache = {}
    for d in sorted({c.data for c in cells}):
        data_cache[d] = make_training_data(
            reference_rod, parse_traj_specs(d.split(" ")), train_len=train_len)
    return _train(list(cells), cfg, reference_rod, data_cache, original, log,
                  mesh)


def _train(cells, cfg, reference_rod, data_cache, original, log, mesh):
    # cells whose data have different trajectory counts cannot share one
    # launch: split into same-shape sub-grids and merge in cell order
    n_traj_of = {d: v[0].shape[0] for d, v in data_cache.items()}
    counts = sorted({n_traj_of[c.data] for c in cells})
    if len(counts) > 1:
        results, secs = {}, 0.0
        for n in counts:
            sub = [c for c in cells if n_traj_of[c.data] == n]
            r = _train(sub, cfg, reference_rod, data_cache, original, log,
                       mesh)
            secs += r.train_seconds
            for c, pr, lh in zip(r.cells, r.params, r.loss_history.T):
                results[c] = (pr, lh)
        return GridResult(cells=cells, params=[results[c][0] for c in cells],
                          loss_history=np.stack([results[c][1]
                                                 for c in cells], axis=1),
                          spec=r.spec, train_seconds=secs)

    dtype = getattr(torch, cfg.dtype)
    dev = reference_rod.device
    spec = cfg.spec()
    G = len(cells)
    # under a mesh the grid axis pads to a multiple of "data" (the padded
    # cells repeat the last one and are dropped at the end)
    run_cells = cells + cells[-1:] * (
        (-G) % mesh.shape["data"] if mesh is not None else 0)
    rods = [apply_mod(c.mod, original=original, N=reference_rod.N,
                      dtype=reference_rod.dtype, device=dev)
            for c in run_cells]
    trajs = torch.stack([data_cache[c.data][0].to(dtype) for c in run_cells])
    ctls = torch.stack([data_cache[c.data][1].to(dtype) for c in run_cells])
    nets = [init_cell_net(spec, c.seed, dtype, dev) for c in run_cells]

    n_cells_model = int(trajs.shape[1] * (trajs.shape[2] - 1)
                        * len(cfg.keypoints))
    mode = _resolve_fused(cfg, spec, n_cells_model, dev)
    if mode in ("wide", "wide_plain"):
        if cfg.fused != "auto":
            raise ValueError(f"cfg.fused={cfg.fused!r}: grid_train has no "
                             "wide grid kernel")
        mode = None
    losses: list = []
    done = 0
    sync = ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    if mode:
        from ..ops.train import (make_fused_grid_training_run,
                                 make_sharded_grid_training_run)
        chunk = (cfg.epochs if log is None
                 else max(1, min(cfg.log_every, cfg.epochs)))
        if mesh is not None:
            make = lambda n: make_sharded_grid_training_run(
                spec, cfg, n, mesh, plain=mode == "plain")
        else:
            make = lambda n: make_fused_grid_training_run(
                spec, cfg, n, plain=mode == "plain")
        run_chunk = make(chunk)
        params, state = StackedMLP(nets), None
        while done < cfg.epochs:
            n = min(chunk, cfg.epochs - done)
            runner = run_chunk if n == chunk else make(n)
            params, ls, state = runner(rods, params, trajs, ctls, state)
            losses.extend(ls[:G].T.cpu().numpy())      # n rows of (G,)
            done += n
            if log:
                log(f"epoch {done - 1} losses {losses[-1]}")
        nets = params.unstack()[:G]
    else:
        # the plain epoch loop over this rank's cells (all of them without
        # a mesh), gathered over "data" after each chunk
        span = range(len(run_cells))
        if mesh is not None:
            grid = data_sharding(mesh)
            span = span[grid.span(len(span))]
        opts = {g: make_optimizer(cfg, nets[g]) for g in span}
        chunk = max(1, min(cfg.log_every, cfg.epochs))
        while done < cfg.epochs:
            n = min(chunk, cfg.epochs - done)
            ls = torch.stack([make_epoch_scan(
                rods[g], spec, opts[g], cfg.keypoints, cfg.clamp_weights, n)(
                    nets[g], trajs[g], ctls[g]) for g in span], dim=1)
            if mesh is not None:
                ls = Placement(mesh, P(None, "data")).gather(ls.detach())
            losses.extend(ls[:, :G].detach().cpu().numpy())
            done += n
            if log:
                log(f"epoch {done - 1} losses {losses[-1]}")
        if mesh is not None:
            mine, whole = StackedMLP([nets[g] for g in span]), StackedMLP(nets)
            with torch.no_grad():
                for W, w in zip(whole.parameters(), mine.parameters()):
                    W.copy_(grid.gather(w.detach()))
            nets = whole.unstack()
        nets = nets[:G]
    sync()
    return GridResult(cells=cells, params=nets,
                      loss_history=np.asarray(losses), spec=spec,
                      train_seconds=time.perf_counter() - t0)
