"""One whole BDF-2 shooting step per launch: kernel K2 and its plain
PyTorch version.

Counterpart of ``knode_cosserat_tpu/ops/pallas_step.py``
(``make_step_kernel``). The CUDA kernel is ``csrc/step.cu``; its design
note is there. Per rod: a forward-difference Jacobian from 6 probe sweeps,
a Levenberg-Marquardt term, a pivoted 6x6 elimination, a backtracking line
search that takes the first improving alpha 0.5**k, a hold-and-escalate
stall ladder, and a final recording sweep.

``make_step_kernel(p, spec, ...)`` returns fn(G (B,6), yh (B,N,19),
zh (B,N,6), tf (B,3), nn_params|None) -> (G_new (B,6), y (B,N,19),
z (B,N-1,6), r2 (B,), iters (B,) int32). ``nn_params`` is one net for all
rods or a StackedMLP of B nets, net b for rod b (the JAX package's vmap of
the step kernel over per-cell params, as the eval tables run it). A CPU
tensor runs :func:`step_reference`, a CUDA tensor launches the kernel (or
raises). A spec with a ``compute_dtype`` (mixed precision): the kernel
computes the net in the weights' dtype, as the JAX TPU kernel does (it
reads only the spec's dims and activation), while the plain version
applies the casts, as JAX's XLA path does. ``iters`` counts each rod's own Newton iterations (on the TPU it was one
count per block of rods); compare it only through its maximum.

While a profiler runs, the wrapper also counts each rod's sweeps (the
counter ``k2.sweeps``): the kernel, or :func:`step_reference` on a CPU
tensor, writes them into an int32 buffer that is made only then.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..core.params import RodParams
from ..models.mlp import MLPSpec
from ..utils.profiling import annotate, count, enabled
from . import sweep as _sweep
from .sweep import (WARP, check_inputs, check_spec, deep_plan,
                    net_smem_bytes, net_table, raise_on, rod_consts,
                    stream_of, sweep_reference, weight_args)

__all__ = ["make_step_kernel", "step_reference", "launch_plan", "StepPlan",
           "LAUNCHES"]

# Levenberg-Marquardt stall escalation: lambda starts at 1e-4, grows x30
# per consecutive failed line search, and a rod stops after 4 failures.
# The FD-Newton driver (core/fast_rollout.py) imports these so the kernel
# and the driver stay in step.
_LM_LAMBDA0 = 1e-4
_LM_GROWTH = 30.0
_MAX_ESCALATIONS = 4

#: K2 launches made by this module's wrapper since the count was last reset
LAUNCHES = 0

_LANES = 7          # lanes per rod: the 6 probes, or a tile of candidates
_PHYS_RODS = 4      # rods per block without the net (one thread per lane)
# sizeof(RodState<T>) in csrc/step.cu: one rod's solver in shared memory
_STATE_BYTES = {torch.float32: 1264, torch.float64: 2504}


class StepPlan(NamedTuple):
    """K2's launch shape: threads per block, rods per block, dynamic shared
    memory in bytes, and whether the net is staged there."""
    threads: int
    rods_per_block: int
    smem_bytes: int
    staged: bool


def launch_plan(dtype: torch.dtype, nn_in: int, hidden,
                method: str) -> StepPlan:
    """K2's launch shape for a net of ``nn_in`` inputs (0: no net) and
    ``hidden`` units (an int: two layers; a tuple of the hidden widths:
    three or more). With the net: one block per rod, one warp per lane
    (7 lanes; a phase of one lane runs on the whole block), the rod's net
    staged in shared memory beside its solver state where both fit in
    ops/sweep.py's SMEM_BUDGET, else the net read from global memory (a
    deep net also keeps its layer table and each lane's activation
    scratch there: ops/sweep.py::deep_plan). Without it: ``_PHYS_RODS``
    rods per block, one thread per lane. It depends on nothing else (not
    on the batch, nor on one net or one per rod)."""
    if method not in ("euler", "rk4"):
        raise ValueError(method)
    state = _STATE_BYTES[dtype]
    if nn_in == 0:
        return StepPlan(_LANES * _PHYS_RODS, _PHYS_RODS, _PHYS_RODS * state,
                        False)
    if not isinstance(hidden, int):
        smem, staged = deep_plan(dtype, (nn_in, *hidden, 25), _LANES, state)
        return StepPlan(_LANES * WARP, 1, smem + state, staged)
    w = net_smem_bytes(dtype, nn_in, hidden)
    staged = w + state <= _sweep.SMEM_BUDGET
    return StepPlan(_LANES * WARP, 1, state + (w if staged else 0), staged)


def fd1_eps(dtype: torch.dtype) -> float:
    """Forward-difference probe step (times 1 + |G_k|)."""
    return 1e-8 if dtype == torch.float64 else 3e-4


@torch.no_grad()
def step_reference(p: RodParams, G, yh, zh, tf, nn_params=None,
                   tol: float = 1e-10,
                   max_iter: int = 30, n_alphas: int = 7,
                   method: str = "euler", sweeps=None):
    """Plain PyTorch version of K2, any device: the FD-Newton driver of
    core/fast_rollout.py over :func:`sweep_reference`, with forward
    differences and a Jacobian refreshed every iteration (K2's semantics).
    ``nn_params``: None, one net, or a StackedMLP (net b for rod b; the
    probe and candidate lanes of the FD-Newton loop are grouped by rod).
    ``sweeps``: None, or an int32 (B,) tensor that receives each rod's
    sweep count as the kernel counts it (the line search's candidates as
    the kernel runs them: alpha = 1 alone, then tiles of up to 7).
    Like the kernel, it records no autograd graph."""
    from ..core.fast_rollout import fd_newton

    k_res = lambda Gx, a, b, c, nn: sweep_reference(p, Gx, a, b, c, nn,
                                                    method, want_rod=False)
    if sweeps is not None:
        sweeps.zero_()
    G_new, r2, iters = fd_newton(k_res, G, yh, zh, tf, nn_params, tol=tol,
                                 max_iter=max_iter, n_alphas=n_alphas,
                                 jacobian_refresh=1, fd_order=1,
                                 sweeps=sweeps)
    _, y, z = sweep_reference(p, G_new, yh, zh, tf, nn_params, method)
    if sweeps is not None:
        sweeps += 1
    return G_new, y, z, r2, iters


def make_step_kernel(p: RodParams, spec: MLPSpec | None = None,
                     tol: float = 1e-10, max_iter: int = 30,
                     n_alphas: int = 7, method: str = "euler"):
    """The whole Newton shooting step for a concrete rod (+ optional KNODE
    net). See the module docstring for the returned function."""
    if method not in ("euler", "rk4"):
        raise ValueError(method)
    cache = {}

    def fn(G, yh, zh, tf, nn_params=None):
        sweeps = (torch.empty(G.shape[0], dtype=torch.int32, device=G.device)
                  if enabled() else None)
        with annotate("k2.launch"):
            out = launch(G, yh, zh, tf, nn_params, sweeps)
        count("k2.newton_iters", out[4])
        count("k2.rod_steps", G.shape[0])
        if sweeps is not None:
            count("k2.sweeps", sweeps)
        return out

    def launch(G, yh, zh, tf, nn_params, sweeps):
        nn_params = nn_params if spec is not None else None
        if G.device.type == "cpu":
            return step_reference(p, G, yh, zh, tf, nn_params, tol, max_iter,
                                  n_alphas, method, sweeps)
        if G.device.type != "cuda":
            raise ValueError(f"no step kernel for device {G.device}")
        if "consts" not in cache:
            check_spec(spec)
            cache["consts"] = rod_consts(p)
        return _launch(p, cache["consts"], spec, tol, max_iter, n_alphas,
                       method, G, yh, zh, tf, nn_params, sweeps)

    return fn


def _launch(p, consts, spec, tol, max_iter, n_alphas, method, G, yh, zh, tf,
            nn_params, sweeps=None):
    global LAUNCHES
    from ._build import library

    check_inputs(p, G, yh, zh, tf)
    B, N = G.shape[0], p.N
    kw = dict(dtype=G.dtype, device=G.device)
    G_out = torch.empty((B, 6), **kw)
    y = torch.empty((B, N, 19), **kw)
    z = torch.empty((B, N - 1, 6), **kw)
    r2 = torch.empty((B,), **kw)
    iters = torch.empty((B,), dtype=torch.int32, device=G.device)
    if B == 0:
        return G_out, y, z, r2, iters
    nn_in, act, W1, b1, W2, b2, hidden, per_rod, ws = weight_args(
        spec, nn_params, G)
    plan = launch_plan(G.dtype, nn_in, hidden, method)
    table = net_table(spec, ws, plan.staged) if nn_in else None
    with torch.cuda.device(G.device):
        code = library().knode_step(
            int(G.dtype == torch.float64), nn_in, act, int(method == "rk4"),
            B, N, ctypes.byref(consts), float(tol), fd1_eps(G.dtype),
            int(max_iter), int(n_alphas), _LM_LAMBDA0, _LM_GROWTH,
            _MAX_ESCALATIONS, G.data_ptr(), yh.data_ptr(), zh.data_ptr(),
            tf.data_ptr(), W1, b1, W2, b2, hidden if table is None else 0,
            None if table is None else ctypes.byref(table), per_rod,
            G_out.data_ptr(),
            y.data_ptr(), z.data_ptr(), r2.data_ptr(), iters.data_ptr(),
            None if sweeps is None else sweeps.data_ptr(), plan.threads,
            plan.smem_bytes, int(plan.staged), stream_of(G))
    raise_on(code, "K2 step")
    LAUNCHES += 1
    return G_out, y, z, r2, iters
