"""The teacher-forced next segment over flat cells: kernel K8 and its plain
PyTorch version.

Counterpart of ``knode_cosserat_tpu/ops/pallas_rhs.py``
(``make_fused_next_segment``). The CUDA kernel is ``csrc/next_segment.cu``
(one warp per cell over K1's cooperative body, the net staged once per
block where it fits; its launch shape is :func:`launch_plan`); its design
note is there.

``make_fused_next_segment(p, spec)`` returns fn(net, y (B,19), yh (B,19),
zh (B,6), tf (B,3)) -> (y + ds * rhs(y, yh, zh, tf), z), the
``core/spatial.next_segment_euler`` of the flat cells. It is a
``torch.autograd.Function`` whose forward pass is K8 on CUDA tensors (the
plain version on CPU tensors; any other device raises) and whose backward
pass is autograd of the plain version recomputed on the saved inputs, as
the JAX op's custom VJP takes the pure version's VJP. The net's weight
tensors are inputs of the Function, so an optimizer holding them sees
their gradients.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..core.params import RodParams
from ..core.spatial import next_segment_euler
from ..models.mlp import ACTIVATIONS, MLPSpec
from . import sweep as _sweep
from .sweep import (_ACT_CODES, WARP, check_spec, deep_plan, net_smem_bytes,
                    net_table, plan_hidden, raise_on, rod_consts, stream_of)

__all__ = ["make_fused_next_segment", "next_segment_reference", "launch_plan",
           "SegmentPlan", "LAUNCHES"]

#: K8 launches made by this module's wrapper since the count was last reset
LAUNCHES = 0

_MAX_WARPS = 8      # cells (one warp each) a block runs at once
_SMS = 132          # the H100 SXM's streaming multiprocessors


class SegmentPlan(NamedTuple):
    """K8's launch shape: threads per block (a warp per cell), blocks,
    dynamic shared memory in bytes, and whether the net is staged there."""
    threads: int
    blocks: int
    smem_bytes: int
    staged: bool


def launch_plan(dtype: torch.dtype, nn_in: int, hidden,
                B: int) -> SegmentPlan:
    """K8's launch shape for B cells and a net of ``nn_in`` inputs and
    ``hidden`` units (an int: two layers; a tuple of the hidden widths:
    three or more): a warp per cell, 8 cells a block (fewer only when B
    is), at most 132 blocks (one per SM; each warp then takes every
    (8 blocks)-th cell), so that each block's staging of the net serves as
    many cells as it can (on the H100, 232 cells: 0.0118 ms in 29 blocks,
    0.0179 in 116, PERF.md); the net staged in shared memory where it
    fits in ops/sweep.py's SMEM_BUDGET, else read from global memory (a
    deep net also keeps its layer table and each warp's activation
    scratch there: ops/sweep.py::deep_plan). A cell's result does not
    depend on the plan."""
    if B < 1:
        raise ValueError(f"K8 needs at least one cell, got {B}")
    C = min(_MAX_WARPS, B)
    if not isinstance(hidden, int):
        smem, staged = deep_plan(dtype, (nn_in, *hidden, 25), C)
        return SegmentPlan(C * WARP, min(_SMS, -(-B // C)), smem, staged)
    w = net_smem_bytes(dtype, nn_in, hidden)
    staged = w <= _sweep.SMEM_BUDGET
    return SegmentPlan(C * WARP, min(_SMS, -(-B // C)), w if staged else 0,
                       staged)


def _net_fn(spec: MLPSpec, weights):
    """The net of ``spec`` with explicit (w, b, w, b, ...) tensors."""
    act = ACTIVATIONS[spec.activation]
    n = len(weights) // 2

    def fn(x):
        for i in range(n):
            x = F.linear(x, weights[2 * i], weights[2 * i + 1])
            if i < n - 1:
                x = act(x)
        return x

    return fn


def next_segment_reference(p: RodParams, spec: MLPSpec, y, yh, zh, tf,
                           *weights):
    """Plain PyTorch version of K8, any device: next_segment_euler on the
    flat cells, the net given by its weight tensors (w, b, w, b, ...)."""
    return next_segment_euler(p, y, yh, zh, tf, nn_fn=_net_fn(spec, weights),
                              nn_history=spec.history)


class _NextSegment(torch.autograd.Function):
    @staticmethod
    def forward(ctx, forward_fn, p, spec, y, yh, zh, tf, *weights):
        ctx.p, ctx.spec = p, spec
        ctx.save_for_backward(y, yh, zh, tf, *weights)
        return forward_fn(y, yh, zh, tf, weights)

    @staticmethod
    def backward(ctx, g_y, g_z):
        ins = [t.detach().requires_grad_(need) for t, need in
               zip(ctx.saved_tensors, ctx.needs_input_grad[3:])]
        wanted = [t for t in ins if t.requires_grad]
        grads = iter(())
        if wanted:
            with torch.enable_grad():
                out = next_segment_reference(ctx.p, ctx.spec, *ins)
                grads = iter(torch.autograd.grad(out, wanted, (g_y, g_z),
                                                 allow_unused=True))
        return (None, None, None) + tuple(
            next(grads) if t.requires_grad else None for t in ins)


def make_fused_next_segment(p: RodParams, spec: MLPSpec):
    """The next-segment op for a concrete rod and net architecture (module
    docstring). On the card it takes the nets K1 takes (ops/sweep.py::
    check_spec): 28 or 53 inputs, 25 outputs, two to eight layers, elu /
    tanh / relu / softplus."""
    cache = {}

    def forward_fn(y, yh, zh, tf, weights):
        if y.device.type == "cpu":
            with torch.no_grad():
                return next_segment_reference(p, spec, y, yh, zh, tf,
                                              *weights)
        if y.device.type != "cuda":
            raise ValueError(f"no next-segment kernel for device {y.device}")
        if "consts" not in cache:
            check_spec(spec)
            cache["consts"] = rod_consts(p)
        return _launch(cache["consts"], spec, y, yh, zh, tf, weights)

    def fn(net, y, yh, zh, tf):
        return _NextSegment.apply(forward_fn, p, spec, y, yh, zh, tf,
                                  *[t for wb in net.weights() for t in wb])

    return fn


def _launch(consts, spec, y, yh, zh, tf, weights):
    global LAUNCHES
    from ._build import library

    B = y.shape[0]
    want = {"y": (y, (B, 19)), "yh": (yh, (B, 19)), "zh": (zh, (B, 6)),
            "tf": (tf, (B, 3))}
    want.update({f"weight {i}": (w, tuple(w.shape))
                 for i, w in enumerate(weights)})
    if y.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"K8 takes float32/float64, got {y.dtype}")
    for name, (t, shape) in want.items():
        if t.device != y.device or t.dtype != y.dtype:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                             f"{y.dtype} on {y.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shape}")
    y, yh, zh, tf = (t.detach().contiguous() for t in (y, yh, zh, tf))
    ws = [w.detach().contiguous() for w in weights]
    yg = torch.empty_like(y)
    z = torch.empty((B, 6), dtype=y.dtype, device=y.device)
    if B == 0:
        return yg, z
    plan = launch_plan(y.dtype, spec.dims[0], plan_hidden(spec), B)
    table = net_table(spec, ws, plan.staged)
    two = table is None
    with torch.cuda.device(y.device):
        code = library().knode_next_segment(
            int(y.dtype == torch.float64), spec.dims[0],
            _ACT_CODES[spec.activation], B, ctypes.byref(consts),
            *((w.data_ptr() for w in ws) if two else (None,) * 4),
            spec.dims[1] if two else 0,
            None if two else ctypes.byref(table), y.data_ptr(),
            yh.data_ptr(), zh.data_ptr(), tf.data_ptr(), yg.data_ptr(),
            z.data_ptr(), plan.threads, plan.blocks, plan.smem_bytes,
            int(plan.staged), stream_of(y))
    raise_on(code, "K8 next segment")
    LAUNCHES += 1
    return yg, z
