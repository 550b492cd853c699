"""The base-to-tip spatial sweep: kernel K3 (with K1 inlined) and its plain
PyTorch version.

Counterpart of ``knode_cosserat_tpu/ops/pallas_sweep.py``
(``make_sweep_kernel``, with the per-node body ``make_rhs_rows``). The
CUDA kernel is ``csrc/sweep.cu`` (K3) over ``csrc/rhs_rows.cuh`` (K1); its
design note is in those files.

``make_sweep_kernel(p, spec, method, want_rod)`` returns
fn(G (B,6), yh (B,N,19), zh (B,N,6), tf (B,3), nn_params|None) ->
res (B,6) [, y (B,N,19), z (B,N-1,6)]. The device of ``G`` picks the
path: a CPU tensor runs :func:`sweep_reference`, a CUDA tensor launches the
kernel (or raises); nothing falls back from one to the other. A spec with
a ``compute_dtype`` (mixed precision): the kernel computes the net in the
weights' dtype, as the JAX TPU kernel does, while the plain version applies
the casts, as JAX's XLA path does.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..core.params import RodParams
from ..core.spatial import integrate_euler, integrate_rk4, tip_residual
from ..models.mlp import KnodeMLP, MLPSpec, StackedMLP

__all__ = ["make_sweep_kernel", "sweep_reference", "launch_plan",
           "net_smem_bytes", "SweepPlan", "LAUNCHES", "SMEM_BUDGET"]

#: K3 launches made by this module's wrapper since the count was last reset
LAUNCHES = 0

_ACT_CODES = {"elu": 0, "tanh": 1, "relu": 2, "softplus": 3}
#: dynamic shared memory one block may have on the H100 (227 KB)
SMEM_BUDGET = 232_448
WARP = 32
_SWEEP_WARPS = 8      # K3 with the net: lanes (one warp each) per block
_PHYS_THREADS = 32    # K3 without it: one thread per lane


class SweepPlan(NamedTuple):
    """K3's launch shape: threads per block, lanes per block, dynamic
    shared memory in bytes, and whether the net is staged there."""
    threads: int
    lanes: int
    smem_bytes: int
    staged: bool


def net_smem_bytes(dtype: torch.dtype, nn_in: int, hidden: int) -> int:
    """Shared memory a staged net takes (csrc/rhs_rows.cuh::net_smem_bytes):
    W1 transposed to (nn_in, hidden + 1), b1, W2 (25, hidden), b2, in
    ``dtype``, rounded up to 8 bytes."""
    size = 8 if dtype == torch.float64 else 4
    elems = nn_in * (hidden + 1) + 26 * hidden + 25
    return -(-size * elems // 8) * 8


def launch_plan(dtype: torch.dtype, nn_in: int, hidden: int,
                method: str) -> SweepPlan:
    """K3's launch shape for a net of ``nn_in`` inputs (0: no net) and
    ``hidden`` units: with the net one warp per lane, 8 lanes per block, the
    net staged in shared memory where it fits in SMEM_BUDGET, else read
    from global memory; without it one thread per lane. It depends on
    nothing else (not on the batch)."""
    if method not in ("euler", "rk4"):
        raise ValueError(method)
    if nn_in == 0:
        return SweepPlan(_PHYS_THREADS, _PHYS_THREADS, 0, False)
    w = net_smem_bytes(dtype, nn_in, hidden)
    staged = w <= SMEM_BUDGET
    return SweepPlan(_SWEEP_WARPS * WARP, _SWEEP_WARPS, w if staged else 0,
                     staged)


def sweep_reference(p: RodParams, G, yh, zh, tf, nn_params: KnodeMLP | None = None,
                    method: str = "euler", want_rod: bool = True):
    """Plain PyTorch version of the K3 sweep, any device: the batched
    ``integrate_euler`` / ``integrate_rk4`` (RK4 history midpoints are the
    linear interpolations 0.5*(yh_j + yh_j+1))."""
    nn_fn = nn_params
    history = nn_params.spec.history if nn_params is not None else False
    if method == "euler":
        y, z = integrate_euler(p, G, yh, zh, tf, nn_fn, history)
    elif method == "rk4":
        y, z = integrate_rk4(p, G, yh, zh, 0.5 * (yh[:, :-1] + yh[:, 1:]),
                             0.5 * (zh[:, :-1] + zh[:, 1:]), tf, nn_fn,
                             history)
    else:
        raise ValueError(method)
    r = tip_residual(p, y)
    return (r, y, z) if want_rod else r


def rod_consts(p: RodParams) -> "ctypes.Structure":
    """The rod's constants for the kernels' ``RodConstsHost`` (float64;
    reads the rod to the host once)."""
    from ._build import RodConstsHost

    c = RodConstsHost()
    host = lambda t: np.asarray(t.detach().to("cpu", torch.float64).numpy(),
                                np.float64).ravel()
    for field, leaf in (("Kse_inv", p.Kse_c0Bse_inv),
                        ("Kbt_inv", p.Kbt_c0Bbt_inv), ("Bse", p.Bse),
                        ("Bbt", p.Bbt), ("rhoJ", p.rhoJ),
                        ("v_rest", p.v_rest), ("rhoAg", p.rhoAg), ("C", p.C),
                        ("p0", p.p0), ("h0", p.h0), ("q0", p.q0),
                        ("w0", p.w0), ("F_tip", p.F_tip),
                        ("M_tip", p.M_tip)):
        getattr(c, field)[:] = host(leaf).tolist()
    c.c0, c.rhoA, c.ds = (float(host(x)[0]) for x in (p.c0, p.rhoA, p.ds))
    return c


def check_spec(spec: MLPSpec | None):
    """Raise unless the CUDA kernels take this net: two layers, 28 or 53
    inputs, 25 outputs, a supported activation."""
    if spec is None:
        return
    if len(spec.dims) != 3:
        raise NotImplementedError(
            f"the CUDA rod kernels take 2-layer KNODE nets; {spec.dims} has "
            f"{len(spec.dims) - 1} (ROADMAP: deeper nets on CUDA)")
    if spec.dims[0] != (53 if spec.history else 28) or spec.dims[2] != 25:
        raise ValueError(f"not a KNODE net: {spec}")
    if spec.activation not in _ACT_CODES:
        raise ValueError(f"activation {spec.activation!r} has no kernel form")


def check_inputs(p: RodParams, G, yh, zh, tf):
    """Device, dtype, shape and contiguity checks shared by K2 and K3."""
    B, N = G.shape[0], p.N
    want = {"G": (G, (B, 6)), "yh": (yh, (B, N, 19)), "zh": (zh, (B, N, 6)),
            "tf": (tf, (B, 3))}
    if G.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernels take float32/float64, got {G.dtype}")
    for name, (t, shape) in want.items():
        if t.device != G.device or t.dtype != G.dtype:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                             f"{G.dtype} on {G.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def weight_args(spec: MLPSpec | None, nn_params, like):
    """(nn_in, act, W1, b1, W2, b2, hidden, per_rod) for the C entry points.
    ``nn_params`` is one net for all rods (per_rod 0) or a StackedMLP with
    one net per rod of ``like`` (per_rod 1: rod b reads net b, at b times
    each tensor's per-net size)."""
    if spec is None or nn_params is None:
        return 0, 0, None, None, None, None, 0, 0
    per_rod = int(isinstance(nn_params, StackedMLP))
    if per_rod and len(nn_params) != like.shape[0]:
        raise ValueError(f"{len(nn_params)} stacked nets for "
                         f"{like.shape[0]} rods")
    ts = [t for wb in nn_params.weights() for t in wb]
    for t in ts:
        if t.device != like.device or t.dtype != like.dtype:
            raise ValueError(f"MLP weights: {t.dtype} on {t.device}, expected "
                             f"{like.dtype} on {like.device}")
        if not t.is_contiguous():
            raise ValueError("MLP weights must be contiguous")
    return (spec.dims[0], _ACT_CODES[spec.activation],
            *(t.data_ptr() for t in ts), spec.dims[1], per_rod)


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def raise_on(code: int, what: str):
    if code != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {code}")


def make_sweep_kernel(p: RodParams, spec: MLPSpec | None = None,
                      method: str = "euler", want_rod: bool = True):
    """The sweep for a concrete rod (+ optional KNODE net): fn(G, yh, zh,
    tf, nn_params=None) -> res (B,6) [, y (B,N,19), z (B,N-1,6)].

    method: "euler" (reference parity, cosserat_ode.py:197-201) or "rk4"
    (cosserat_ode.py:222-242 with linear history midpoints)."""
    if method not in ("euler", "rk4"):
        raise ValueError(method)
    cache = {}

    def fn(G, yh, zh, tf, nn_params=None):
        nn_params = nn_params if spec is not None else None
        if isinstance(nn_params, StackedMLP):
            raise NotImplementedError("K3 takes one net for all lanes; "
                                      "stacked nets run on K2 (ops/step.py)")
        if G.device.type == "cpu":
            return sweep_reference(p, G, yh, zh, tf, nn_params, method,
                                   want_rod)
        if G.device.type != "cuda":
            raise ValueError(f"no sweep for device {G.device}")
        if "consts" not in cache:
            check_spec(spec)
            cache["consts"] = rod_consts(p)
        return _launch(p, cache["consts"], spec, method, want_rod, G, yh, zh,
                       tf, nn_params)

    return fn


def _launch(p, consts, spec, method, want_rod, G, yh, zh, tf, nn_params):
    global LAUNCHES
    from ._build import library

    check_inputs(p, G, yh, zh, tf)
    B, N = G.shape[0], p.N
    res = torch.empty((B, 6), dtype=G.dtype, device=G.device)
    y = z = None
    if want_rod:
        y = torch.empty((B, N, 19), dtype=G.dtype, device=G.device)
        z = torch.empty((B, N - 1, 6), dtype=G.dtype, device=G.device)
    if B == 0:
        return (res, y, z) if want_rod else res
    nn_in, act, W1, b1, W2, b2, hidden, _ = weight_args(spec, nn_params, G)
    plan = launch_plan(G.dtype, nn_in, hidden, method)
    with torch.cuda.device(G.device):
        code = library().knode_sweep(
            int(G.dtype == torch.float64), nn_in, act, int(method == "rk4"),
            B, N, ctypes.byref(consts), G.data_ptr(), yh.data_ptr(),
            zh.data_ptr(), tf.data_ptr(), W1, b1, W2, b2, hidden,
            res.data_ptr(), y.data_ptr() if want_rod else None,
            z.data_ptr() if want_rod else None, plan.threads,
            plan.smem_bytes, int(plan.staged), stream_of(G))
    raise_on(code, "K3 sweep")
    LAUNCHES += 1
    return (res, y, z) if want_rod else res
