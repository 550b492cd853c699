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
kernel (or raises); nothing falls back from one to the other. The net may
have two to MAX_LAYERS layers: two take K1's two-layer form, three or more
its layer-table form (``NetTableHost``, :func:`net_table`). A spec with
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
           "net_smem_bytes", "deep_net_bytes", "deep_smem_bytes",
           "deep_plan", "net_table", "SweepPlan", "LAUNCHES", "SMEM_BUDGET",
           "MAX_LAYERS"]

#: K3 launches made by this module's wrapper since the count was last reset
LAUNCHES = 0

_ACT_CODES = {"elu": 0, "tanh": 1, "relu": 2, "softplus": 3}
#: dynamic shared memory one block may have on the H100 (227 KB)
SMEM_BUDGET = 232_448
WARP = 32
_SWEEP_WARPS = 8      # K3 with the net: lanes (one warp each) per block
_PHYS_THREADS = 32    # K3 without it: one thread per lane
#: the deepest net the kernels take (csrc/rhs_rows.cuh::MAX_LAYERS)
MAX_LAYERS = 8
# the layer table at the head of a deep net's shared memory: MAX_LAYERS
# DeepLayer entries of 32 bytes (csrc/rhs_rows.cuh::DEEP_TABLE_BYTES)
DEEP_TABLE_BYTES = 32 * MAX_LAYERS


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


def _elem_bytes(dtype: torch.dtype) -> int:
    return 8 if dtype == torch.float64 else 4


def deep_net_bytes(dtype: torch.dtype, dims) -> int:
    """Shared memory a staged net of three layers or more takes
    (csrc/rhs_rows.cuh::deep_net_bytes): each hidden layer transposed to
    (din, dout + 1) and its bias, the output layer (25, din) and its bias,
    in ``dtype``, rounded up to 8 bytes."""
    L = len(dims) - 1
    elems = sum((din * (dout + 1) if l < L - 1 else dout * din) + dout
                for l, (din, dout) in enumerate(zip(dims[:-1], dims[1:])))
    return -(-_elem_bytes(dtype) * elems // 8) * 8


def deep_maxw(dims) -> int:
    """The widest hidden layer whose activations a lane keeps (the outputs
    of layers 0 .. L-3; the last hidden layer goes straight into the
    outputs)."""
    return max(dims[1:-2])


def deep_smem_bytes(dtype: torch.dtype, dims, groups: int,
                    staged: bool) -> int:
    """A deep net's dynamic shared memory (csrc/rhs_rows.cuh::
    deep_smem_bytes): the layer table, the staged net when ``staged``, and
    ``groups`` lanes' activation scratch of 2 x deep_maxw(dims) values."""
    return (DEEP_TABLE_BYTES
            + (deep_net_bytes(dtype, dims) if staged else 0)
            + groups * 2 * deep_maxw(dims) * _elem_bytes(dtype))


def deep_plan(dtype: torch.dtype, dims, groups: int, extra: int = 0):
    """(smem_bytes, staged) of a deep net for a kernel whose block runs
    ``groups`` lanes at once and keeps ``extra`` more bytes (K2's solver
    state): the net staged where all of it fits in SMEM_BUDGET, else read
    from global memory; raises when even the table and the scratch do not
    fit (a hidden layer too wide for a lane's scratch)."""
    for staged in (True, False):
        smem = deep_smem_bytes(dtype, dims, groups, staged)
        if smem + extra <= SMEM_BUDGET:
            return smem, staged
    raise ValueError(f"net {tuple(dims)}: its widest hidden layer does not "
                     f"fit {groups} lanes' scratch in shared memory")


def launch_plan(dtype: torch.dtype, nn_in: int, hidden,
                method: str) -> SweepPlan:
    """K3's launch shape for a net of ``nn_in`` inputs (0: no net) and
    ``hidden`` units (an int: two layers; a tuple of the hidden widths:
    three layers or more): with the net one warp per lane, 8 lanes per
    block, the net staged in shared memory where it fits in SMEM_BUDGET,
    else read from global memory (a deep net also keeps its layer table
    and each lane's activation scratch there: deep_plan); without it one
    thread per lane. It depends on nothing else (not on the batch)."""
    if method not in ("euler", "rk4"):
        raise ValueError(method)
    if nn_in == 0:
        return SweepPlan(_PHYS_THREADS, _PHYS_THREADS, 0, False)
    if not isinstance(hidden, int):
        smem, staged = deep_plan(dtype, (nn_in, *hidden, 25), _SWEEP_WARPS)
        return SweepPlan(_SWEEP_WARPS * WARP, _SWEEP_WARPS, smem, staged)
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
    """Raise unless the CUDA kernels take this net: 28 or 53 inputs, 25
    outputs, two to MAX_LAYERS layers, a supported activation."""
    if spec is None:
        return
    dims = spec.dims
    if (len(dims) < 3 or dims[0] != (53 if spec.history else 28)
            or dims[-1] != 25 or min(dims) < 1):
        raise ValueError(f"not a KNODE net: {spec}")
    if len(dims) - 1 > MAX_LAYERS:
        raise ValueError(f"{spec.dims}: the CUDA rod kernels take at most "
                         f"{MAX_LAYERS} layers")
    if spec.activation not in _ACT_CODES:
        raise ValueError(f"activation {spec.activation!r} has no kernel form")


def plan_hidden(spec: MLPSpec | None):
    """The launch plans' ``hidden`` for a net: its width (two layers) or
    the tuple of its hidden widths (three or more); 0 without a net."""
    if spec is None:
        return 0
    return spec.dims[1] if len(spec.dims) == 3 else tuple(spec.dims[1:-1])


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
    """(nn_in, act, W1, b1, W2, b2, hidden, per_rod, weights) for the C
    entry points. ``nn_params`` is one net for all rods (per_rod 0) or a
    StackedMLP with one net per rod of ``like`` (per_rod 1: rod b reads
    net b, at b times each tensor's per-net size). A net of three layers
    or more gives null W1 .. b2 and ``hidden`` the tuple of its hidden
    widths (plan_hidden); its layer table is :func:`net_table` of
    ``weights``, the checked tensors."""
    if spec is None or nn_params is None:
        return 0, 0, None, None, None, None, 0, 0, []
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
    ptrs = ([t.data_ptr() for t in ts] if len(spec.dims) == 3
            else [None] * 4)
    return (spec.dims[0], _ACT_CODES[spec.activation], *ptrs,
            plan_hidden(spec), per_rod, ts)


def net_table(spec: MLPSpec, weights, staged: bool):
    """The layer table (``_build.NetTableHost``) of a net of three layers or
    more, from its weight tensors (w, b, w, b, ...; per-net or stacked, as
    the kernel reads them), for a launch whose plan says ``staged``; None
    for a two-layer net (the C entries take it as W1 .. b2)."""
    from ._build import NetTableHost

    dims = spec.dims
    if len(dims) == 3:
        return None
    t = NetTableHost()
    t.n_layers = len(dims) - 1
    t.act = _ACT_CODES[spec.activation]
    t.staged = int(staged)
    t.maxw = deep_maxw(dims)
    for i, d in enumerate(dims):
        t.dims[i] = d
    for l in range(t.n_layers):
        t.W[l] = weights[2 * l].data_ptr()
        t.b[l] = weights[2 * l + 1].data_ptr()
    return t


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
    nn_in, act, W1, b1, W2, b2, hidden, _, ws = weight_args(spec, nn_params,
                                                            G)
    plan = launch_plan(G.dtype, nn_in, hidden, method)
    table = net_table(spec, ws, plan.staged) if nn_in else None
    with torch.cuda.device(G.device):
        code = library().knode_sweep(
            int(G.dtype == torch.float64), nn_in, act, int(method == "rk4"),
            B, N, ctypes.byref(consts), G.data_ptr(), yh.data_ptr(),
            zh.data_ptr(), tf.data_ptr(), W1, b1, W2, b2,
            hidden if table is None else 0,
            None if table is None else ctypes.byref(table),
            res.data_ptr(), y.data_ptr() if want_rod else None,
            z.data_ptr() if want_rod else None, plan.threads,
            plan.smem_bytes, int(plan.staged), stream_of(G))
    raise_on(code, "K3 sweep")
    LAUNCHES += 1
    return (res, y, z) if want_rod else res
