"""One whole coupled-assembly BDF-2 step per launch: kernel K7 and its
plain PyTorch version.

Counterpart of ``knode_cosserat_tpu/ops/pallas_assembly.py``
(``make_assembly_step_kernel``). The CUDA kernel is ``csrc/assembly.cu``;
its design note is there. Over X = [G_1..G_M, p_plate, h_plate]
(U = 6M+7), while r2 > tol, fails <= 4 and it < max_iter:

  one pass of 2U+1 lanes: lane 0 the base residual r(X), lanes 1..U the
    +h_k probes, lanes U+1..2U the -h_k probes (h_k = eps0 (1 + |X_k|));
  A[:, k] = r(X + h_k e_k) - r(X - h_k e_k)   (= J[:, k] 2 h_k)
  A_kk += lam max(|A_kk|, 2 h_k)              (LM, Marquardt scaling)
  t = A^-1 (-r) by pivoted Gauss-Jordan; dX = 2 h t; a non-finite dX
    falls back to -r
  the first alpha = 0.5^l (l < 7) with r2(X + alpha dX) < r2 is taken;
    success: lam = 0, fails = 0; stall: hold X, lam = max(30 lam, 1e-4),
    fails += 1
then a recording sweep gives y and z. No KNODE net and no contact plane.
The kernel sweeps only the (rod, lane) pairs a pass needs, one thread per
job (:func:`probe_jobs`), and closes each lane from the jobs' tips; its
launch shape is :func:`launch_plan`.

``make_assembly_step_kernel(asm, tol, max_iter)`` returns fn(X0 (U,),
yh (M,N,19), zh (M,N,6), tf (M,3), pph (3,), vph (3,), hph (4,),
wbh (3,)) -> (X (U,), y (M,N,19), z (M,N-1,6), r2 (), iters () int32):
the plain version for CPU tensors, the kernel for CUDA tensors (or it
raises). The assembly's constants go to the card once per wrapper.

A batch of B systems of the assembly (``jax.vmap`` of the JAX kernel,
which Pallas runs as a grid of B programs): every argument and result
gains a leading B (X0 (B, U) ... r2 (B,), iters (B,)), and the kernel
runs as ONE launch of B blocks, block b on system b with its own Newton
loop, so each system's outputs are, bit for bit, those of a launch of
its own. ``LAUNCHES`` counts launches, not systems. The plain version
runs the batch under per-system masks.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.assembly import (MAX_FUSED_RODS, RodAssembly, _assembly_residual,
                             _sweep_all)
from .step import _LM_GROWTH, _LM_LAMBDA0, _MAX_ESCALATIONS, fd1_eps
from . import sweep as _sweep
from .sweep import WARP, raise_on, rod_consts, stream_of

__all__ = ["make_assembly_step_kernel", "assembly_step_reference",
           "gauss_jordan", "launch_plan", "probe_jobs", "AssemblyPlan",
           "LAUNCHES"]

#: K7 launches made by this module's wrapper since the count was last reset
LAUNCHES = 0

_N_ALPHAS = 7           # alphas 0.5^0 .. 0.5^6
_ROD_JOBS = 13          # probe jobs per rod: its base sweep, 6 +h, 6 -h
_TIP = 13               # a job's tip: p (3), h (4), n (3), m (3)
_MAX_THREADS = 128
# sizeof(RodConsts<T>) / sizeof(T) in csrc/rhs_rows.cuh
_ROD_CONSTS = 76
# bytes of the kernel's own __shared__ variables (the permutation, the
# pivot board, the scalars: 404 in float64), beside the dynamic ones
_STATIC_SMEM = 512


class AssemblyPlan(NamedTuple):
    """K7's launch shape: threads per block and dynamic shared memory in
    bytes."""
    threads: int
    smem_bytes: int


def launch_plan(dtype: torch.dtype, M: int, N: int) -> AssemblyPlan:
    """K7's launch shape for M rods of N nodes: a thread per probe job
    (13M), per lane (2U+1) and per line-search job (7M), rounded up to whole
    warps; the shared memory csrc/assembly.cu::smem_count counts (the
    constants, histories, r and the U x U system in padded rows, the 13M
    jobs' tips). Raises for M outside 1..MAX_FUSED_RODS, N < 2, or a block
    the card cannot hold: the longest rod is N = 1127 / 362 / 162 / 99 at
    M = 1 / 3 / 6 / 9 in float64 and N = 2287 / 749 / 355 / 228 in
    float32."""
    if not 1 <= M <= MAX_FUSED_RODS:
        raise ValueError(f"the fused step supports 1 <= M <= "
                         f"{MAX_FUSED_RODS} rods, got {M}")
    if N < 2:
        raise ValueError(f"a rod needs N >= 2 nodes, got {N}")
    U = 6 * M + 7
    threads = -(-max(_ROD_JOBS * M, 2 * U + 1, _N_ALPHAS * M) // WARP) * WARP
    lda = -(-U // 32) * 32 + 2          # A's padded rows
    values = (M * _ROD_CONSTS + 14 + 7 * M + M * N * 25 + 3 * M + 13 + 5 * U
              + U * lda + _N_ALPHAS + 1 + _ROD_JOBS * M * _TIP)
    smem = values * (8 if dtype == torch.float64 else 4)
    if threads > _MAX_THREADS or smem + _STATIC_SMEM > _sweep.SMEM_BUDGET:
        raise ValueError(f"K7 at M={M}, N={N}: {threads} threads, {smem} B "
                         f"of shared memory exceed one block")
    return AssemblyPlan(threads, smem)


def probe_jobs(M: int):
    """The probe pass's job map, as csrc/assembly.cu runs it: (jobs, src).
    jobs[t] = (rod, unknown, sign) is job t's sweep: rod i's base reaction
    G_i, its unknown k (0..5) moved by sign * h (unknown -1, sign 0: no
    move), job 13i the base and 13i+1+k+6s the probes. src[l][j] is the job
    whose tip lane l closes for rod j: lane 0 the base residual, lanes
    1..U the +h probes of unknown l-1, lanes U+1..2U the -h probes of
    unknown l-1-U (U = 6M+7); a lane that moves one of G_j's unknowns reads
    rod j's probe, every other lane (the plate pose's too) its base."""
    U = 6 * M + 7
    jobs = []
    for i in range(M):
        jobs.append((i, -1, 0))
        jobs.extend((i, k, s) for s in (1, -1) for k in range(6))
    src = []
    for lane in range(2 * U + 1):
        minus = lane > U
        pk = lane - 1 - U if minus else lane - 1
        src.append([_ROD_JOBS * j + (1 + pk % 6 + 6 * minus
                                     if lane and 0 <= pk < 6 * M
                                     and pk // 6 == j else 0)
                     for j in range(M)])
    return jobs, src


def gauss_jordan(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A t = b (A (..., U, U), b (..., U)) as the TPU kernel's
    ``solve_tile`` does: for each pivot k the row of the largest |A_ik|
    over i >= k (ties to the lowest i) is swapped up, column k is
    eliminated from every other row, and t = b / diag(A) at the end; each
    system of a batch pivots on its own. No host synchronisation."""
    lead, U = A.shape[:-2], A.shape[-1]
    A, b = A.reshape((-1, U, U)), b.reshape((-1, U))
    sys = torch.arange(A.shape[0], device=A.device)
    rows = torch.arange(U, device=A.device).expand(A.shape[0], U)
    for k in range(U):
        p = k + torch.argmax(A[:, k:, k].abs(), dim=-1)   # the first maximum
        perm = rows.clone()
        perm[:, k] = p
        perm[sys, p] = k
        A, b = A[sys[:, None], perm], b[sys[:, None], perm]
        fac = A[:, :, k] / A[:, k, k, None]
        fac[:, k] = 0.0
        A = A - fac[:, :, None] * A[:, None, k]
        b = b - fac * b[:, k, None]
    return (b / torch.diagonal(A, dim1=-2, dim2=-1)).reshape(lead + (U,))


@torch.no_grad()
def assembly_step_reference(asm: RodAssembly, X0, yh, zh, tf, pph, vph, hph,
                            wbh, tol: float = 1e-10, max_iter: int = 50):
    """Plain PyTorch version of K7, any device: the same algorithm on the
    same lanes (module docstring), each pass one batched residual call.
    A batch (X0 (B, U), the histories with a leading B) runs every system
    under its own mask, as the kernel's blocks do: one that is done holds
    X, r2, lam and its counters while the others iterate."""
    one = X0.dim() == 1
    if one:
        X0, yh, zh, tf, pph, vph, hph, wbh = (
            t[None] for t in (X0, yh, zh, tf, pph, vph, hph, wbh))
    M, U = asm.M, 6 * asm.M + 7
    B = X0.shape[0]
    kw = dict(dtype=X0.dtype, device=X0.device)
    eps0 = fd1_eps(X0.dtype)
    res = lambda X: _assembly_residual(asm, X, yh, zh, tf, pph, vph, hph, wbh)
    eye = torch.eye(U, **kw)
    probes = torch.cat([torch.zeros((1, U), **kw), eye, -eye])  # (2U+1, U)
    alphas = (0.5 ** torch.arange(_N_ALPHAS, dtype=torch.float64)).to(**kw)
    lam0 = torch.tensor(_LM_LAMBDA0, **kw)
    sys = torch.arange(B, device=X0.device)
    X = X0
    r0 = res(X)
    r2 = (r0 * r0).sum(-1)
    lam = torch.zeros(B, **kw)
    fails = torch.zeros(B, dtype=torch.int32, device=X0.device)
    it = torch.zeros_like(fails)
    while True:
        active = (r2 > tol) & (fails <= _MAX_ESCALATIONS) & (it < max_iter)
        if not bool(active.any()):
            break
        h = eps0 * (1.0 + X.abs())                  # (B, U)
        Rt = res(X + h * probes[:, None])           # lane l: Rt[l] (B, U)
        r = Rt[0]
        A = (Rt[1:U + 1] - Rt[U + 1:]).permute(1, 2, 0)   # A[b, :, k]
        d = torch.diagonal(A, dim1=-2, dim2=-1).abs()
        A = A + torch.diag_embed(lam[:, None] * torch.maximum(d, 2.0 * h))
        dX = 2.0 * h * gauss_jordan(A, -r)
        dX = torch.where(torch.isfinite(dX).all(-1, keepdim=True), dX, -r)
        Xc = X + alphas[:, None, None] * dX         # (7, B, U)
        Rc = res(Xc)
        r2c = (Rc * Rc).sum(-1)
        improves = r2c < r2
        found = improves.any(0)
        step = active & found
        k = improves.int().argmax(0)                # the first improver
        X = torch.where(step[:, None], Xc[k, sys], X)
        r2 = torch.where(step, r2c[k, sys], r2)
        lam = torch.where(active, torch.where(
            found, 0.0, torch.maximum(lam * _LM_GROWTH, lam0)), lam)
        fails = torch.where(active, torch.where(found, 0, fails + 1), fails)
        it = it + active.int()
    y, z = _sweep_all(asm, X[..., :6 * M].unflatten(-1, (M, 6)), yh, zh, tf,
                      None, False)
    out = (X, y, z, r2, it)
    return tuple(t[0] for t in out) if one else out


def _plate_consts(asm: RodAssembly) -> np.ndarray:
    """[mass, inertia (9), g (3), c0, offsets (3M), attach quats (4M)] in
    float64, as csrc/assembly.cu reads them."""
    host = lambda t: t.detach().to("cpu", torch.float64).numpy().ravel()
    pl = asm.plate
    return np.concatenate([host(pl.mass), host(pl.inertia), host(pl.g),
                           host(asm.rods[0].c0), host(pl.attach_offsets),
                           host(pl.attach_quats)])


def make_assembly_step_kernel(asm: RodAssembly, tol: float = 1e-10,
                              max_iter: int = 50):
    """The coupled-step solver for a concrete assembly (module docstring).
    Refuses contact planes and more than MAX_FUSED_RODS rods, as the JAX
    kernel does; a net is refused by its callers (core/assembly.py)."""
    if asm.plate.has_contact:
        raise NotImplementedError(
            "fused assembly step does not support contact planes yet; "
            "use the plain path (fused=False)")
    M = asm.M
    U = 6 * M + 7
    if M > MAX_FUSED_RODS:
        raise ValueError(f"2(6M+7)+1 = {2 * U + 1} probe lanes exceed the "
                         f"128-thread block; the fused step supports M <= "
                         f"{MAX_FUSED_RODS}")
    cache = {}

    def step(X0, yh, zh, tf, pph, vph, hph, wbh):
        """(X0, yh, zh, tf, pph, vph, hph, wbh) -> (X, y, z, r2, iters),
        each with a leading B for a batch (module docstring)."""
        if X0.device.type == "cpu":
            return assembly_step_reference(asm, X0, yh, zh, tf, pph, vph, hph,
                                           wbh, tol, max_iter)
        if X0.device.type != "cuda":
            raise ValueError(f"no assembly step kernel for device {X0.device}")
        if "consts" not in cache:
            rods = np.concatenate([np.frombuffer(bytes(rod_consts(p)),
                                                 np.float64)
                                   for p in asm.rods])
            cache["consts"] = torch.from_numpy(rods).to(X0.device)
            cache["plate"] = torch.from_numpy(_plate_consts(asm)).to(
                X0.device)
        return _launch(asm, cache, tol, max_iter, X0, yh, zh, tf,
                       torch.cat([pph, vph, hph, wbh], dim=-1))

    return step


def _launch(asm, cache, tol, max_iter, X0, yh, zh, tf, ph):
    global LAUNCHES
    from ._build import library

    M, N = asm.M, asm.N
    U = 6 * M + 7
    lead = tuple(X0.shape[:-1])             # (B,) for a batch, else ()
    if len(lead) > 1 or 0 in lead:
        raise ValueError(f"X0: shape {tuple(X0.shape)}, expected (U,) or "
                         f"(B, U) with B >= 1")
    want = {"X0": (X0, (U,)), "yh": (yh, (M, N, 19)), "zh": (zh, (M, N, 6)),
            "tf": (tf, (M, 3)), "plate histories": (ph, (13,))}
    want = {k: (t, lead + shape) for k, (t, shape) in want.items()}
    if X0.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"K7 takes float32/float64, got {X0.dtype}")
    for name, (t, shape) in want.items():
        if t.device != X0.device or t.dtype != X0.dtype:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                             f"{X0.dtype} on {X0.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shape}")
    X0, yh, zh, tf, ph = (t.contiguous() for t in (X0, yh, zh, tf, ph))
    kw = dict(dtype=X0.dtype, device=X0.device)
    X = torch.empty(lead + (U,), **kw)
    y = torch.empty(lead + (M, N, 19), **kw)
    z = torch.empty(lead + (M, N - 1, 6), **kw)
    r2 = torch.empty(lead, **kw)
    iters = torch.empty(lead, dtype=torch.int32, device=X0.device)
    plan = launch_plan(X0.dtype, M, N)
    with torch.cuda.device(X0.device):
        code = library().knode_assembly(
            int(X0.dtype == torch.float64), lead[0] if lead else 1, M, N,
            cache["consts"].data_ptr(),
            cache["plate"].data_ptr(), float(tol), fd1_eps(X0.dtype),
            int(max_iter), X0.data_ptr(), yh.data_ptr(), zh.data_ptr(),
            tf.data_ptr(), ph.data_ptr(), X.data_ptr(), y.data_ptr(),
            z.data_ptr(), r2.data_ptr(), iters.data_ptr(), plan.threads,
            plan.smem_bytes, stream_of(X0))
    raise_on(code, "K7 assembly step")
    LAUNCHES += 1
    return X, y, z, r2, iters
