"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

``library()`` compiles each ``.cu`` file under ``csrc/`` with its own
``nvcc`` process for Hopper (``sm_90a``), all started together, into one
shared library per source with a plain C interface, and loads them with
``ctypes``. The libraries live in ``build/torch_kernels/<hash>/`` at the
root of the checkout, the hash taken over the sources, the flags and the
compiler's version, so a changed source or toolkit builds anew and an
unchanged one is loaded as it is. Nothing is built or loaded when this
module is imported: the first kernel launch calls ``library()``.

Every C entry point returns ``cudaGetLastError()`` after its launch; the
wrappers (ops/sweep.py, ops/step.py, ops/train.py, ops/train_wide.py,
ops/assembly.py, ops/next_segment.py) raise when it is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["library", "RodConstsHost", "NetTableHost", "TrainArgs",
           "TrainPlanC", "WideArgs", "WidePlanC", "build_info", "NVCC_FLAGS",
           "SOURCE_FLAGS"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# flags for one source only. K7 (assembly.cu) rounds every multiply and add
# on its own, as its plain version and the TPU kernel do: in float32 the
# coupled system's near-null axial direction turns rounding into where the
# FD-Newton stops inside its tolerance, and with contracted multiply-adds
# K7 stopped 3-9x farther from the float64 truth than the plain coupled
# Newton (PERF.md), without them 1.0-1.3x
SOURCE_FLAGS = {"assembly": ("-fmad=false",)}

_LIB = None
_INFO: dict = {}


class RodConstsHost(ctypes.Structure):
    """Mirror of ``RodConstsHost`` in csrc/rhs_rows.cuh (all float64; the
    kernel casts to its working type)."""
    _fields_ = [("Kse_inv", ctypes.c_double * 9),
                ("Kbt_inv", ctypes.c_double * 9),
                ("Bse", ctypes.c_double * 9),
                ("Bbt", ctypes.c_double * 9),
                ("rhoJ", ctypes.c_double * 9),
                ("v_rest", ctypes.c_double * 3),
                ("rhoAg", ctypes.c_double * 3),
                ("C", ctypes.c_double * 3),
                ("c0", ctypes.c_double),
                ("rhoA", ctypes.c_double),
                ("ds", ctypes.c_double),
                ("p0", ctypes.c_double * 3),
                ("h0", ctypes.c_double * 4),
                ("q0", ctypes.c_double * 3),
                ("w0", ctypes.c_double * 3),
                ("F_tip", ctypes.c_double * 3),
                ("M_tip", ctypes.c_double * 3)]


class NetTableHost(ctypes.Structure):
    """Mirror of ``NetTableHost`` in csrc/rhs_rows.cuh: a KNODE net of three
    layers or more as K1's deep form takes it (device pointers of each
    layer's weight (dout, din) and bias, the widths, the activation code,
    whether the kernel stages the net in shared memory, and the widest
    hidden layer a lane keeps)."""
    _fields_ = [("W", ctypes.c_void_p * 8),
                ("b", ctypes.c_void_p * 8),
                ("dims", ctypes.c_int * 9),
                ("n_layers", ctypes.c_int), ("act", ctypes.c_int),
                ("staged", ctypes.c_int), ("maxw", ctypes.c_int)]


class TrainArgs(ctypes.Structure):
    """Mirror of ``TrainArgs`` in csrc/train.cu: device pointers of the
    cell slabs, weights, moments and scalars, and the run's constants."""
    _fields_ = [("cells", ctypes.c_void_p * 6),    # x, y_base, z_phys,
                                                   # tgt_y, tgt_z, e_tgt
                ("w_in", ctypes.c_void_p * 4),     # W1, b1, W2, b2
                ("m_in", ctypes.c_void_p * 8),     # mu, nu of each
                ("s_in", ctypes.c_void_p),         # count, best, pcount, scale
                ("w_out", ctypes.c_void_p * 4),
                ("m_out", ctypes.c_void_p * 8),
                ("s_out", ctypes.c_void_p),
                ("losses", ctypes.c_void_p),
                ("C", ctypes.c_int), ("din", ctypes.c_int),
                ("hidden", ctypes.c_int), ("n_epochs", ctypes.c_int),
                ("patience", ctypes.c_int), ("clamp", ctypes.c_int),
                ("lr", ctypes.c_double), ("weight_decay", ctypes.c_double),
                ("factor", ctypes.c_double), ("rtol", ctypes.c_double),
                ("ds", ctypes.c_double),
                ("inv", ctypes.c_double * 4),     # pos, states, eul, z
                ("ds_grid", ctypes.c_void_p),     # K5: (G,) float64; K4: 0
                ("part", ctypes.c_void_p),        # scratch, a slab a part
                ("bar", ctypes.c_void_p)]         # (2 G,) int32 zeros


class TrainPlanC(ctypes.Structure):
    """Mirror of ``TrainPlan`` in csrc/train.cu (ops/train.py::launch_plan):
    threads, cluster, units, slots, tile, dynamic shared memory bytes,
    clusters a run."""
    _fields_ = [(f, ctypes.c_int) for f in
                ("threads", "cluster", "units", "slots", "tile", "smem",
                 "clusters")]


class WideArgs(ctypes.Structure):
    """Mirror of ``WideArgs`` in csrc/train_wide.cu: the cell slabs, the
    weights and moments (updated in place), the scalars, the run's
    constants and the scratch buffers."""
    _fields_ = [("cells", ctypes.c_void_p * 6),
                ("w", ctypes.c_void_p * 4),        # W1, b1, W2, b2
                ("m", ctypes.c_void_p * 8),        # mu, nu of each
                ("s_in", ctypes.c_void_p),
                ("s_out", ctypes.c_void_p),
                ("losses", ctypes.c_void_p),
                ("g", ctypes.c_void_p),            # (C, 25) scratch
                ("sums", ctypes.c_void_p),         # (loss blocks, 26)
                ("run", ctypes.c_void_p),          # (3,) float64
                ("C", ctypes.c_int), ("din", ctypes.c_int),
                ("hidden", ctypes.c_int), ("n_epochs", ctypes.c_int),
                ("patience", ctypes.c_int), ("clamp", ctypes.c_int),
                ("lr", ctypes.c_double), ("weight_decay", ctypes.c_double),
                ("factor", ctypes.c_double), ("rtol", ctypes.c_double),
                ("ds", ctypes.c_double),
                ("inv", ctypes.c_double * 4),
                ("part", ctypes.c_void_p),         # forward partial NN
                ("grad", ctypes.c_void_p),         # backward partials
                ("count", ctypes.c_void_p),        # int32 ticket
                ("step", ctypes.c_void_p)]         # the epoch's Adam step


class WidePlanC(ctypes.Structure):
    """Mirror of ``WidePlan`` in csrc/train_wide.cu
    (ops/train_wide.py::launch_plan)."""
    _fields_ = [(f, ctypes.c_int) for f in
                ("threads", "fwd_units", "fwd_cells", "fwd_tiles",
                 "loss_cells", "bwd_units", "bwd_cells", "slices", "chunks",
                 "fwd_smem", "bwd_smem", "part_floats", "sums_floats",
                 "grad_floats", "counters")]


class _Kernels:
    """The C entry points of every kernel library, as attributes."""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "of knode_cosserat_tpu_torch are built at first use")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cu*"))


def build_info() -> dict:
    """What the last ``library()`` call did: the libraries' directory,
    seconds spent building (~0 when loaded from an earlier build) and the
    ptxas register / spill report of a build made in this process (also
    kept beside each library as ``lib<source>.ptxas.log``)."""
    return dict(_INFO)


def library() -> _Kernels:
    """Build (if needed) and load the kernel libraries; cached per process."""
    global _LIB
    if _LIB is not None:
        return _LIB
    nvcc = _nvcc()
    cu, all_src = _sources()
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout
    h = hashlib.sha256()
    for f in all_src:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(repr((NVCC_FLAGS, sorted(SOURCE_FLAGS.items()))).encode())
    h.update(version.encode())
    out_dir = BUILD_DIR / h.hexdigest()[:16]
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    outs = {src.stem: out_dir / f"lib{src.stem}.so" for src in cu}
    jobs = {}
    for src in cu:                  # one nvcc per source, all at once
        out = outs[src.stem]
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            jobs[src.stem] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(src.stem, ()), "-I",
                 str(CSRC), "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    logs, failed = [], []
    for stem, (tmp, proc) in jobs.items():
        log = proc.communicate()[0]
        logs.append(log)
        if proc.returncode != 0:
            failed.append(f"{stem}.cu ({proc.returncode}):\n{log}")
            continue
        outs[stem].with_suffix(".ptxas.log").write_text(log)
        os.replace(tmp, outs[stem])
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    kernels = _Kernels()
    for stem, out in outs.items():
        kernels.__dict__[stem] = ctypes.CDLL(str(out))
    _declare(kernels)
    _INFO.update(path=str(out_dir), build_seconds=time.perf_counter() - t0,
                 ptxas="".join(logs))
    _LIB = kernels
    return kernels


def _declare(k: _Kernels):
    """Set argtypes / restype of each entry point and bind it onto ``k``."""
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    consts = ctypes.POINTER(RodConstsHost)
    k.knode_sweep = k.sweep.knode_sweep
    k.knode_step = k.step.knode_step
    k.knode_train = k.train.knode_train
    table = ctypes.POINTER(NetTableHost)
    # knode_sweep(is_f64, nn_in, act, rk4, B, N, consts, G, yh, zh, tf,
    #             W1, b1, W2, b2, hidden, deep, res, y, z, threads, smem,
    #             staged, stream)
    k.knode_sweep.argtypes = [I, I, I, I, I, I, consts, P, P, P, P,
                                P, P, P, P, I, table, P, P, P, I, I, I, P]
    k.knode_sweep.restype = I
    # knode_step(is_f64, nn_in, act, rk4, B, N, consts, tol, eps0, max_iter,
    #            n_alphas, lm_lambda0, lm_growth, max_escalations,
    #            G, yh, zh, tf, W1, b1, W2, b2, hidden, deep, nn_per_rod,
    #            G_out, y, z, r2, iters, sweeps, threads, smem, staged,
    #            stream)
    k.knode_step.argtypes = [I, I, I, I, I, I, consts, D, D, I,
                               I, D, D, I,
                               P, P, P, P, P, P, P, P, I, table, I,
                               P, P, P, P, P, P, I, I, I, P]
    k.knode_step.restype = I
    plan = ctypes.POINTER(TrainPlanC)
    # knode_train(args, plan, stream)
    k.knode_train.argtypes = [ctypes.POINTER(TrainArgs), plan, P]
    k.knode_train.restype = I
    # knode_train_grid(args, G, plan, stream)
    k.knode_train_grid = k.train.knode_train_grid
    k.knode_train_grid.argtypes = [ctypes.POINTER(TrainArgs), I, plan, P]
    k.knode_train_grid.restype = I
    # knode_train_clusters(din, hidden, plan, clusters)
    k.knode_train_clusters = k.train.knode_train_clusters
    k.knode_train_clusters.argtypes = [I, I, plan, ctypes.POINTER(I)]
    k.knode_train_clusters.restype = I
    # knode_error_name(code)
    k.knode_error_name = k.train.knode_error_name
    k.knode_error_name.argtypes = [I]
    k.knode_error_name.restype = ctypes.c_char_p
    # knode_train_wide(args, plan, stream)
    k.knode_train_wide = k.train_wide.knode_train_wide
    k.knode_train_wide.argtypes = [ctypes.POINTER(WideArgs),
                                   ctypes.POINTER(WidePlanC), P]
    k.knode_train_wide.restype = I
    # knode_assembly(is_f64, B, M, N, consts, plate, tol, eps0, max_iter,
    #                X0, yh, zh, tf, ph, X, y, z, r2, iters, threads, smem,
    #                stream)
    k.knode_assembly = k.assembly.knode_assembly
    k.knode_assembly.argtypes = [I, I, I, I, P, P, D, D, I,
                                 P, P, P, P, P, P, P, P, P, P, I, I, P]
    k.knode_assembly.restype = I
    # knode_next_segment(is_f64, nn_in, act, B, consts, W1, b1, W2, b2,
    #                    hidden, deep, y, yh, zh, tf, yg, z, threads, blocks,
    #                    smem, staged, stream)
    k.knode_next_segment = k.next_segment.knode_next_segment
    k.knode_next_segment.argtypes = [I, I, I, I, consts, P, P, P, P,
                                     I, table, P, P, P, P, P, P, I, I, I, I,
                                     P]
    k.knode_next_segment.restype = I
