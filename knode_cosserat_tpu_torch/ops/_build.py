"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

``library()`` compiles every ``.cu`` file under ``csrc/`` with ``nvcc`` for
Hopper (``sm_90a``) into one shared library with a plain C interface, and
loads it with ``ctypes``. The library lives in ``build/torch_kernels/``
at the root of the checkout, named by a hash of the sources, the flags and
the compiler's version, so a changed source or toolkit builds anew and an
unchanged one is loaded as it is. Nothing is built or loaded when this
module is imported: the first kernel launch calls ``library()``.

Every C entry point returns ``cudaGetLastError()`` after its launch; the
wrappers (ops/sweep.py, ops/step.py) raise when it is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["library", "RodConstsHost", "build_info", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    """What the last ``library()`` call did: path, seconds spent building
    (~0 when loaded from an earlier build) and the ptxas register / spill
    report of a build made in this process (also kept beside the library
    as ``lib<hash>.ptxas.log``)."""
    return dict(_INFO)


def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
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
    h.update(repr(NVCC_FLAGS).encode())
    h.update(version.encode())
    out = BUILD_DIR / f"lib{h.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    log = ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
             *map(str, cu)], capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        out.with_suffix(".ptxas.log").write_text(log)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    _declare(lib)
    _INFO.update(path=str(out), build_seconds=time.perf_counter() - t0,
                 ptxas=log)
    _LIB = lib
    return lib


def _declare(lib):
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    consts = ctypes.POINTER(RodConstsHost)
    # knode_sweep(is_f64, nn_in, act, rk4, B, N, consts, G, yh, zh, tf,
    #             W1, b1, W2, b2, hidden, res, y, z, block, stream)
    lib.knode_sweep.argtypes = [I, I, I, I, I, I, consts, P, P, P, P,
                                P, P, P, P, I, P, P, P, I, P]
    lib.knode_sweep.restype = I
    # knode_step(is_f64, nn_in, act, rk4, B, N, consts, tol, eps0, max_iter,
    #            n_alphas, lm_lambda0, lm_growth, max_escalations,
    #            G, yh, zh, tf, W1, b1, W2, b2, hidden,
    #            G_out, y, z, r2, iters, block, stream)
    lib.knode_step.argtypes = [I, I, I, I, I, I, consts, D, D, I,
                               I, D, D, I,
                               P, P, P, P, P, P, P, P, I,
                               P, P, P, P, P, I, P]
    lib.knode_step.restype = I
