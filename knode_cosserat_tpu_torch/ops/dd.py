"""Double-double (two-float) reductions.

PyTorch counterpart of ``knode_cosserat_tpu/ops/dd.py``: error-free
transformations (Knuth TwoSum; Dekker split / TwoProd), where every add or
multiply also yields its EXACT rounding error as a second number, and a
pairwise tree of dd additions that carries the (hi, lo) pair through a
reduction. From float32 inputs this gives ~2^-48 relative precision.

The JAX package needs them because the TPU has no float64; the port's
``training/sysid.py`` forms its Gauss-Newton Gram in native float64 on the
H100 instead (at least as accurate as a float32 double-double; ROADMAP
Queue 3). These functions are kept for callers that hold float32 data.

The transformations rely on each operation rounding on its own: they run
as separate eager tensor operations (no ``torch.compile``, which could
contract a multiply and an add into a fused multiply-add).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["two_sum", "two_prod", "dd_add", "dd_sum", "dd_gram",
           "dd_to_float64"]

# Dekker splitting constants: 2^ceil(p/2) + 1 for a p-bit significand
_SPLIT_F32 = 4097.0          # 2^12 + 1
_SPLIT_F64 = 134217729.0     # 2^27 + 1


def two_sum(a: torch.Tensor, b: torch.Tensor):
    """Error-free sum: (s, e) with s = fl(a + b) and s + e = a + b
    EXACTLY (Knuth, branch-free 6-flop variant)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _split(a: torch.Tensor):
    c = _SPLIT_F32 if a.dtype == torch.float32 else _SPLIT_F64
    t = c * a
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a: torch.Tensor, b: torch.Tensor):
    """Error-free product: (p, e) with p = fl(a * b) and p + e = a * b
    exactly (Dekker, without a fused multiply-add)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def dd_add(x: Tuple[torch.Tensor, torch.Tensor],
           y: Tuple[torch.Tensor, torch.Tensor]):
    """(hi, lo) + (hi, lo): the standard dd addition (~2 ulp^2 error)."""
    xh, xl = x
    yh, yl = y
    s, e = two_sum(xh, yh)
    e = e + xl + yl
    return two_sum(s, e)       # renormalize


def dd_sum(hi: torch.Tensor, lo: torch.Tensor, dim: int = 0):
    """Compensated reduction of a dd vector along ``dim`` by a pairwise
    tree of dd additions (log2 n rounds of elementwise operations)."""
    hi = hi.movedim(dim, 0)
    lo = lo.movedim(dim, 0)
    n = hi.shape[0]
    # pad to a power of two with exact zeros
    m = 1 if n == 0 else 1 << (n - 1).bit_length()
    if m != n:
        pad = hi.new_zeros((m - n,) + tuple(hi.shape[1:]))
        hi = torch.cat([hi, pad])
        lo = torch.cat([lo, pad])
    while hi.shape[0] > 1:
        half = hi.shape[0] // 2
        hi, lo = dd_add((hi[:half], lo[:half]), (hi[half:], lo[half:]))
    return hi[0], lo[0]


def dd_gram(J: torch.Tensor):
    """J^T J with dd accumulation: a (hi, lo) pair of (D, D) matrices; each
    product J[n, k] J[n, l] is formed error-free (TwoProd) and the n-sum
    carries the compensation. Memory: two (n, D, D) intermediates."""
    if J.dim() != 2:
        raise ValueError(f"dd_gram wants (n, D), got {tuple(J.shape)}")
    p, e = two_prod(J[:, :, None], J[:, None, :])      # (n, D, D) exact
    return dd_sum(p, e, dim=0)


def dd_to_float64(hi: torch.Tensor, lo: torch.Tensor) -> np.ndarray:
    """Host float64 view of a dd result (exact: dd's 48-bit significand
    fits in float64's 53)."""
    f = lambda t: t.detach().cpu().to(torch.float64).numpy()
    return f(hi) + f(lo)
