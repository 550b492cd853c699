"""Batched small dense solves for the Newton shooting drivers.

PyTorch counterpart of ``knode_cosserat_tpu/ops/linalg.py``. The JAX package
unrolls its own pivoted elimination because XLA:TPU has no float64 LU;
here ``torch.linalg.solve_ex`` does the LU on any device and dtype. It
reports a singular system through ``info`` instead of raising (plain
``torch.linalg.solve`` raises), and those lanes come back as NaN so the
callers' non-finite masks treat them exactly as the JAX package treats its
non-finite eliminations.
"""
from __future__ import annotations

import torch

__all__ = ["solve_small", "solve_spd_small"]


def solve_small(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for A (..., n, n), b (..., n). Lanes whose LU hits a
    zero pivot (``info != 0``) return NaN."""
    x, info = torch.linalg.solve_ex(A, b.unsqueeze(-1))
    x = x.squeeze(-1)
    return torch.where((info == 0).unsqueeze(-1), x,
                       torch.full_like(x, float("nan")))


def solve_spd_small(A: torch.Tensor, b: torch.Tensor,
                    damping: float = 0.0) -> torch.Tensor:
    """Solve (A^T A + damping I) x = A^T b — the Levenberg-Marquardt normal
    equations, for rescuing near-singular Newton steps."""
    AtA = A.transpose(-1, -2) @ A
    Atb = (A.transpose(-1, -2) @ b.unsqueeze(-1)).squeeze(-1)
    if damping:
        AtA = AtA + damping * torch.eye(A.shape[-1], dtype=A.dtype,
                                        device=A.device)
    return solve_small(AtA, Atb)
