"""Exact DTW on the trajectories' device: the anti-diagonal wavefront.

PyTorch counterpart of ``knode_cosserat_tpu/ops/dtw.py``. The recurrence

    S[i, j] = C[i, j] + min(S[i-1, j], S[i, j-1], S[i-1, j-1])

is sequential in (i, j), but every cell of the anti-diagonal i + j = k
depends only on diagonals k-1 and k-2, so the matrix is filled by a loop of
n + m - 1 vectorized diagonal updates (the JAX package's ``lax.scan``
becomes a Python loop over diagonals), for a whole batch at once. The
rollout and its score stay on the device.

Distance parity: evaluation.metrics.dtw (exact DTW; the 1-norm point
distance is the fastdtw-package default the reference inherits). Returns
the distance only.
"""
from __future__ import annotations

import torch

__all__ = ["dtw_device", "batch_dtw_device", "tip_dtw_device"]


def batch_dtw_device(xs: torch.Tensor, ys: torch.Tensor,
                     dist_ord: int = 1) -> torch.Tensor:
    """Exact DTW distances of xs (B, n, d) against ys (B, m, d) -> (B,)."""
    diff = xs[:, :, None, :] - ys[:, None, :, :]
    if dist_ord == 1:
        C = diff.abs().sum(-1)
    elif dist_ord == 2:
        C = (diff * diff).sum(-1).sqrt()
    else:
        raise ValueError(f"dist_ord must be 1 or 2, got {dist_ord}")
    B, n, m = C.shape
    inf = torch.full((B, 1), float("inf"), dtype=C.dtype, device=C.device)
    i = torch.arange(n, device=C.device)

    def shift(v):   # v[:, i] -> v[:, i-1], out of range = inf
        return torch.cat([inf, v[:, :-1]], dim=1)

    prev2 = prev = inf.expand(B, n)             # diagonals k-2 and k-1
    for k in range(n + m - 1):
        j = k - i
        valid = (j >= 0) & (j < m)
        c = torch.where(valid, C[:, i, j.clamp(0, m - 1)], inf)
        best = torch.minimum(torch.minimum(prev,          # (i, j-1)
                                           shift(prev)),  # (i-1, j)
                             shift(prev2))                # (i-1, j-1)
        if k == 0:   # cell (0, 0) has no predecessor
            best = torch.where(i == 0, torch.zeros_like(best), best)
        prev2, prev = prev, torch.where(valid, c + best, inf)
    return prev[:, n - 1]


def dtw_device(x: torch.Tensor, y: torch.Tensor, dist_ord: int = 1):
    """Exact DTW distance between x (n, d) and y (m, d), a 0-dim tensor."""
    x = x[:, None] if x.dim() == 1 else x
    y = y[:, None] if y.dim() == 1 else y
    return batch_dtw_device(x[None], y[None], dist_ord)[0]


def tip_dtw_device(pred_trajs: torch.Tensor, ref_traj: torch.Tensor,
                   node: int = -1, dist_ord: int = 1) -> torch.Tensor:
    """Tip-trajectory DTW, the reference metric (fastdtw on traj[:, :3, 9],
    physics_multitrain.py:213), of a batch of rollouts against one
    reference. pred_trajs: (B, T, N, >=3); ref_traj: (T', N, >=3),
    state-last (moved to the rollouts' device and dtype). Returns (B,)
    distances."""
    pred_tip = pred_trajs[:, :, node, :3]
    ref_tip = torch.as_tensor(ref_traj)[:, node, :3].to(pred_tip)
    return batch_dtw_device(pred_tip,
                            ref_tip.expand((pred_tip.shape[0],)
                                           + ref_tip.shape), dist_ord)
