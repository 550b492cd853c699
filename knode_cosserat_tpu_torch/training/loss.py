"""Teacher-forced one-step KNODE training loss.

PyTorch counterpart of ``knode_cosserat_tpu/training/loss.py``: the
reference's ``--fast`` training path (physics_train.py:306-376 driving
parallelGetNextSegmentEuler, cosserat_ode_torch.py:401-437). The whole
(trajectory x timestep x keypoint) batch is one broadcast RHS evaluation.

Loss per trajectory (physics_train.py:345-352), the mean over timesteps:
  MSE(pos[kp]) + MSE(states 7:19 [kp]) + MSE(euler(quat[kp])) + MSE(z[kp-1])
where euler is the reference's own quaternion_to_euler and the z targets
use keypoint index kp-1 (the node where the RHS produced z,
physics_train.py:351-352).

Every function takes trajectories with optional leading batch axes,
``(..., T, N, 25)`` with controls ``(..., T, 4)``; the loss is one value per
trajectory (the JAX package vmaps a single-trajectory loss instead). A
stack of R rods (core/params.stack_params) scores every trajectory under
every rod, the rod axis in front: losses ``(R, ...)``.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from ..core.params import RodParams, align_rods
from ..core.spatial import next_segment_euler
from ..core.stepper import tendon_forces
from ..models.mlp import KnodeMLP, MLPSpec, mlp_apply
from ..ops.quaternion import quaternion_to_euler

__all__ = ["teacher_forced_loss", "teacher_forced_residuals",
           "grow_predictions",
           "DEFAULT_KEYPOINTS_FAST", "DEFAULT_KEYPOINTS_SLOW",
           "DEFAULT_KEYPOINTS_REAL"]

# keypoint sets used by the reference trainers
DEFAULT_KEYPOINTS_FAST = (3, 5, 7, 9)   # physics_train.py:328
DEFAULT_KEYPOINTS_SLOW = (2, 6, 9)      # physics_train.py:250
DEFAULT_KEYPOINTS_REAL = (1, 3, 6, 9)   # train_segment.py:172


def _nodes(a: torch.Tensor, idx) -> torch.Tensor:
    """a[..., idx, :] along the node axis (second to last)."""
    return a.index_select(-2, torch.as_tensor(idx, device=a.device))


def grow_predictions(
    p: RodParams,
    spec: MLPSpec,
    nn_params: KnodeMLP | None,
    traj: torch.Tensor,
    controls: torch.Tensor,
    keypoints: Sequence[int],
    fused_fn=None,
    nn_fn=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced next-state predictions at the keypoints.

    Args:
      traj: (..., T, N, 25) state-last ground truth ([y(19), z(6)]).
      controls: (..., T, 4) tendon tensions.
      fused_fn: the fused next-segment op
        (ops/next_segment.make_fused_next_segment), called once on the
        flattened cells of every trajectory.
      nn_fn: the net as a function (..., din) -> (..., 25), in place of
        ``nn_params`` (a tensor-parallel shard's forward,
        parallel/sharded_train.TPNet; a StackedMLP's net per rod).
    Returns:
      (y_grown, z_new): (..., T-1, K, 19), (..., T-1, K, 6) predictions for
      steps 1..T-1 evaluated at nodes keypoints-1; (R, ..., T-1, K, 19),
      (R, ..., T-1, K, 6) for a stack of R rods.
    """
    if p.n_rods is not None:
        if fused_fn is not None:
            raise ValueError("the fused next-segment op takes one rod")
        traj = traj.expand((p.n_rods,) + traj.shape)
        controls = controls.expand((p.n_rods,) + controls.shape)
        # the rods against the tensions (R, ..., T-1, 4) and against the
        # node states (R, ..., T-1, K, 19)
        tf = tendon_forces(align_rods(p, controls.dim() - 2),
                           controls[..., :-1, :])
        p = align_rods(p, traj.dim() - 2)
    else:
        tf = tendon_forces(p, controls[..., :-1, :])  # (..., T-1, 3)
    kp1 = [k - 1 for k in keypoints]
    ys = traj[..., :-1, :, :19]
    zs = traj[..., :-1, :, 19:]
    # the first step uses itself as its previous one (physics_train.py:321-322)
    y_prev = torch.cat([ys[..., :1, :, :], ys[..., :-1, :, :]], dim=-3)
    z_prev = torch.cat([zs[..., :1, :, :], zs[..., :-1, :, :]], dim=-3)
    yh = p.c1 * ys + p.c2 * y_prev               # (..., T-1, N, 19)
    zh = p.c1 * zs + p.c2 * z_prev

    G = traj[..., 1:, :, :]                      # truth next state
    y_in = _nodes(G[..., :19], kp1)              # (..., T-1, K, 19)
    yh_in = _nodes(yh, kp1)
    zh_in = _nodes(zh, kp1)

    if fused_fn is not None:
        # the fused op (K8, ops/next_segment.py) over every trajectory's
        # (T-1) x K cells at once: one launch
        lead = y_in.shape[:-1]
        flat = lambda a: a.reshape(-1, a.shape[-1])
        yg, zn = fused_fn(nn_params, flat(y_in), flat(yh_in), flat(zh_in),
                          flat(tf.unsqueeze(-2).expand(lead + (3,))))
        return yg.reshape(lead + (19,)), zn.reshape(lead + (6,))

    if nn_fn is None and nn_params is not None:
        nn_fn = lambda x: mlp_apply(spec, nn_params, x)
    return next_segment_euler(p, y_in, yh_in, zh_in, tf, nn_fn=nn_fn,
                              nn_history=spec.history)


def teacher_forced_loss(
    p: RodParams,
    spec: MLPSpec,
    nn_params: KnodeMLP | None,
    traj: torch.Tensor,
    controls: torch.Tensor,
    keypoints: Sequence[int] = DEFAULT_KEYPOINTS_FAST,
    fused_fn=None,
    skip_first: bool = False,
    nn_fn=None,
) -> torch.Tensor:
    """The loss of each trajectory, shape ``traj.shape[:-3]`` (a scalar for
    one trajectory; ``(R,) + traj.shape[:-3]`` for a stack of R rods); sum
    it for the multi-trajectory total (physics_train.py:313-366). fused_fn,
    nn_fn: as grow_predictions.

    skip_first: drop each trajectory's first transition. Its BDF-2 history
    uses the frame as its own predecessor (physics_train.py:321-322):
    exact when traj[0] is the initial state at rest, made up when the
    trajectory is a window that starts mid-motion."""
    if skip_first and traj.shape[-3] < 3:
        # slicing off the first transition of a 2-frame trajectory leaves no
        # residuals, and the mean would be NaN
        raise ValueError(
            f"teacher_forced_loss(skip_first=True) needs >= 3 frames, got "
            f"traj of length {traj.shape[-3]} (after any trimming)")
    y_grown, z_new = grow_predictions(p, spec, nn_params, traj, controls,
                                      keypoints, fused_fn=fused_fn,
                                      nn_fn=nn_fn)
    target = traj[..., 1:, :, :]                 # (..., T-1, N, 25)
    if skip_first:
        y_grown, z_new = y_grown[..., 1:, :, :], z_new[..., 1:, :, :]
        target = target[..., 1:, :, :]
    tgt_y = _nodes(target[..., :19], list(keypoints))
    tgt_z = _nodes(target[..., 19:], [k - 1 for k in keypoints])

    mse = lambda a, b: ((a - b) ** 2).mean(dim=(-3, -2, -1))
    return (mse(y_grown[..., 0:3], tgt_y[..., 0:3])
            + mse(y_grown[..., 7:19], tgt_y[..., 7:19])
            + mse(quaternion_to_euler(y_grown[..., 3:7]),
                  quaternion_to_euler(tgt_y[..., 3:7]))
            + mse(z_new, tgt_z))


def teacher_forced_residuals(
    p: RodParams,
    spec: MLPSpec,
    nn_params: KnodeMLP | None,
    traj: torch.Tensor,
    controls: torch.Tensor,
    keypoints: Sequence[int] = DEFAULT_KEYPOINTS_FAST,
    skip_first: bool = False,
) -> torch.Tensor:
    """The residual vector r of each trajectory, shape
    ``traj.shape[:-3] + (n,)``, with sum(r**2) == teacher_forced_loss.

    The loss is four equally weighted MSE groups (positions, internal
    states 7:19, Euler angles, strains); each group's raw residuals are
    scaled by 1/sqrt(its size), so the plain square-sum reproduces it. Its
    Jacobian feeds the Gauss-Newton / Fisher path of
    training/sysid.identifiability."""
    if skip_first and traj.shape[-3] < 3:
        raise ValueError(
            f"teacher_forced_residuals(skip_first=True) needs >= 3 "
            f"frames, got traj of length {traj.shape[-3]}")
    y_grown, z_new = grow_predictions(p, spec, nn_params, traj, controls,
                                      keypoints)
    target = traj[..., 1:, :, :]
    if skip_first:
        y_grown, z_new = y_grown[..., 1:, :, :], z_new[..., 1:, :, :]
        target = target[..., 1:, :, :]
    tgt_y = _nodes(target[..., :19], list(keypoints))
    tgt_z = _nodes(target[..., 19:], [k - 1 for k in keypoints])

    def group(a, b):
        d = (a - b).flatten(-3)
        return d / math.sqrt(d.shape[-1])

    return torch.cat([
        group(y_grown[..., 0:3], tgt_y[..., 0:3]),
        group(y_grown[..., 7:19], tgt_y[..., 7:19]),
        group(quaternion_to_euler(y_grown[..., 3:7]),
              quaternion_to_euler(tgt_y[..., 3:7])),
        group(z_new, tgt_z),
    ], dim=-1)
