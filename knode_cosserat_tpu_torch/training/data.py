"""Training-data generation (sim track).

PyTorch counterpart of ``knode_cosserat_tpu/training/data.py``
(forward_datas / compute_validation_reference, physics_train.py:81-134):
trajectories are rollouts of the UNMODIFIED reference rod on the requested
control schedules; the KNODE net attached to a modified rod is then trained
to close the gap. Gaussian noise is optionally added to trajectories and
controls (physics_train.py:126-127), drawn from a ``torch.Generator`` in
place of the JAX package's PRNG key.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..controls import calc_controls
from ..core.params import RodParams
from ..core.stepper import simulate

__all__ = ["make_training_data", "make_validation_reference", "TrajSpec",
           "parse_traj_specs"]

TrajSpec = Tuple[str, float]  # e.g. ("sine", 0.5)


def parse_traj_specs(tokens: Sequence[str]) -> List[TrajSpec]:
    """Parse the reference CLI trajectory syntax: first half types, second
    half args ("sine sine 0.5 1.0" -> [("sine", .5), ("sine", 1.)]),
    physics_train.py:52-58."""
    tokens = list(tokens)
    half = len(tokens) // 2
    types, args = tokens[:half], tokens[half:]
    if len(types) != len(args):
        raise ValueError("Different number of control types and args")
    return [(t, float(a)) for t, a in zip(types, args)]


def make_training_data(
    reference_rod: RodParams,
    specs: Sequence[TrajSpec],
    train_len: int = 30,
    noise_traj: float = 0.0,
    noise_controls: float = 0.0,
    generator: Optional[torch.Generator] = None,
):
    """Returns (trajs, controls): (n_traj, T, N, 25) and (n_traj, T, 4), on
    the rod's device and in its dtype.

    Trajectories are reference-rod rollouts, ``traj[:, :, :25]`` of the
    solver record (training never sees the recorded history channels,
    physics_train.py:116). All schedules roll out as one rod batch; each
    rod's Newton solve stops on its own (core/shooting.py), so the batch
    gives each trajectory that its own rollout gives."""
    dt = float(reference_rod.del_t)
    ctls = np.stack([calc_controls(kind, arg, dt, train_len)
                     for kind, arg in specs])
    trajs = simulate(reference_rod, ctls)[..., :25]
    ctls = torch.as_tensor(ctls, dtype=reference_rod.dtype,
                           device=reference_rod.device)
    if generator is not None and (noise_traj or noise_controls):
        noise = lambda a: torch.randn(a.shape, generator=generator,
                                      dtype=a.dtype,
                                      device=generator.device).to(a.device)
        trajs = trajs + noise_traj * noise(trajs)
        ctls = ctls + noise_controls * noise(ctls)
    return trajs, ctls


def make_validation_reference(
    reference_rod: RodParams,
    validation: TrajSpec = ("sine", 1.25),
    eval_len: int = 100,
):
    """Validation rollout of the reference rod (physics_train.py:89-94).
    Returns (controls (T, 4) numpy, traj (T, N, 25) on the rod's device)."""
    kind, arg = validation
    c = calc_controls(kind, arg, float(reference_rod.del_t), eval_len)
    return c, simulate(reference_rod, c)[..., :25]
