"""The comparisons that decide ``correct``: the program's outputs against
the plain reference's, each as one number held to a limit of its own
(``limits/<workload>.json``)."""
from __future__ import annotations

import numpy as np
import torch

# the rod state's physical groups along its last axis: position, the
# quaternion, internal force and moment, velocity, angular velocity, and
# the strains v, u
GROUPS = {"p": (0, 3), "h": (3, 7), "n": (7, 10), "m": (10, 13),
          "q": (13, 16), "w": (16, 19), "v": (19, 22), "u": (22, 25)}


def state_err(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """Worst relative error of rod states (..., 25) = [y, z]: per physical
    group the largest |prog - ref| over the largest |ref| of that group,
    the worst group taken. A non-finite state reads inf."""
    prog = prog.to(ref.device, torch.float64)
    if not bool(torch.isfinite(prog).all()):
        return float("inf")
    worst = 0.0
    for i, j in GROUPS.values():
        scale = float(ref[..., i:j].abs().max())
        diff = float((prog[..., i:j] - ref[..., i:j]).abs().max())
        worst = max(worst, diff / max(scale, 1e-30))
    return worst


def norm_gap(prog_norms, ref_norms) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, against the larger of that leaf's reference norm and the
    median leaf's (some leaves are near zero)."""
    med = float(np.median(ref_norms))
    gaps = [abs(a - b) / max(b, med, 1e-300)
            for a, b in zip(prog_norms, ref_norms)]
    return max(gaps) if all(np.isfinite(prog_norms)) else float("inf")


def rel_gap(prog, ref) -> float:
    """max |prog - ref| / |ref| elementwise (losses)."""
    prog, ref = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    if prog.shape != ref.shape or not np.isfinite(prog).all():
        return float("inf")
    return float(np.max(np.abs(prog - ref) / np.abs(ref)))
