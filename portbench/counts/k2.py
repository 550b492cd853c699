"""Work of K2 (one whole BDF-2 Newton-shooting step per rod, csrc/step.cu)
and of a hybrid rod-step, counted from the plain reference.

A sweep is N-1 nodes of the RHS, each the net's two layers and ELU plus
``reference.rod.NODE_OPS`` of physics and Euler update. A rod-step needs
the sweeps that the reference's forward-difference Newton needs on these
inputs (the first residual, 6 probes an iteration, the line search up to
its first improving candidate, the recording sweep) plus one 6x6 solve an
iteration (the FD Jacobian 72, the LM term 12, LU and substitution 216).
"""
from ..reference.rod import NODE_OPS

SOLVE_OPS = 72 + 12 + 216


def node_flops(dims) -> int:
    """One node of the hybrid RHS: 2 H (din + 25) for the two layers
    (bias adds included), H for the ELU, and the physics."""
    din, hidden, dout = dims
    return 2 * hidden * (din + dout) + hidden + NODE_OPS


def rod_step_flops(dims, N: int, sweeps: float, iters: float) -> float:
    """Operations of one hybrid rod-step needing ``sweeps`` sweeps and
    ``iters`` Newton iterations (means over the rod-steps of a cell)."""
    return sweeps * (N - 1) * node_flops(dims) + iters * SOLVE_OPS


def launch_bytes(dims, N: int, rods: int, dtype_bytes: int = 4) -> int:
    """One launch over ``rods`` rods: the net once; per rod G, yh, zh and
    the tendon force in, G, y, z (N-1 nodes), r2 and iters out."""
    din, hidden, dout = dims
    net = hidden * (din + 1) + dout * (hidden + 1)
    per_rod = (6 + N * 19 + N * 6 + 3) + (6 + N * 19 + (N - 1) * 6 + 1 + 1)
    return dtype_bytes * (net + rods * per_rod)
