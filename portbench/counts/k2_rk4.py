"""Work of K2 with the RK4 sweep (csrc/step.cu, node_step<RK4=true>) and of
an RK4 hybrid rod-step, counted from the plain reference
(reference/rod_rk4.py).

An RK4 node is four evaluations of the hybrid RHS (the net's two layers and
ELU, and ``reference.rod.NODE_OPS`` of physics less its Euler update) plus
the stages' combinations, RK4_OPS. A rod-step needs the sweeps of N-1 such
nodes that the reference's Newton needs on these inputs plus one 6x6 solve
an iteration (counts/k2.py's SOLVE_OPS). A launch moves the bytes of an
Euler one (the stages read no more than the node's history rows j and
j+1): counts/k2.py's ``launch_bytes``.
"""
from ..reference.rod import NODE_OPS
from .k2 import SOLVE_OPS, launch_bytes  # noqa: F401 (one launch's bytes)

# the Euler update y + ds dy, counted in NODE_OPS, which RK4 replaces
EULER_UPDATE_OPS = 38
# the history midpoints 0.5 (a + b) of 19 + 6 rows 50; the three stage
# states y + k (ds / 2), y + k (ds / 2), y + k ds 3 x 38; the running sum
# of k2 and k3 19; the update y + ds (k1 + 2 acc + k4) / 6 19 x 6
RK4_OPS = 50 + 3 * 38 + 19 + 19 * 6


def rhs_flops(dims) -> int:
    """One evaluation of the hybrid RHS: 2 H (din + 25) for the two layers
    (bias adds included), H for the ELU, and the physics."""
    din, hidden, dout = dims
    return 2 * hidden * (din + dout) + hidden + NODE_OPS - EULER_UPDATE_OPS


def node_flops(dims) -> int:
    """One RK4 node: four RHS and the combinations."""
    return 4 * rhs_flops(dims) + RK4_OPS


def rod_step_flops(dims, N: int, sweeps: float, iters: float) -> float:
    """Operations of one RK4 hybrid rod-step needing ``sweeps`` sweeps and
    ``iters`` Newton iterations (means over the rod-steps of a cell)."""
    return sweeps * (N - 1) * node_flops(dims) + iters * SOLVE_OPS
