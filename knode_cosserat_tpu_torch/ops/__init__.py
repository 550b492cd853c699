"""Small tensor ops and the kernel wrappers. The kernel modules (sweep,
step, train, train_wide, assembly, next_segment), the DTW wavefront (dtw)
and the build (_build) are imported by their users, not here."""
from .linalg import solve_small, solve_spd_small
from .quaternion import (quat_spatial_derivative, quat_to_rotmat,
                         quaternion_to_euler)
