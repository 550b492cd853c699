from .params import (MODS, MODS_ORIGINAL, RodParams, apply_mod, derive,
                     experimental_rod, make_rod, original_rod, rod_from_numpy)
from .rhs import nn_input_features, rhs
from .shooting import NewtonStats, implicit_root, newton_solve
from .spatial import (base_state, integrate_euler, integrate_rk4,
                      next_segment_euler, residual_euler, residual_rk4,
                      tip_residual)
from .stepper import SimOutput, initial_state, simulate, simulate_scan
