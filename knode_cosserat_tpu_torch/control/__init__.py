"""Control: gradient-based MPC through the differentiable rollout.

- assembly_mpc.py: plate-pose tracking over multi-rod assemblies.

The single-rod planner (the JAX package's control/mpc.py) is not ported
yet (ROADMAP.md, Queue 1, item 14).
"""
from ..core.assembly import AssemblyCarry
from .assembly_mpc import (AssemblyMPCController, AssemblyPlanResult,
                           make_assembly_planner,
                           make_multistart_assembly_planner, rollout_plate)

__all__ = ["AssemblyCarry", "AssemblyMPCController", "AssemblyPlanResult",
           "make_assembly_planner", "make_multistart_assembly_planner",
           "rollout_plate"]
