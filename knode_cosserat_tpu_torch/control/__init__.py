"""Control: gradient-based MPC through the differentiable rollout.

- mpc.py: single-rod tip tracking (forward roots on kernel K2 on the card).
- assembly_mpc.py: plate-pose tracking over multi-rod assemblies.
"""
from ..core.assembly import AssemblyCarry
from .assembly_mpc import (AssemblyMPCController, AssemblyPlanResult,
                           make_assembly_planner,
                           make_multistart_assembly_planner, rollout_plate)
from .mpc import (MPCController, PlanResult, PlanState, make_planner,
                  make_multistart_planner, rollout_tips)

__all__ = ["MPCController", "PlanResult", "PlanState", "make_planner",
           "make_multistart_planner", "rollout_tips", "AssemblyCarry",
           "AssemblyMPCController", "AssemblyPlanResult",
           "make_assembly_planner", "make_multistart_assembly_planner",
           "rollout_plate"]
