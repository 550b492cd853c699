"""Batched hybrid rollouts with the configuration's spatial method (RK4):
``fast_rollout``'s closed loop of one client, whose ``make_fast_rollout``
takes the configuration's ``method``.

The check takes the whole sampled call: its trajectories against
``reference/rod_rk4.py``'s rollout of the same schedules in float64
(solved to REF_TOL), and that reference's tip residual at every base
reaction the program chose, each on the history of the program's own
previous states.
"""
from __future__ import annotations

import torch

from .. import compare
from ..reference import rod_rk4 as RK
from . import fast_rollout
from .common import ref_rod, spec_of

REF_TOL = fast_rollout.REF_TOL


class Cell(fast_rollout.Cell):
    def __init__(self, run):
        from knode_cosserat_tpu_torch.core import fast_rollout as port
        # the same seeded weights and schedules; the rollout rebuilt with
        # the configuration's method (the base's is Euler's)
        super().__init__(run)
        tr = run.traffic
        self.roll = port.make_fast_rollout(
            self.rod, spec_of(run.cfg), tol=tr["tol"],
            max_iter=tr["max_iter"], impl=tr["impl"],
            method=run.cfg["method"])

    def reference_in_place(self, kind):
        """The sampled call's outputs made by the reference in the
        program's place: "control" in float32 with TF32 products; "counts"
        in float32 (returns the sweeps and Newton iterations a rod-step
        needs on these inputs, the K2 yardstick)."""
        tr = self.run.traffic
        idx = self.kept.items[0][0]
        rod = ref_rod(self.run, torch.float32, tf32=kind == "control")
        traj, r2, it, sw = RK.rollout(rod, self.controls[idx], self.weights,
                                      tr["tol"], tr["max_iter"])
        self.kept.items = [(idx, (traj, r2.sqrt(), it))]
        return {"sweeps_per_rod_step": float(sw.double().mean()),
                "iters_per_rod_step": float(it.double().mean()),
                "max_residual": float(r2.max().sqrt())}

    def check(self):
        idx, (traj, _, _) = self.kept.items[0]
        rod = ref_rod(self.run)
        ctl = self.controls[idx].double()
        w64 = [w.double() for w in self.weights]
        ref, _, _, _ = RK.rollout(rod, ctl, w64, REF_TOL,
                                  self.run.traffic["max_iter"])
        return [
            ("traj_err", compare.state_err(traj[..., :25], ref[..., :25])),
            ("ref_residual", RK.program_residual(rod, traj, ctl, w64)),
        ]
