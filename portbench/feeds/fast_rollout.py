"""Batched hybrid rollouts in a closed loop of one client: back-to-back
calls of one ``make_fast_rollout`` (the traffic's impl, tol and max_iter),
each a batch of rods over T steps, each rod on a sine schedule of a period
of its own. The schedules are drawn once from the seed; call i rolls out
set i mod ``schedules_per_run``.

The check takes a sampled timed call: its trajectories against the
reference's own rollout of the same schedules in float64 (solved to
REF_TOL), and the reference's tip residual at every base reaction the
program chose, each on the history of the program's own previous states.
"""
from __future__ import annotations

import time

import torch

from .. import compare
from ..harness import Reservoir
from ..reference import rod as R
from .common import (periods, port_net, port_rod, ref_rod, seeded_weights,
                     sine_tensions, spec_of)

REF_TOL = 1e-22       # the float64 reference's Newton, on sum(r^2)


def _launches():
    from knode_cosserat_tpu_torch.ops import step as kstep
    return kstep.LAUNCHES


def program_residual(rod, traj, controls, weights):
    """max over rods and steps of |r| of the reference's sweep at the
    program's base reaction (node 0's n and m), on the BDF-2 history of
    the program's two previous states; float64, one batched sweep."""
    traj = traj.to(rod.device, rod.dtype)
    y, z = traj[..., :19], traj[..., 19:25]
    B, T = y.shape[:2]
    prev = torch.cat([y[:, :1], y[:, :-1]], 1)
    zprev = torch.cat([z[:, :1], z[:, :-1]], 1)
    yh, zh = R.history(rod, y[:, :-1], z[:, :-1], prev[:, :-1],
                       zprev[:, :-1])
    tf = R.tendon_forces(rod, controls[:, :T - 1].to(rod.dtype))
    G = y[:, 1:, 0, 7:13]
    flat = lambda a: a.reshape((-1,) + a.shape[2:])
    ys, _ = R.sweep(rod, flat(G), flat(yh), flat(zh), flat(tf),
                    [w.to(rod.dtype) for w in weights])
    return float(R.tip_residual(rod, ys).norm(dim=-1).max())


class Cell:
    def __init__(self, run):
        from knode_cosserat_tpu_torch.core.fast_rollout import \
            make_fast_rollout
        self.run = run
        tr = run.traffic
        g = run.generator()
        self.weights = seeded_weights(run, g)
        self.net = port_net(run, self.weights)
        self.rod = port_rod(run)
        self.R, self.T, self.P = (tr["rods"], tr["steps"],
                                  tr["schedules_per_run"])
        per = periods(run, g, self.P * self.R).reshape(self.P, self.R)
        self.controls = sine_tensions(per, run.cfg["rod"]["del_t"], self.T)
        self.roll = make_fast_rollout(self.rod, spec_of(run.cfg),
                                      tol=tr["tol"], max_iter=tr["max_iter"],
                                      impl=tr["impl"])
        self.kept = Reservoir(1, run.rng)

    def call(self, i):
        return self.roll(self.controls[i % self.P], self.net)

    def warm(self):
        self.call(0)

    def _loop(self, seconds=None, calls=None):
        l0, n = _launches(), 0
        t0 = time.perf_counter()
        while True:
            out = self.call(n)
            self.run.sync()
            t = time.perf_counter()
            if seconds is not None:
                self.kept.offer((n % self.P, out))
            n += 1
            if (t - t0 >= seconds) if seconds is not None else n >= calls:
                break
        return {"wall_s": t - t0, "attempted": n, "calls": n,
                "rod_steps": n * self.R * (self.T - 1),
                "launches": _launches() - l0}

    def window(self, seconds):
        return self._loop(seconds=seconds)

    def traced(self):
        return self._loop(calls=int(self.run.traffic["trace_calls"]))

    @staticmethod
    def e2e(w):
        return {"rollout_rod_steps_per_s": w["rod_steps"] / w["wall_s"]}

    def release(self):
        self.roll = self.net = self.rod = None

    def reference_in_place(self, kind):
        """The sampled call's outputs made by the reference in the
        program's place: "control" in float32 with TF32 products;
        "counts" in float32 (returns the sweeps and Newton iterations a
        rod-step needs on these inputs, the K2 yardstick)."""
        tr = self.run.traffic
        idx = self.kept.items[0][0]
        rod = ref_rod(self.run, torch.float32, tf32=kind == "control")
        traj, r2, it, sw = R.rollout(rod, self.controls[idx], self.weights,
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
        ref, r2, _, _ = R.rollout(rod, ctl, w64, REF_TOL,
                                  self.run.traffic["max_iter"])
        return [
            ("traj_err", compare.state_err(traj[..., :25], ref[..., :25])),
            ("ref_residual", program_residual(rod, traj, ctl, w64)),
        ]
