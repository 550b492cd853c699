"""A control loop of one controller: ``CompiledStepper(fast=True)`` at one
rod, each step the next tensions of a schedule of sine segments (one a
period of the traffic's grid, in a seeded order, the schedule wrapped
around), each step timed on
the host clock from its call to a ``torch.cuda.synchronize()`` after it
(a controller reads the state before it acts).

The check reads the window's served states: its first steps from the
reset against the reference's own steps from the rest state, and a sample
of steps drawn from the seed, each against the reference's step from the
program's own state before it. The reference solves in float64 to
REF_TOL from the same base-reaction guess the stepper takes (the state's
last G).
"""
from __future__ import annotations

import time
from types import SimpleNamespace

import torch

from .. import compare
from ..harness import Reservoir, percentile
from ..reference import rod as R
from .common import (periods, port_net, port_rod, ref_rod, seeded_weights,
                     sine_tensions, spec_of)

REF_TOL = 1e-22


def _launches():
    from knode_cosserat_tpu_torch.ops import step as kstep
    return kstep.LAUNCHES


def _state(s):
    """(y, z, y_prev, z_prev, G) of one rod's StepState, batch of one."""
    return tuple(t[None] for t in (s.y, s.z, s.y_prev, s.z_prev, s.G))


class Cell:
    def __init__(self, run):
        from knode_cosserat_tpu_torch.serving import CompiledStepper
        self.run = run
        tr = run.traffic
        if tr["rods"] != 1:
            raise ValueError("the stepper cell serves one rod")
        g = run.generator()
        self.weights = seeded_weights(run, g)
        self.net = port_net(run, self.weights)
        self.rod = port_rod(run)
        segs = int(tr["schedule"]["segments"])
        self.L = segs * int(tr["schedule"]["segment_steps"])
        self.tensions = sine_tensions(
            periods(run, g, segs), run.cfg["rod"]["del_t"],
            self.L // segs).reshape(self.L, 4)
        self.stepper = CompiledStepper(self.rod, spec_of(run.cfg), self.net,
                                       tol=tr["tol"], max_iter=tr["max_iter"],
                                       fast=True)
        ck = tr["check"]
        self.K = int(ck["start_steps"])
        self.kept = Reservoir(int(ck["sampled_steps"]), run.rng)
        self.start = []

    def warm(self):
        st = self.stepper.reset()
        for i in range(int(self.run.traffic["warm_steps"])):
            st, _ = self.stepper.step(st, self.tensions[i % self.L])

    def _loop(self, seconds=None, steps=None):
        step, sync, ten = self.stepper.step, self.run.sync, self.tensions
        st = self.stepper.reset()
        keep = seconds is not None
        if keep:
            self.start = [st]
        lat, l0, i = [], _launches(), 0
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            new, _ = step(st, ten[i % self.L])
            sync()
            b = time.perf_counter()
            lat.append(b - a)
            if keep:
                if i < self.K:
                    self.start.append(new)
                self.kept.offer((st, i % self.L, new))
            st = new
            i += 1
            if (b - t0 >= seconds) if keep else i >= steps:
                break
        return {"wall_s": b - t0, "attempted": i, "steps": i, "lat": lat,
                "launches": _launches() - l0}

    def window(self, seconds):
        return self._loop(seconds=seconds)

    def traced(self):
        return self._loop(steps=int(self.run.traffic["trace_steps"]))

    @staticmethod
    def e2e(w):
        return {"step_latency_p95_ms": percentile(w["lat"], 95) * 1e3}

    def release(self):
        self.stepper = self.net = self.rod = None

    def reference_in_place(self, kind):
        """The window's served states made by the reference in the
        program's place ("control": float32 with TF32 products): K steps
        from the rest state and as many more as the sample holds, the
        sample taken from them."""
        tr = self.run.traffic
        rod = ref_rod(self.run, torch.float32, tf32=kind == "control")
        states = _stream(rod, self.weights, self.tensions,
                         self.K + self.kept.k, tr["tol"], tr["max_iter"])
        self.start = states[:self.K + 1]
        self.kept.items = [(states[i], i, states[i + 1])
                           for i in range(self.K, len(states) - 1)]

    def check(self):
        tr = self.run.traffic
        rod = ref_rod(self.run)
        w64 = [w.double() for w in self.weights]
        ten = self.tensions.double()
        cat = lambda s: torch.cat([s.y, s.z], -1)
        ref = _stream(rod, w64, ten, len(self.start) - 1, REF_TOL,
                      tr["max_iter"])
        start_err = compare.state_err(
            torch.stack([cat(s) for s in self.start[1:]]),
            torch.stack([cat(s) for s in ref[1:]]))
        ins = [_state(s) for s, _, _ in self.kept.items]
        batch = [torch.cat(a).double() for a in zip(*ins)]
        idx = torch.tensor([i for _, i, _ in self.kept.items],
                           device=ten.device)
        yn, zn, *_ = R.step(rod, *batch, ten[idx], w64, REF_TOL,
                            tr["max_iter"])
        outs = torch.stack([cat(o) for _, _, o in self.kept.items])
        return [
            ("start_err", start_err),
            ("step_err", compare.state_err(outs, torch.cat([yn, zn], -1))),
        ]


def _stream(rod, weights, tensions, n, tol, max_iter):
    """The reference serving one rod from the rest state for n steps, each
    Newton started from the last G, as the stepper does: the n + 1 states
    (y, z, y_prev, z_prev, G)."""
    y, z = R.initial_state(rod)
    s = SimpleNamespace(y=y, z=z, y_prev=y, z_prev=z,
                        G=torch.zeros(6, dtype=rod.dtype, device=rod.device))
    out = [s]
    for i in range(n):
        yn, zn, G, *_ = R.step(rod, *_state(s), tensions[i][None], weights,
                               tol, max_iter)
        s = SimpleNamespace(y=yn[0], z=zn[0], y_prev=s.y, z_prev=s.z,
                            G=G[0])
        out.append(s)
    return out
