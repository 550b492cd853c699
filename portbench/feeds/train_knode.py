"""train_knode in a closed loop of one client: back-to-back calls as
cli.py:cmd_train_real makes them (a TrainConfig of epochs, hidden, weight
decay, seed, keypoints and dtype; no validation; ``log=None``), each a
whole training run from the seed's net on the configuration's recordings.

The check reads a sampled timed call's loss history across K4's chunk
boundaries, where train_knode carries the weights and the optimizer's
state from one chunk to the next: its first ``epochs`` losses (whole
chunks) against the float64 reference from the same net, and its losses
from ``late_from`` on against the reference restarted from the program's
own checkpoint at ``late_from`` (the plateau's state included). Set-up
makes the calls that give the program's state: a one-epoch call with a
checkpoint (Adam's first moment over 1 - b1 is the first gradient), an
``epochs``-epoch call (the change of every weight) and a ``late_from``-epoch
call with a checkpoint; they go through the same entry on the same feed,
and their losses must equal the timed call's first ones bit for bit.
"""
from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from .. import compare
from ..harness import Reservoir
from ..reference import train as RT
from .common import port_rod, ref_rod


def _launches():
    from knode_cosserat_tpu_torch.ops import train as ktrain
    return ktrain.LAUNCHES


def state_of_checkpoint(ck) -> RT.AdamState:
    """The reference's float64 state from the program's checkpoint tree
    (training/train.py: params per layer {"w" (dout, din), "b"}; opt_state
    ((count, mu, nu),), (scale, best, plateau count, ...))."""
    leaves = lambda tree: [torch.as_tensor(np.asarray(layer[k]),
                                           dtype=torch.float64)
                           for layer in tree for k in ("w", "b")]
    (count, mu, nu), = ck["opt_state"][0]
    scale, best, pcount = ck["opt_state"][1][:3]
    return RT.AdamState(leaves(ck["params"]), leaves(mu), leaves(nu),
                        int(count), float(best), int(pcount), float(scale))


class Cell:
    def __init__(self, run):
        from knode_cosserat_tpu_torch.training.train import (TrainConfig,
                                                             train_knode)
        self.run = run
        cfg, rec = run.cfg, run.traffic["recording"]
        d, t, net = cfg["data"], cfg["train"], cfg["net"]
        if (net["activation"], net["history"]) != ("elu", False):
            raise ValueError("train-real trains the (28, H, 25) ELU net")
        g = run.generator()
        shape = (d["recordings"], d["train_len"], cfg["N"], 25)
        rest = torch.zeros(25, device=run.device)
        rest[3] = 1.0
        noise = lambda: torch.randn(shape, generator=g, device=run.device)
        self.trajs = rest + rec["state_std"] * noise()
        self.trajs = self.trajs + d["noise_traj"] * noise()
        lo, hi = rec["tension_range"]
        self.ctls = lo + (hi - lo) * torch.rand(
            shape[:2] + (4,), generator=g, device=run.device)
        self.rod = port_rod(run)
        self.seed = run.seed % (1 << 63)
        self.cfg_of = lambda epochs, **kw: TrainConfig(
            epochs=epochs, hidden=net["dims"][1],
            weight_decay=t["weight_decay"], seed=self.seed,
            keypoints=tuple(t["keypoints"]), dtype=cfg["dtype"], **kw)
        self.tc = self.cfg_of(t["epochs"])
        self.train_knode = train_knode
        self.kept = Reservoir(1, run.rng)
        self.first = None

    def call(self, tc=None, **kw):
        return self.train_knode(self.rod, self.trajs, self.ctls,
                                tc or self.tc, log=None, **kw)

    def _checkpointed(self, epochs):
        """A call of ``epochs`` epochs that saves the program's own
        checkpoint at its end: (losses, the reference's AdamState of it)."""
        from knode_cosserat_tpu_torch.training.checkpoint import \
            load_checkpoint
        tmp = tempfile.mkdtemp(prefix="portbench-")
        try:
            path = os.path.join(tmp, "state.npz")
            res = self.call(self.cfg_of(epochs - 1, checkpoint_every=epochs),
                            checkpoint_path=path)
            ck, _ = load_checkpoint(path)
        finally:
            shutil.rmtree(tmp)
        return np.asarray(res.loss_history), state_of_checkpoint(ck)

    def warm(self):
        """A whole call (every chunk the window launches), then the calls
        that give the check the program's state: after the first epoch,
        after the first ``epochs`` (whole chunks) and at ``late_from``."""
        t0 = time.perf_counter()
        self.call()
        self.run.sync()
        print(f"portbench: warm-up: the first call {time.perf_counter() - t0:.3f}"
              " s", file=sys.stderr)
        ck = self.run.traffic["check"]
        loss1, s1 = self._checkpointed(1)
        early = self.call(self.cfg_of(ck["epochs"] - 1))
        late_loss, late = self._checkpointed(ck["late_from"])
        self.first = dict(
            g1=[m / (1 - RT.B1) for m in s1.mu],
            P=[p.detach().double().cpu() for p in early.params.parameters()],
            late=late, replay=[loss1, np.asarray(early.loss_history),
                               late_loss])

    def _loop(self, seconds=None, calls=None):
        l0, n, epochs = _launches(), 0, 0
        t0 = time.perf_counter()
        while True:
            res = self.call()
            t = time.perf_counter()
            n += 1
            epochs += len(res.loss_history)
            if seconds is not None:
                self.kept.offer(np.asarray(res.loss_history))
            if (t - t0 >= seconds) if seconds is not None else n >= calls:
                break
        return {"wall_s": t - t0, "attempted": n, "calls": n,
                "epochs": epochs, "launches": _launches() - l0}

    def window(self, seconds):
        return self._loop(seconds=seconds)

    def traced(self):
        return self._loop(calls=int(self.run.traffic["trace_calls"]))

    @staticmethod
    def e2e(w):
        return {"train_epochs_per_s": w["epochs"] / w["wall_s"]}

    def release(self):
        self.rod = None

    def reference_in_place(self, kind):
        """The outputs the check reads, made by the reference in the
        program's place over the epochs the check reads: "control" in
        float32 with TF32 products, "half_batch" in float32 on half of the
        recordings, their loss the mean over those times the full count."""
        run, t = self.run, self.run.cfg["train"]
        ck = run.traffic["check"]
        rod = ref_rod(run, torch.float32, tf32=kind == "control")
        n = self.trajs.shape[0] // 2 if kind == "half_batch" else None
        cl = RT.cells(rod, self.trajs[:n], self.ctls[:n], t["keypoints"])
        if n:
            cl["scale"] = self.trajs.shape[0] / n
        P0 = [p.to(run.device) for p in RT.init_net(
            run.cfg["net"]["dims"], self.seed)]
        L, _, g1, kept = RT.train(
            rod, cl, RT.AdamState.fresh(P0),
            ck["late_from"] + ck["late_epochs"], *self._hyper(t),
            keep_at=(ck["epochs"], ck["late_from"]))
        L = L.numpy()
        cpu = lambda xs: [x.double().cpu() for x in xs]
        late = kept[ck["late_from"]]
        self.first = dict(
            g1=cpu(g1), P=cpu(kept[ck["epochs"]].P),
            late=RT.AdamState(cpu(late.P), cpu(late.mu), cpu(late.nu),
                              late.t, late.best, late.count, late.scale),
            replay=[L[:1], L[:ck["epochs"]], L[:ck["late_from"]]])
        self.kept.items = [L]

    @staticmethod
    def _hyper(t):
        return (t["lr"], t["weight_decay"], t["plateau_factor"],
                t["plateau_patience"], t["clamp_weights"])

    def check(self):
        run, t = self.run, self.run.cfg["train"]
        ck = run.traffic["check"]
        E, a, k = ck["epochs"], ck["late_from"], ck["late_epochs"]
        rod = ref_rod(run)
        dev = lambda xs: [x.to(run.device, torch.float64) for x in xs]
        P0 = dev(RT.init_net(run.cfg["net"]["dims"], self.seed))
        cl = RT.cells(rod, self.trajs.double(), self.ctls.double(),
                      t["keypoints"])
        L, S, g1, _ = RT.train(rod, cl, RT.AdamState.fresh(P0), E,
                               *self._hyper(t))
        f = self.first
        s = f["late"]
        late = RT.AdamState(dev(s.P), dev(s.mu), dev(s.nu), s.t, s.best,
                            s.count, s.scale)
        L_late, _, _, _ = RT.train(rod, cl, late, k, *self._hyper(t))
        timed = self.kept.items[0]
        norm = lambda x: float(torch.linalg.vector_norm(
            torch.as_tensor(x, dtype=torch.float64).cpu()))
        g_ref = [norm(g) for g in g1]
        # leaves whose reference gradient is nought to rounding move by
        # round-off alone: a thousandth of the median leaf's and under
        live = [i for i, v in enumerate(g_ref)
                if v >= 1e-3 * float(np.median(g_ref))]
        pick = lambda xs: [xs[i] for i in live]
        P0 = [p.cpu() for p in P0]
        d_ref = [norm(p.cpu() - p0) for p, p0 in zip(S.P, P0)]
        d_prog = [norm(p - p0) for p, p0 in zip(f["P"], P0)]
        replay = max(compare.rel_gap(r, timed[:len(r)]) for r in f["replay"])
        return [
            ("loss_gap", compare.rel_gap(timed[:E], L.numpy())),
            ("grad_gap", compare.norm_gap(pick([norm(g) for g in f["g1"]]),
                                          pick(g_ref))),
            ("change_gap", compare.norm_gap(pick(d_prog), pick(d_ref))),
            ("late_gap", compare.rel_gap(timed[a:a + k], L_late.numpy())),
            ("replay_gap", replay),
        ]
