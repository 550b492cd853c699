"""KNODE training in plain PyTorch: the teacher-forced one-step loss and
the Adam(W) chain with reduce-on-plateau and the non-negative weight
clamp, over every epoch of a run.

The loss (physics_train.py:306-376 with train_segment.py's keypoints): per
trajectory and (step t, keypoint k), the RHS at the TRUE next state of node
k-1, with the BDF-2 history of step t (the first step its own previous
one), grows node k by one Euler step; the loss is the per-trajectory mean
over steps and keypoints of the squared error of positions, states 7:19,
the Euler angles of the quaternion (Utils/transformations.py:3-31) and the
strains at node k-1, summed over trajectories. The physics part of each
cell does not depend on the net, so it is computed once per run.

The optimizer (physics_train.py:199-206, optax's chain): the plateau sees
the epoch's loss (an improvement is loss < (1 - 1e-4) best; 80 epochs
without one halve the scale), then Adam(W) with b1 0.9, b2 0.999, eps 1e-8,
then the weight matrices clamped at 0 (physics_train.py:299-304).

The net's two layers and their gradients are matrix products through
``rod.mm`` (TF32 in the control); the loss's elementwise part takes its
gradient from autograd.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .rod import Rod, rhs, tendon_forces

B1, B2, EPS, PLATEAU_RTOL = 0.9, 0.999, 1e-8, 1e-4


def init_net(dims, seed: int, dtype=torch.float32):
    """The reference's non-negative normal init (cosserat_ode_torch.py:
    90-105) drawn layer by layer from a CPU generator seeded with the run's
    seed: W = |0.01 + 0.01 N(0, 1)| (dout, din), then b = 0.01 N(0, 1)."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for din, dout in zip(dims[:-1], dims[1:]):
        W = (0.01 + 0.01 * torch.randn((dout, din), generator=g,
                                       dtype=dtype)).abs()
        b = 0.01 * torch.randn((dout,), generator=g, dtype=dtype)
        out += [W, b]
    return out


def euler(h: torch.Tensor) -> torch.Tensor:
    """The training loss's quaternion -> Euler map (transformations.py)."""
    hn = h / torch.linalg.vector_norm(h, dim=-1, keepdim=True)
    w, x, y, z = hn.unbind(-1)
    return torch.stack([
        torch.atan2(2 * (w * y + x * z), 1 - 2 * (y * y + z * z)),
        torch.asin(torch.clamp(2 * (w * z - x * y), -1.0, 1.0)),
        torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + z * z))], -1)


def cells(rod: Rod, trajs, controls, keypoints):
    """The per-cell constants of the loss: net inputs x (C, 28), the
    physics-grown state y_base (C, 19), the physics strains (C, 6), the
    targets (C, 19), (C, 6) and the target Euler angles (C, 3), and the
    number of cells of one trajectory."""
    c = rod.c
    kp = torch.as_tensor(list(keypoints), device=trajs.device)
    ys, zs = trajs[:, :-1, :, :19], trajs[:, :-1, :, 19:]
    yp = torch.cat([ys[:, :1], ys[:, :-1]], 1)
    zp = torch.cat([zs[:, :1], zs[:, :-1]], 1)
    yh, zh = c["c1"] * ys + c["c2"] * yp, c["c1"] * zs + c["c2"] * zp
    nxt = trajs[:, 1:]
    y_in = nxt[:, :, kp - 1, :19]
    tf = tendon_forces(rod, controls[:, :-1])[:, :, None, :].expand(
        y_in.shape[:3] + (3,))
    dy, z = rhs(rod, y_in, yh[:, :, kp - 1], zh[:, :, kp - 1], tf)
    x = torch.cat([y_in, z, tf], -1)
    tgt_y = nxt[:, :, kp, :19]
    flat = lambda a: a.reshape(-1, a.shape[-1])
    return dict(x=flat(x), y_base=flat(y_in + c["ds"] * dy), z_phys=flat(z),
                tgt_y=flat(tgt_y), tgt_z=flat(nxt[:, :, kp - 1, 19:]),
                e_tgt=flat(euler(tgt_y[..., 3:7])),
                per_traj=(trajs.shape[1] - 1) * len(keypoints))


def loss_of_output(cl: dict, ds, o: torch.Tensor) -> torch.Tensor:
    """The summed per-trajectory losses given the net's output o (C, 25),
    times ``cl["scale"]`` where a fault sets one."""
    yg = cl["y_base"] + ds * o[:, :19]
    zg = cl["z_phys"] + o[:, 19:]
    n = cl["per_traj"]
    sq = lambda a, b: ((a - b) ** 2).sum()
    loss = (sq(yg[:, 0:3], cl["tgt_y"][:, 0:3]) / (3 * n)
            + sq(yg[:, 7:19], cl["tgt_y"][:, 7:19]) / (12 * n)
            + sq(euler(yg[:, 3:7]), cl["e_tgt"]) / (3 * n)
            + sq(zg, cl["tgt_z"]) / (6 * n))
    return loss * cl.get("scale", 1.0)


def loss_and_grads(rod: Rod, cl: dict, P):
    """(loss, [dW1, db1, dW2, db2]) at P = [W1, b1, W2, b2]."""
    W1, b1, W2, b2 = P
    x = cl["x"]
    pre = rod.mm(x, W1.transpose(0, 1)) + b1
    a = F.elu(pre)
    o = (rod.mm(a, W2.transpose(0, 1)) + b2).detach().requires_grad_(True)
    with torch.enable_grad():
        loss = loss_of_output(cl, rod.c["ds"], o)
        (dO,) = torch.autograd.grad(loss, o)
    dW2 = rod.mm(dO.transpose(0, 1), a)
    dA = rod.mm(dO, W2)
    dPre = dA * torch.where(pre > 0, torch.ones_like(pre), torch.exp(pre))
    dW1 = rod.mm(dPre.transpose(0, 1), x)
    return loss.detach(), [dW1, dPre.sum(0), dW2, dO.sum(0)]


@dataclass
class AdamState:
    """The trained weights [W1, b1, W2, b2] and the optimizer's state: the
    moments, the Adam count, and the plateau's best value, count and
    scale."""
    P: list
    mu: list
    nu: list
    t: int = 0
    best: float = float("inf")
    count: int = 0
    scale: float = 1.0

    @classmethod
    def fresh(cls, P0):
        return cls([p.clone() for p in P0], [torch.zeros_like(p) for p in P0],
                   [torch.zeros_like(p) for p in P0])

    def clone(self):
        c = lambda xs: [x.clone() for x in xs]
        return AdamState(c(self.P), c(self.mu), c(self.nu), self.t,
                         self.best, self.count, self.scale)


@torch.no_grad()
def train(rod: Rod, cl: dict, state: AdamState, epochs: int, lr: float,
          weight_decay: float, factor: float, patience: int,
          clamp: bool = True, keep_at=()):
    """``epochs`` epochs from ``state`` (left as it is): (losses (epochs,),
    the state after them, the first gradient, {k: the state after k
    epochs} for each k in ``keep_at``)."""
    s = state.clone()
    losses, first, kept = [], None, {}
    for e in range(epochs):
        if e in keep_at:
            kept[e] = s.clone()
        loss, g = loss_and_grads(rod, cl, s.P)
        if first is None:
            first = g
        value = float(loss)
        losses.append(value)
        improved = value < (1.0 - PLATEAU_RTOL) * s.best
        if improved:
            s.best = value
        s.count = 0 if improved else s.count + 1
        if s.count == patience:
            s.scale, s.count = s.scale * factor, 0
        s.t += 1
        bc1, bc2 = 1.0 - B1 ** s.t, 1.0 - B2 ** s.t
        for i, p in enumerate(s.P):
            s.mu[i] = (1 - B1) * g[i] + B1 * s.mu[i]
            s.nu[i] = (1 - B2) * g[i] * g[i] + B2 * s.nu[i]
            u = (s.mu[i] / bc1) / (torch.sqrt(s.nu[i] / bc2) + EPS)
            if weight_decay:
                u = u + weight_decay * p
            p.add_(u * (-lr) * s.scale)
        if clamp:
            s.P[0].clamp_(min=0.0)
            s.P[2].clamp_(min=0.0)
    if epochs in keep_at:
        kept[epochs] = s.clone()
    return torch.tensor(losses, dtype=torch.float64), s, first, kept
