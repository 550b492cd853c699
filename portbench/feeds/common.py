"""What the feeds share: the configuration's rod and net handed to the
program and to the reference alike, and the seeded schedules."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..reference import rod as R


def dtype_of(cfg):
    return getattr(torch, cfg["dtype"])


def port_rod(run):
    """The program's rod, built by the program from the configuration."""
    from knode_cosserat_tpu_torch.core.params import make_rod

    kw = {k: np.asarray(v, np.float64) for k, v in run.cfg["rod"].items()}
    return make_rod(N=run.cfg["N"], dtype=dtype_of(run.cfg),
                    device=run.device, **kw)


def ref_rod(run, dtype=torch.float64, tf32=False) -> R.Rod:
    return R.derive(run.cfg["rod"], run.cfg["N"], dtype, run.device, tf32)


def spec_of(cfg):
    from knode_cosserat_tpu_torch.models.mlp import MLPSpec

    n = cfg["net"]
    return MLPSpec(dims=tuple(n["dims"]), activation=n["activation"],
                   history=n["history"])


def seeded_weights(run, g):
    """[W1, b1, W2, b2] in the configuration's dtype on the device in one
    draw: the reference init |0.01 + 0.01 N| for weights and 0.01 N for
    biases, times the configuration's weight scale."""
    din, hidden, dout = run.cfg["net"]["dims"]
    shapes = [(hidden, din), (hidden,), (dout, hidden), (dout,)]
    x = torch.randn(sum(math.prod(s) for s in shapes), generator=g,
                    device=run.device, dtype=dtype_of(run.cfg))
    scale = float(run.cfg["net"]["weight_scale"])
    out, i = [], 0
    for k, s in enumerate(shapes):
        n = math.prod(s)
        v = x[i:i + n].reshape(s)
        out.append(((0.01 + 0.01 * v).abs() if k % 2 == 0 else 0.01 * v)
                   * scale)
        i += n
    return out


def port_net(run, weights):
    """The program's net object holding the seeded weights."""
    from knode_cosserat_tpu_torch.models.mlp import KnodeMLP

    net = KnodeMLP(spec_of(run.cfg), dtype=dtype_of(run.cfg),
                   device=run.device)
    with torch.no_grad():
        for P, w in zip(net.parameters(), weights):
            P.copy_(w)
    return net


def periods(run, g, n: int):
    """n sine periods (s) on the device: the midpoints of n equal parts of
    the traffic's range in an order drawn from the seed, so that every
    seed gives the same work in another order."""
    lo, hi = run.traffic["schedule"]["period_s"]
    grid = lo + (hi - lo) * (torch.arange(n, dtype=torch.float64,
                                          device=run.device) + 0.5) / n
    return grid[torch.randperm(n, generator=g, device=run.device)]


def sine_tensions(periods: torch.Tensor, del_t: float, T: int):
    """(..., T, 4) tensions: 4 tendons at 6 N +- 1 N, a quarter period
    apart, at steps 1..T (physics_controls.py:7-13), float32."""
    i = torch.arange(1, T + 1, dtype=torch.float64, device=periods.device)
    k = torch.arange(4, dtype=torch.float64, device=periods.device)
    ang = (2 * math.pi * del_t * i[:, None] / periods[..., None, None]
           + k * (math.pi / 2))
    return (6.0 + torch.sin(ang)).to(torch.float32)
