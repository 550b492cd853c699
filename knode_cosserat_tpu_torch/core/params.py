"""Rod parameters as a frozen dataclass of tensors.

PyTorch counterpart of ``knode_cosserat_tpu/core/params.py``. The derived
terms are computed by :func:`derive` in float64 torch operations,
differentiable in the base parameters (for conditioning, including the
``v_rest`` precompute that keeps the float32 path exact), and then cast to
the requested dtype. ``RodParams.to`` moves
every tensor leaf to a device and/or dtype.

State conventions:
  y (19,) = [p(3), h(4), n(3), m(3), q(3), w(3)]
  z  (6,) = [v(3), u(3)]
All layouts are state-last: ``(..., N, 19)``.

A stack of R rods (:func:`stack_params`; the JAX package's rods stacked on
a leading axis for ``jax.vmap``) is one RodParams whose leaves carry the
rods first: scalars (R, 1), vectors (R, k), matrices (R, 3, 3), so the rod
axis sits just left of a state's last axis and broadcasts from the right
against per-node states (..., R, k). ``derive`` and the physics core
(core/rhs.py, core/spatial.py, core/stepper.py) take such a stack;
:func:`align_rods` lines it up with states that carry more axes between
the rod axis and the state axis.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from ..device import default_device

__all__ = [
    "RodParams",
    "make_rod",
    "derive",
    "experimental_rod",
    "original_rod",
    "apply_mod",
    "rod_from_numpy",
    "stack_params",
    "unstack_params",
    "rod_at",
    "repeat_rods",
    "align_rods",
    "MODS",
    "MODS_ORIGINAL",
]

_STATIC = ("N", "n_tendons")
# the leaves that are 0-dim for one rod (a stack holds them as (R, 1)),
# and the (3, 3) / (n_tendons, 3) ones; every other leaf is a vector
_SCALARS = frozenset(("L", "E", "r", "rho", "del_t", "T0", "tendon_offset",
                      "A", "Gmod", "ds", "c0", "c1", "c2", "rhoA"))
_MATRICES = frozenset(("Bse", "Bbt", "tendon_dirs", "J", "Kse", "Kbt",
                       "Kse_c0Bse_inv", "Kbt_c0Bbt_inv", "rhoJ"))
_BASE = ("L", "E", "r", "rho", "vstar", "g", "Bse", "Bbt", "C", "del_t",
         "F_tip", "M_tip", "T0", "tendon_offset", "tendon_dirs", "p0", "h0",
         "q0", "w0")


def _ndim(name: str) -> int:
    """A leaf's number of axes in one rod."""
    return 0 if name in _SCALARS else 2 if name in _MATRICES else 1


@dataclasses.dataclass(frozen=True)
class RodParams:
    """Physical + derived parameters for one tendon-driven Cosserat rod.

    ``N`` (node count) and ``n_tendons`` are Python ints; every other field
    is a tensor (derived fields are ``None`` until :func:`derive`)."""

    N: int
    n_tendons: int

    # --- base physical parameters ---
    L: Any
    E: Any
    r: Any
    rho: Any
    vstar: Any          # (3,)
    g: Any              # (3,)
    Bse: Any            # (3,3)
    Bbt: Any            # (3,3)
    C: Any              # (3,)
    del_t: Any
    F_tip: Any          # (3,)
    M_tip: Any          # (3,)
    T0: Any
    tendon_offset: Any
    tendon_dirs: Any    # (n_tendons, 3)

    # --- boundary conditions ---
    p0: Any             # (3,)
    h0: Any             # (4,)
    q0: Any             # (3,)
    w0: Any             # (3,)

    # --- derived (filled by `derive`) ---
    A: Any = None
    Gmod: Any = None
    ds: Any = None
    J: Any = None               # (3,3)
    Kse: Any = None             # (3,3)
    Kbt: Any = None             # (3,3)
    c0: Any = None
    c1: Any = None
    c2: Any = None
    Kse_c0Bse_inv: Any = None   # (3,3)
    Kbt_c0Bbt_inv: Any = None   # (3,3)
    Kse_vstar: Any = None       # (3,)
    # Kse_c0Bse_inv @ Kse_vstar, precomputed in f64 (derive) so the f32
    # path avoids adding O(1e5) stiffness terms to O(1) internal forces
    v_rest: Any = None          # (3,)
    rhoA: Any = None
    rhoAg: Any = None           # (3,)
    rhoJ: Any = None            # (3,3)

    def replace(self, **kw) -> "RodParams":
        return dataclasses.replace(self, **kw)

    def leaves(self):
        """(name, tensor) for every tensor field, in declaration order."""
        return [(f.name, getattr(self, f.name))
                for f in dataclasses.fields(self)
                if f.name not in _STATIC and getattr(self, f.name) is not None]

    def to(self, device=None, dtype=None) -> "RodParams":
        """Copy with every tensor leaf moved to ``device`` / cast to
        ``dtype``. Cast down from a float64 rod (as :func:`derive` does),
        never up from a float32 one."""
        return self.replace(**{k: v.to(device=device, dtype=dtype)
                               for k, v in self.leaves()})

    @property
    def dtype(self) -> torch.dtype:
        return self.L.dtype

    @property
    def device(self) -> torch.device:
        return self.L.device

    @property
    def n_rods(self) -> int | None:
        """R for a stack of R rods (:func:`stack_params`), None for one."""
        return int(self.L.shape[0]) if np.ndim(self.L) else None


def derive(p: RodParams, dtype: torch.dtype = torch.float64,
           device=None) -> RodParams:
    """Fill the derived terms (reference cosserat_ode.py:58-78): float64
    torch operations, differentiable in every base leaf, cast to ``dtype``
    on ``device`` (default: the CUDA card, see device.py) at the end, so a
    float32 rod keeps the float64 conditioning of ``v_rest``. This one
    function is both of the JAX package's derives: the host ``derive`` and
    the traced ``derive_traced`` that system identification differentiates
    (training/sysid.py).

    The arithmetic runs on the CPU whatever the rod's device (the leaves
    move there and back, differentiably): its values are then the JAX host
    derive's bit for bit, and a rod built on the card equals the one built
    on the CPU (the card's float64 ``pow`` may round differently by an
    ulp, which moves Newton stop tests that sit at the tolerance).

    A base leaf with a leading rod axis (a stack, or one fitted leaf per
    start: scalars (R,) or (R, 1)) makes the result a stack of R rods, the
    other leaves shared by all R. Rod i of the stack equals the derive of
    rod i alone, bit for bit: the batched operations are elementwise over
    the rods, the 3x3 inverses one LU each."""
    device = default_device(device)
    f = lambda x: torch.as_tensor(x, dtype=torch.float64, device="cpu")
    base = {k: f(getattr(p, k)) for k in _BASE}
    R = next((int(v.shape[0]) for k, v in base.items()
              if v.dim() > _ndim(k)), None)
    if R is not None:
        # every base leaf on the rod axis; scalars (R,) while computing
        base = {k: (v.reshape(-1).expand(R) if k in _SCALARS
                    else v.expand((R,) + v.shape[v.dim() - _ndim(k):]))
                for k, v in base.items()}
    L, E, r, rho, del_t = (base[k] for k in ("L", "E", "r", "rho", "del_t"))
    Bse, Bbt, vstar, g = (base[k] for k in ("Bse", "Bbt", "vstar", "g"))
    mat = lambda s: s[..., None, None]          # a scalar against a 3x3

    A = math.pi * r ** 2
    Gmod = E / (2 * (1 + 0.3))
    ds = L / (p.N - 1)
    # rod by rod: the CPU's vectorized pow, which takes batches of 8 and
    # more, may round an ulp away from the scalar one
    r4 = r ** 4 if R is None else torch.stack([x ** 4 for x in r.unbind()])
    J = torch.diag_embed(torch.stack([math.pi * r4 / 4, math.pi * r4 / 4,
                                      math.pi * r4 / 2], -1))
    Kse = torch.diag_embed(torch.stack([Gmod * A, Gmod * A, E * A], -1))
    Kbt = torch.diag_embed(torch.stack([E * J[..., 0, 0], E * J[..., 1, 1],
                                        Gmod * J[..., 2, 2]], -1))

    c0 = 1.5 / del_t
    c1 = -2.0 / del_t
    c2 = 0.5 / del_t

    Kse_c0Bse_inv = torch.linalg.inv(Kse + mat(c0) * Bse)
    Kbt_c0Bbt_inv = torch.linalg.inv(Kbt + mat(c0) * Bbt)
    Kse_vstar = (Kse * vstar.unsqueeze(-2)).sum(-1)
    v_rest = (Kse_c0Bse_inv * Kse_vstar.unsqueeze(-2)).sum(-1)

    rhoA = rho * A
    out = dict(base, A=A, Gmod=Gmod, ds=ds, J=J, Kse=Kse, Kbt=Kbt, c0=c0,
               c1=c1, c2=c2, Kse_c0Bse_inv=Kse_c0Bse_inv,
               Kbt_c0Bbt_inv=Kbt_c0Bbt_inv, Kse_vstar=Kse_vstar,
               v_rest=v_rest, rhoA=rhoA,
               rhoAg=rhoA[..., None] * g,
               rhoJ=mat(rho) * J)

    def cast(k, x):
        if R is not None and k in _SCALARS:
            x = x.unsqueeze(-1)
        return x.to(device=device, dtype=dtype)

    return p.replace(**{k: cast(k, v) for k, v in out.items()})


def stack_params(rods) -> RodParams:
    """R rods of one N and n_tendons as a stack (module docstring): every
    leaf stacked on a leading rod axis, scalars as (R, 1)."""
    rods = list(rods)
    kw = {}
    for k, _ in rods[0].leaves():
        t = torch.stack([getattr(q, k) for q in rods])
        kw[k] = t[:, None] if k in _SCALARS else t
    return rods[0].replace(**kw)


def rod_at(p: RodParams, i: int) -> RodParams:
    """Rod ``i`` of a stack, its leaves views of the stack's."""
    return p.replace(**{k: v[i, 0] if k in _SCALARS else v[i]
                        for k, v in p.leaves()})


def unstack_params(p: RodParams) -> tuple:
    """The R rods of a stack (:func:`rod_at` each)."""
    return tuple(rod_at(p, i) for i in range(p.n_rods))


def repeat_rods(p: RodParams, n: int) -> RodParams:
    """A stack of R rods as one of R * n, each rod repeated ``n`` times in
    a row (rod-major: row ``i * n + b`` is rod ``i``), so the rods pair
    with n schedules each on one flat batch axis."""
    return p.replace(**{k: v.repeat_interleave(n, dim=0)
                        for k, v in p.leaves()})


def align_rods(p: RodParams, n: int) -> RodParams:
    """A stack whose leaves carry ``n`` unit axes between the rod axis and
    their own axes, so they broadcast against states (R, *n axes, k)."""
    return p.replace(**{k: v.reshape(v.shape[:1] + (1,) * n + v.shape[1:])
                        for k, v in p.leaves()})


def _host(x):
    """A leaf as float64 numpy on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return x


def make_rod(N: int = 10, dtype: torch.dtype = torch.float64, device=None,
             **overrides) -> RodParams:
    """Rod with the reference's default ("paper") parameters
    (cosserat_ode.py:14-47): L=0.4 m, E=109 GPa, r=1.2 mm, rho=8000,
    4 tendons at 45-degree-offset directions, cantilever base BCs."""
    n_tendons = int(overrides.pop("n_tendons", 4))
    theta = np.pi / n_tendons
    tendon_dirs = np.array([
        [np.cos(theta + k * np.pi / 2), np.sin(theta + k * np.pi / 2), 0.0]
        for k in range(4)
    ])
    base = dict(
        N=N, n_tendons=n_tendons,
        L=0.4, E=109e9, r=0.0012, rho=8000.0,
        vstar=np.array([0.0, 0.0, 1.0]),
        g=np.array([0.0, 0.0, -9.81]),
        Bse=np.zeros((3, 3)),
        Bbt=np.diag([3e-2, 3e-2, 3e-2]),
        C=np.array([1e-4, 1e-4, 1e-4]),
        del_t=0.005,
        F_tip=np.zeros(3), M_tip=np.zeros(3),
        T0=5.0, tendon_offset=0.02, tendon_dirs=tendon_dirs,
        p0=np.zeros(3), h0=np.array([1.0, 0.0, 0.0, 0.0]),
        q0=np.zeros(3), w0=np.zeros(3),
    )
    base.update(overrides)
    return derive(RodParams(**base), dtype=dtype, device=device)


# --- configurations + perturbation "mods" (fault-injection registry) -------

MODS = ("noair", "nsw", "short", "damping", "dampstiff", "lengthstiff", "youngs")
MODS_ORIGINAL = ("nsw", "short", "damping", "diameter", "youngs", "dampstiff",
                 "lengthstiff")


def experimental_rod(mod: str | None = None, N: int = 10,
                     dtype: torch.dtype = torch.float64,
                     device=None) -> RodParams:
    """Measured-hardware (Delrin rod) parameters + optional perturbation mod
    (reference: knode.py:6-53). Mods deliberately inject wrong physics that
    the KNODE residual must compensate for."""
    kw = dict(del_t=0.05, L=0.635, tendon_offset=0.04445,
              r=0.003175, rho=1411.6751, E=2.757903e9)
    Bbt = 3e-2
    if mod is None:
        pass
    elif mod == "noair":
        kw["C"] = np.zeros(3)
    elif mod == "nsw":
        kw["g"] = np.zeros(3)
    elif mod == "short":
        kw["L"] = 0.4
    elif mod == "damping":
        Bbt = 0.2
    elif mod == "dampstiff":
        Bbt, kw["E"] = 0.2, 10e9
    elif mod == "lengthstiff":
        kw["L"], kw["E"] = 0.4, 10e9
    elif mod == "youngs":
        kw["E"] = 10e9
    else:
        raise ValueError(f"Unknown mod {mod!r}")
    kw["Bbt"] = np.diag([Bbt, Bbt, Bbt])
    return make_rod(N=N, dtype=dtype, device=device, **kw)


def original_rod(mod: str | None = None, N: int = 10,
                 dtype: torch.dtype = torch.float64, device=None) -> RodParams:
    """Original-paper parameters + mods (reference: prepare.py:35-73)."""
    kw = dict(del_t=0.005, L=0.4, E=209e9, r=0.0012, rho=8000.0)
    Bbt = 5e-4
    if mod is None:
        pass
    elif mod == "nsw":
        kw["g"] = np.zeros(3)
    elif mod == "short":
        kw["L"] = 0.3
    elif mod == "damping":
        Bbt = 9e-4
    elif mod == "diameter":
        kw["r"] = 0.002
    elif mod == "youngs":
        kw["E"] = 109e9
    elif mod == "dampstiff":
        Bbt, kw["E"] = 3e-2, 109e9
    elif mod == "lengthstiff":
        kw["L"], kw["E"] = 0.3, 109e9
    else:
        raise ValueError(f"Unknown mod {mod!r}")
    kw["Bbt"] = np.diag([Bbt, Bbt, Bbt])
    return make_rod(N=N, dtype=dtype, device=device, **kw)


def apply_mod(mod: str | None, original: bool = False, N: int = 10,
              dtype: torch.dtype = torch.float64, device=None) -> RodParams:
    """Dispatch matching reference setup_robot(robot, mod, original)."""
    if original:
        return original_rod(mod, N=N, dtype=dtype, device=device)
    return experimental_rod(mod, N=N, dtype=dtype, device=device)


def rod_from_numpy(p, dtype: torch.dtype | None = None,
                   device=None) -> RodParams:
    """Build a RodParams from any object with the same field names (e.g. the
    JAX package's rod), reading every leaf through ``np.asarray``. The
    leaves are taken as they are (no re-derivation); ``dtype`` defaults to
    the source leaves' dtype, ``device`` to the CUDA card (device.py)."""
    device = default_device(device)
    kw = {}
    for f in dataclasses.fields(RodParams):
        v = getattr(p, f.name)
        if f.name in _STATIC:
            kw[f.name] = int(v)
        elif v is not None:
            t = torch.from_numpy(np.array(v))       # a writable copy
            kw[f.name] = t.to(device=device, dtype=dtype or t.dtype)
        else:
            kw[f.name] = None
    return RodParams(**kw)
