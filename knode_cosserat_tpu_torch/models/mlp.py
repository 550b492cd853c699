"""The KNODE residual MLP as an ``nn.Module``.

PyTorch counterpart of ``knode_cosserat_tpu/models/mlp.py``: Linear(in ->
hidden) - activation - ... - Linear(hidden -> 25), input 28 = [y, z,
tendon_forces] or 53 with history, output 25 = residual on [ys(19), z(6)]
(reference cosserat_ode_torch.py:53-105). Weights are ``(dout, din)``,
the JAX package's layout (and ``nn.Linear``'s), so weights move between
the two packages unchanged (:func:`params_from_jax`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import default_device

__all__ = ["MLPSpec", "KnodeMLP", "StackedMLP", "init_mlp", "mlp_apply",
           "mlp_forward",
           "clamp_nonnegative", "count_params", "bind", "params_from_jax",
           "spec_from_params",
           "stacked_params_from_jax", "ACTIVATIONS"]


def _softplus(x):
    # logaddexp(x, 0), as jax.nn.softplus (F.softplus switches to the
    # identity above its threshold, which the JAX package does not)
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


ACTIVATIONS = {
    "tanh": torch.tanh,
    "softplus": _softplus,
    "relu": torch.relu,
    "elu": F.elu,
    "identity": lambda x: x,
}


@dataclasses.dataclass(frozen=True)
class MLPSpec:
    """Static architecture description (hashable).

    dims: layer widths, e.g. (28, 512, 25) for the reference default.
    activation: name from ACTIVATIONS applied between Linear layers.
    history: 53-input variant using [y, yh, z, zh, tf] (cosserat_ode.py:173).
    compute_dtype: optional matmul storage dtype ("bfloat16") for mixed
      precision: each layer's inputs and weights are rounded to it, and the
      product is taken in the caller's dtype (exact for bfloat16 operands,
      summed in float32 or float64), as the JAX package's
      ``jnp.dot(..., preferred_element_type=...)``; the bias add, the
      activation, the output and the master weights stay in the caller's
      dtype, and gradients land on the master weights.
    """
    dims: Tuple[int, ...] = (28, 512, 25)
    activation: str = "elu"
    history: bool = False
    compute_dtype: str | None = None

    @staticmethod
    def for_knode(hidden: int = 512, history: bool = False,
                  activation: str = "elu",
                  compute_dtype: str | None = None) -> "MLPSpec":
        return MLPSpec(dims=(53 if history else 28, hidden, 25),
                       activation=activation, history=history,
                       compute_dtype=compute_dtype)


class KnodeMLP(nn.Module):
    """The residual net: ``layers`` is an ``nn.ModuleList`` of
    ``nn.Linear``, the activation applied between them. ``device``
    defaults to the CUDA card (device.py)."""

    def __init__(self, spec: MLPSpec, dtype=torch.float64, device=None):
        super().__init__()
        device = default_device(device)
        self.spec = spec
        self.layers = nn.ModuleList(
            nn.Linear(din, dout, dtype=dtype, device=device)
            for din, dout in zip(spec.dims[:-1], spec.dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Inputs and weights of different dtypes compute in the wider one
        (JAX's promotion: float32 weights on float64 features give float64,
        with the gradient flowing back to the float32 weights)."""
        return mlp_forward(self.spec, list(self.parameters()), x)

    def weights(self):
        """[(w (dout, din), b (dout,)), ...] per layer."""
        return [(layer.weight, layer.bias) for layer in self.layers]


def mlp_forward(spec: MLPSpec, weights, x: torch.Tensor) -> torch.Tensor:
    """The net's function of its parameters [w1, b1, w2, b2, ...] (in
    ``KnodeMLP.parameters()`` order): a net whose weights are explicit
    arguments (core/stepper.step_residual)."""
    act = ACTIVATIONS[spec.activation]
    n = len(weights) // 2
    for i in range(n):
        x = _linear(spec, x, weights[2 * i], weights[2 * i + 1])
        if i < n - 1:
            x = act(x)
    return x


def _linear(spec: MLPSpec, x, W, b):
    """One layer's x W^T + b in the wider of the two dtypes; with
    ``spec.compute_dtype`` the operands are first rounded to it (the
    product of two bfloat16 numbers is exact in float32, so only the order
    of summation differs from the JAX package's mixed-precision dot). The
    caller keeps TF32 off on a CUDA device (ab_kernels.py does)."""
    dt = torch.promote_types(x.dtype, W.dtype)
    if spec.compute_dtype is None:
        return F.linear(x.to(dt), W.to(dt), b.to(dt))
    cd = getattr(torch, spec.compute_dtype)
    return F.linear(x.to(cd).to(dt), W.to(cd).to(dt), b.to(dt))


def init_mlp(spec: MLPSpec, generator: torch.Generator,
             dtype=torch.float32, device=None) -> KnodeMLP:
    """Non-negative normal init matching non_negative_normal_init
    (cosserat_ode_torch.py:90-105): W = |N(0.01, 0.01)|, b = N(0, 0.01).
    Draws on the CPU from ``generator`` (same numbers on every device)."""
    net = KnodeMLP(spec, dtype=dtype, device=device)
    with torch.no_grad():
        for layer in net.layers:
            dout, din = layer.weight.shape
            w = (0.01 + 0.01 * torch.randn((dout, din), generator=generator,
                                           dtype=dtype)).abs()
            b = 0.01 * torch.randn((dout,), generator=generator, dtype=dtype)
            layer.weight.copy_(w)
            layer.bias.copy_(b)
    return net


def mlp_apply(spec: MLPSpec, params: KnodeMLP, x: torch.Tensor) -> torch.Tensor:
    """Forward pass on (..., din) -> (..., dout) under ``spec`` (its
    compute_dtype included, as the JAX package's mlp_apply takes it)."""
    if params.spec.dims != spec.dims or params.spec.activation != spec.activation:
        raise ValueError(f"net built for {params.spec}, called as {spec}")
    return mlp_forward(spec, list(params.parameters()), x)


def bind(spec: MLPSpec, params: KnodeMLP) -> Callable[[torch.Tensor],
                                                      torch.Tensor]:
    """Close the weights over the apply function -> an ``nn_fn`` for
    core.rhs / core.stepper."""
    return lambda x: mlp_apply(spec, params, x)


def clamp_nonnegative(params: KnodeMLP, skip_first: bool = False) -> KnodeMLP:
    """Post-step weight clamp (physics_train.py:299-304), in place."""
    with torch.no_grad():
        for i, layer in enumerate(params.layers):
            if not (skip_first and i == 0):
                layer.weight.clamp_(min=0.0)
    return params


def count_params(params: KnodeMLP) -> int:
    return sum(int(t.numel()) for t in params.parameters())


def spec_from_params(params, activation: str = "elu") -> MLPSpec:
    """The MLPSpec of the JAX package's params (a tuple of {"w" (dout, din),
    "b"} per layer, any depth): the widths from the weights' shapes, the
    history form when the net takes 53 inputs."""
    dims = [int(np.shape(params[0]["w"])[1])]
    dims += [int(np.shape(layer["w"])[0]) for layer in params]
    return MLPSpec(dims=tuple(dims), activation=activation,
                   history=dims[0] == 53)


def params_from_jax(params, spec: MLPSpec | None = None, dtype=None,
                    device=None) -> KnodeMLP:
    """The JAX package's params (a tuple of {"w" (dout, din), "b" (dout,)}
    arrays, any depth) -> a KnodeMLP computing the same function.
    ``spec`` defaults to :func:`spec_from_params` (ELU); ``dtype`` to the
    arrays' dtype."""
    ws = [torch.from_numpy(np.array(layer["w"])) for layer in params]
    bs = [torch.from_numpy(np.array(layer["b"])) for layer in params]
    spec = spec or spec_from_params(params)
    dtype = dtype or ws[0].dtype
    net = KnodeMLP(spec, dtype=dtype, device=device)
    if len(ws) != len(net.layers):
        raise ValueError(f"{len(ws)} layers given, spec has {len(net.layers)}")
    with torch.no_grad():
        for layer, w, b in zip(net.layers, ws, bs):
            layer.weight.copy_(w)
            layer.bias.copy_(b)
    return net


class StackedMLP(nn.Module):
    """G nets of one spec stacked on a leading axis: the JAX package's
    ``vmap``-ed per-cell params (the eval rollouts of a grid, K5's nets).

    ``weights()`` gives ``[(w (G, dout, din), b (G, dout)), ...]``. As an
    ``nn_fn`` it takes inputs whose leading axis holds G equal, contiguous
    groups of rows (rods, or rods x probes repeated per rod) and applies
    net g to group g, one ``F.linear`` per net, so each net sees exactly
    the rows a single-net call on its own rods gives it. ``along(axis)``
    groups another axis instead (a stack of rods behind the Newton
    probes' copies: axis -2)."""

    def __init__(self, nets):
        super().__init__()
        nets = list(nets)
        if not nets:
            raise ValueError("no nets to stack")
        self.spec = nets[0].spec
        if any(n.spec != self.spec for n in nets):
            raise ValueError("stacked nets must share one spec")
        n_layers = len(nets[0].layers)
        # registered w, b per layer in order, as KnodeMLP.parameters() gives
        self.flat = nn.ParameterList(
            torch.stack([getattr(n.layers[i], name).detach() for n in nets])
            for i in range(n_layers) for name in ("weight", "bias"))

    def __len__(self) -> int:
        return self.flat[0].shape[0]

    def weights(self):
        """[(w (G, dout, din), b (G, dout)), ...] per layer."""
        return [(self.flat[i], self.flat[i + 1])
                for i in range(0, len(self.flat), 2)]

    def unstack(self):
        """The G nets as KnodeMLPs (copies)."""
        w = self.flat[0]
        nets = []
        for g in range(len(self)):
            net = KnodeMLP(self.spec, dtype=w.dtype, device=w.device)
            with torch.no_grad():
                for P, Q in zip(net.parameters(), self.flat):
                    P.copy_(Q[g])
            nets.append(net)
        return nets

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._grouped(x, 0)

    def along(self, axis: int) -> Callable[[torch.Tensor], torch.Tensor]:
        """The stack as an ``nn_fn`` whose G groups of rows lie along
        ``axis`` of its inputs (axis 0: the module itself)."""
        return lambda x: self._grouped(x, axis)

    def _grouped(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        G = len(self)
        x = x.movedim(axis, 0)
        if x.shape[0] % G:
            raise ValueError(f"{x.shape[0]} rows do not split into {G} nets")
        act = ACTIVATIONS[self.spec.activation]
        layers = self.weights()
        groups = x.reshape((G, -1) + tuple(x.shape[1:]))
        outs = []
        for g in range(G):
            h = groups[g]
            for i, (W, b) in enumerate(layers):
                h = _linear(self.spec, h, W[g], b[g])
                if i < len(layers) - 1:
                    h = act(h)
            outs.append(h)
        out = torch.stack(outs).reshape(tuple(x.shape[:-1])
                                        + (outs[0].shape[-1],))
        return out.movedim(0, axis)


def stacked_params_from_jax(trees, spec: MLPSpec, dtype=None,
                            device=None) -> StackedMLP:
    """A list of the JAX package's per-cell params (``GridResult.params``)
    -> one StackedMLP."""
    return StackedMLP([params_from_jax(t, spec, dtype, device) for t in trees])
