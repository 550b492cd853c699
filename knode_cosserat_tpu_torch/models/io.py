"""Interop with reference checkpoints.

PyTorch-port counterpart of ``knode_cosserat_tpu/models/io.py``. The
reference saves whole-robot torch pickles ({'robot': CosseratRodTorch,
'dtw', 'loss', 'optim'}, physics_train.py:284-288). Users migrating from it
have directories of such .pth files; ``load_reference_pth`` converts one
into (MLPSpec, KnodeMLP) usable by the port's hybrid rollout / training —
the replacement for the reference's numpy re-execution shim
(cosserat_ode.py:81-112).

Unpickling needs the reference classes importable; pass ``reference_path``
pointing at the reference checkout (its knode_cosserat directory).
"""
from __future__ import annotations

import sys
from typing import Optional, Tuple

import torch

from .mlp import KnodeMLP, MLPSpec

__all__ = ["load_reference_pth", "params_from_torch_modules"]

_ACT_NAMES = {"ELU": "elu", "Tanh": "tanh", "ReLU": "relu",
              "Softplus": "softplus"}


def params_from_torch_modules(nn_models, dtype=torch.float32, device=None
                              ) -> Tuple[MLPSpec, KnodeMLP]:
    """Convert a torch ModuleList of Linear/activation layers (the
    reference's robot.nn_models) into (MLPSpec, KnodeMLP) in ``dtype`` on
    ``device`` (default the CUDA card, device.py)."""
    weights = []
    dims = []
    activation = "elu"
    for mod in nn_models:
        name = type(mod).__name__
        if name == "Linear":
            w = mod.weight.detach().cpu()
            weights.append((w, mod.bias.detach().cpu()))
            if not dims:
                dims.append(w.shape[1])
            dims.append(w.shape[0])
        elif name in _ACT_NAMES:
            activation = _ACT_NAMES[name]
        elif name == "Dropout":
            continue  # inference no-op, matching cosserat_ode.py:107-108
        else:
            raise ValueError(f"unsupported layer {name}")
    spec = MLPSpec(dims=tuple(dims), activation=activation,
                   history=(dims[0] == 53))
    net = KnodeMLP(spec, dtype=dtype, device=device)
    with torch.no_grad():
        for layer, (w, b) in zip(net.layers, weights):
            layer.weight.copy_(w)
            layer.bias.copy_(b)
    return spec, net


def load_reference_pth(path: str,
                       reference_path: Optional[str] = None,
                       dtype=torch.float32, device=None):
    """Load a reference .pth checkpoint.

    .. warning::
       Reference checkpoints pickle the ENTIRE robot object
       (physics_train.py:284-288), so this must unpickle with
       ``weights_only=False`` — which executes arbitrary code embedded in
       the pickle. Only load ``.pth`` files from sources you trust.
       (Checkpoints produced by this package are plain npz+JSON trees,
       training/checkpoint.py, and have no such hazard.)

    Returns dict with keys: spec, params (a KnodeMLP), and whichever of
    loss/dtw the checkpoint carried."""
    import logging
    logging.getLogger(__name__).warning(
        "load_reference_pth(%s): unpickling with weights_only=False "
        "executes code embedded in the file; load only trusted .pth files",
        path)
    if reference_path and reference_path not in sys.path:
        sys.path.insert(0, reference_path)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    robot = ckpt["robot"]
    spec, params = params_from_torch_modules(robot.nn_models, dtype, device)
    out = {"spec": spec, "params": params}
    for k in ("loss", "dtw"):
        if k in ckpt:
            out[k] = ckpt[k]
    return out
