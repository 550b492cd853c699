"""The device the port's constructors build on when the caller names none.

Every constructor that makes tensors from nothing (rods, nets) takes a
``device`` argument and, when it is None, asks :func:`default_device`: the
CUDA card. Without a card that is an error, never a silent move to the
CPU; the CPU is used when the caller passes ``device="cpu"``, as the tests
do. Everything downstream follows the device of the rod or the tensors it
is given.
"""
from __future__ import annotations

import torch

__all__ = ["default_device"]


def default_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the CUDA card, and
    raises when no card is present."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: knode_cosserat_tpu_torch builds on "
            "the GPU by default; pass device='cpu' to build on the CPU")
    return torch.device("cuda")
