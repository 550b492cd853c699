"""The ("data", "seq", "model") device mesh and its placements.

PyTorch counterpart of ``knode_cosserat_tpu/parallel/mesh.py``. The mesh is
a ``torch.distributed.device_mesh.DeviceMesh`` over every rank of the
process group (one rank per card with NCCL, or per CPU worker with gloo),
laid out row-major as (data, seq, model) like the JAX package's
``np.reshape`` of its device list:

  data   the batch axis: trajectories, or the experiment grid's cells (DP);
  seq    the sequence axis: the rollout's time transitions in training (SP)
         and the rod's segments in multiple shooting;
  model  the KNODE net's hidden units (TP).

Axes of size 1 still exist, so placements read the same for every mesh
shape. Where the JAX package hands a ``NamedSharding`` to ``device_put``,
a :class:`Placement` here does the work itself: ``shard(t)`` gives this
rank's slice of a whole tensor and ``gather(t)`` the whole tensor back
from every rank's slice (``all_gather`` over the axis).

One deviation from the JAX package: a torch mesh spans the whole world,
so a mesh smaller than the number of ranks raises (JAX takes the first
devices). ``make_mesh`` with no process group starts a world of one for a
1 x 1 x 1 mesh and raises for a larger one (start the ranks with
``torchrun``, or call parallel/distributed.init_distributed).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..device import default_device

__all__ = ["make_mesh", "data_sharding", "replicated", "shard_params_tp",
           "load_params_tp", "P", "Mesh", "Placement", "AXES"]

AXES = ("data", "seq", "model")


class P(tuple):
    """A partition spec, as ``jax.sharding.PartitionSpec``: one entry per
    tensor dimension, the mesh axis it is split over or None."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)


class Mesh:
    """A ("data", "seq", "model") mesh over the process group.

    ``shape`` is {"data": d, "seq": s, "model": m}; ``index(axis)`` is this
    rank's coordinate on an axis, ``group(axis)`` the process group of the
    ranks that differ only there, and ``device`` the rank's device (its
    card with NCCL, the CPU with gloo)."""

    axis_names = AXES

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.shape = dict(zip(AXES, (int(n) for n in device_mesh.shape)))
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if device_mesh.device_type == "cuda"
                       else torch.device("cpu"))
        coord = device_mesh.get_coordinate()
        self._coord = dict(zip(AXES, coord))

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["seq"] * self.shape["model"]

    def index(self, axis: str) -> int:
        return int(self._coord[axis])

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def all_reduce(self, t: torch.Tensor, axes: Sequence[str]):
        """Sum ``t`` in place over the ranks that differ on ``axes`` (one
        all-reduce per axis of size > 1)."""
        for axis in axes:
            if self.shape[axis] > 1:
                dist.all_reduce(t, group=self.group(axis))
        return t

    def all_gather(self, t: torch.Tensor, axis: str) -> list:
        """Every rank's ``t`` along ``axis``, in coordinate order."""
        n = self.shape[axis]
        if n == 1:
            return [t]
        out = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(out, t.contiguous(), group=self.group(axis))
        return out

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, seq={self.shape['seq']}, "
                f"model={self.shape['model']}, {self.device_mesh.device_type})")


def _start_world_of_one(devices):
    dev = default_device(devices if isinstance(devices, (str, torch.device))
                         else None)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)


def make_mesh(data: int = -1, model: int = 1, seq: int = 1,
              devices=None) -> Mesh:
    """Build a ("data", "seq", "model") mesh over every rank of the process
    group. data=-1 takes the ranks left over from model x seq. ``devices``:
    the device type ("cuda" or "cpu") for a world this call starts itself
    (no process group yet and a 1 x 1 x 1 mesh; default the card); with a
    group, the device follows its backend (NCCL: the rank's card, gloo:
    the CPU)."""
    if not dist.is_initialized():
        if (data in (-1, 1)) and model == 1 and seq == 1:
            _start_world_of_one(devices)
        else:
            raise RuntimeError(
                f"mesh {data}x{seq}x{model}: no process group; start one "
                "rank per device with torchrun (or call "
                "parallel.init_distributed) before make_mesh")
    n = dist.get_world_size()
    if data == -1:
        if n % (model * seq):
            raise ValueError(f"{n} devices not divisible by "
                             f"model*seq={model * seq}")
        data = n // (model * seq)
    if data * model * seq > n:
        raise ValueError(f"mesh {data}x{seq}x{model} needs "
                         f"{data * model * seq} devices, have {n}")
    if data * model * seq < n:
        raise ValueError(f"mesh {data}x{seq}x{model} covers "
                         f"{data * model * seq} of {n} ranks; a torch mesh "
                         "spans the whole world")
    from torch.distributed.device_mesh import init_device_mesh

    dev_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(init_device_mesh(dev_type, (data, seq, model),
                                 mesh_dim_names=AXES))


class Placement:
    """A tensor's layout on the mesh (``spec``: the axis each dimension is
    split over, or None): ``span`` is this rank's share of a dimension,
    ``shard`` cuts this rank's slice out of a whole tensor, ``gather`` puts
    the whole tensor back together."""

    def __init__(self, mesh: Mesh, spec: P):
        self.mesh, self.spec = mesh, P(*spec)

    def span(self, n: int, dim: int = 0) -> slice:
        """This rank's contiguous share of a dimension ``dim`` of length
        ``n`` (all of it where the dimension is not split)."""
        axis = self.spec[dim] if dim < len(self.spec) else None
        if axis is None or self.mesh.shape[axis] == 1:
            return slice(0, n)
        k = self.mesh.shape[axis]
        if n % k:
            raise ValueError(f"dimension {dim} ({n}) does not split over "
                             f"{axis}={k}")
        i = self.mesh.index(axis)
        return slice(i * (n // k), (i + 1) * (n // k))

    def shard(self, t: torch.Tensor) -> torch.Tensor:
        for dim in range(len(self.spec)):
            t = t[(slice(None),) * dim + (self.span(t.shape[dim], dim),)]
        return t.contiguous()

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        for dim in reversed(range(len(self.spec))):
            axis = self.spec[dim]
            if axis is None or self.mesh.shape[axis] == 1:
                continue
            t = torch.cat(self.mesh.all_gather(t, axis), dim=dim)
        return t

    def __repr__(self) -> str:
        return f"Placement({self.spec})"


def data_sharding(mesh: Mesh, ndim: int = 1,
                  seq_axis: Optional[int] = None) -> Placement:
    """Split the leading axis over "data" (and axis ``seq_axis`` over
    "seq"), replicate the rest."""
    spec = ["data"] + [None] * (ndim - 1)
    if seq_axis is not None:
        spec[seq_axis] = "seq"
    return Placement(mesh, P(*spec))


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, P())


def shard_params_tp(mesh: Mesh, params):
    """Tensor-parallel placements for a KNODE net's layers (``params``: any
    sequence with one entry per layer): layer 0's output rows (its weight's
    rows and its bias) and the last layer's input columns split over
    "model", everything else replicated, as the JAX package's placement.
    Returns ({"w": Placement, "b": Placement}, ...) per layer."""
    n = len(params)
    out = []
    for i in range(n):
        if i == 0:
            s = {"w": P("model", None), "b": P("model")}
        elif i == n - 1:
            s = {"w": P(None, "model"), "b": P()}
        else:
            s = {"w": P(), "b": P()}
        out.append({k: Placement(mesh, v) for k, v in s.items()})
    return tuple(out)


def load_params_tp(mesh: Mesh, params, dtype=None, device=None):
    """The whole net's weights in, this rank's tensor-parallel shard out:
    ``params`` in the JAX package's layout (({"w", "b"}, ...) per layer,
    numpy, jax or torch arrays; a checkpoint's "params"), returned as
    [w0, b0, w1, b1, ...] tensors (``shard_params_tp``'s slices) on
    ``device`` (default the mesh's) in ``dtype`` (default the arrays')."""
    import numpy as np

    device = device if device is not None else mesh.device
    out = []
    for layer, pl in zip(params, shard_params_tp(mesh, params)):
        for key in ("w", "b"):
            a = layer[key]
            t = (a.detach() if isinstance(a, torch.Tensor)
                 else torch.from_numpy(np.array(a)))
            out.append(pl[key].shard(t.to(device=device,
                                          dtype=dtype or t.dtype)))
    return out
