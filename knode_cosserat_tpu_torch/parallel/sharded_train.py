"""KNODE training over a device mesh: ``train_knode(mesh=...)``'s machinery,
and ``ShardedTrainer``, its deprecated alias.

PyTorch counterpart of ``knode_cosserat_tpu/parallel/sharded_train.py``
and of the mesh branch of ``knode_cosserat_tpu/training/train.py``, where
GSPMD places the arrays and inserts the collectives. Here the placements
and collectives are written out (parallel/mesh.py):

  DP   the trajectories split over "data", when their count divides the
       axis (else every data rank holds them all, as JAX replicates them);
  SP   the time transitions split over "seq": a rank holds the frames of
       its transitions, the frame after its last one (the truth of the
       next step) and the frame before its first one (the BDF-2 history's
       previous step), so the teacher-forced shift needs no exchange after
       placement; the first transition of every rank but the first is the
       previous rank's and is dropped (teacher_forced_loss's skip_first);
  TP   the net's hidden units split over "model": layer 0's rows and the
       output layer's columns (mesh.shard_params_tp), an identity forward
       with an all-reduce backward on the net's input and an all-reduce
       forward with an identity backward on the output layer's partial
       product (:class:`TPNet`).

The loss is a sum over cells, as on one device: each rank's share is its
trajectories' partial means over the global transition count, and the
shares and the gradients are all-reduced over data (under DP) and seq.
Every rank then takes the same optimizer step on its own slice, and the
plateau test sees the global loss. Validation, checkpoints and the result
use the gathered net, so every rank scores the same DTW and keeps the same
best net; rank 0 writes the checkpoints. Results match the single-device
trainer up to the order of the reductions. The fused trainers (K4, K6)
run one model on one card and are declined under a mesh; the grid's K5
runs under a mesh in parallel/grid.py.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..core.params import RodParams
from ..models.mlp import ACTIVATIONS, KnodeMLP, MLPSpec
from .mesh import Mesh, data_sharding, load_params_tp, shard_params_tp

__all__ = ["ShardedTrainer", "TPNet", "MeshTraining"]


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over "model" backward (every
    model rank's partial product depends on the whole input)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.clone(), ("model",)), None


class _ReduceFromModel(torch.autograd.Function):
    """The partial products summed over "model" forward; identity
    backward (the sum's gradient reaches every partial unchanged)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x.clone(), ("model",))

    @staticmethod
    def backward(ctx, g):
        return g, None


class TPNet(nn.Module):
    """This rank's tensor-parallel shard of a two-layer KNODE net:
    ``flat`` holds [W1 rows, b1 rows, W2 columns, b2] (the layer-0 units of
    this model rank; b2 replicated). As an ``nn_fn`` it computes the whole
    net's output on every model rank."""

    def __init__(self, spec: MLPSpec, mesh: Mesh, shards):
        super().__init__()
        if len(spec.dims) != 3:
            raise ValueError(f"tensor parallelism takes two-layer nets, got "
                             f"{spec.dims}")
        self.spec, self.mesh = spec, mesh
        self.flat = nn.ParameterList(nn.Parameter(t) for t in shards)

    @classmethod
    def from_net(cls, net: KnodeMLP, mesh: Mesh) -> "TPNet":
        tree = [{"w": w, "b": b} for w, b in net.weights()]
        return cls(net.spec, mesh, [t.clone() for t in load_params_tp(
            mesh, tree, device=net.layers[0].weight.device)])

    def weights(self):
        return [(self.flat[0], self.flat[1]), (self.flat[2], self.flat[3])]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        W1, b1, W2, b2 = self.flat
        dt = torch.promote_types(x.dtype, W1.dtype)
        cd = (getattr(torch, self.spec.compute_dtype)
              if self.spec.compute_dtype else dt)
        rnd = lambda t: t.to(cd).to(dt)
        x = _CopyToModel.apply(x, self.mesh)
        h = ACTIVATIONS[self.spec.activation](
            F.linear(rnd(x), rnd(W1), b1.to(dt)))
        part = F.linear(rnd(h), rnd(W2))
        return _ReduceFromModel.apply(part, self.mesh) + b2.to(dt)

    def gather(self) -> KnodeMLP:
        """The whole net (a new KnodeMLP on this rank's device)."""
        W1 = self.flat[0]
        net = KnodeMLP(self.spec, dtype=W1.dtype, device=W1.device)
        pls = shard_params_tp(self.mesh, net.layers)
        with torch.no_grad():
            for (w, b), (tw, tb), pl in zip(net.weights(), self.weights(),
                                            pls):
                w.copy_(pl["w"].gather(tw.detach()))
                b.copy_(pl["b"].gather(tb.detach()))
        return net


def _spans(n: int, parts: int):
    """[start, stop) of each of ``parts`` near-equal pieces of range(n)."""
    edges = np.linspace(0, n, parts + 1).round().astype(int)
    return list(zip(edges[:-1], edges[1:]))


@dataclasses.dataclass
class MeshTraining:
    """One rank's part of ``train_knode(mesh=)``: the net's TP shard and its
    optimizer, the rank's trajectories and transitions, and the sharded
    epoch loop (:meth:`run`). Built from the whole net and optimizer that
    train_knode made (and resumed), so a checkpoint's weights and Adam
    moments are scattered back to the ranks."""

    mesh: Mesh
    p: RodParams
    spec: MLPSpec
    cfg: object
    net: TPNet
    optimizer: object
    trajs: torch.Tensor          # this rank's frames
    controls: torch.Tensor
    skip_first: bool             # the first transition is the last rank's
    share: float                 # local transitions / all transitions
    axes: tuple                  # the axes the loss and gradients sum over

    @classmethod
    def build(cls, mesh: Mesh, p: RodParams, spec: MLPSpec, cfg,
              net: KnodeMLP, optimizer, trajs, controls):
        from ..training.train import make_optimizer

        tp = TPNet.from_net(net, mesh)
        opt = make_optimizer(cfg, tp)
        opt.chain.update(optimizer.chain)
        pls = [pl[k] for pl in shard_params_tp(mesh, net.layers)
               for k in ("w", "b")]
        for P, Q, pl in zip(opt.params(), optimizer.params(), pls):
            for name in ("mu", "nu"):
                opt.state[P][name] = pl.shard(optimizer.state[Q][name]).clone()
        B, T = trajs.shape[0], trajs.shape[1]
        n_data, n_seq = mesh.shape["data"], mesh.shape["seq"]
        dp = B % n_data == 0
        if dp:
            trajs, controls = (data_sharding(mesh).shard(t)
                               for t in (trajs, controls))
        if T - 1 < n_seq:
            raise ValueError(f"{T - 1} transitions do not split over "
                             f"seq={n_seq}")
        a, b = _spans(T - 1, n_seq)[mesh.index("seq")]
        first = max(a - 1, 0)
        trajs, controls = (t[:, first:b + 1].contiguous()
                           for t in (trajs, controls))
        return cls(mesh, p, spec, cfg, tp, opt, trajs, controls,
                   skip_first=a > 0, share=(b - a) / (T - 1),
                   axes=(("data",) if dp else ()) + ("seq",))

    def loss(self) -> torch.Tensor:
        """This rank's share of the summed loss (with autograd)."""
        from ..training.loss import teacher_forced_loss

        per = teacher_forced_loss(self.p, self.spec, None, self.trajs,
                                  self.controls, self.cfg.keypoints,
                                  skip_first=self.skip_first,
                                  nn_fn=self.net)
        return per.sum() * self.share

    def step(self) -> torch.Tensor:
        """One optimizer step on every rank; returns the global loss."""
        self.optimizer.zero_grad(set_to_none=False)
        local = self.loss()
        local.backward()
        for P in self.net.parameters():
            self.mesh.all_reduce(P.grad, self.axes)
        loss = self.mesh.all_reduce(local.detach().clone(), self.axes)
        self.optimizer.step(loss)
        if self.cfg.clamp_weights:
            with torch.no_grad():
                for W, _ in self.net.weights():
                    W.clamp_(min=0.0)
        return loss

    def run(self, n_epochs: int) -> torch.Tensor:
        """The plain epoch loop over the mesh: losses (n_epochs,)."""
        return torch.stack([self.step() for _ in range(n_epochs)])

    def gathered(self):
        """(the whole net, an optimizer over it holding the gathered Adam
        moments and the shared plateau state): for validation, checkpoints
        and the result."""
        from ..training.train import make_optimizer

        net = self.net.gather()
        opt = make_optimizer(self.cfg, net)
        opt.chain.update(self.optimizer.chain)
        pls = [pl[k] for pl in shard_params_tp(self.mesh, net.layers)
               for k in ("w", "b")]
        for P, Q, pl in zip(opt.params(), self.optimizer.params(), pls):
            for name in ("mu", "nu"):
                opt.state[P][name] = pl.gather(self.optimizer.state[Q][name])
        return net, opt

    @property
    def writer(self) -> bool:
        """Whether this rank writes checkpoints (rank 0)."""
        return dist.get_rank() == 0


class ShardedTrainer:
    """DEPRECATED alias: delegates to ``train_knode(..., mesh=mesh)``.

    trajs (B, T, N, 25) and controls (B, T, 4) split over "data" / "seq";
    the net's hidden units over "model" (mesh.shard_params_tp). Losses are
    summed over the batch as by the single-device trainer.

    SINGLE-SHOT: each instance runs one training; a second fit() raises
    (for incremental training call train_knode with checkpoint_path= and
    resume_from=)."""

    def __init__(self, mesh: Mesh, p_mod: RodParams, cfg):
        warnings.warn(
            "ShardedTrainer is deprecated; call "
            "training.train.train_knode(..., mesh=mesh) directly",
            DeprecationWarning, stacklevel=2)
        self.mesh, self.p, self.cfg = mesh, p_mod, cfg
        self.spec = cfg.spec()
        self._params = None

    def fit(self, trajs, controls, epochs=None, log=None,
            validation_controls=None, validation_reference=None):
        """Run ``epochs`` optimizer steps of the sharded trainer; returns the
        per-epoch losses. The validation arguments turn on the eval and
        best-DTW selection as on one device."""
        from ..training.train import train_knode

        if self._params is not None:
            raise RuntimeError(
                "ShardedTrainer is a single-shot shim over "
                "train_knode(mesh=); for incremental training call "
                "train_knode with checkpoint_path= and resume_from=")
        epochs = epochs or self.cfg.epochs
        cfg = dataclasses.replace(self.cfg, epochs=max(int(epochs) - 1, 0))
        res = train_knode(self.p, trajs, controls, cfg,
                          validation_controls=validation_controls,
                          validation_reference=validation_reference,
                          log=log, mesh=self.mesh)
        self._params = res.params
        self.result = res
        return [float(x) for x in np.asarray(res.loss_history)[:epochs]]

    def gathered_params(self):
        if self._params is None:
            raise RuntimeError("call fit() first")
        return self._params
