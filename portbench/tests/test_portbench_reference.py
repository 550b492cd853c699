"""The frozen reference against the port's plain path on the CPU in float64
at a small size. Only this file imports both."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from knode_cosserat_tpu_torch.core.fast_rollout import make_fast_rollout
from knode_cosserat_tpu_torch.core.params import experimental_rod, make_rod
from knode_cosserat_tpu_torch.models.mlp import KnodeMLP, MLPSpec
from knode_cosserat_tpu_torch.ops.train import precompute
from knode_cosserat_tpu_torch.serving import CompiledStepper
from knode_cosserat_tpu_torch.training.checkpoint import load_checkpoint
from knode_cosserat_tpu_torch.training.train import TrainConfig, train_knode
from portbench.feeds.common import sine_tensions
from portbench.feeds.train_knode import state_of_checkpoint
from portbench.reference import rod as R
from portbench.reference import train as RT
from portbench.tests.fixture import REPO

F64 = torch.float64
H, N = 16, 6


def _cfg(name):
    return json.load(open(REPO / f"portbench/configs/{name}.json"))


def _net(seed, scale):
    g = torch.Generator().manual_seed(seed)
    w = [(0.01 + 0.01 * torch.randn(H, 28, generator=g, dtype=F64)).abs(),
         0.01 * torch.randn(H, generator=g, dtype=F64),
         (0.01 + 0.01 * torch.randn(25, H, generator=g, dtype=F64)).abs(),
         0.01 * torch.randn(25, generator=g, dtype=F64)]
    w = [x * scale for x in w]
    net = KnodeMLP(MLPSpec.for_knode(H), dtype=F64, device="cpu")
    with torch.no_grad():
        for P, x in zip(net.parameters(), w):
            P.copy_(x)
    return w, net


@pytest.mark.parametrize("name,mod", [("sim-nsw-h512", "nsw"),
                                      ("real-h512", None)])
def test_configuration_rods_are_the_presets(name, mod):
    kw = {k: np.asarray(v) for k, v in _cfg(name)["rod"].items()}
    a = make_rod(N=10, dtype=F64, device="cpu", **kw)
    b = experimental_rod(mod, N=10, dtype=F64, device="cpu")
    for (k, x), (_, y) in zip(a.leaves(), b.leaves()):
        assert torch.equal(x, y), k
    rod = R.derive(_cfg(name)["rod"], 10, F64, "cpu")
    for mine, port in (("Kse_inv", b.Kse_c0Bse_inv), ("Kbt_inv",
                       b.Kbt_c0Bbt_inv), ("v_rest", b.v_rest),
                       ("rhoJ", b.rhoJ), ("rhoAg", b.rhoAg), ("ds", b.ds),
                       ("c1", b.c1), ("c2", b.c2)):
        torch.testing.assert_close(rod.c[mine], port.to(F64), rtol=1e-15,
                                   atol=0)


def test_rollout_matches_the_port_plain_k2():
    p = experimental_rod("nsw", N=N, dtype=F64, device="cpu")
    rod = R.derive(_cfg("sim-nsw-h512")["rod"], N, F64, "cpu")
    w, net = _net(3, 1e-3)
    ctl = sine_tensions(torch.tensor([0.7, 1.3, 1.9], dtype=F64), 0.05,
                        8).double()
    roll = make_fast_rollout(p, MLPSpec.for_knode(H), tol=1e-16,
                             max_iter=50, impl="mega")
    traj, _, it = roll(ctl, net)
    ref, _, rit, sweeps = R.rollout(rod, ctl, w, 1e-16, 50)
    torch.testing.assert_close(traj, ref, rtol=0, atol=1e-8)
    assert torch.equal(it.long(), rit)
    assert bool((sweeps >= 1 + 7 * rit + 1).all())


def test_a_served_stream_matches_the_port_stepper():
    p = experimental_rod("nsw", N=N, dtype=F64, device="cpu")
    rod = R.derive(_cfg("sim-nsw-h512")["rod"], N, F64, "cpu")
    w, net = _net(4, 1e-3)
    ten = sine_tensions(torch.tensor([1.1], dtype=F64), 0.05, 6)[0].double()
    st = CompiledStepper(p, MLPSpec.for_knode(H), net, tol=1e-16,
                         max_iter=30, fast=True)
    s = st.reset()
    y, z = R.initial_state(rod)
    yp, zp, G = y, z, torch.zeros(6, dtype=F64)
    for i in range(6):
        s, _ = st.step(s, ten[i])
        yn, zn, Gn, *_ = R.step(rod, y[None], z[None], yp[None], zp[None],
                                G[None], ten[i][None], w, 1e-16, 30)
        yp, zp, y, z, G = y, z, yn[0], zn[0], Gn[0]
        torch.testing.assert_close(s.y, y, rtol=0, atol=1e-9)
        torch.testing.assert_close(s.z, z, rtol=0, atol=1e-9)


def _data(seed, n=2, T=7):
    g = torch.Generator().manual_seed(seed)
    trajs = 0.01 * torch.randn(n, T, N, 25, generator=g, dtype=F64)
    trajs[..., 3] += 1.0
    return trajs, 1 + 2 * torch.rand(n, T, 4, generator=g, dtype=F64)


def test_training_matches_the_port_trainer():
    p = experimental_rod(None, N=N, dtype=F64, device="cpu")
    rod = R.derive(_cfg("real-h512")["rod"], N, F64, "cpu")
    trajs, ctls = _data(5)
    cfg = TrainConfig(epochs=25, hidden=H, weight_decay=0.1, seed=5,
                      keypoints=(1, 3, 5), dtype="float64")
    res = train_knode(p, trajs, ctls, cfg, log=None)
    P0 = RT.init_net((28, H, 25), 5, F64)
    cl = RT.cells(rod, trajs, ctls, (1, 3, 5))
    L, S, g1, _ = RT.train(rod, cl, RT.AdamState.fresh(P0), 26, 1e-2, 0.1,
                           0.5, 80)
    np.testing.assert_allclose(res.loss_history, L.numpy(), rtol=1e-12)
    for a, b in zip(res.params.parameters(), S.P):
        torch.testing.assert_close(a.detach(), b, rtol=1e-10, atol=1e-13)
    assert len(g1) == 4 and all(bool(torch.isfinite(x).all()) for x in g1)


def test_the_reference_continues_from_the_port_checkpoint(tmp_path):
    """Restarted from the port's own checkpoint (weights, moments, count,
    plateau), the reference continues the port's run; a short patience
    and a large rate make the plateau cut the scale after the restart."""
    p = experimental_rod(None, N=N, dtype=F64, device="cpu")
    rod = R.derive(_cfg("real-h512")["rod"], N, F64, "cpu")
    trajs, ctls = _data(8)
    cfg = lambda epochs, **kw: TrainConfig(
        epochs=epochs, hidden=H, weight_decay=0.1, seed=8, keypoints=(1, 3),
        dtype="float64", plateau_patience=2, lr=0.2, **kw)
    whole = train_knode(p, trajs, ctls, cfg(29), log=None).loss_history
    path = str(tmp_path / "ck.npz")
    train_knode(p, trajs, ctls, cfg(19, checkpoint_every=20), log=None,
                checkpoint_path=path)
    state = state_of_checkpoint(load_checkpoint(path)[0])
    cl = RT.cells(rod, trajs, ctls, (1, 3))
    _, S, _, kept = RT.train(rod, cl, RT.AdamState.fresh(
        RT.init_net((28, H, 25), 8, F64)), 30, 0.2, 0.1, 0.5, 2,
        keep_at=(20,))
    assert S.scale < 1.0
    assert (state.t, state.scale, state.count) == (20, kept[20].scale,
                                                   kept[20].count)
    L, _, _, _ = RT.train(rod, cl, state, 10, 0.2, 0.1, 0.5, 2)
    np.testing.assert_allclose(whole[20:], L.numpy(), rtol=1e-12)


def test_cells_match_the_port_precompute():
    p = experimental_rod(None, N=N, dtype=F64, device="cpu")
    rod = R.derive(_cfg("real-h512")["rod"], N, F64, "cpu")
    trajs, ctls = _data(6)
    mine = RT.cells(rod, trajs.float().double(), ctls.float().double(),
                    (1, 3, 5))
    port = precompute(p, MLPSpec.for_knode(H), (1, 3, 5), trajs, ctls)
    for k in ("x", "y_base", "z_phys", "tgt_y", "tgt_z", "e_tgt"):
        torch.testing.assert_close(mine[k].float(), getattr(port, k),
                                   rtol=1e-6, atol=1e-6)
