"""K4's plain version (ops/train.py) against the JAX package's fused
whole-run kernel in interpret mode (float32 runs on a float64 rod, as
tests/test_pallas_train.py runs it), chunked runs, the CPU dispatch of the
wrapper and train_knode's routing of cfg.fused."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import knode_cosserat_tpu as J
import knode_cosserat_tpu_torch as K
from knode_cosserat_tpu.models import mlp as jmlp
from knode_cosserat_tpu.ops import pallas_train as jpt
from knode_cosserat_tpu.training import data as jdata
from knode_cosserat_tpu.training import train as jtrain
from knode_cosserat_tpu_torch.models import mlp as kmlp
from knode_cosserat_tpu_torch.ops import train as kt
from knode_cosserat_tpu_torch.training import train as ktrain

torch.set_num_threads(1)
# the JAX package's own fused-vs-scan tolerances (test_pallas_train.py)
LOSS_RTOL, LOSS_ATOL = 2e-4, 1e-9
PARAM_RTOL, PARAM_ATOL = 3e-3, 3e-5


def _setup(history=False, hidden=32, train_len=8, **cfg_kw):
    trajs, ctls = jdata.make_training_data(
        J.apply_mod(None), [("sine", 0.5), ("sine", 1.0)], train_len=train_len)
    kw = dict(hidden=hidden, history=history, dtype="float32", **cfg_kw)
    cfg, kcfg = jtrain.TrainConfig(**kw), ktrain.TrainConfig(**kw)
    params = jmlp.init_mlp(cfg.spec(), jax.random.PRNGKey(0), jnp.float32)
    net = kmlp.params_from_jax(params, kcfg.spec(), device="cpu")
    return (cfg, kcfg, params, net, np.asarray(trajs, np.float32),
            np.asarray(ctls, np.float32))


@pytest.mark.parametrize("case", [
    dict(),
    dict(history=True, weight_decay=1e-4, plateau_patience=4)])
def test_plain_version_matches_jax_fused_kernel(case):
    epochs = 20
    cfg, kcfg, params, net, trajs, ctls = _setup(**case)
    run_j = jpt.make_fused_training_run(J.apply_mod("nsw"), cfg.spec(), cfg,
                                        epochs, interpret=True)
    pj, lj, _ = run_j(params, jnp.asarray(trajs), jnp.asarray(ctls))
    before = kt.LAUNCHES
    run_k = kt.make_fused_training_run(K.apply_mod("nsw", device="cpu"),
                                       kcfg.spec(), kcfg, epochs)
    out, lk, state = run_k(net, torch.tensor(trajs), torch.tensor(ctls))
    assert kt.LAUNCHES == before                  # CPU cells: plain version
    np.testing.assert_allclose(lk.numpy(), np.asarray(lj), rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    for (w, b), layer in zip(out.weights(), pj):
        for t, key in ((w, "w"), (b, "b")):
            np.testing.assert_allclose(t.detach().numpy(),
                                       np.asarray(layer[key]),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL)
    assert float(state["scalars"][0]) == epochs
    assert float(lk[-1]) < float(lk[0])


def test_chunked_runs_compose():
    """10 + 10 epochs, the state carried between them, == one 20-epoch run
    (plain version, float32)."""
    _, kcfg, _, net, trajs, ctls = _setup(hidden=16, train_len=6,
                                          plateau_patience=3)
    p = K.apply_mod("nsw", device="cpu")
    t, c = torch.tensor(trajs), torch.tensor(ctls)
    whole, l20, s20 = kt.make_fused_training_run(p, kcfg.spec(), kcfg, 20,
                                                 plain=True)(net, t, c)
    half = kt.make_fused_training_run(p, kcfg.spec(), kcfg, 10, plain=True)
    mid, la, sa = half(net, t, c)
    end, lb, sb = half(mid, t, c, sa)
    torch.testing.assert_close(torch.cat([la, lb]), l20, rtol=1e-6, atol=0)
    for a, b in zip(end.parameters(), whole.parameters()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)
    torch.testing.assert_close(sb["scalars"], s20["scalars"])
    assert float(s20["scalars"][0]) == 20.0


def test_a_chain_on_a_device_net_builds_the_cells_once():
    """Runs on a DeviceNet return the next DeviceNet, with the cells the
    first built, and equal runs on the net bit for bit."""
    _, kcfg, _, net, trajs, ctls = _setup(hidden=16, train_len=6,
                                          plateau_patience=3)
    p = K.apply_mod("nsw", device="cpu")
    t, c = torch.tensor(trajs), torch.tensor(ctls)
    half = kt.make_fused_training_run(p, kcfg.spec(), kcfg, 10)
    mid, la, sa = half(net, t, c)
    end, lb, sb = half(mid, t, c, sa)
    before = [w.clone() for w in net.parameters()]
    held = kt.DeviceNet.of(net)
    assert held.cells is None
    h1, ha, s1 = half(held, t, c)
    h2, hb, s2 = half(h1, t, c, s1)
    assert h1.cells is not None and h2.cells is h1.cells
    assert torch.equal(torch.cat([ha, hb]), torch.cat([la, lb]))
    for a, b in zip(h2.write_to(mid).parameters(), end.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(s2["moments"] + (s2["scalars"],),
                    sb["moments"] + (sb["scalars"],)):
        assert torch.equal(a, b)
    for a, b in zip(net.parameters(), before):
        assert torch.equal(a, b)          # the net itself is left as it is


def test_state_converts_to_and_from_the_optimizer():
    _, kcfg, _, net, _, _ = _setup(hidden=8)
    opt = ktrain.make_optimizer(kcfg, net)
    opt.chain.update(count=7, best_value=0.25, plateau_count=2, scale=0.5)
    for P in opt.params():
        opt.state[P]["mu"] = torch.full_like(P, 0.1)
    state = kt.fused_state_from_optimizer(opt)
    assert state["scalars"].tolist() == [7.0, 0.25, 2.0, 0.5]
    assert len(state["moments"]) == 8
    other = kt.load_fused_state(ktrain.make_optimizer(kcfg, net), state)
    assert other.chain == opt.chain
    for P in other.params():
        torch.testing.assert_close(other.state[P]["mu"], opt.state[P]["mu"])


def test_wrapper_dispatches_by_device_and_checks_the_gate():
    spec = K.MLPSpec.for_knode(512)
    assert kt.fused_trainer_supported(spec, 8192)
    assert not kt.fused_trainer_supported(spec, 8193)
    assert not kt.fused_trainer_supported(K.MLPSpec.for_knode(1024), 8)
    assert not kt.fused_trainer_supported(K.MLPSpec.for_knode(64, False,
                                                              "tanh"), 8)
    assert not kt.fused_trainer_supported(K.MLPSpec((28, 8, 8, 25)), 8)
    cells = kt.Cells(*(torch.zeros((2, d), device="meta")
                       for d in (28, 19, 6, 19, 6, 3)), (1.0,) * 4, 0.1)
    with pytest.raises(ValueError, match="device"):
        kt.train_run(cells, [], {}, 1, None)


@pytest.mark.parametrize("mode,dev,hidden,want", [
    ("auto", "cuda", 32, "kernel"), ("auto", "cpu", 32, None),
    ("auto", "cuda", 1024, None), ("on", "cuda", 32, "kernel"),
    ("on", "cpu", 32, "kernel"), ("plain", "cuda", 32, "plain"),
    ("interpret", "cpu", 32, "plain"), ("off", "cuda", 32, None)])
def test_fused_routing(mode, dev, hidden, want):
    cfg = ktrain.TrainConfig(hidden=hidden, fused=mode)
    got = ktrain._resolve_fused(cfg, cfg.spec(), 56, torch.device(dev))
    assert got == want


def test_fused_routing_refusals():
    spec = ktrain.TrainConfig(hidden=32).spec()
    cuda = torch.device("cuda")
    for mode in ("wide", "wide_interpret"):     # K6 (ops/train_wide.py)
        with pytest.raises(ValueError, match="wide trainer"):
            ktrain._resolve_fused(ktrain.TrainConfig(fused=mode), spec,
                                  10 ** 6, cuda)
    with pytest.raises(ValueError, match="does not support"):
        ktrain._resolve_fused(ktrain.TrainConfig(hidden=1024, fused="on"),
                              K.MLPSpec.for_knode(1024), 8, cuda)
    with pytest.raises(ValueError, match="float32-only"):
        ktrain._resolve_fused(ktrain.TrainConfig(fused="on",
                                                 dtype="float64"), spec, 8,
                              cuda)
    assert ktrain._resolve_fused(ktrain.TrainConfig(dtype="float64"), spec, 8,
                                 cuda) is None
    p = K.apply_mod(None, device="cpu")
    # a forced fused trainer under a mesh: the JAX package's refusal, before
    # any work (the mesh itself runs in tests/test_torch_parallel.py)
    with pytest.raises(ValueError, match="single-device"):
        ktrain.train_knode(p, None, None, ktrain.TrainConfig(fused="on"),
                           mesh=object())
    with pytest.raises(ValueError, match="does not support"):
        ktrain.train_knode(p, np.zeros((1, 3, 10, 25)), np.zeros((1, 3, 4)),
                           ktrain.TrainConfig(nn_dtype="bfloat16",
                                              fused="on"))
