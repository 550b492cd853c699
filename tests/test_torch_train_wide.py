"""K6's plain version (ops/train_wide.py: the wide trainer's runner over
ops/train.py:train_run_reference) against the JAX package's streamed wide
kernel in interpret mode (float32 on a float64 rod, as
tests/test_pallas_train.py runs it), a run resumed from JAX's wide state,
the gate, and train_knode's routing of cfg.fused to K6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import knode_cosserat_tpu as J
import knode_cosserat_tpu_torch as K
from knode_cosserat_tpu.models import mlp as jmlp
from knode_cosserat_tpu.ops import pallas_train_wide as jwide
from knode_cosserat_tpu.training import data as jdata
from knode_cosserat_tpu.training import train as jtrain
from knode_cosserat_tpu_torch.models import mlp as kmlp
from knode_cosserat_tpu_torch.ops import train as kt
from knode_cosserat_tpu_torch.ops import train_wide as kw
from knode_cosserat_tpu_torch.training import train as ktrain

torch.set_num_threads(1)
# tests/test_pallas_train.py's wide-vs-scan tolerances
PARAM_RTOL, PARAM_ATOL = 3e-3, 3e-5


@pytest.fixture(scope="module")
def data():
    trajs, ctls = jdata.make_training_data(
        J.apply_mod(None), [("sine", 0.5), ("sine", 1.0)], train_len=8)
    return np.asarray(trajs, np.float32), np.asarray(ctls, np.float32)


def _setup(data, **cfg_kw):
    kw_ = dict(hidden=640, dtype="float32", **cfg_kw)
    cfg, kcfg = jtrain.TrainConfig(**kw_), ktrain.TrainConfig(**kw_)
    params = jmlp.init_mlp(cfg.spec(), jax.random.PRNGKey(0), jnp.float32)
    net = kmlp.params_from_jax(params, kcfg.spec(), device="cpu")
    return cfg, kcfg, params, net


def _assert_params(net, tree, rtol, atol):
    for (w, b), layer in zip(net.weights(), tree):
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(layer["w"]),
                                   rtol=rtol, atol=atol)
        np.testing.assert_allclose(b.detach().numpy(),
                                   np.asarray(layer["b"]).ravel(), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("epochs,loss_rtol,case", [
    (40, 2e-4, {}),
    (60, 5e-4, dict(history=True, weight_decay=0.1, plateau_patience=4,
                    plateau_factor=0.5))])
def test_plain_wide_run_matches_jax_wide_kernel(data, epochs, loss_rtol,
                                                case):
    """hidden 640: two 512-wide tiles of the JAX kernel with padded
    columns; the port's run has no tiles to pad."""
    trajs, ctls = data
    cfg, kcfg, params, net = _setup(data, **case)
    pj, lj, _ = jwide.make_wide_training_run(
        J.apply_mod("nsw"), cfg.spec(), cfg, epochs, interpret=True)(
            params, jnp.asarray(trajs), jnp.asarray(ctls))
    before = kw.LAUNCHES
    run = kw.make_wide_training_run(K.apply_mod("nsw", device="cpu"),
                                    kcfg.spec(), kcfg, epochs)
    out, lk, state = run(net, torch.tensor(trajs), torch.tensor(ctls))
    assert kw.LAUNCHES == before                 # CPU cells: plain version
    np.testing.assert_allclose(lk.numpy(), np.asarray(lj), rtol=loss_rtol,
                               atol=1e-9)
    _assert_params(out, pj, PARAM_RTOL, PARAM_ATOL)
    assert float(state["scalars"][0]) == epochs
    if case:
        assert float(state["scalars"][3]) < 1.0          # the plateau fired


def test_wide_run_resumes_from_jax_wide_state(data):
    """15 epochs of the JAX wide kernel, its state converted, then 25 of the
    port's == 40 of the JAX kernel; and the converted state goes back."""
    trajs, ctls = data
    cfg, kcfg, params, _ = _setup(data)
    p_mod = J.apply_mod("nsw")
    tj, cj = jnp.asarray(trajs), jnp.asarray(ctls)
    p15, _, s15 = jwide.make_wide_training_run(p_mod, cfg.spec(), cfg, 15,
                                               interpret=True)(params, tj, cj)
    p40, l40, _ = jwide.make_wide_training_run(p_mod, cfg.spec(), cfg, 40,
                                               interpret=True)(params, tj, cj)
    state = kt.fused_state_from_jax(s15, device="cpu")
    assert state["moments"][2].shape == (640,)
    back = kt.fused_state_to_jax(state)
    for a, b in zip(back["moments"], s15["moments"]):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(back["scalars"][0, :4],
                                  np.asarray(s15["scalars"])[0, :4])
    net = kmlp.params_from_jax(p15, kcfg.spec(), device="cpu")
    run = kw.make_wide_training_run(K.apply_mod("nsw", device="cpu"),
                                    kcfg.spec(), kcfg, 25)
    out, l25, s25 = run(net, torch.tensor(trajs), torch.tensor(ctls), state)
    np.testing.assert_allclose(l25.numpy(), np.asarray(l40)[15:], rtol=2e-4,
                               atol=1e-9)
    _assert_params(out, p40, PARAM_RTOL, PARAM_ATOL)
    assert float(s25["scalars"][0]) == 40.0


def test_wide_gate_matches_jax():
    for hidden in (64, 512, 1024, 8192, 32768):
        assert kw.wide_trainer_supported(K.MLPSpec.for_knode(hidden), 1904)
        assert jwide.wide_trainer_supported(jmlp.MLPSpec.for_knode(hidden),
                                            1904)
    assert kw.WIDE_MAX_CELLS == jwide.WIDE_MAX_CELLS
    assert not kw.wide_trainer_supported(K.MLPSpec.for_knode(1024),
                                         kw.WIDE_MAX_CELLS + 1)
    assert not kw.wide_trainer_supported(
        K.MLPSpec.for_knode(1024, activation="tanh"), 1904)
    assert not kw.wide_trainer_supported(K.MLPSpec((28, 8, 8, 25)), 1904)


@pytest.mark.parametrize("mode,dev,hidden,want", [
    ("auto", "cuda", 512, "kernel"), ("auto", "cuda", 1024, None),
    ("auto", "cuda", 2048, "wide"), ("auto", "cuda", 4096, "wide"),
    ("auto", "cpu", 4096, None), ("wide", "cpu", 4096, "wide"),
    ("wide", "cuda", 64, "wide"), ("wide_interpret", "cuda", 4096,
                                   "wide_plain")])
def test_fused_routing_takes_k6(mode, dev, hidden, want):
    """The JAX package's routing (tests/test_pallas_train.py::
    test_resolve_fused_routes_wide) with the card in place of its TPU
    backend: auto takes K4 up to 512, K6 from 2048 on a CUDA rod, and
    'wide' / 'wide_interpret' force K6 or its plain version."""
    cfg = ktrain.TrainConfig(hidden=hidden, fused=mode)
    assert ktrain._resolve_fused(cfg, cfg.spec(), 1904,
                                 torch.device(dev)) == want


def test_fused_routing_refuses_what_k6_cannot_take():
    cuda = torch.device("cuda")
    cfg = ktrain.TrainConfig(hidden=4096, fused="wide")
    with pytest.raises(ValueError, match="wide trainer"):
        ktrain._resolve_fused(cfg, cfg.spec(), 10 ** 6, cuda)
    cfg = ktrain.TrainConfig(hidden=4096, fused="wide", dtype="float64")
    with pytest.raises(ValueError, match="float32-only"):
        ktrain._resolve_fused(cfg, cfg.spec(), 1904, cuda)
    # too many cells for K6: auto falls back to the plain epoch loop
    cfg = ktrain.TrainConfig(hidden=4096)
    assert ktrain._resolve_fused(cfg, cfg.spec(), 10 ** 6, cuda) is None


def test_train_knode_runs_its_chunks_on_the_wide_runner(data):
    """train_knode with cfg.fused="wide" on a CPU rod: K6's plain version
    per chunk, the optimizer state carried through it, against the plain
    epoch loop (float32 both)."""
    trajs, ctls = data
    p = K.apply_mod("nsw", device="cpu")
    kw_ = dict(hidden=24, epochs=6, log_every=3, dtype="float32")
    wide = ktrain.train_knode(p, trajs, ctls,
                              ktrain.TrainConfig(fused="wide", **kw_),
                              log=None)
    off = ktrain.train_knode(p, trajs, ctls,
                             ktrain.TrainConfig(fused="off", **kw_), log=None)
    np.testing.assert_allclose(wide.loss_history, off.loss_history,
                               rtol=2e-4, atol=1e-9)
