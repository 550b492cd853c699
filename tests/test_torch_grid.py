"""The experiment grid (parallel/grid.py) and K5's plain version against the
JAX package on the CPU: the enumeration order, grid_train through K5's
plain version against JAX's fused grid in interpret mode (float32, its own
fused-vs-scan tolerances), the plain grid epoch loop against JAX's in
float64, and the grid runner against make_fused_grid_training_run."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import knode_cosserat_tpu as J
import knode_cosserat_tpu_torch as K
from knode_cosserat_tpu.models import mlp as jmlp
from knode_cosserat_tpu.ops import pallas_train as jpt
from knode_cosserat_tpu.parallel import grid as jgrid
from knode_cosserat_tpu.training import data as jdata
from knode_cosserat_tpu.training import train as jtrain
from knode_cosserat_tpu_torch.models import mlp as kmlp
from knode_cosserat_tpu_torch.ops import train as kt
from knode_cosserat_tpu_torch.parallel import grid as kgrid
from knode_cosserat_tpu_torch.training import train as ktrain

torch.set_num_threads(1)
# the JAX package's fused-vs-scan tolerances (tests/test_pallas_train.py)
LOSS_RTOL, LOSS_ATOL = 5e-4, 1e-9
PARAM_RTOL, PARAM_ATOL = 3e-3, 3e-5
# 1 and 2 trajectories: the grid splits into two sub-grids
DATAS = ["sine 0.5", "sine sine 0.5 1.0"]


def _same_inits(monkeypatch, dtype):
    """The port's cells start from the JAX package's init_mlp(PRNGKey(seed))
    weights, so both grids train the same nets."""
    def init(spec, seed, dt, device):
        p = jmlp.init_mlp(spec, jax.random.PRNGKey(seed), dtype)
        return kmlp.params_from_jax(p, spec, dt, device)
    monkeypatch.setattr(kgrid, "init_cell_net", init)


def _assert_params(nets, trees, rtol, atol):
    for net, tree in zip(nets, trees):
        for (w, b), layer in zip(net.weights(), tree):
            np.testing.assert_allclose(w.detach().numpy(),
                                       np.asarray(layer["w"]), rtol=rtol,
                                       atol=atol)
            np.testing.assert_allclose(b.detach().numpy(),
                                       np.asarray(layer["b"]), rtol=rtol,
                                       atol=atol)


def test_build_grid_order_matches_jax():
    datas, mods = ["a b 1 2", "c 3"], ["nsw", None, "short"]
    want = jgrid.build_grid(datas, mods, 3)
    got = kgrid.build_grid(datas, mods, 3)
    assert [(c.data, c.mod, c.seed) for c in got] == \
        [(c.data, c.mod, c.seed) for c in want]


@pytest.mark.parametrize("fused,dtype", [("plain", "float32"),
                                         ("off", "float64")])
def test_grid_train_matches_jax(monkeypatch, fused, dtype):
    """fused="plain" (K5's plain version, chunked at log_every) against
    JAX's fused grid in interpret mode; fused="off" (the plain grid epoch
    loop) against JAX's in float64 at rtol 1e-9."""
    _same_inits(monkeypatch, jnp.dtype(dtype))
    kw = dict(epochs=4, hidden=16, dtype=dtype, log_every=2)
    cells_j = jgrid.build_grid(DATAS, ["nsw", "short"], 2)
    rj = jgrid.grid_train(
        cells_j, jtrain.TrainConfig(fused="interpret" if fused == "plain"
                                    else "off", **kw),
        reference_rod=J.apply_mod(None), train_len=6, log=lambda s: None)
    logs = []
    rk = kgrid.grid_train(kgrid.build_grid(DATAS, ["nsw", "short"], 2),
                          ktrain.TrainConfig(fused=fused, **kw),
                          reference_rod=K.apply_mod(None, device="cpu"),
                          train_len=6, log=logs.append)
    assert rk.loss_history.shape == rj.loss_history.shape == (4, 8)
    assert len(logs) == 4                       # 2 sub-grids x 2 chunks
    if fused == "plain":
        np.testing.assert_allclose(rk.loss_history, rj.loss_history,
                                   rtol=LOSS_RTOL, atol=LOSS_ATOL)
        _assert_params(rk.params, rj.params, PARAM_RTOL, PARAM_ATOL)
    else:
        np.testing.assert_allclose(rk.loss_history, rj.loss_history,
                                   rtol=1e-9)
        _assert_params(rk.params, rj.params, 1e-9, 1e-14)
    assert rk.train_seconds > 0


def test_grid_runner_matches_jax_fused_grid():
    """make_fused_grid_training_run(plain=True) against the JAX package's
    vmapped fused kernel in interpret mode, set up as
    tests/test_pallas_train.py::test_fused_grid_training_matches_per_model
    sets it up ("short" changes L and so each cell's ds)."""
    epochs, mods = 10, ["nsw", "short"]
    trajs, ctls = jdata.make_training_data(
        J.apply_mod(None), [("sine", 0.5), ("sine", 1.0)], train_len=8)
    trajs = np.asarray(trajs, np.float32)
    ctls = np.asarray(ctls, np.float32)
    cfg = jtrain.TrainConfig(epochs=epochs, hidden=32, dtype="float32")
    kcfg = ktrain.TrainConfig(epochs=epochs, hidden=32, dtype="float32")
    spec = cfg.spec()
    params = [jmlp.init_mlp(spec, jax.random.PRNGKey(s), jnp.float32)
              for s in range(len(mods))]
    st = lambda xs: jax.tree.map(lambda *a: jnp.stack(a), *xs)
    pj, lj, sj = jpt.make_fused_grid_training_run(spec, cfg, epochs,
                                                  interpret=True)(
        st([J.apply_mod(m) for m in mods]), st(params),
        jnp.stack([trajs] * 2), jnp.stack([ctls] * 2))

    run = kt.make_fused_grid_training_run(kcfg.spec(), kcfg, epochs)
    before = kt.GRID_LAUNCHES
    pk, lk, sk = run([K.apply_mod(m, device="cpu") for m in mods],
                     kmlp.stacked_params_from_jax(params, kcfg.spec(),
                                                  device="cpu"),
                     torch.tensor(np.stack([trajs] * 2)),
                     torch.tensor(np.stack([ctls] * 2)))
    assert kt.GRID_LAUNCHES == before            # CPU cells: plain version
    assert lk.shape == (2, epochs)
    np.testing.assert_allclose(lk.numpy(), np.asarray(lj), rtol=2e-4,
                               atol=LOSS_ATOL)
    _assert_params(pk.unstack(), [jax.tree.map(lambda x, g=g: x[g], pj)
                                  for g in range(2)], PARAM_RTOL, PARAM_ATOL)
    # the grid state carries each cell's Adam count, as the JAX state does
    np.testing.assert_array_equal(sk["scalars"][:, 0].numpy(),
                                  np.asarray(sj["scalars"])[:, 0, 0])
    assert kt.fused_state_from_jax(
        jax.tree.map(lambda x: x[0], sj))["scalars"].shape == (4,)
