"""The eval tables (evaluation/tables.py) against the JAX package's on the
CPU (float64, the scan rollouts on both sides): DTW, pose MSE, the text
tables and the saved .npz records; the port's mega eval (K2's plain version
with one net per rod) against its scan; and K2's plain version with a
stacked net against single-net calls."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import knode_cosserat_tpu as J
import knode_cosserat_tpu_torch as K
from knode_cosserat_tpu.evaluation import tables as jtab
from knode_cosserat_tpu.models import mlp as jmlp
from knode_cosserat_tpu.parallel import grid as jgrid
from knode_cosserat_tpu_torch.core.fast_rollout import make_fast_rollout
from knode_cosserat_tpu_torch.core.stepper import initial_state
from knode_cosserat_tpu_torch.evaluation import tables as ktab
from knode_cosserat_tpu_torch.models import mlp as kmlp
from knode_cosserat_tpu_torch.ops.step import step_reference
from knode_cosserat_tpu_torch.ops.sweep import make_sweep_kernel
from knode_cosserat_tpu_torch.parallel import grid as kgrid

torch.set_num_threads(1)
EVAL_SET, EVAL_LEN = ["sine 1.5"], 8
DATAS, MODS = ["sine 0.5"], ["nsw", "short"]


def _nets(hidden=16):
    spec = jmlp.MLPSpec.for_knode(hidden)
    trees = [jmlp.init_mlp(spec, jax.random.PRNGKey(s), jnp.float64)
             for s in range(len(MODS))]
    kspec = kmlp.MLPSpec.for_knode(hidden)
    return spec, trees, kspec, [kmlp.params_from_jax(t, kspec, device="cpu")
                                for t in trees]


@pytest.fixture(scope="module")
def evals(tmp_path_factory):
    """Both packages' records for 2 cells (2 mods), with their .npz files."""
    spec, trees, kspec, nets = _nets()
    d = tmp_path_factory.mktemp("evals")
    rj = jtab.evaluate_cells(jgrid.build_grid(DATAS, MODS, 1), trees, spec,
                             EVAL_SET, reference_rod=J.apply_mod(None),
                             eval_len=EVAL_LEN, impl="xla",
                             save_dir=str(d / "jax"))
    cells = kgrid.build_grid(DATAS, MODS, 1)
    ref = K.apply_mod(None, device="cpu")
    rk = ktab.evaluate_cells(cells, nets, kspec, EVAL_SET, reference_rod=ref,
                             eval_len=EVAL_LEN, save_dir=str(d / "port"))
    rm = ktab.evaluate_cells(cells, nets, kspec, EVAL_SET, reference_rod=ref,
                             eval_len=EVAL_LEN, impl="mega")
    return rj, rk, rm, d


def test_evaluate_cells_matches_jax(evals):
    rj, rk, _, _ = evals
    assert [(r.label, r.eval_name) for r in rk] == \
        [(r.label, r.eval_name) for r in rj]
    for a, b in zip(rk, rj):
        np.testing.assert_allclose([a.dtw, a.mse], [b.dtw, b.mse], rtol=1e-7)
        if b.dtw_pct is None:
            assert a.dtw_pct is None and a.mse_pct is None
        else:
            np.testing.assert_allclose([a.dtw_pct, a.mse_pct],
                                       [b.dtw_pct, b.mse_pct], rtol=1e-6,
                                       atol=1e-9)
        assert a.residual <= 1e-8          # every f64 step solved (tol 1e-16)
    assert ktab.format_table(rk) == jtab.format_table(rj)
    assert (ktab.format_table(ktab.aggregate_seeds(rk))
            == jtab.format_table(jtab.aggregate_seeds(rj)))


def test_eval_records_match_jax_files(evals):
    _, _, _, d = evals
    names = sorted(p.name for p in (d / "jax").iterdir())
    assert names == sorted(p.name for p in (d / "port").iterdir())
    assert len(names) == 4 and names[0].startswith("physics_sine_1.5+")
    for name in names:
        with np.load(d / "jax" / name) as a, np.load(d / "port" / name) as b:
            assert sorted(a.files) == sorted(b.files) == \
                ["predicted", "reference", "tensions"]
            for k in a.files:
                assert a[k].shape == b[k].shape
                np.testing.assert_allclose(b[k], a[k], rtol=1e-7, atol=1e-10)


def test_mega_eval_matches_scan(evals):
    """impl="mega" (K2's plain version, the cells of a mod stacked on the
    rod axis; the baselines physics-only) against the scan: the converged
    rollouts agree to the Newton tolerance (sum r^2 <= 1e-16)."""
    _, rk, rm, _ = evals
    for a, b in zip(rm, rk):
        assert a.label == b.label
        np.testing.assert_allclose([a.dtw, a.mse], [b.dtw, b.mse], rtol=1e-8)
        assert a.residual <= 1e-8


def test_step_reference_with_stacked_nets_is_exact():
    """K2's plain version with one net per rod equals a loop of single-net
    calls bit for bit: each net sees exactly its own rod's lanes."""
    p = K.experimental_rod(N=6, device="cpu")
    B, g = 3, np.random.RandomState(0)
    y0, z0 = (a.numpy() for a in initial_state(p))
    yh = torch.tensor(float(p.c1) * (y0 + 1e-3 * g.randn(B, p.N, 19))
                      + float(p.c2) * y0)
    zh = torch.tensor(float(p.c1) * (z0 + 1e-3 * g.randn(B, p.N, 6))
                      + float(p.c2) * z0)
    tf = torch.tensor((5 + 2 * g.rand(B, 4)) @ p.tendon_dirs.numpy())
    G = torch.zeros((B, 6), dtype=torch.float64)
    spec = kmlp.MLPSpec.for_knode(8)
    nets = [kmlp.init_mlp(spec, torch.Generator().manual_seed(s),
                          torch.float64, "cpu") for s in range(B)]
    got = step_reference(p, G, yh, zh, tf, kmlp.StackedMLP(nets), tol=1e-16)
    for b in range(B):
        want = step_reference(p, G[b:b + 1], yh[b:b + 1], zh[b:b + 1],
                              tf[b:b + 1], nets[b], tol=1e-16)
        for x, w in zip(got, want):
            assert torch.equal(x[b:b + 1], w)


def test_stacked_nets_roundtrip_and_single_net_paths_refuse_them():
    spec, trees, kspec, nets = _nets(hidden=4)
    st = kmlp.stacked_params_from_jax(trees, kspec, device="cpu")
    assert len(st) == 2
    assert st.weights()[0][0].shape == (2, 4, 28)
    for a, b in zip(st.unstack(), nets):
        for x, y in zip(a.parameters(), b.parameters()):
            assert torch.equal(x, y)
    x = torch.randn(6, 28, dtype=torch.float64)       # 3 rows per net
    torch.testing.assert_close(st(x), torch.cat([nets[0](x[:3]),
                                                 nets[1](x[3:])]))
    p = K.experimental_rod(N=4, device="cpu")
    G = torch.zeros((2, 6), dtype=torch.float64)
    yh = torch.zeros((2, 4, 19), dtype=torch.float64)
    zh = torch.zeros((2, 4, 6), dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="K3"):
        make_sweep_kernel(p, kspec)(G, yh, zh, G[:, :3], st)
    roll = make_fast_rollout(p, kspec, impl="plain")
    with pytest.raises(NotImplementedError, match="mega"):
        roll(torch.ones((2, 3, 4), dtype=torch.float64), st)
