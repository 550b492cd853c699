"""The port's multiple shooting (core/multiple_shooting.py) against the JAX
package's, float64 on the CPU: simulate_scan_ms over S segments, with the
structured (block-bidiagonal) and the dense Newton direction, physics and
hybrid, within 1e-10 of the JAX rollout and within 1e-9 of the port's own
single-shooting simulate_scan (the JAX test's bar); the doubling prefix
against the sequential chain; the argument checks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knode_cosserat_tpu.controls import calc_controls
from knode_cosserat_tpu.core import multiple_shooting as jms
from knode_cosserat_tpu.core import params as jp
from knode_cosserat_tpu.models import mlp as jmlp
from knode_cosserat_tpu_torch.core import multiple_shooting as kms
from knode_cosserat_tpu_torch.core import params as kp
from knode_cosserat_tpu_torch.core.shooting import block_jacobian
from knode_cosserat_tpu_torch.core.stepper import initial_state, simulate_scan
from knode_cosserat_tpu_torch.models.mlp import MLPSpec, params_from_jax

torch.set_num_threads(1)
T = 12
JAX_TOL = 1e-10        # the port against the JAX rollout (max abs)
SEQ_TOL = 1e-9         # against single shooting (tests/test_multiple_shooting.py)


@pytest.fixture(scope="module")
def rods():
    return jp.make_rod(N=17, dtype=jnp.float64), kp.make_rod(N=17,
                                                              device="cpu")


@pytest.fixture(scope="module")
def ctl(rods):
    return calc_controls("sine", 0.5, float(rods[1].del_t), T)


@pytest.fixture(scope="module")
def sequential(rods, ctl):
    return simulate_scan(rods[1], ctl, tol=1e-24).traj.numpy()


@pytest.fixture(scope="module")
def net():
    spec = jmlp.MLPSpec.for_knode(16, False, "elu")
    params = jmlp.init_mlp(spec, jax.random.PRNGKey(3), jnp.float64)
    # shrink the random residual so the hybrid rollout stays stable
    params = jax.tree.map(lambda x: 0.01 * x, params)
    return (jmlp.bind(spec, params),
            params_from_jax(params, MLPSpec.for_knode(16), device="cpu"))


@pytest.mark.parametrize("S", [2, 4, 8])
@pytest.mark.parametrize("solver", ["structured", "dense"])
def test_physics_rollout_matches_jax(rods, ctl, sequential, solver, S):
    jrod, krod = rods
    want = jms.simulate_scan_ms(jrod, jnp.asarray(ctl), S, tol=1e-24,
                                solver=solver)
    got = kms.simulate_scan_ms(krod, ctl, S, tol=1e-24, solver=solver)
    traj = got.traj.numpy()
    assert traj.shape == (T, 17, 50)
    assert np.abs(traj - np.asarray(want.traj)).max() < JAX_TOL
    assert np.abs(traj - sequential).max() < SEQ_TOL
    np.testing.assert_allclose(got.G.numpy(), np.asarray(want.G), rtol=0,
                               atol=JAX_TOL)
    assert got.residuals.numpy().max() < 1e-10
    # a warm-started rollout needs few iterations and no LM retries
    assert got.newton_iters.numpy().max() <= 10
    assert got.lm_retries.numpy().max() == 0


@pytest.mark.parametrize("solver", ["structured", "dense"])
def test_hybrid_rollout_matches_jax(rods, ctl, net, solver):
    jrod, krod = rods
    jfn, knet = net
    want = jms.simulate_scan_ms(jrod, jnp.asarray(ctl), 4, nn_fn=jfn,
                                tol=1e-24, solver=solver)
    got = kms.simulate_scan_ms(krod, ctl, 4, nn_fn=knet, tol=1e-24,
                               solver=solver).traj.numpy()
    assert np.abs(got - np.asarray(want.traj)).max() < JAX_TOL
    seq = simulate_scan(krod, ctl, nn_fn=knet, tol=1e-24).traj.numpy()
    assert np.abs(got - seq).max() < SEQ_TOL


def test_doubling_prefix_matches_sequential_chain():
    """The log-depth prefix (S-1 >= 32, the JAX package's associative scan)
    against the sequential chain on a fine rod's real segment tangents
    (N=65, S=32: 31 maps of one node each), relative 1e-12."""
    p = kp.make_rod(N=65, device="cpu")
    S = 32
    y0, z0 = initial_state(p)
    yh = p.c1 * y0 + p.c2 * y0
    zh = p.c1 * z0 + p.c2 * z0
    yh_segs = yh[:-1].reshape(S, 2, 19)
    zh_segs = zh[:-1].reshape(S, 2, 6)
    tf = torch.tensor([0.3, -0.2, 0.1], dtype=torch.float64)
    starts = y0[::2][:S]
    A = block_jacobian(lambda s: kms._segment_sweeps(
        p, s, yh_segs, zh_segs, tf, None, False, want_states=False)[2],
        starts)
    r = torch.from_numpy(np.random.RandomState(0).randn(S - 1, 19))
    B = torch.zeros((19, 6), dtype=torch.float64)
    B[7:13] = torch.eye(6, dtype=torch.float64)
    M1, v1 = kms._chain_prefix(0.9 * A[:-1], 0.9 * r, B)
    M2, v2 = kms._doubling_prefix(0.9 * A[:-1], 0.9 * r, B)
    assert M1.shape == (S - 1, 19, 6) and v1.shape == (S - 1, 19)
    for a, b in ((M2, M1), (v2, v1)):
        scale = b.abs().amax(dim=-1, keepdim=True).clamp_min(1e-300)
        assert float(((a - b).abs() / scale).max()) < 1e-12


def test_doubling_branch_rollout_matches_sequential():
    """S = 64 at N=65 (one node a segment) takes the doubling prefix in
    every Newton direction; the rollout matches single shooting."""
    p = kp.make_rod(N=65, device="cpu")
    ctl = calc_controls("sine", 0.5, float(p.del_t), 3)
    got = kms.simulate_scan_ms(p, ctl, 64, tol=1e-24).traj.numpy()
    seq = simulate_scan(p, ctl, tol=1e-24).traj.numpy()
    assert np.abs(got - seq).max() < SEQ_TOL


def test_segment_count_and_mesh_are_checked(rods, ctl):
    krod = rods[1]
    for S in (5, 0):                       # 5 does not divide N-1 = 16
        with pytest.raises(ValueError, match="must divide"):
            kms.simulate_scan_ms(krod, ctl, S)
    with pytest.raises(ValueError, match="unknown solver"):
        kms.simulate_scan_ms(krod, ctl, 4, solver="sparse")
    # a mesh needs the seq axis, over which S must divide (a mesh of
    # ranks runs in tests/test_torch_parallel.py)
    from types import SimpleNamespace
    with pytest.raises(ValueError, match="no axis 'seq'"):
        kms.simulate_scan_ms(krod, ctl, 4, mesh=object())
    with pytest.raises(ValueError, match="divide over the seq=3 mesh axis"):
        kms.simulate_scan_ms(krod, ctl, 4, mesh=SimpleNamespace(
            shape={"seq": 3}, index=lambda axis: 0))
