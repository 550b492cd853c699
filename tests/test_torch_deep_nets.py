"""Nets of any depth in the rod kernels: the plain versions of K3 (with K1
inside), K2 and K8 against the JAX package with the same deep nets, float64
on the CPU: JAX's Pallas kernels in interpret mode (its deep kernel tests'
shapes, tests/test_pallas_kernels.py:26-32: a 3-layer (28, 32, 32, 25) elu
net and a 4-layer (53, 16, 16, 16, 25) tanh history net) and its XLA
integrators; the kernels' spec check and launch plans for deep nets; and
the weights carried across (params_from_jax / spec_from_params, and the
CLI's ``simulate --model`` of a deep checkpoint; the mesh-sharded load,
parallel/mesh.load_params_tp, is held to JAX in tests/test_torch_parallel.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import knode_cosserat_tpu as J
import knode_cosserat_tpu_torch as K
from knode_cosserat_tpu.core.spatial import (integrate_euler, integrate_rk4,
                                             next_segment_euler, tip_residual)
from knode_cosserat_tpu.core.stepper import initial_state as jinit
from knode_cosserat_tpu.models import mlp as jmlp
from knode_cosserat_tpu.ops.pallas_rhs import (
    make_fused_next_segment as jax_segment)
from knode_cosserat_tpu.ops.pallas_step import make_step_kernel as jax_step
from knode_cosserat_tpu.ops.pallas_sweep import make_sweep_kernel as jax_sweep
from knode_cosserat_tpu_torch.models import mlp as kmlp
from knode_cosserat_tpu_torch.ops import next_segment as kseg
from knode_cosserat_tpu_torch.ops import step as kstep
from knode_cosserat_tpu_torch.ops import sweep as ksweep

torch.set_num_threads(1)
SWEEP_TOL = (1e-10, 1e-12)           # tests/test_torch_sweep.py's bar
STEP_TOL = (1e-9, 1e-10)             # tests/test_torch_step.py's
SEG_TOL = (1e-12, 1e-12)             # K8 in float64 (chip_smoke.K8_TOL)
SPECS = [((28, 32, 32, 25), "elu"), ((53, 16, 16, 16, 25), "tanh")]
IDS = ["3-layer", "4-layer-history"]


def _nets(dims, act, scale, seed=0):
    spec = jmlp.MLPSpec(dims=dims, activation=act, history=dims[0] == 53)
    params = jax.tree.map(lambda a: a * scale,
                          jmlp.init_mlp(spec, jax.random.PRNGKey(seed),
                                        jnp.float64))
    net = kmlp.params_from_jax(params, kmlp.MLPSpec(
        dims=dims, activation=act, history=dims[0] == 53), device="cpu")
    return spec, params, net


def _close(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=tol[0], atol=tol[1])


def _sweep_inputs(p, B, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, 6) * 0.01, rng.randn(B, p.N, 19) * 0.1,
            rng.randn(B, p.N, 6) * 0.1, rng.randn(B, 3))


@pytest.mark.parametrize("dims,act", SPECS, ids=IDS)
def test_deep_sweep_matches_pallas_interpret(dims, act):
    pj, pk = J.apply_mod("nsw"), K.apply_mod("nsw", device="cpu")
    spec, params, net = _nets(dims, act, 0.1)
    ins = _sweep_inputs(pk, 3, seed=1)
    want = jax_sweep(pj, spec, block_b=8, interpret=True)(
        *map(jnp.asarray, ins), params)
    got = ksweep.make_sweep_kernel(pk, net.spec)(*map(torch.tensor, ins), net)
    _close(got, want, SWEEP_TOL)


@pytest.mark.parametrize("method", ["euler", "rk4"])
@pytest.mark.parametrize("dims,act", SPECS, ids=IDS)
def test_deep_sweep_matches_integrators(dims, act, method):
    pj, pk = J.apply_mod("short"), K.apply_mod("short", device="cpu")
    spec, params, net = _nets(dims, act, 0.1, seed=2)
    nn_fn = jmlp.bind(spec, params)
    ins = _sweep_inputs(pk, 4, seed=3)

    def one(g, a, b, c):
        if method == "euler":
            y, z = integrate_euler(pj, g, a, b, c, nn_fn, spec.history)
        else:
            y, z = integrate_rk4(pj, g, a, b, 0.5 * (a[:-1] + a[1:]),
                                 0.5 * (b[:-1] + b[1:]), c, nn_fn,
                                 spec.history)
        return tip_residual(pj, y), y, z

    want = jax.vmap(one)(*map(jnp.asarray, ins))
    got = ksweep.sweep_reference(pk, *map(torch.tensor, ins), net, method)
    _close(got, want, SWEEP_TOL)


def _step_inputs(pj, B, seed):
    rng = np.random.RandomState(seed)
    y0, z0 = (np.asarray(a) for a in jinit(pj))
    y = y0 + 1e-3 * rng.randn(B, pj.N, 19)
    z = z0 + 1e-3 * rng.randn(B, pj.N, 6)
    c1, c2 = float(pj.c1), float(pj.c2)
    tf = (5 + 2 * rng.rand(B, 4)) @ np.asarray(pj.tendon_dirs)
    return np.zeros((B, 6)), c1 * y + c2 * y0, c1 * z + c2 * z0, tf


@pytest.mark.parametrize("dims,act", SPECS, ids=IDS)
def test_deep_step_matches_pallas_interpret(dims, act):
    pj, pk = J.apply_mod("nsw"), K.apply_mod("nsw", device="cpu")
    spec, params, net = _nets(dims, act, 1e-2, seed=4)
    ins = _step_inputs(pj, 3, seed=5)
    k = jax.jit(jax_step(pj, spec, block_b=8, tol=1e-18, max_iter=30,
                         interpret=True))
    want = k(*map(jnp.asarray, ins), params)
    got = kstep.make_step_kernel(pk, net.spec, tol=1e-18, max_iter=30)(
        *map(torch.tensor, ins), net)
    _close(got[:4], want[:4], STEP_TOL)
    assert int(got[4].max()) == int(np.max(np.asarray(want[4])))


@pytest.mark.parametrize("dims,act", SPECS, ids=IDS)
def test_deep_next_segment_matches_pallas_interpret(dims, act):
    pj, pk = J.apply_mod(None), K.apply_mod(None, device="cpu")
    spec, params, net = _nets(dims, act, 1.0, seed=6)
    rng = np.random.RandomState(7)
    y = rng.randn(40, 19) * 0.1
    y[:, 3] += 1.0
    ins = (y, rng.randn(40, 19), rng.randn(40, 6), rng.randn(40, 3))
    want = jax_segment(pj, spec, block_b=128, interpret=True)(
        params, *map(jnp.asarray, ins))
    # JAX's XLA form of the same cells (the kernel's ELU is exp(x) - 1)
    ref = next_segment_euler(pj, *map(jnp.asarray, ins),
                             nn_fn=jmlp.bind(spec, params),
                             nn_history=spec.history)
    got = kseg.make_fused_next_segment(pk, net.spec)(
        net, *map(torch.tensor, ins))
    _close(got, ref, SEG_TOL)
    _close(got, want, (1e-9, 1e-12))
    # the op's gradient reaches every layer of the deep net
    (sum(t.square().sum() for t in got)).backward()
    assert all(P.grad is not None and bool(P.grad.abs().sum() > 0)
               for P in net.parameters())


def test_deep_spec_checks_and_plans():
    for dims, act in SPECS:
        ksweep.check_spec(kmlp.MLPSpec(dims=dims, activation=act,
                                       history=dims[0] == 53))
    # K1's deep form: the layer table, each lane's scratch of two rows of
    # the widest kept hidden layer, the net staged only where all fits
    f32, f64 = torch.float32, torch.float64
    small = ksweep.launch_plan(f32, 28, (32, 32), "euler")
    assert small.staged and small.smem_bytes == (
        ksweep.DEEP_TABLE_BYTES + ksweep.deep_net_bytes(f32, (28, 32, 32, 25))
        + 8 * 2 * 32 * 4)
    wide = ksweep.launch_plan(f64, 53, (512, 512, 512), "rk4")
    assert not wide.staged and wide.smem_bytes == 256 + 8 * 2 * 512 * 8
    step = kstep.launch_plan(f64, 53, (512, 512, 512), "euler")
    assert not step.staged and step.smem_bytes == (
        256 + 7 * 2 * 512 * 8 + kstep._STATE_BYTES[f64])
    seg = kseg.launch_plan(f32, 28, (16, 16), 3)
    assert seg.threads == 96 and seg.smem_bytes == (
        256 + ksweep.deep_net_bytes(f32, (28, 16, 16, 25)) + 3 * 2 * 16 * 4)
    # the two-layer plans keep their form
    assert ksweep.launch_plan(f32, 28, 512, "euler") == (256, 8, 110808, True)
    with pytest.raises(ValueError, match="scratch"):
        ksweep.launch_plan(f64, 28, (8192, 8192), "euler")
    # deep_net_bytes counts csrc/rhs_rows.cuh's staged layout
    assert ksweep.deep_net_bytes(f32, (28, 32, 32, 25)) == 4 * (
        28 * 33 + 32 + 32 * 33 + 32 + 25 * 32 + 25) + 4


def test_deep_weights_carried_across(tmp_path, capsys):
    """params_from_jax infers a deep net's spec from its weights; the CLI's
    simulate --model loads a deep checkpoint of either package and rolls
    it out as the JAX package's XLA rollout does."""
    from knode_cosserat_tpu.controls import calc_controls
    from knode_cosserat_tpu.core.stepper import simulate as jsimulate
    from knode_cosserat_tpu.training import checkpoint as jckpt
    from knode_cosserat_tpu_torch import cli

    spec, params, net = _nets((28, 16, 16, 25), "elu", 1e-2, seed=8)
    assert net.spec == kmlp.MLPSpec(dims=(28, 16, 16, 25))
    assert kmlp.spec_from_params(params, "tanh").activation == "tanh"
    hist = jmlp.init_mlp(jmlp.MLPSpec(dims=(53, 8, 8, 8, 25), history=True),
                         jax.random.PRNGKey(1), jnp.float64)
    assert kmlp.spec_from_params(hist).history
    x = np.random.RandomState(9).randn(5, 28)
    np.testing.assert_allclose(
        net(torch.tensor(x)).detach().numpy(),
        np.asarray(jmlp.mlp_apply(spec, params, jnp.asarray(x))),
        rtol=1e-12, atol=1e-14)
    path = jckpt.save_checkpoint(
        str(tmp_path / "deep"), {"params": jax.tree.map(np.asarray, params)},
        meta={"train": {"activation": "elu"}})
    out = str(tmp_path / "sim.npz")
    traj = cli.main(["simulate", "--model", path, "--steps", "6", "--arg",
                     "0.5",
                     "--dtype", "float64", "--device", "cpu", "--save", out])
    pj = J.apply_mod(None)
    ctl = calc_controls("sine", 0.5, float(pj.del_t), 6)
    want = jsimulate(pj, jnp.asarray(ctl), nn_fn=jmlp.bind(spec, params),
                     tol=1e-16)
    np.testing.assert_allclose(traj, np.asarray(want), rtol=1e-9, atol=1e-9)
    assert "saved" in capsys.readouterr().out
