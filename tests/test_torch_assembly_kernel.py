"""The plain version of kernel K7 (ops/assembly.py) against the JAX
package's fused assembly step in interpret mode (float64 on the CPU), the
fused rollout against the JAX fused rollout, and float32 against a
float64 truth."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knode_cosserat_tpu.controls import calc_controls
from knode_cosserat_tpu.core import assembly as ja
from knode_cosserat_tpu.ops.pallas_assembly import \
    make_assembly_step_kernel as jax_step
from knode_cosserat_tpu_torch.core import assembly as ka
from knode_cosserat_tpu_torch.ops import assembly as kops

torch.set_num_threads(1)
# f64 and both solves run past the fused default (1e-16) to 1e-24, so each
# stops at its floor and not somewhere of its own inside |r| <= 1e-8
TOL = 1e-24
X_ATOL, REL = 1e-9, 1e-9


def _step_inputs(asm_j, seed):
    """One coupled step from a perturbed history around the straight
    assembly: X0, yh, zh, tf, pph, vph, hph, wbh (float64 numpy)."""
    g = np.random.RandomState(seed)
    M = asm_j.M
    carry = ja.AssemblyCarry.initial(asm_j)
    y, z = np.asarray(carry.y), np.asarray(carry.z)
    c1, c2 = float(asm_j.rods.c1[0]), float(asm_j.rods.c2[0])
    yh = c1 * (y + 1e-3 * g.randn(*y.shape)) + c2 * y
    zh = c1 * (z + 1e-3 * g.randn(*z.shape)) + c2 * z
    tf = (5 + 2 * g.rand(M, 4)) @ np.asarray(asm_j.rods.tendon_dirs[0])
    pp, hp = np.asarray(asm_j.p_plate0), np.asarray(asm_j.h_plate0)
    X0 = np.concatenate([np.zeros(6 * M), pp, hp])
    return (X0, yh, zh, tf, (c1 + c2) * pp + 1e-4 * g.randn(3),
            1e-3 * g.randn(3), (c1 + c2) * hp + 1e-4 * g.randn(4),
            1e-3 * g.randn(3))


def _close(name, got, want, rel=REL):
    w = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), w, rtol=rel,
                               atol=rel * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("M,N", [(2, 6), (3, 10)])
def test_reference_matches_pallas_interpret(M, N):
    asm_j = ja.make_ring_assembly(n_rods=M, base_radius=0.05, N=N,
                                  dtype=jnp.float64)
    asm_k = ka.assembly_from_jax(asm_j, device="cpu")
    ins = _step_inputs(asm_j, seed=M)
    want = jax.jit(jax_step(asm_j, tol=TOL, max_iter=30, interpret=True))(
        *map(jnp.asarray, ins))
    got = kops.assembly_step_reference(asm_k, *map(torch.tensor, ins),
                                       tol=TOL, max_iter=30)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=X_ATOL, err_msg="X")
    _close("y", got[1], want[1])
    _close("z", got[2], want[2])
    assert float(got[3]) < 1e-20 and float(want[3]) < 1e-20
    assert int(got[4]) == int(want[4]) and got[4].dtype == torch.int32
    # the wrapper on CPU tensors is the plain version
    k = kops.make_assembly_step_kernel(asm_k, tol=TOL, max_iter=30)
    for a, b in zip(k(*map(torch.tensor, ins)), got):
        assert torch.equal(a, b)


def test_fused_rollout_matches_jax_fused():
    asm_j = ja.make_ring_assembly(n_rods=2, base_radius=0.04, N=6,
                                  dtype=jnp.float64)
    asm_k = ka.assembly_from_jax(asm_j, device="cpu")
    ctl = np.stack([calc_controls("sine", a, 0.005, 3) for a in (0.8, 1.2)],
                   axis=1)
    want = ja.simulate_assembly(asm_j, jnp.asarray(ctl), tol=TOL,
                                fused="interpret")
    kops.LAUNCHES = 0
    got = ka.simulate_assembly(asm_k, torch.tensor(ctl), tol=TOL, fused=True)
    assert kops.LAUNCHES == 0               # CPU: the plain version
    np.testing.assert_allclose(got.Gs.numpy(), np.asarray(want.Gs), rtol=0,
                               atol=X_ATOL)
    np.testing.assert_allclose(got.plate_pose.numpy(),
                               np.asarray(want.plate_pose), rtol=0,
                               atol=X_ATOL)
    _close("traj", got.traj, want.traj)
    np.testing.assert_array_equal(got.newton_iters.numpy(),
                                  np.asarray(want.newton_iters))


def test_float32_inside_the_float64_envelope():
    """As the JAX package's own test: in f32 the arrowhead is
    ill-conditioned, so both f32 solvers carry a G looseness against the
    f64 truth (measured there ~1.5e-3); the fused solve must sit inside
    the plain solve's envelope, not element-wise near it."""
    T = 8
    ctl = np.stack([calc_controls("sine", a, 0.005, T)
                    for a in (0.7, 1.0, 1.3)], axis=1)
    asm64 = ka.make_ring_assembly(n_rods=3, base_radius=0.05, N=10,
                                  device="cpu")
    truth = ka.simulate_assembly(asm64, torch.tensor(ctl), tol=1e-24)
    asm32 = ka.make_ring_assembly(n_rods=3, base_radius=0.05, N=10,
                                  dtype=torch.float32, device="cpu")
    plain = ka.simulate_assembly(asm32, torch.tensor(ctl))
    fused = ka.simulate_assembly(asm32, torch.tensor(ctl), fused=True)
    err = lambda a, b: float((a.double() - b).abs().max())
    eG_p, eG_f = err(plain.Gs, truth.Gs), err(fused.Gs, truth.Gs)
    ep_p = err(plain.plate_pose, truth.plate_pose)
    ep_f = err(fused.plate_pose, truth.plate_pose)
    assert eG_f < 3.0 * eG_p + 1e-6, (eG_f, eG_p)
    assert ep_f < 3.0 * ep_p + 1e-7, (ep_f, ep_p)
    assert float(fused.residual_norm.max()) < 1e-4
    assert bool((fused.newton_iters[1:] >= 1).all())


def test_gauss_jordan_pivots_past_a_zero_diagonal():
    """The massless plate's rows have a structurally zero diagonal; the
    pivoted elimination must solve them as an LU does."""
    g = np.random.RandomState(0)
    A = g.randn(9, 9)
    A[np.arange(9), np.arange(9)] = 0.0
    b = g.randn(9)
    t = kops.gauss_jordan(torch.tensor(A), torch.tensor(b))
    np.testing.assert_allclose(t.numpy(), np.linalg.solve(A, b), rtol=1e-10)


def test_wrapper_refusals():
    asm = ka.make_ring_assembly(n_rods=2, N=4, device="cpu")
    k = kops.make_assembly_step_kernel(asm)
    X0 = torch.zeros(19, device="meta")
    with pytest.raises(ValueError, match="device"):
        k(X0, *(torch.zeros(s, device="meta") for s in
                ((2, 4, 19), (2, 4, 6), (2, 3), 3, 3, 4, 3)))
    with pytest.raises(NotImplementedError, match="contact"):
        kops.make_assembly_step_kernel(
            ka.with_contact_plane(asm, [0, 0, 1.0], 0.0))
