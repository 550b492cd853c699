"""The port's multi-rod assembly (core/assembly.py) against the JAX package
(float64 on the CPU): the constructors, the plate algebra with and without
contact and plate mass, the structured Jacobian, the plain coupled
rollout (dense and structured solvers, a contact plane, per-rod nets), the
one-rod massless reduction to the single-rod rollout, and the refusals."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knode_cosserat_tpu.controls import calc_controls
from knode_cosserat_tpu.core import assembly as ja
from knode_cosserat_tpu.models import mlp as jmlp
from knode_cosserat_tpu_torch.core import assembly as ka
from knode_cosserat_tpu_torch.core.multiple_shooting import jacobian
from knode_cosserat_tpu_torch.core.params import make_rod
from knode_cosserat_tpu_torch.core.stepper import simulate_scan
from knode_cosserat_tpu_torch.models import mlp as kmlp

torch.set_num_threads(1)
ROLLOUT_ATOL = 1e-9          # G and plate pose, f64, both solved to 1e-24


def _pair(M=2, N=6, **kw):
    asm = ja.make_ring_assembly(n_rods=M, base_radius=0.04, N=N,
                                dtype=jnp.float64, **kw)
    return asm, ka.assembly_from_jax(asm, device="cpu")


def _controls(M, T, args=(0.8, 1.2, 1.0)):
    return np.stack([calc_controls("sine", a, 0.005, T) for a in args[:M]],
                    axis=1)


def _leaves(asm_k):
    out = [t for r in asm_k.rods for _, t in r.leaves()]
    pl = asm_k.plate
    out += [t for t in (pl.mass, pl.inertia, pl.attach_offsets,
                        pl.attach_quats, pl.g, pl.contact_plane,
                        pl.contact_points, pl.contact_k, pl.contact_d,
                        pl.contact_beta) if t is not None]
    return out + [asm_k.p_plate0, asm_k.h_plate0]


def test_constructors_match_jax():
    """make_ring_assembly / with_contact_plane / AssemblyCarry.initial of
    the port, leaf for leaf, against assembly_from_jax of the JAX ones
    (rods derived in f64 numpy on both sides)."""
    kw = dict(plate_mass=0.05, plate_inertia=1e-4 * np.eye(3))
    asm_j, via = _pair(M=3, N=7, **kw)
    own = ka.make_ring_assembly(n_rods=3, base_radius=0.04, N=7,
                                device="cpu", **kw)
    for a, b in zip(_leaves(own), _leaves(via), strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-15, atol=0)
    cj = ja.with_contact_plane(asm_j, [0.0, 1.0, 1.0], 0.3, k=2e4)
    ck = ka.with_contact_plane(own, [0.0, 1.0, 1.0], 0.3, k=2e4)
    for a, b in zip(_leaves(ck), _leaves(ka.assembly_from_jax(
            cj, device="cpu")), strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-15, atol=0)
    assert ck.plate.has_contact and not own.plate.has_contact
    carry_j = ja.AssemblyCarry.initial(asm_j)
    for a, b in zip(ka.AssemblyCarry.initial(own),
                    ka.carry_from_jax(carry_j, device="cpu"), strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-16)


@pytest.mark.parametrize("contact,mass", [(False, 0.0), (False, 0.05),
                                          (True, 0.05)])
def test_residual_algebra_matches_jax(contact, mass):
    kw = dict(plate_mass=mass, plate_inertia=mass * 2e-3 * np.eye(3))
    asm_j, _ = _pair(M=3, N=6, **kw)
    if contact:     # a plane the plate presses on (gap ~ -1/beta)
        asm_j = ja.with_contact_plane(asm_j, [0.1, 0.0, 1.0], 0.399,
                                      beta=2000.0)
    asm_k = ka.assembly_from_jax(asm_j, device="cpu")
    g = np.random.RandomState(3)
    tips = g.randn(3, 13)
    tips[:, 3:7] += [1.0, 0, 0, 0]
    plate7 = np.concatenate([[0.01, -0.02, 0.4], [1.0, 0.01, -0.02, 0.03]])
    hist = [g.randn(n) for n in (3, 3, 4, 3)]
    want = ja._residual_algebra(asm_j, jnp.asarray(tips),
                                jnp.asarray(plate7), *map(jnp.asarray, hist))
    got = ka._residual_algebra(asm_k, torch.tensor(tips),
                               torch.tensor(plate7), *map(torch.tensor, hist))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)
    # leading axes broadcast: a batch of 2 equals two single calls
    both = ka._residual_algebra(asm_k, torch.tensor(np.stack([tips, -tips])),
                                torch.tensor(np.stack([plate7, plate7])),
                                *map(torch.tensor, hist))
    np.testing.assert_allclose(both[0].numpy(), got.numpy(), rtol=1e-15)


def test_structured_jacobian_matches_dense():
    asm_j, asm_k = _pair(M=3, N=6, plate_mass=0.05,
                         plate_inertia=1e-4 * np.eye(3))
    g = np.random.RandomState(1)
    carry = ka.AssemblyCarry.initial(asm_k)
    c1, c2 = float(asm_k.rods[0].c1), float(asm_k.rods[0].c2)
    yh = (c1 + c2) * carry.y + torch.tensor(1e-3 * g.randn(3, 6, 19))
    zh = (c1 + c2) * carry.z
    tf = torch.tensor((5 + 2 * g.rand(3, 4)) @ np.asarray(
        asm_j.rods.tendon_dirs[0]))
    hist = [torch.tensor(1e-3 * g.randn(n)) for n in (3, 3, 4, 3)]
    X = torch.cat([torch.tensor(0.05 * g.randn(18)), carry.pp, carry.hp])
    kw = dict(yh=yh, zh=zh, tf=tf, pph=hist[0], vph=hist[1], hph=hist[2],
              wbh=hist[3])
    J_s, r_s = ka._assembly_jacobian(asm_k, X, **kw)
    res = lambda x: ka._assembly_residual(asm_k, x, **kw)
    J_d = jacobian(res, X)
    scale = float(J_d.abs().max())
    np.testing.assert_allclose(J_s.numpy(), J_d.numpy(), rtol=0,
                               atol=1e-10 * scale)
    np.testing.assert_allclose(r_s.numpy(), res(X).numpy(), rtol=1e-13,
                               atol=1e-13)
    J_j = jax.jacfwd(lambda x: ja._assembly_residual(
        asm_j, x, *(jnp.asarray(v.numpy()) for v in kw.values()), None,
        False))(jnp.asarray(X.numpy()))
    np.testing.assert_allclose(J_d.numpy(), np.asarray(J_j), rtol=0,
                               atol=1e-10 * scale)


def _per_rod_nets(M):
    spec = jmlp.MLPSpec.for_knode(8)
    trees = [jax.tree.map(lambda a: 1e-2 * a,
                          jmlp.init_mlp(spec, jax.random.PRNGKey(i),
                                        jnp.float64)) for i in range(M)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *trees)
    kspec = kmlp.MLPSpec.for_knode(8)
    return (spec, stacked), (kspec, [kmlp.params_from_jax(t, kspec,
                                                          device="cpu")
                                     for t in trees])


@pytest.mark.parametrize("case", ["structured", "dense", "contact",
                                  "per-rod nets"])
def test_simulate_assembly_matches_jax(case):
    """M=2, N=6, T=4 coupled rollouts, both solved to 1e-24."""
    asm_j, _ = _pair(M=2, N=6, plate_mass=0.02,
                     plate_inertia=1e-5 * np.eye(3))
    solver = "dense" if case == "dense" else "structured"
    jkw, kkw = dict(solver=solver), dict(solver=solver)
    if case == "contact":       # the plate starts pressed on the plane
        asm_j = ja.with_contact_plane(asm_j, [0.0, 0.0, 1.0], 0.3999)
    if case == "per-rod nets":
        (spec, stacked), (kspec, nets) = _per_rod_nets(2)
        jkw.update(nn_spec=spec, nn_params=stacked)
        kkw.update(nn_spec=kspec, nn_params=nets)
    asm_k = ka.assembly_from_jax(asm_j, device="cpu")
    ctl = _controls(2, 4)
    want = ja.simulate_assembly(asm_j, jnp.asarray(ctl), tol=1e-24, **jkw)
    got = ka.simulate_assembly(asm_k, torch.tensor(ctl), tol=1e-24, **kkw)
    for name in ("Gs", "plate_pose"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=0,
                                   atol=ROLLOUT_ATOL, err_msg=name)
    t_k, t_j = got.traj.numpy(), np.asarray(want.traj)
    np.testing.assert_allclose(t_k, t_j, rtol=1e-9,
                               atol=1e-9 * np.abs(t_j).max())
    assert got.traj.shape == (4, 2, 6, 50) and got.newton_iters.shape == (4,)
    assert float(got.residual_norm.max()) < 1e-11


def test_one_rod_massless_plate_is_the_free_tip_rollout():
    """M=1, massless plate, zero attachment offset == the single rod's
    free-tip problem (core/stepper.simulate_scan)."""
    asm = ka.make_ring_assembly(n_rods=1, base_radius=0.0, N=10, device="cpu")
    ctl = torch.tensor(calc_controls("sine", 0.5, 0.005, 10))
    ref = simulate_scan(make_rod(N=10, device="cpu"), ctl, tol=1e-24)
    out = ka.simulate_assembly(asm, ctl[:, None, :], tol=1e-24)
    assert float((out.traj[:, 0] - ref.traj).abs().max()) < 1e-9
    tip, plate = out.traj[-1, 0, -1, :7], out.plate_pose[-1]
    assert float((plate[:3] - tip[:3]).abs().max()) < 1e-9
    q, qt = plate[3:] / plate[3:].norm(), tip[3:] / tip[3:].norm()
    assert min(float((q - qt).abs().max()), float((q + qt).abs().max())) < 1e-9


def test_refusals_match_jax():
    with pytest.raises(ValueError, match="del_t"):
        ka.stack_rods([make_rod(N=6, device="cpu"),
                       make_rod(N=6, device="cpu", del_t=0.01)])
    with pytest.raises(ValueError, match="N and"):
        ka.stack_rods([make_rod(N=6, device="cpu"),
                       make_rod(N=7, device="cpu")])
    asm = ka.make_ring_assembly(n_rods=2, N=5, device="cpu")
    ctl = torch.tensor(_controls(2, 3))
    with pytest.raises(NotImplementedError, match="contact"):
        ka.simulate_assembly(ka.with_contact_plane(asm, [0, 0, 1.0], -0.1),
                             ctl, fused=True)
    with pytest.raises(NotImplementedError, match="KNODE"):
        ka.simulate_assembly(asm, ctl, fused=True,
                             nn_fn=lambda x: 0.0 * x[..., :25])
    with pytest.raises(ValueError, match="solve_fn"):
        ka.assembly_step_carry(asm, ka.AssemblyCarry.initial(asm), ctl[0],
                               nn_fn=lambda x: 0.0 * x[..., :25],
                               solve_fn=lambda *a: None)
    with pytest.raises(ValueError, match="M <= 9"):
        ka.simulate_assembly(ka.make_ring_assembly(n_rods=10, N=3,
                                                   device="cpu"),
                             torch.full((2, 10, 4), 5.0), fused=True)
    with pytest.raises(ValueError, match="solver"):
        ka.simulate_assembly(asm, ctl, solver="lu")
    with pytest.raises(ValueError, match="normal"):
        ka.with_contact_plane(asm, [0, 0, 0], 0.1)
