"""The port's energy budgets, reference-weight import and experiment config
against the JAX package's on the same numpy inputs (float64, CPU)."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import knode_cosserat_tpu as J
import knode_cosserat_tpu_torch as K
from knode_cosserat_tpu import config as jconfig
from knode_cosserat_tpu.core import energy as jenergy
from knode_cosserat_tpu.core.assembly import make_ring_assembly as j_ring
from knode_cosserat_tpu.models import io as jio
from knode_cosserat_tpu_torch import config as tconfig
from knode_cosserat_tpu_torch.core import energy as tenergy
from knode_cosserat_tpu_torch.core.assembly import make_ring_assembly as t_ring
from knode_cosserat_tpu_torch.models import io as tio

torch.set_num_threads(1)
ENERGY_RTOL = 1e-12


def _unit_quats(g, shape):
    q = g.normal(size=shape + (4,)) * 0.1
    q[..., 0] += 1.0
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _states(g, lead, N):
    """Random rod states (..., N, 25) around the straight rod, with unit
    quaternions."""
    x = g.normal(size=lead + (N, 25)) * 0.05
    x[..., 2] += np.linspace(0.0, 0.5, N)
    x[..., 3:7] = _unit_quats(g, lead + (N,))
    x[..., 21] += 1.0
    return x


def _assert_energies(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=ENERGY_RTOL, atol=0, err_msg=k)


@pytest.mark.parametrize("mod", [None, "nsw", "youngs"])
def test_rod_energies_match_jax(mod):
    g = np.random.default_rng(0)
    traj = _states(g, (7,), 10)
    traj = np.concatenate([traj, g.normal(size=traj.shape[:-1] + (25,))],
                          axis=-1)                     # history channels
    pj = J.apply_mod(mod, dtype=jnp.float64)
    pt = K.apply_mod(mod, device="cpu")
    got = tenergy.rod_energies(pt, traj)
    _assert_energies(got, jenergy.rod_energies(pj, traj))
    assert tenergy.energy_summary(pt, traj) == jenergy.energy_summary(pj,
                                                                      traj)


@pytest.mark.parametrize("n_rods,plate_mass", [(2, 0.0), (3, 0.2)])
def test_assembly_energies_match_jax(n_rods, plate_mass):
    g = np.random.default_rng(n_rods)
    T, N = 6, 6
    traj = _states(g, (T, n_rods), N)
    plate = np.concatenate([g.normal(size=(T, 3)) * 0.01
                            + [0.0, 0.0, 0.5], _unit_quats(g, (T,))], -1)
    aj = j_ring(n_rods=n_rods, N=N, plate_mass=plate_mass, dtype=jnp.float64)
    at = t_ring(n_rods=n_rods, N=N, plate_mass=plate_mass, device="cpu")
    got = tenergy.assembly_energies(at, traj, plate)
    _assert_energies(got, jenergy.assembly_energies(aj, traj, plate))
    assert float(got["plate_kinetic"].abs().max()) > 0 or plate_mass == 0.0


def test_energy_refusals():
    p = K.apply_mod(None, device="cpu")
    with pytest.raises(ValueError, match="traj must be"):
        tenergy.rod_energies(p, np.zeros((4, 10, 19)))
    asm = K.core.assembly.with_contact_plane(
        t_ring(n_rods=2, N=6, device="cpu"), [0, 0, 1], 0.3)
    with pytest.raises(ValueError, match="contact"):
        tenergy.assembly_energies(asm, np.zeros((3, 2, 6, 25)),
                                  np.zeros((3, 7)))


def _stand_in_robot(seed):
    """The reference's robot as far as the importer reads it: nn_models, a
    ModuleList of Linear 53->16, ELU, Dropout, Linear 16->25."""
    torch.manual_seed(seed)
    nn = torch.nn
    return types.SimpleNamespace(nn_models=nn.ModuleList([
        nn.Linear(53, 16), nn.ELU(), nn.Dropout(0.1), nn.Linear(16, 25)]))


def test_reference_weights_match_jax(tmp_path, caplog):
    robot = _stand_in_robot(0)
    spec_j, params_j = jio.params_from_torch_modules(robot.nn_models,
                                                     jnp.float64)
    spec_t, net = tio.params_from_torch_modules(robot.nn_models,
                                                torch.float64, "cpu")
    assert (spec_t.dims, spec_t.activation, spec_t.history) == (
        spec_j.dims, spec_j.activation, spec_j.history) == ((53, 16, 25),
                                                            "elu", True)
    for (w, b), layer in zip(net.weights(), params_j):
        assert np.array_equal(w.detach().numpy(), np.asarray(layer["w"]))
        assert np.array_equal(b.detach().numpy(), np.asarray(layer["b"]))
    x = np.random.default_rng(1).normal(size=(64, 53))
    want = np.asarray(J.models.mlp_apply(spec_j, params_j, jnp.asarray(x)))
    got = K.mlp_apply(spec_t, net, torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)

    # a pickled checkpoint, as physics_train.py:284-288 writes it
    path = str(tmp_path / "robot.pth")
    torch.save({"robot": robot, "loss": [3.0, 2.0], "dtw": 0.5}, path)
    with caplog.at_level("WARNING"):
        out = tio.load_reference_pth(path, dtype=torch.float64, device="cpu")
    assert "weights_only=False" in caplog.text
    ref = jio.load_reference_pth(path, dtype=jnp.float64)
    assert out["spec"] == spec_t and out["loss"] == ref["loss"] == [3.0, 2.0]
    assert out["dtw"] == 0.5
    for (w, _), layer in zip(out["params"].weights(), ref["params"]):
        assert np.array_equal(w.detach().numpy(), np.asarray(layer["w"]))


def test_reference_weights_refuse_unknown_layers():
    with pytest.raises(ValueError, match="unsupported layer"):
        tio.params_from_torch_modules(
            torch.nn.ModuleList([torch.nn.Linear(28, 4), torch.nn.GELU()]),
            device="cpu")


@pytest.mark.parametrize("kw", [
    {},
    dict(rod=dict(mod="nsw"), data=dict(specs=[("sine", 0.5), ("sine", 1.0)],
                                        train_len=12, noise_traj=0.01),
         train=dict(epochs=7, hidden=64, seed=3, dtype="float64")),
    dict(rod=dict(mod="short", original=True), eval=dict(
        validation=("step", 1.5)), name="named"),
])
def test_config_matches_jax(kw, tmp_path):
    def build(mod):
        sub = {k: v for k, v in kw.items() if k != "name"}
        parts = dict(rod=mod.RodConfig(**sub.get("rod", {})),
                     data=mod.DataConfig(**sub.get("data", {})),
                     eval=mod.EvalConfig(**sub.get("eval", {})))
        tr = sub.get("train", {})
        parts["train"] = mod.TrainConfig(**tr)
        return mod.ExperimentConfig(name=kw.get("name", ""), **parts)

    cj, ct = build(jconfig), build(tconfig)
    assert ct.short_name() == cj.short_name()
    assert ct.to_dict() == cj.to_dict()
    ct.save(str(tmp_path / "c.json"))
    back = jconfig.ExperimentConfig.load(str(tmp_path / "c.json"))
    assert back.to_dict() == cj.to_dict()
    assert tconfig.ExperimentConfig.from_dict(cj.to_dict()).to_dict() == \
        ct.to_dict()
    rod = ct.rod.build(device="cpu")
    assert rod.dtype == torch.float64 and rod.device.type == "cpu"
    assert float(rod.L) == float(cj.rod.build(jnp.float64).L)
