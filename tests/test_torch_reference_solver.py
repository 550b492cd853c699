"""The port's MINPACK-driven rollout (core/reference_solver.py) against the
JAX package's, float64 on the CPU: Euler and RK4 over a few steps (RMSE
1e-9), the stiff original-paper golden at tests/test_parity.py's bar for
this path (1e-9), and the float64-only contract."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knode_cosserat_tpu.controls import calc_controls
from knode_cosserat_tpu.core import params as jp
from knode_cosserat_tpu.core import reference_solver as jrs
from knode_cosserat_tpu_torch.core import params as kp
from knode_cosserat_tpu_torch.core.reference_solver import simulate_fsolve

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


@pytest.mark.parametrize("method", ["euler", "rk4"])
def test_fsolve_rollout_matches_jax(method):
    jrod = jp.make_rod(N=10, dtype=jnp.float64)
    krod = kp.make_rod(N=10, device="cpu")
    ctl = calc_controls("sine", 0.5, float(krod.del_t), 8)
    want = jrs.simulate_fsolve(jrod, ctl, method=method)
    got = simulate_fsolve(krod, ctl, method=method)
    assert got.shape == want.shape == (8, 10, 50)
    assert np.sqrt(np.mean((got - want) ** 2)) < 1e-9


def test_fsolve_matches_stiff_golden():
    """The stiff original-paper rod: the reference's own solver stack over
    the port's residual reproduces the golden (tests/test_parity.py::
    test_fsolve_emulation_matches_stiff_golden's 1e-9)."""
    path = os.path.join(GOLDEN, "sine_1_0_30_None_orig.npz")
    if not os.path.exists(path):
        pytest.skip("golden data not generated (scripts/gen_golden.py)")
    data = np.load(path)
    p = kp.apply_mod(None, original=True, device="cpu")
    traj = simulate_fsolve(p, data["controls"], reference_layout=True)
    assert traj.shape == data["traj"].shape
    assert np.sqrt(np.mean((traj - data["traj"]) ** 2)) < 1e-9


def test_fsolve_requires_float64():
    p = kp.make_rod(N=4, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="float64"):
        simulate_fsolve(p, np.ones((3, 4)))
    with pytest.raises(ValueError, match="unknown method"):
        simulate_fsolve(kp.make_rod(N=4, device="cpu"), np.ones((3, 4)),
                        method="midpoint")
