"""The PyTorch port's rod parameters and controls against the JAX package
(float64 on the CPU)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import knode_cosserat_tpu as J
import knode_cosserat_tpu_torch as K
from knode_cosserat_tpu.core.params import MODS, MODS_ORIGINAL
from knode_cosserat_tpu_torch.controls import calc_controls

torch.set_num_threads(1)

ROD_CASES = ([(False, m) for m in (None,) + MODS]
             + [(True, m) for m in (None,) + MODS_ORIGINAL])


@pytest.mark.parametrize("original,mod", ROD_CASES)
def test_rod_leaves_match_jax(original, mod):
    pj = J.apply_mod(mod, original=original)
    pk = K.apply_mod(mod, original=original, device="cpu")
    assert (pk.N, pk.n_tendons) == (pj.N, pj.n_tendons)
    assert pk.dtype == torch.float64
    names = [n for n, _ in pk.leaves()]
    assert len(names) == len(dataclasses.fields(pk)) - 2   # all but N, n_tendons
    for name, leaf in pk.leaves():
        np.testing.assert_allclose(leaf.numpy(), np.asarray(getattr(pj, name)),
                                   rtol=1e-15, atol=0, err_msg=name)


def test_rod_float32_and_from_numpy():
    pj = J.experimental_rod(N=12, dtype=jnp.float32)
    pk = K.experimental_rod(N=12, dtype=torch.float32, device="cpu")
    assert pk.dtype == torch.float32 and pk.N == 12
    for name, leaf in pk.leaves():
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(getattr(pj, name)),
                                      err_msg=name)
    # .to() casts the float64 rod's leaves exactly as derive(dtype=f32) does
    cast = K.experimental_rod(N=12, device="cpu").to(dtype=torch.float32)
    for (name, a), (_, b) in zip(cast.leaves(), pk.leaves()):
        assert torch.equal(a, b), name
    # rod_from_numpy takes the JAX rod's leaves as they are
    back = K.rod_from_numpy(J.apply_mod("youngs"), device="cpu")
    ref = K.apply_mod("youngs", device="cpu")
    for (name, a), (_, b) in zip(back.leaves(), ref.leaves()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("kind,arg", [("sine", 1.0), ("step", 2.0),
                                      ("random", 3.0), ("ramp", 0.5)])
def test_calc_controls_is_the_jax_packages(kind, arg):
    a = calc_controls(kind, arg, 0.05, 40)
    b = J.calc_controls(kind, arg, 0.05, 40)
    np.testing.assert_array_equal(a, b)
