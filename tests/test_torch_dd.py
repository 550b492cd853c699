"""The port's double-double reductions (ops/dd.py) against the JAX
package's: the error-free transformations are exact (checked in float64
arithmetic), and dd_sum / dd_gram return the JAX functions' (hi, lo) bit
for bit on the same float32 inputs. The port's sysid forms its Gram in
float64 instead; its difference from the JAX dd Gram of the same float32
J is bounded here."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knode_cosserat_tpu.ops import dd as jdd
from knode_cosserat_tpu_torch.ops import dd

torch.set_num_threads(1)


def _ill_conditioned(seed=0):
    """A float32 (500, 7) J with singular values spanning 1e6."""
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.normal(size=(500, 7)))
    V, _ = np.linalg.qr(rng.normal(size=(7, 7)))
    return ((U * np.logspace(0, -6, 7)) @ V.T).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_error_free_transforms(dtype):
    rng = np.random.default_rng(0)
    a = torch.tensor(rng.normal(size=256), dtype=dtype)
    b = torch.tensor(rng.normal(size=256) * 1e-4, dtype=dtype)
    s, e = dd.two_sum(a, b)
    p, f = dd.two_prod(a, b)
    if dtype == torch.float32:     # exact in float64 arithmetic
        A, B = a.double().numpy(), b.double().numpy()
        np.testing.assert_array_equal(s.double().numpy() + e.double().numpy(),
                                      A + B)
        np.testing.assert_array_equal(p.double().numpy() + f.double().numpy(),
                                      A * B)
    else:                          # the rounding is the error term
        assert torch.equal(s, a + b) and torch.equal(p, a * b)
        assert torch.equal(s + e, s) and torch.equal(p + f, p)
        assert bool((e != 0).any()) and bool((f != 0).any())


def test_dd_sum_matches_jax_bit_for_bit():
    rng = np.random.default_rng(1)
    x = rng.normal(size=4097) * np.where(rng.random(4097) < 0.5, 1.0, 1e-5)
    x32 = x.astype(np.float32)
    hi, lo = dd.dd_sum(torch.from_numpy(x32), torch.zeros(4097))
    jhi, jlo = jdd.dd_sum(jnp.asarray(x32), jnp.zeros(4097, jnp.float32))
    assert hi.dtype == torch.float32
    assert float(hi) == float(jhi) and float(lo) == float(jlo)
    exact = np.sum(x32.astype(np.float64))
    assert abs(float(dd.dd_to_float64(hi, lo)) - exact) < 1e-10 * abs(exact)
    # along another dim: the same tree per column
    m = torch.from_numpy(x32[:4096].reshape(64, 64))
    h2, l2 = dd.dd_sum(m, torch.zeros_like(m), dim=1)
    jh2, jl2 = jdd.dd_sum(jnp.asarray(m.numpy()), jnp.zeros((64, 64),
                                                             jnp.float32),
                          axis=1)
    np.testing.assert_array_equal(h2.numpy(), np.asarray(jh2))
    np.testing.assert_array_equal(l2.numpy(), np.asarray(jl2))


def test_dd_gram_matches_jax_and_the_float64_gram():
    J = _ill_conditioned()
    hi, lo = dd.dd_gram(torch.from_numpy(J))
    jhi, jlo = jdd.dd_gram(jnp.asarray(J))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    G_dd = dd.dd_to_float64(hi, lo)
    np.testing.assert_array_equal(G_dd, jdd.dd_to_float64(jhi, jlo))
    # sysid's float64 Gram of the same J (training/sysid.py::_gram) sits
    # within 1e-14 of the dd Gram; the smallest eigenvalue agrees
    J64 = torch.from_numpy(J).double()
    G_64 = (J64.T @ J64).numpy()
    assert np.abs(G_dd - G_64).max() < 1e-14
    np.testing.assert_allclose(np.linalg.eigvalsh(G_dd)[0],
                               np.linalg.eigvalsh(G_64)[0], rtol=1e-3)
    with pytest.raises(ValueError, match="dd_gram"):
        dd.dd_gram(torch.from_numpy(J[:, 0]))
