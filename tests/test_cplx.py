"""Pair-complex representation (cplx.C): arithmetic, conversions, Gauss matmul."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rsp_chains.cplx import (
    C, as_pair, gauss_triple, join, like, matmul_gauss, to_numpy,
)


def _rand_c(rng, *shape):
    return (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)


def test_roundtrip_and_split(rng):
    z = _rand_c(rng, 3, 8)
    c = as_pair(z)
    np.testing.assert_array_equal(to_numpy(c), z)
    np.testing.assert_array_equal(np.asarray(join(c)), z)
    # real input -> zero imaginary part
    r = as_pair(np.ones((4,), np.float32))
    assert np.all(np.asarray(r.im) == 0)


def test_arithmetic_matches_complex(rng):
    a, b = _rand_c(rng, 16), _rand_c(rng, 16)
    ca, cb = as_pair(a), as_pair(b)
    np.testing.assert_allclose(to_numpy(ca * cb), a * b, rtol=1e-5)
    np.testing.assert_allclose(to_numpy(ca + cb), a + b, rtol=1e-6)
    np.testing.assert_allclose(to_numpy(ca - cb), a - b, rtol=1e-6)
    np.testing.assert_allclose(to_numpy(ca.conj()), np.conj(a), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(ca.abs()), np.abs(a), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(ca.abs2()), np.abs(a) ** 2, rtol=1e-5)
    np.testing.assert_allclose(to_numpy(2.0 * ca), 2 * a, rtol=1e-6)


def test_pytree_through_jit(rng):
    z = as_pair(_rand_c(rng, 8))
    f = jax.jit(lambda c: (c * c.conj()).re)
    np.testing.assert_allclose(np.asarray(f(z)), np.asarray(z.abs2()), rtol=1e-5)


def test_gauss_matmul_matches_complex(rng):
    m = _rand_c(rng, 16, 16)
    x = as_pair(_rand_c(rng, 4, 16))
    got = to_numpy(matmul_gauss(gauss_triple(m), x, "km,...m->...k"))
    want = to_numpy(x) @ m.T
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_like_preserves_representation(rng):
    z = _rand_c(rng, 4)
    c = as_pair(z)
    assert isinstance(like(c, c), C)
    assert jnp.iscomplexobj(like(jnp.asarray(z), c))


def test_indexing_and_reshape(rng):
    c = as_pair(_rand_c(rng, 4, 8))
    assert c[1:3].shape == (2, 8)
    assert c.reshape(32).shape == (32,)
    assert c[..., :4].shape == (4, 4)
