"""Pulse-integration ops: coherent/non-coherent SNR gain, m-of-n fusion."""

import numpy as np
import jax.numpy as jnp

from rsp_chains.ops.integrate import (
    binary_integration, coherent_integration, noncoherent_integration,
)


def test_coherent_gain(rng):
    p, n = 64, 256
    tone = np.exp(2j * np.pi * 0.1 * np.arange(n)) * 0.1
    x = tone[None, :] + (rng.randn(p, n) + 1j * rng.randn(p, n)) / np.sqrt(2)
    y = np.asarray(coherent_integration(jnp.asarray(x, jnp.complex64)))
    # coherent sum: signal grows as P, noise as sqrt(P)
    snr_single = np.abs(np.fft.fft(x[0]))[round(0.1 * n)] / np.median(np.abs(np.fft.fft(x[0])))
    snr_int = np.abs(np.fft.fft(y))[round(0.1 * n)] / np.median(np.abs(np.fft.fft(y)))
    assert snr_int > 4 * snr_single


def test_noncoherent_average(rng):
    m = np.abs(rng.randn(8, 32)).astype(np.float32)
    got = np.asarray(noncoherent_integration(jnp.asarray(m)))
    np.testing.assert_allclose(got, m.mean(0), rtol=1e-6)
    got_sum = np.asarray(noncoherent_integration(jnp.asarray(m), average=False))
    np.testing.assert_allclose(got_sum, m.sum(0), rtol=1e-6)


def test_binary_m_of_n():
    peaks = np.zeros((5, 10), bool)
    peaks[:3, 4] = True   # 3-of-5 at cell 4
    peaks[:1, 7] = True   # 1-of-5 at cell 7
    got = np.asarray(binary_integration(jnp.asarray(peaks), m=2))
    assert got[4] and not got[7]
    got3 = np.asarray(binary_integration(jnp.asarray(peaks), m=4))
    assert not got3[4]
