"""Beamforming tests: steering gain, FFT beam space."""

import numpy as np
import jax.numpy as jnp

from rsp_chains.ops.beamform import beamform, fft_beamform, ula_steering


def _plane_wave(c, t, angle, rng, snr=10.0):
    s = np.exp(2j * np.pi * 0.1 * np.arange(t))
    a = ula_steering(c, [angle])[0]
    x = np.outer(a, s)  # arriving wavefront matches the steering convention
    x += (rng.randn(c, t) + 1j * rng.randn(c, t)) / np.sqrt(2) / snr
    return x.astype(np.complex64)


def test_steered_beam_maximizes_on_target(rng):
    c, t = 8, 256
    target = 0.3
    x = _plane_wave(c, t, target, rng)
    angles = np.linspace(-1.2, 1.2, 41)
    w = ula_steering(c, angles)
    y = np.asarray(beamform(jnp.asarray(x), jnp.asarray(w)))
    powers = (np.abs(y) ** 2).mean(-1)
    assert abs(angles[np.argmax(powers)] - target) < 0.1


def test_beamform_batched_shape(rng):
    x = (rng.randn(3, 8, 64) + 1j * rng.randn(3, 8, 64)).astype(np.complex64)
    w = ula_steering(8, np.linspace(-1, 1, 5))
    y = beamform(jnp.asarray(x), jnp.asarray(w))
    assert y.shape == (3, 5, 64)


def test_fft_beamform_matches_dft(rng):
    x = (rng.randn(2, 16, 32) + 1j * rng.randn(2, 16, 32)).astype(np.complex64)
    got = np.asarray(fft_beamform(jnp.asarray(x)))
    want = np.fft.fft(x, axis=-2)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_beamform_gain(rng):
    """Coherent gain: beam SNR improves ~C over single channel."""
    c, t = 16, 512
    x = _plane_wave(c, t, 0.0, rng, snr=1.0)
    w = ula_steering(c, [0.0])
    y = np.asarray(beamform(jnp.asarray(x), jnp.asarray(w)))[0]
    def snr(sig):
        spec = np.abs(np.fft.fft(sig)) ** 2
        k = round(0.1 * t)
        return spec[k] / np.median(spec)
    assert snr(y) > 4 * snr(x[0])
