"""Beamforming over the channel axis (multi-channel front end).

The reference processes one channel per elaborated chain; multi-channel arrays
would be N chain instances (SURVEY §2.15 "data parallel over channels/beams").
Conventional (Bartlett) beamforming is one ``[beams, channels] x [channels,
samples]`` complex matmul — three real matmuls via Gauss's algorithm in the
pair representation — inside the chain jit.

Conventions: channels along axis ``-2`` of ``[..., C, T]`` blocks (fast time /
range last, like everywhere else in the framework). Steering for a uniform
linear array (ULA) with half-wavelength spacing by default.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..cplx import C, CLike, as_pair, gauss_triple, like, matmul_gauss
from .fft import _four_step_c


def ula_steering(num_channels: int, angles_rad, spacing_wavelengths: float = 0.5) -> np.ndarray:
    """Steering matrix A [beams, channels] for a uniform linear array:
    A[b, c] = exp(-j 2 pi d c sin(theta_b))."""
    angles = np.atleast_1d(np.asarray(angles_rad, np.float64))
    c = np.arange(num_channels)
    phase = -2j * np.pi * spacing_wavelengths * np.outer(np.sin(angles), c)
    return np.exp(phase).astype(np.complex64)


def beamform(x: CLike, weights: np.ndarray) -> CLike:
    """Weighted beam formation: ``x`` [..., C, T] (pair or complex), ``weights``
    [B, C] host complex (conjugated internally, conventional beamformer).
    Returns [..., B, T]. One Gauss complex matmul -> 3 real matmuls."""
    xp = as_pair(x)
    w = np.conj(np.asarray(weights))
    return like(x, matmul_gauss(gauss_triple(w), xp, "bc,...ct->...bt"))


def fft_beamform(x: CLike) -> CLike:
    """DFT across the channel axis: C uniformly spaced beams at spatial
    frequencies k/C (the spatial analog of the range FFT). ``x`` [..., C, T] ->
    [..., C, T] beam space."""
    xp = as_pair(x)
    c = xp.shape[-2]
    xt = C(jnp.swapaxes(xp.re, -1, -2), jnp.swapaxes(xp.im, -1, -2))
    if c & (c - 1) == 0:
        yt = _four_step_c(xt, c)
    else:
        a = np.exp(-2j * np.pi * np.outer(np.arange(c), np.arange(c)) / c)
        yt = matmul_gauss(gauss_triple(a), xt, "kc,...c->...k")
    y = C(jnp.swapaxes(yt.re, -1, -2), jnp.swapaxes(yt.im, -1, -2))
    return like(x, y)
