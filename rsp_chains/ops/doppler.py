"""Doppler (slow-time) FFT over the pulse axis of a CPI (BASELINE config 3).

The reference processes a single range line per frame; the 2-D range-Doppler map is
the north-star extension (SURVEY §2.3: "Used twice in 2D: range FFT over fast time,
Doppler FFT over slow time"). The pulse axis is axis -2 of a ``[..., P, N]`` CPI
block. Implemented with the same four-step matmul FFT (real-pair arithmetic) by
transposing the pulse axis last (a relayout XLA handles natively)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..configs import DopplerConfig, FftScaling
from ..cplx import C, CLike, as_pair, like
from .fft import _four_step_c
from .windows import window as make_window


def doppler_fft(cpi: CLike, cfg: DopplerConfig = DopplerConfig()) -> CLike:
    """Doppler transform of a CPI block over axis -2 (pulses).

    ``cpi``: [..., P, N] (P pulses, N range bins), pair or complex. Returns
    [..., P, N] Doppler-transformed (optionally windowed, fftshifted so zero
    Doppler is centered)."""
    xp = as_pair(cpi)
    p = xp.shape[-2]
    assert (p & (p - 1)) == 0, "num_pulses must be a power of two"
    if cfg.window is not None:
        w = jnp.asarray(make_window(cfg.window, p))[..., :, None]
        xp = xp * w
    xt = C(jnp.swapaxes(xp.re, -1, -2), jnp.swapaxes(xp.im, -1, -2))
    yt = _four_step_c(xt, p)
    if cfg.scaling is FftScaling.DIV_N:
        yt = yt * (1.0 / p)
    elif cfg.scaling is FftScaling.SQRT_N:
        yt = yt * float(1.0 / np.sqrt(p))
    y = C(jnp.swapaxes(yt.re, -1, -2), jnp.swapaxes(yt.im, -1, -2))
    if cfg.fft_shift:
        y = C(jnp.roll(y.re, p // 2, axis=-2), jnp.roll(y.im, p // 2, axis=-2))
    return like(cpi, y)
