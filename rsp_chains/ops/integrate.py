"""Pulse integration — coherent / non-coherent / binary (m-of-n).

The reference's tester utilities are lifted from an upstream spectrometer design
whose accumulator block integrates magnitude frames ("used also for checking
output of the accumulator", ``RspChainTesterUtils.scala:229-231``); integration
is the standard radar post-detection gain stage, so it is a first-class op here.

All three reduce over the pulse axis (axis -2 of [..., P, N] blocks) and are
plain reductions XLA fuses into the surrounding chain.
"""

from __future__ import annotations

import jax.numpy as jnp


def coherent_integration(iq: jnp.ndarray, axis: int = -2) -> jnp.ndarray:
    """Complex sum over pulses: +10log10(P) SNR gain for phase-stable returns."""
    return jnp.sum(iq, axis=axis)


def noncoherent_integration(mag: jnp.ndarray, axis: int = -2,
                            average: bool = True) -> jnp.ndarray:
    """Magnitude-domain integration over pulses (no phase assumption)."""
    s = jnp.sum(mag, axis=axis)
    if average:
        s = s / mag.shape[axis]
    return s


def binary_integration(peaks: jnp.ndarray, m: int, axis: int = -2) -> jnp.ndarray:
    """m-of-n detection fusion: a cell detects when >= m of the n per-pulse CFAR
    decisions fired (the classic double-threshold detector)."""
    counts = jnp.sum(peaks.astype(jnp.int32), axis=axis)
    return counts >= m
