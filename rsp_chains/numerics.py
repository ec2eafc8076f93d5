"""Numerics substrate: dtype policy and fixed-point fidelity.

The reference computes everything in dsptools ``FixedPoint(16.W, bp.BP)`` /
``DspComplex`` (SURVEY §L0; ``RspChain.scala:131-133``). The framework computes in
float32/complex64 (the fast path) and offers an injectable *quantization policy*
applied at stage boundaries, so an int16 "bit-true-ish" mode can be checked against
reference-style fixed-point streams within an SNR bound without duplicating ops.

Rounding modes mirror dsptools (``RoundHalfUp``, ``RspChainVanillaTester.scala:201``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .configs import FixedPointConfig, Rounding


def round_to_int(x: jnp.ndarray, mode: Rounding) -> jnp.ndarray:
    """Round float values to integers under the given fixed-point rounding mode."""
    if mode is Rounding.HALF_UP:
        # round-half-up: floor(x + 0.5) — matches dsptools RoundHalfUp
        return jnp.floor(x + 0.5)
    if mode is Rounding.HALF_EVEN:
        return jnp.round(x)
    if mode is Rounding.TRUNCATE:
        return jnp.trunc(x)
    raise ValueError(f"unknown rounding mode {mode}")


def quantize(x: jnp.ndarray, cfg: FixedPointConfig) -> jnp.ndarray:
    """Quantize a (real or complex) float array onto the fixed-point grid
    2^-bin_point with saturation at the 2's-complement ``width`` range.

    Identity when ``cfg.enabled`` is False. Values stay in float domain (scaled back
    down) so downstream ops are unchanged; only the representable grid is enforced.
    """
    from .cplx import C

    if not cfg.enabled:
        return x
    if isinstance(x, C):
        return C(quantize(x.re, cfg), quantize(x.im, cfg))
    if jnp.iscomplexobj(x):
        re = quantize(x.real, cfg)
        im = quantize(x.imag, cfg)
        return jax.lax.complex(re, im)
    scaled = x * cfg.scale
    q = round_to_int(scaled, cfg.rounding)
    q = jnp.clip(q, cfg.min_int, cfg.max_int)
    return q / cfg.scale


def saturate_int(x: jnp.ndarray, width: int) -> jnp.ndarray:
    """Saturate integer values to the signed ``width``-bit range."""
    lo = -(2 ** (width - 1))
    hi = 2 ** (width - 1) - 1
    return jnp.clip(x, lo, hi)


def snr_db(reference, test) -> float:
    """Signal-to-noise ratio of ``test`` against ``reference`` in dB.

    Replaces the reference's +/-2-LSB tolerance checks
    (``RspChainTesterUtils.scala:221-237``) for float-vs-fixed comparisons.
    """
    import numpy as np

    reference = np.asarray(reference, dtype=np.complex128)
    test = np.asarray(test, dtype=np.complex128)
    err = reference - test
    p_sig = float(np.sum(np.abs(reference) ** 2))
    p_err = float(np.sum(np.abs(err) ** 2))
    if p_err == 0.0:
        return float("inf")
    return 10.0 * float(np.log10(p_sig / p_err))
