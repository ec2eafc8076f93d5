"""LogMagMux — runtime-muxed magnitude extraction.

Whole-array rebuild of the reference's ``AXI4LogMagMuxBlock`` (SURVEY §2.4;
constructor at ``RspChain.scala:44``, params ``MAGParams.fixed`` at
``RspChain.scala:120-129``). The hardware muxes between magnitude functions via a
runtime register (base+0, ``RspChainVanillaTester.scala:98``); here the same mux is
a ``lax.switch`` over traced ``RuntimeConfig.mag_mode``, so changing the mode never
recompiles. Golden menu: ``RspChainTesterUtils.scala:120-127,197-216``.

Modes (see ``configs.MagMode``): 0 abs, 1 squared, 2 JPL approximation, 3 log2(jpl).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..configs import LogMagConfig


def _jpl(re: jnp.ndarray, im: jnp.ndarray) -> jnp.ndarray:
    """JPL magnitude approximation max(u + v/8, 7u/8 + v/2)
    (``RspChainTesterUtils.scala:120-127``). Multiplier-free in hardware (shifts and
    adds); on the device it is a handful of elementwise ops that XLA fuses into the
    preceding FFT's epilogue."""
    u = jnp.maximum(jnp.abs(re), jnp.abs(im))
    v = jnp.minimum(jnp.abs(re), jnp.abs(im))
    return jnp.maximum(u + v * 0.125, u * 0.875 + v * 0.5)


def logmag(x, mag_mode: jnp.ndarray, cfg: LogMagConfig | None = None) -> jnp.ndarray:
    """Compute the runtime-selected magnitude of complex input ``x``.

    Args:
      x: complex array or ``cplx.C`` pair (the device representation), any shape.
      mag_mode: traced int32 scalar, ``MagMode`` code (the base+0 register).
      cfg: static LogMagConfig (LUT-log fidelity options).

    Returns float32 array of the same shape.
    """
    from ..cplx import as_pair

    cfg = cfg or LogMagConfig()
    xp = as_pair(x)
    re, im = xp.re, xp.im

    def mode_abs(_):
        return jnp.sqrt(re * re + im * im)

    def mode_sqr(_):
        return re * re + im * im

    def mode_jpl(_):
        return _jpl(re, im)

    def mode_log2(_):
        j = _jpl(re, im)
        if cfg.use_lut_log:
            # Bit-faithful-ish LUT path: log2 with the fractional part truncated to
            # log2_lookup_width bits (MAGParams.log2LookUpWidth, RspChain.scala:125),
            # then snapped/clamped to the FixedPoint(data_width_log, bin_point_log)
            # output proto (protoLog, RspChainVanillaTester.scala:222-224)
            lg = jnp.log2(jnp.maximum(j, 1e-30))
            q = 2.0 ** cfg.log2_lookup_width
            lg = jnp.floor(lg * q) / q
            qo = 2.0 ** cfg.bin_point_log
            hi = (2.0 ** (cfg.data_width_log - 1) - 1) / qo
            lo = -(2.0 ** (cfg.data_width_log - 1)) / qo
            return jnp.clip(jnp.floor(lg * qo) / qo, lo, hi)
        return jnp.log2(jnp.maximum(j, 1e-30))

    return jax.lax.switch(
        jnp.clip(mag_mode, 0, 3), [mode_abs, mode_sqr, mode_jpl, mode_log2], None
    )
