"""NCO — numerically controlled oscillator (SURVEY §2.2).

Whole-array rebuild of ``AXI4NCOLazyModuleBlock`` (constructor ``RspChain.scala:42``,
``FixedNCOParams`` at ``RspChainVanillaTester.scala:192-204``). The hardware is a
``phase_width``-bit phase accumulator driven by the PLFG frequency-word stream
(``pincType = Streaming``: ``nco.freq := plfg.streamNode``, ``RspChain.scala:57``)
indexing a sine/cosine LUT of ``table_size`` entries (quadrant-folded; the tested
config has table_size=128, phase_width=9 => 512 phase positions = 4*table_size).

Phase contract: a constant word ``s`` yields a phase step of ``s / 2^phase_width`` =
``s / (4*table_size)`` cycles/sample, hence the reference's peak-bin formula
``s * N / (4*table_size)`` (``RspChainVanillaTester.scala:85``). Output is
``Complex(cos, sin)`` scaled to +/-2^(table_width-2) = 2^14, first sample emitted
*after* one accumulation step (the golden model indexes i = 1..N,
``RspChainTesterUtils.scala:174-181``).

Feature parity with ``FixedNCOParams``:

* ``phase_acc_enable`` — accumulate words (``jnp.cumsum``, an O(log T) parallel
  scan under XLA) vs. treat words as absolute phase.
* ``quantized_lut`` — bit-faithful integer LUT gather (fidelity mode) vs. exact
  complex exponential (fast float path; XLA fuses sin/cos into the pipeline).
* ``n_interpolation_terms`` — LUT interpolation: with terms >= 1 the fractional
  part of the phase linearly interpolates between adjacent LUT entries
  (suppresses phase-truncation spurs), matching the hardware's interpolated
  table option. Only meaningful with ``quantized_lut``.
* ``dither_enable`` — adds +/-0.5-LSB pseudo-random phase dither before
  truncation (spur decorrelation), seeded deterministically.
* ``rasterized_mode`` — exact-period mode: the hardware rasterized NCO steps
  through table entries directly so each period is bit-exact with no phase
  truncation error; here phase is reduced modulo 2^phase_width in exact integer
  arithmetic before lookup (vs. float modular reduction on the fast path).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..configs import NcoConfig
from ..cplx import C


@functools.lru_cache(maxsize=None)
def _lut_np(table_size: int, table_width: int) -> np.ndarray:
    """Full-cycle complex LUT with 4*table_size positions, values truncated to
    integers at amplitude 2^(table_width-2) like the hardware table."""
    n = 4 * table_size
    amp = 2.0 ** (table_width - 2)
    ph = 2 * np.pi * np.arange(n) / n
    return (np.trunc(amp * np.cos(ph)) + 1j * np.trunc(amp * np.sin(ph))).astype(
        np.complex64
    )


def nco(
    freq_words: jnp.ndarray,
    cfg: NcoConfig = NcoConfig(),
    phase_offset: jnp.ndarray | float = 0.0,
    dither_seed: int = 0x5EED,
    pair: bool = False,
) -> jnp.ndarray | C:
    """Convert a frequency-word stream into complex IQ samples.

    Args:
      freq_words: [..., T] float32/int32 phase increments (PLFG words, possibly
        including a traced runtime start value).
      cfg: static NCO parameters.
      phase_offset: ``poffType = Fixed`` phase offset in *phase-accumulator
        units* (same units as the words) — ``RuntimeConfig.phase_offset``.
      dither_seed: seed for the deterministic phase-dither sequence.

    Returns [..., T] amplitude-2^(table_width-2) IQ samples: a ``cplx.C``
    real pair when ``pair`` (the device representation — complex dtypes are not
    materialized), else complex64.
    """
    words = jnp.asarray(freq_words, jnp.float32)
    modulus = float(2 ** cfg.phase_width)  # = 4 * table_size in the tested config
    if cfg.phase_acc_enable:
        phase = jnp.cumsum(words, axis=-1)  # inclusive: first output after 1 step
    else:
        phase = words
    phase = phase + jnp.asarray(phase_offset, jnp.float32)

    if cfg.rasterized_mode:
        # exact-period mode: integer phase arithmetic, no float modular error
        phase = jnp.mod(jnp.round(phase).astype(jnp.int32), int(modulus)).astype(
            jnp.float32
        )

    if cfg.dither_enable:
        key = jax.random.key(dither_seed)
        dither = jax.random.uniform(key, phase.shape, minval=-0.5, maxval=0.5)
        phase = phase + dither

    if cfg.quantized_lut:
        lut_np = _lut_np(cfg.table_size, cfg.table_width)
        nlut = 4 * cfg.table_size
        # the top log2(nlut) bits of the phase accumulator index the LUT (the
        # tested config has 2^phase_width == 4*table_size so the ratio is 1).
        # host-side split: complex arrays never reach the device
        lut_per_phase = nlut / modulus
        lut_re = jnp.asarray(np.ascontiguousarray(lut_np.real))
        lut_im = jnp.asarray(np.ascontiguousarray(lut_np.imag))
        if cfg.n_interpolation_terms > 0:
            # linear interpolation between adjacent entries on the phase fraction
            pm = jnp.mod(phase, modulus) * lut_per_phase
            base = jnp.floor(pm)
            frac = (pm - base).astype(jnp.float32)
            i0 = jnp.mod(base.astype(jnp.int32), nlut)
            i1 = jnp.mod(i0 + 1, nlut)
            out = C(
                jnp.take(lut_re, i0, 0) + (jnp.take(lut_re, i1, 0) - jnp.take(lut_re, i0, 0)) * frac,
                jnp.take(lut_im, i0, 0) + (jnp.take(lut_im, i1, 0) - jnp.take(lut_im, i0, 0)) * frac,
            )
        else:
            idx = jnp.mod(jnp.round(phase * lut_per_phase), nlut).astype(jnp.int32)
            out = C(jnp.take(lut_re, idx, 0), jnp.take(lut_im, idx, 0))
        return out if pair else (out.re + 1j * out.im).astype(jnp.complex64)

    angle = (2.0 * np.pi / modulus) * jnp.mod(phase, modulus)
    amp = cfg.amplitude
    out = C(amp * jnp.cos(angle), amp * jnp.sin(angle))
    return out if pair else (out.re + 1j * out.im).astype(jnp.complex64)
