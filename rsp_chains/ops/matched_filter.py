"""Matched filter / pulse compression (BASELINE config 2; north-star addition per
SURVEY §7 — the reference checkout has no matched filter, but its chirp front end
(PLFG+NCO) is exactly the waveform such a filter compresses).

Two paths, both in real-pair arithmetic (``cplx.C``; complex dtypes
only at the CPU-convenience boundary):

* ``matched_filter`` — per-frame frequency-domain correlation
  ``ifft(fft(x) * conj(fft(ref)))`` built on the four-step matmul FFT. One
  fused jit region: forward FFT, conjugate multiply (fused), inverse FFT.
* ``overlap_save_fir`` — streaming/continuous convolution over long sequences via
  overlap-save blocks; the (num_taps - 1)-sample left halo per block is exactly the
  shard-boundary halo the ``parallel`` layer exchanges between devices when the range axis
  is sharded (SURVEY §2.15 / §5.7).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..configs import MatchedFilterConfig
from ..cplx import C, CLike, as_pair, like
from .fft import _four_step_c


def _next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def _pad_taps(taps: C, nfft: int) -> C:
    m = taps.shape[-1]
    z = jnp.zeros((nfft,), jnp.float32)
    return C(z.at[:m].set(taps.re), z.at[:m].set(taps.im))


def matched_filter_spectrum(taps: np.ndarray, n: int,
                            normalize: bool) -> np.ndarray:
    """Matched-filter reference spectrum H = conj(FFT_n(pad(taps)))[/||taps||]
    in natural bin order (complex128 host constant). Matches
    ``matched_filter`` (``hf = FFT(pad(taps)).conj()``, optional 1/||taps||
    normalization); the collapsed ``spectral_mf`` stage of
    ``presets.pulse_compression_chain`` multiplies by it."""
    t = np.asarray(taps).astype(np.complex128)
    assert t.ndim == 1 and t.shape[0] <= n
    h = np.conj(np.fft.fft(t, n))
    if normalize:
        h = h / max(np.sqrt(np.sum(np.abs(t) ** 2)), 1e-30)
    return h


def matched_filter(
    x: CLike,
    taps,
    cfg: MatchedFilterConfig = MatchedFilterConfig(),
) -> CLike:
    """Circular pulse compression along the last axis (frame-sized FFT).

    ``x``: [..., N] frames (N a power of two), pair or complex; ``taps``: [M]
    the transmit replica (M <= N). Output [..., N]: correlation of x with the
    replica, peak at the target delay. Matches
    ``golden.matched_filter_golden(mode="circular")``."""
    xp = as_pair(x)
    # jax arrays (incl. tracers) go straight to as_pair's device-side split —
    # np.asarray on them would force a device->host copy
    # or a TracerArrayConversionError; host lists/np arrays split host-side
    tp = as_pair(taps if isinstance(taps, (C, jnp.ndarray))
                 else np.asarray(taps))
    n = xp.shape[-1]
    assert (n & (n - 1)) == 0, "frame length must be a power of two"
    assert tp.shape[-1] <= n, (
        f"matched-filter length {tp.shape[-1]} exceeds frame length {n}")
    hf = _four_step_c(_pad_taps(tp, n), n).conj()
    if cfg.normalize:
        norm = jnp.maximum(jnp.sqrt(jnp.sum(tp.abs2())), 1e-30)
        hf = hf * (1.0 / norm)
    xf = _four_step_c(xp, n)
    prod = xf * hf
    y = _four_step_c(prod.conj(), n).conj() * (1.0 / n)   # inverse FFT
    return like(x, y)


def overlap_save_fir(
    x: CLike,
    taps,
    block_size: int | None = None,
) -> CLike:
    """Linear convolution of a long last axis with ``taps`` via overlap-save.

    ``x``: [..., T]; returns [..., T] (same-alignment output: y[t] =
    sum_m taps[m] * x[t - m], zero-padded history). Each block of length B reads a
    left halo of (M-1) samples — the halo that crosses chip boundaries when T is
    sharded (see ``parallel.halo``)."""
    xp = as_pair(x)
    tp = as_pair(taps if isinstance(taps, (C, jnp.ndarray))
                 else np.asarray(taps))  # see matched_filter on why
    m = tp.shape[-1]
    t = xp.shape[-1]
    b = block_size or max(_next_pow2(4 * m), 256)
    # the gather-free block extraction reads each block's (m-1)-sample history
    # from the PREVIOUS block's body, so b must cover it; overlap-save output
    # is invariant to the block partition, so raising b only changes the
    # internal tiling
    b = max(b, _next_pow2(m - 1) if m > 1 else 1)
    nfft = _next_pow2(b + m - 1)
    nblk = -(-t // b)
    pad_t = nblk * b

    padcfg = [(0, 0)] * (xp.ndim - 1) + [(m - 1, pad_t - t)]
    xpad = C(jnp.pad(xp.re, padcfg), jnp.pad(xp.im, padcfg))

    # overlapping blocks WITHOUT a gather: block i covers xpad[i*b : i*b + b + m - 1] =
    # history xpad[i*b : i*b + m-1] ++ body xpad[m-1 + i*b : m-1 + (i+1)*b];
    # both are plain reshapes of aligned slices (b >= 2m always, so the
    # history never spans two blocks)
    def to_blocks(a):
        body = a[..., m - 1 :].reshape(a.shape[:-1] + (nblk, b))
        hist = a[..., : nblk * b].reshape(a.shape[:-1] + (nblk, b))[..., :, : m - 1]
        return jnp.concatenate([hist, body], axis=-1)

    blocks = C(to_blocks(xpad.re), to_blocks(xpad.im))
    bpad = [(0, 0)] * (blocks.ndim - 1) + [(0, nfft - (b + m - 1))]
    blocks = C(jnp.pad(blocks.re, bpad), jnp.pad(blocks.im, bpad))

    hf = _four_step_c(_pad_taps(tp, nfft), nfft)
    yf = _four_step_c(blocks, nfft) * hf
    y = _four_step_c(yf.conj(), nfft).conj() * (1.0 / nfft)  # inverse FFT
    y = y[..., m - 1 : m - 1 + b]          # valid part of each block
    y = y.reshape(xp.shape[:-1] + (pad_t,))[..., :t]
    return like(x, y)


def mf_reference_taps(chirp: np.ndarray) -> np.ndarray:
    """Matched-filter taps for a transmit replica: time-reversed conjugate."""
    return np.conj(chirp[::-1]).astype(np.complex64)


def matched_filter_os(
    x: CLike,
    taps,
    cfg: MatchedFilterConfig = MatchedFilterConfig(),
) -> CLike:
    """LINEAR pulse compression via overlap-save blocks
    (``MatchedFilterConfig.method = 'overlap_save'``): the streaming form for
    continuous fast-time sequences. Same interior alignment as the circular
    form (``corr[tau] = sum_j conj(taps[j]) x[tau + j]``, peak at the target
    delay) but zero-extended edges instead of frame wraparound — matches
    ``golden.matched_filter_golden(mode='full')[..., M-1 : M-1+T]``."""
    xp = as_pair(x)
    t = xp.shape[-1]
    if isinstance(taps, jnp.ndarray):
        taps = as_pair(taps)  # device/traced taps: stay on-device (see below)
    if isinstance(taps, C):
        # keep device-resident / traced taps on-device (a forced host fetch
        # is a tracer error under jit and a device->host copy outside it)
        h = C(jnp.flip(taps.re, -1), -jnp.flip(taps.im, -1))
        m = h.shape[-1]
        if cfg.normalize:
            norm = jnp.maximum(jnp.sqrt(jnp.sum(taps.abs2())), 1e-30)
            h = h * (1.0 / norm)
    else:
        h = mf_reference_taps(np.asarray(taps))
        m = h.shape[-1]
        if cfg.normalize:
            h = h / max(float(np.sqrt(np.sum(np.abs(h) ** 2))), 1e-30)
    # honor the elaborated overlap-save FFT block size: an F-point block
    # carries F - (m-1) new samples (overlap_save_fir re-derives nfft =
    # next_pow2(b + m - 1) = F for power-of-two F)
    block = max(cfg.fft_size - (m - 1), 1) if cfg.fft_size else None
    # right-extend by m-1 zeros so the trailing partial correlations exist,
    # then realign: corr[tau] = conv[tau + m - 1]
    padcfg = [(0, 0)] * (xp.ndim - 1) + [(0, m - 1)]
    xe = C(jnp.pad(xp.re, padcfg), jnp.pad(xp.im, padcfg))
    y = as_pair(overlap_save_fir(xe, h, block))
    out = y[..., m - 1 : m - 1 + t]
    return like(x, out)
