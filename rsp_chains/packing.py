"""Stream payload packing: int16 IQ <-> 32-bit beat words <-> complex arrays.

The reference's data plane carries one complex sample per 32-bit AXI4-Stream beat,
**real in bits [31:16], imag in bits [15:0]**, 16-bit two's complement
(``RspChainTesterUtils.scala:105-109`` — real concatenated before imag). CFAR output
beats pack ``{threshold | bin | peak}`` with bit 0 = peak flag and
bits [log2(fftSize):1] = bin index (``RspChainVanillaTester.scala:164-172``).

These functions are the framework's wire format for host I/O and for
fixed-point fidelity checks. They are pure jnp/numpy and work on both host and
device; the C++ fast path for bulk host-side conversion lives in ``io/native``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def pack_iq(iq) -> jnp.ndarray:
    """Pack a complex array or ``cplx.C`` pair (integer-valued, |re|,|im| < 2^15)
    into uint32 beat words: real in [31:16], imag in [15:0]
    (``RspChainTesterUtils.scala:105-109``)."""
    from .cplx import C

    if isinstance(iq, C):
        re_f, im_f = iq.re, iq.im
    else:
        re_f, im_f = jnp.real(iq), jnp.imag(iq)
    re = jnp.asarray(re_f, jnp.int32).astype(jnp.int16).astype(jnp.uint16)
    im = jnp.asarray(im_f, jnp.int32).astype(jnp.int16).astype(jnp.uint16)
    return (re.astype(jnp.uint32) << 16) | im.astype(jnp.uint32)


def unpack_iq_pair(words: jnp.ndarray):
    """Unpack 32-bit beat words into a ``cplx.C`` real pair (the device path —
    no complex dtype is materialized)."""
    from .cplx import C

    words = jnp.asarray(words, jnp.uint32)
    re = (words >> 16).astype(jnp.uint16).astype(jnp.int16).astype(jnp.float32)
    im = (words & 0xFFFF).astype(jnp.uint16).astype(jnp.int16).astype(jnp.float32)
    return C(re, im)


def unpack_iq(words: jnp.ndarray, dtype=jnp.complex64) -> jnp.ndarray:
    """Unpack 32-bit beat words into a complex array (CPU/test path)."""
    p = unpack_iq_pair(words)
    return (p.re + 1j * p.im).astype(dtype)


def pack_cfar_words(
    threshold: jnp.ndarray,
    peaks: jnp.ndarray,
    log2_fft_size: int,
    cut: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Pack CFAR outputs into the reference's 32-bit output word format:
    bit 0 = peak flag, bits [log2(fftSize):1] = bin index (or cell-under-test value
    when ``sendCut`` was elaborated), bits [31:log2(fftSize)+1] = threshold
    (decode contract at ``RspChainVanillaTester.scala:164-172``)."""
    n = threshold.shape[-1]
    bin_width = int(log2_fft_size)
    if cut is None:
        mid = jnp.broadcast_to(
            jnp.arange(n, dtype=jnp.uint32), threshold.shape
        )
    else:
        mid = jnp.asarray(cut, jnp.uint32) & ((1 << bin_width) - 1)
    # saturate to the threshold field width (hardware register semantics)
    thr_max = float((1 << (31 - bin_width)) - 1)
    thr = jnp.asarray(jnp.clip(threshold, 0, thr_max), jnp.uint32)
    pk = jnp.asarray(peaks, jnp.uint32) & 1
    return (thr << (bin_width + 1)) | ((mid & ((1 << bin_width) - 1)) << 1) | pk


def unpack_cfar_words(words: np.ndarray, log2_fft_size: int):
    """Decode reference-format CFAR words -> (threshold, bin_or_cut, peak) arrays,
    mirroring the tester decode loop (``RspChainVanillaTester.scala:168-172``)."""
    words = np.asarray(words, np.uint32)
    bin_width = int(log2_fft_size)
    peaks = words & 1
    bins = (words >> 1) & ((1 << bin_width) - 1)
    threshold = words >> (bin_width + 1)
    return threshold, bins, peaks
