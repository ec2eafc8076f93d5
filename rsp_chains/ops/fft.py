"""Runtime-sized FFT — whole-array rebuild of the SDF-FFT generator (SURVEY §2.3).

The reference's ``AXI4FFTBlock`` is a streaming radix-2 single-path delay-feedback
pipeline with a *runtime-variable* size register ("number of active stages",
``RspChainVanillaTester.scala:96``) bounded by the elaborated ``numPoints``
(``FFTParams.fixed`` at ``RspChainVanillaTester.scala:205-217``). Its tested scaling
configuration (expandLogic all-0, keepMSBorLSB all-MSB) divides by 2 per stage, so
the output equals FFT(x)/N — matching the tester golden
``fourierTr(...)/fftSize`` (``FftMagCfarChainTester.scala:77``).

Design decisions (NOT a translation of the SDF pipeline):

* The per-sample butterfly pipeline becomes a whole-array transform over frames of
  static shape ``[..., max_size]``.
* **Real-pair arithmetic throughout** (``cplx.C``): the transform is built
  from real float32 arrays. The four-step factorization N = N1 x N2 turns the
  FFT into batched small matmuls, and each complex matmul lowers to **three**
  real matmuls via Gauss's algorithm (the matrix-side sums are precomputed
  constants), at HIGHEST precision (full float32, not TF32).
* **Runtime size without recompile**: the "number of active stages" register maps
  to a ``lax.switch`` over all compiled log2 sizes in [min_log2_size,
  log2(max_size)]. Every branch has static shapes (slice x[..., :n], transform,
  zero-pad to max_size); changing the traced ``log2_fft_size`` scalar between
  calls selects a branch with no recompilation — mirroring the hardware's
  elaborate-max/configure-at-runtime split exactly.
* ``useBitReverse`` (``FFTParams`` at ``RspChain.scala:111``): the default
  ``True`` gives natural-order output (the chains' setting). ``False``
  reproduces the raw SDF datapath's bit-reversed bin order for stream-level
  parity with a reorder-less hardware elaboration — implemented as a static
  index permutation of the active bins per runtime-size branch.

All entry points are representation-polymorphic: a ``cplx.C`` pair in gives a
pair out (the device path); a complex ndarray in gives a complex ndarray out
(CPU/test convenience — the only place complex dtypes are materialized).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..configs import FftConfig, FftScaling
from ..cplx import C, CLike, as_pair, gauss_triple, join, like, matmul_gauss
from .windows import window as make_window


@functools.lru_cache(maxsize=None)
def _dft_matrix_np(n: int) -> np.ndarray:
    k = np.arange(n)
    return np.exp(-2j * np.pi * np.outer(k, k) / n).astype(np.complex64)


def dft_matrix(n: int) -> np.ndarray:
    """The n-point DFT matrix W[k, m] = exp(-2j pi k m / n) (host constant)."""
    return _dft_matrix_np(n)


@functools.lru_cache(maxsize=None)
def _dft_triple(n: int):
    return gauss_triple(_dft_matrix_np(n))


@functools.lru_cache(maxsize=None)
def _four_step_consts(n: int):
    """Precompute Gauss triples for F1 [N1,N1], F2 [N2,N2] and the twiddle
    pair [N1,N2] for N = N1*N2."""
    p = int(np.log2(n))
    n1 = 1 << ((p + 1) // 2)
    n2 = 1 << (p // 2)
    k1 = np.arange(n1)[:, None]
    m2 = np.arange(n2)[None, :]
    tw = np.exp(-2j * np.pi * k1 * m2 / n).astype(np.complex64)
    return (n1, n2, _dft_triple(n1), _dft_triple(n2),
            np.ascontiguousarray(tw.real), np.ascontiguousarray(tw.imag))


def _precision(name: Optional[str]):
    import jax

    return {None: None, "highest": jax.lax.Precision.HIGHEST,
            "default": jax.lax.Precision.DEFAULT}[name]


def _four_step_c(x: C, n: int, precision: Optional[str] = None) -> C:
    """n-point FFT of the last axis in pair arithmetic (see module docstring).

    Derivation: with input index m = N2*m1 + m2 and output index k = k1 + N1*k2,
      X[k1 + N1 k2] = sum_{m2} W_N^{m2 k1} W_{N2}^{m2 k2}
                      * (sum_{m1} x[N2 m1 + m2] W_{N1}^{m1 k1})
    i.e. DFT columns (length N1), twiddle, DFT rows (length N2), transpose."""
    prec = _precision(precision)
    if n <= 64:
        return matmul_gauss(_dft_triple(n), x, "km,...m->...k", precision=prec)
    n1, n2, f1t, f2t, twr, twi = _four_step_consts(n)
    xm = x.reshape(x.shape[:-1] + (n1, n2))               # [..., m1, m2]
    a = matmul_gauss(f1t, xm, "km,...mj->...kj", precision=prec)  # DFT over m1
    twr_j, twi_j = jnp.asarray(twr), jnp.asarray(twi)
    b = C(a.re * twr_j - a.im * twi_j, a.re * twi_j + a.im * twr_j)
    c = matmul_gauss(f2t, b, "lj,...kj->...kl", precision=prec)   # DFT over m2
    # output index k = k1 + N1*k2 -> k2 must be the slower axis
    out = C(jnp.swapaxes(c.re, -1, -2), jnp.swapaxes(c.im, -1, -2))
    return out.reshape(x.shape[:-1] + (n,))


def four_step_fft(x: CLike, n: int) -> CLike:
    """n-point FFT via four-step matmuls; ``x.shape[-1] == n`` (static)."""
    return like(x, _four_step_c(as_pair(x), n))


def _scale_factor(n: int, scaling: FftScaling) -> float:
    if scaling is FftScaling.DIV_N:
        return 1.0 / n
    if scaling is FftScaling.SQRT_N:
        return 1.0 / float(np.sqrt(n))
    return 1.0


def _cpad_last(c: C, pad: int) -> C:
    cfgpad = [(0, 0)] * (c.ndim - 1) + [(0, pad)]
    return C(jnp.pad(c.re, cfgpad), jnp.pad(c.im, cfgpad))


@functools.lru_cache(maxsize=None)
def _bitrev_idx(n: int) -> np.ndarray:
    """idx[k] = bit-reversal of k over log2(n) bits (host constant)."""
    bits = int(np.log2(n))
    k = np.arange(n)
    r = np.zeros(n, np.int32)
    for b in range(bits):
        r |= ((k >> b) & 1) << (bits - 1 - b)
    return r


def _fixed_size_fft(x: C, n: int, cfg: FftConfig) -> C:
    """FFT of the first n samples of the last axis, zero-padded back to max size."""
    xa = x[..., :n]
    if cfg.window is not None:
        xa = xa * jnp.asarray(make_window(cfg.window, n))
    y = _four_step_c(xa, n, precision=cfg.matmul_precision)
    if cfg.expand_logic is not None:
        # per-stage growth enables (FFTParams.expandLogic): each active
        # non-expanding stage halves; only the first log2(n) stages are active
        # at runtime size n (the hardware bypasses the rest)
        stages = cfg.expand_logic[: int(np.log2(n))]
        y = y * float(2.0 ** -sum(1 for e in stages if not e))
    else:
        y = y * _scale_factor(n, cfg.scaling)
    if not cfg.use_bit_reverse:
        # raw-SDF output order: bin k emerges at slot bitrev(k) — a static
        # permutation of the active bins (see module docstring)
        idx = jnp.asarray(_bitrev_idx(n))
        y = C(y.re[..., idx], y.im[..., idx])
    pad = x.shape[-1] - n
    if pad:
        y = _cpad_last(y, pad)
    return y


def fft_op(
    x: CLike,
    log2_fft_size: Optional[jnp.ndarray] = None,
    cfg: FftConfig = FftConfig(),
) -> CLike:
    """The FFT stage. ``x``: [..., max_size] frames (pair or complex).

    With ``cfg.runtime_size`` (the reference's ``runTime = true``), the traced
    scalar ``log2_fft_size`` (the base+0 "active stages" register,
    ``RspChainVanillaTester.scala:96``) selects the active size n = 2^log2_fft_size;
    the first n samples of each frame are transformed and bins [n:max_size] are
    zero. With a static size the single branch is inlined.
    """
    xp = as_pair(x)
    assert xp.shape[-1] == cfg.max_size, (
        f"frame length {xp.shape[-1]} != elaborated max_size {cfg.max_size}"
    )
    if cfg.keep_msb_or_lsb is not None and not all(cfg.keep_msb_or_lsb):
        raise ValueError(
            "keepMSBorLSB = LSB stages (wraparound overflow) have no float "
            "analog — elaborate the bit-true integer pipeline instead "
            "(FixedPointConfig(enabled=True, bit_true=True) routes the chain "
            "through ops.bit_true.fft_int_op, which reproduces them exactly)")
    if not cfg.runtime_size or log2_fft_size is None:
        return like(x, _fixed_size_fft(xp, cfg.max_size, cfg))
    lo = cfg.min_log2_size
    hi = cfg.log2_max
    branches = [
        functools.partial(_fixed_size_fft, n=1 << p, cfg=cfg)
        for p in range(lo, hi + 1)
    ]
    idx = jnp.clip(log2_fft_size - lo, 0, hi - lo)
    return like(x, jax.lax.switch(idx, branches, xp))


def ifft_op(x: CLike, n: Optional[int] = None) -> CLike:
    """Inverse FFT along the last axis via the forward four-step kernel:
    ifft(x) = conj(fft(conj(x))) / n. Used by the matched filter."""
    xp = as_pair(x)
    n = n if n is not None else xp.shape[-1]
    y = _four_step_c(xp.conj(), n).conj() * (1.0 / n)
    return like(x, y)


def rfft_op(x: jnp.ndarray, pair: bool = False) -> CLike:
    """Real-input FFT of the last axis (length n, power of two) -> n//2+1 bins.

    Real ADC streams (the reference's ``getTone`` real test vectors,
    ``RspChainTesterUtils.scala:39-41``) carry no imaginary part; the standard
    pack trick treats even/odd samples as one n/2-point pair sequence,
    transforms, and untangles with one twiddle pass — ~2x cheaper than the
    complex FFT of a zero-imag input. Returns a ``cplx.C`` when ``pair`` else a
    complex ndarray."""
    n = x.shape[-1]
    assert (n & (n - 1)) == 0, "length must be a power of two"
    h = n // 2
    z = C(x[..., 0::2].astype(jnp.float32), x[..., 1::2].astype(jnp.float32))
    zf = _four_step_c(z, h)
    rev = jnp.concatenate  # reversed-index conjugate: Z*[(-k) mod h]
    zfc = C(
        rev([zf.re[..., :1], zf.re[..., :0:-1]], axis=-1),
        -rev([zf.im[..., :1], zf.im[..., :0:-1]], axis=-1),
    )
    e = C(0.5 * (zf.re + zfc.re), 0.5 * (zf.im + zfc.im))
    o = C(0.5 * (zf.im - zfc.im), -0.5 * (zf.re - zfc.re))  # -0.5i (zf - zfc)
    k = np.arange(h)
    twr = jnp.asarray(np.cos(-2 * np.pi * k / n).astype(np.float32))
    twi = jnp.asarray(np.sin(-2 * np.pi * k / n).astype(np.float32))
    full = C(e.re + twr * o.re - twi * o.im, e.im + twr * o.im + twi * o.re)
    nyq = C(e.re[..., :1] - o.re[..., :1], jnp.zeros_like(e.im[..., :1]))
    out = C(jnp.concatenate([full.re, nyq.re], axis=-1),
            jnp.concatenate([full.im, nyq.im], axis=-1))
    return out if pair else join(out)