"""Real-pair complex representation — the device-side complex number format.

The device path carries complex values as an explicit struct-of-arrays
(re, im) of float32 arrays rather than complex64:

* matmuls decompose under our control — the four-step FFT uses Gauss's
  3-multiplication complex product instead of the naive 4;
* elementwise complex arithmetic becomes plain float ops that XLA fuses
  exactly like any other;
* each component is a contiguous float32 array — no interleaved layouts.

Whether this beats XLA's own complex64 and ``jnp.fft`` on the GPU is an open
measurement (ROADMAP queue 1 item 3).

``C`` is a NamedTuple (hence a pytree: jit/shard_map/donation all treat it as
two float arrays). Complex64 appears only at host boundaries.

Every op in ``rsp_chains.ops`` is polymorphic: given a ``C`` it computes
entirely in pair arithmetic and returns a ``C`` (the device path); given a complex
ndarray it returns a complex ndarray (the CPU/test-convenience path) — the
pair<->complex joins happen only in that legacy path.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import jax.numpy as jnp
import numpy as np


class C(NamedTuple):
    """A complex array as separate real/imag float arrays (struct-of-arrays)."""

    re: jnp.ndarray
    im: jnp.ndarray

    # -- shape-like conveniences -------------------------------------------
    @property
    def shape(self):
        return self.re.shape

    @property
    def ndim(self):
        return self.re.ndim

    @property
    def size(self):
        return self.re.size

    @property
    def dtype(self):
        return self.re.dtype

    def __getitem__(self, idx):
        return C(self.re[idx], self.im[idx])

    def reshape(self, *shape):
        return C(self.re.reshape(*shape), self.im.reshape(*shape))

    def astype(self, dtype):
        return C(self.re.astype(dtype), self.im.astype(dtype))

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, C):
            return C(self.re + o.re, self.im + o.im)
        return C(self.re + o, self.im)

    def __sub__(self, o):
        if isinstance(o, C):
            return C(self.re - o.re, self.im - o.im)
        return C(self.re - o, self.im)

    def __mul__(self, o):
        if isinstance(o, C):
            return C(self.re * o.re - self.im * o.im,
                     self.re * o.im + self.im * o.re)
        return C(self.re * o, self.im * o)  # real scalar/array

    def __rmul__(self, o):
        return self.__mul__(o)

    def conj(self):
        return C(self.re, -self.im)

    def abs2(self):
        return self.re * self.re + self.im * self.im

    def abs(self):
        return jnp.sqrt(self.abs2())


CLike = Union[C, jnp.ndarray, np.ndarray]


def is_pair(x: CLike) -> bool:
    return isinstance(x, C)


def as_pair(x: CLike) -> C:
    """Normalize to C. Complex ndarray inputs are split (host-side for numpy;
    jnp.real/imag for traced complex arrays — the CPU path)."""
    if isinstance(x, C):
        return x
    if isinstance(x, np.ndarray) and np.iscomplexobj(x):
        # host split: never materializes complex on the device
        return C(jnp.asarray(np.ascontiguousarray(x.real), jnp.float32),
                 jnp.asarray(np.ascontiguousarray(x.imag), jnp.float32))
    if jnp.iscomplexobj(x):
        return C(jnp.real(x).astype(jnp.float32), jnp.imag(x).astype(jnp.float32))
    x = jnp.asarray(x)
    return C(x.astype(jnp.float32), jnp.zeros_like(x, jnp.float32))


def join(c: C, dtype=jnp.complex64) -> jnp.ndarray:
    """Pair -> complex array (CPU/test path only; complex math on device)."""
    return (c.re + 1j * c.im).astype(dtype)


def to_numpy(c: C) -> np.ndarray:
    """Pair -> host numpy complex64 (fetches the two real arrays)."""
    return np.asarray(c.re, np.float32) + 1j * np.asarray(c.im, np.float32)


def like(x_in: CLike, result: C):
    """Return ``result`` in the caller's representation: C for pair callers,
    complex ndarray for complex callers."""
    return result if isinstance(x_in, C) else join(result)


def gauss_triple(m: np.ndarray):
    """Precompute the three real matrices for a Gauss 3-multiplication complex
    matmul with constant matrix M = Mr + i Mi: (Mr, Mr + Mi, Mi - Mr)."""
    mr = np.ascontiguousarray(m.real.astype(np.float32))
    mi = np.ascontiguousarray(m.imag.astype(np.float32))
    return mr, mr + mi, mi - mr


def matmul_gauss(triple, x: C, einsum_spec: str, precision=None) -> C:
    """y = M @ x with 3 real matmuls (vs 4 naive):
      k1 = Mr(xr + xi); k2 = (Mr + Mi) xi; k3 = (Mi - Mr) xr
      real = k1 - k2;  imag = k1 + k3
    ``einsum_spec`` contracts (matrix, data), matrix operand first; the matrix
    sums are precomputed constants (``gauss_triple``).

    ``precision`` defaults to HIGHEST: a float32 matmul at default precision
    may run in TF32 on the GPU (about three decimal digits), which breaks the
    framework's ±2-LSB fixed-point fidelity contract. Pass ``jax.lax.Precision.DEFAULT`` explicitly
    for a fast low-precision mode."""
    import jax

    if precision is None:
        precision = jax.lax.Precision.HIGHEST
    mr, mpm, mmm = (jnp.asarray(t) for t in triple)
    k1 = jnp.einsum(einsum_spec, mr, x.re + x.im, precision=precision)
    k2 = jnp.einsum(einsum_spec, mpm, x.im, precision=precision)
    k3 = jnp.einsum(einsum_spec, mmm, x.re, precision=precision)
    return C(k1 - k2, k1 + k3)
