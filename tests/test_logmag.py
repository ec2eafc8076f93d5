"""LogMagMux tests: runtime mode mux vs goldens (RspChainTesterUtils.scala:120-216)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rsp_chains.configs import LogMagConfig, MagMode
from rsp_chains.ops.logmag import logmag
from rsp_chains.golden import jpl_mag, sqr_mag, log2_mag, abs_mag


@pytest.mark.parametrize("mode,golden", [
    (MagMode.ABS, abs_mag),
    (MagMode.SQR, sqr_mag),
    (MagMode.JPL, jpl_mag),
    (MagMode.LOG2, log2_mag),
])
def test_modes_match_golden(mode, golden, rng):
    x = (rng.randn(512) * 100 + 1j * rng.randn(512) * 100).astype(np.complex64)
    got = np.asarray(logmag(jnp.asarray(x), jnp.asarray(int(mode), jnp.int32)))
    want = golden(x)
    assert np.allclose(got, want, rtol=1e-4, atol=1e-3)


def test_jpl_error_bound_vs_true_mag(rng):
    # JPL approximation max error is ~3% of |x|
    x = (rng.randn(4096) + 1j * rng.randn(4096)).astype(np.complex64)
    got = np.asarray(logmag(jnp.asarray(x), jnp.asarray(2, jnp.int32)))
    true = np.abs(x)
    rel = np.abs(got - true) / np.maximum(true, 1e-9)
    assert rel.max() < 0.04


def test_mode_mux_single_compile(rng):
    f = jax.jit(lambda x, m: logmag(x, m))
    x = jnp.asarray((rng.randn(64) + 1j * rng.randn(64)).astype(np.complex64))
    for m in range(4):
        f(x, jnp.asarray(m, jnp.int32)).block_until_ready()
    assert f._cache_size() == 1


def test_lut_log_mode(rng):
    cfg = LogMagConfig(use_lut_log=True, log2_lookup_width=9)
    x = (rng.randn(128) * 1000 + 1j * rng.randn(128) * 1000).astype(np.complex64)
    got = np.asarray(logmag(jnp.asarray(x), jnp.asarray(3, jnp.int32), cfg))
    want = log2_mag(x)
    # LUT truncation: within one LSB of the 9-bit fractional grid
    assert np.all(got <= want + 1e-5)
    assert np.all(want - got <= 2.0 ** -9 + 1e-5)
