"""FFT op tests: four-step matmul formulation vs numpy, runtime sizing, scaling."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rsp_chains.configs import FftConfig, FftScaling, RuntimeConfig
from rsp_chains.ops.fft import fft_op, four_step_fft, ifft_op
from rsp_chains.golden import fft_golden


@pytest.mark.parametrize("n", [8, 16, 64, 128, 256, 1024, 4096])
def test_four_step_matches_numpy(n, rng):
    x = (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)
    got = np.asarray(four_step_fft(jnp.asarray(x), n))
    want = np.fft.fft(x)
    assert np.allclose(got, want, rtol=1e-3, atol=1e-2 * np.sqrt(n))


def test_four_step_batched(rng):
    x = (rng.randn(3, 5, 256) + 1j * rng.randn(3, 5, 256)).astype(np.complex64)
    got = np.asarray(four_step_fft(jnp.asarray(x), 256))
    want = np.fft.fft(x, axis=-1)
    assert np.allclose(got, want, rtol=1e-3, atol=0.2)


def test_ifft_roundtrip(rng):
    x = (rng.randn(4, 512) + 1j * rng.randn(4, 512)).astype(np.complex64)
    y = ifft_op(four_step_fft(jnp.asarray(x), 512), 512)
    assert np.allclose(np.asarray(y), x, atol=1e-4)


@pytest.mark.parametrize("fft_size", [64, 256, 1024])
def test_runtime_size_matches_golden(fft_size, rng):
    cfg = FftConfig(max_size=1024, runtime_size=True, scaling=FftScaling.DIV_N)
    x = (rng.randn(1024) + 1j * rng.randn(1024)).astype(np.complex64)
    rt = RuntimeConfig.make(fft_size=fft_size)
    got = np.asarray(fft_op(jnp.asarray(x), rt.log2_fft_size, cfg))
    want = fft_golden(x, n=fft_size, scaling="div_n")
    assert np.allclose(got[:fft_size], want, atol=1e-4)
    # bins beyond the active size are zero
    assert np.all(got[fft_size:] == 0)


def test_runtime_size_is_single_compile(rng):
    cfg = FftConfig(max_size=256, runtime_size=True)
    f = jax.jit(lambda x, s: fft_op(x, s, cfg))
    x = jnp.asarray((rng.randn(256) + 1j * rng.randn(256)).astype(np.complex64))
    for n in (64, 128, 256):
        f(x, jnp.asarray(int(np.log2(n)), jnp.int32)).block_until_ready()
    assert f._cache_size() == 1


@pytest.mark.parametrize("scaling,ref_div", [
    (FftScaling.DIV_N, 1024.0),
    (FftScaling.NONE, 1.0),
    (FftScaling.SQRT_N, 32.0),
])
def test_scaling_modes(scaling, ref_div, rng):
    cfg = FftConfig(max_size=1024, runtime_size=False, scaling=scaling)
    x = (rng.randn(1024) + 1j * rng.randn(1024)).astype(np.complex64)
    got = np.asarray(fft_op(jnp.asarray(x), None, cfg))
    want = np.fft.fft(x) / ref_div
    assert np.allclose(got, want, rtol=1e-3, atol=0.3 / ref_div)


def test_mxu_vs_jnp_fft_paths(rng):
    """The four-step matmul FFT agrees with XLA's own FFT (``jnp.fft``)."""
    x = (rng.randn(2, 1024) + 1j * rng.randn(2, 1024)).astype(np.complex64)
    a = fft_op(jnp.asarray(x), None, FftConfig(max_size=1024, runtime_size=False))
    b = jnp.fft.fft(jnp.asarray(x), axis=-1) / 1024
    assert np.allclose(np.asarray(a), np.asarray(b), atol=1e-3)


def test_expand_logic_per_stage_scaling(rng):
    """FFTParams.expandLogic parity: stage k with expand=0 halves; arbitrary
    arrays => overall 2^-(#zeros among active stages), adapting to runtime size."""
    x = (rng.randn(256) + 1j * rng.randn(256)).astype(np.complex64)
    # 8 stages: expand the first 3, truncate the remaining 5 -> /32 at n=256
    el = (1, 1, 1, 0, 0, 0, 0, 0)
    cfg = FftConfig(max_size=256, runtime_size=True, expand_logic=el)
    rt = RuntimeConfig.make(fft_size=256)
    got = np.asarray(fft_op(jnp.asarray(x), rt.log2_fft_size, cfg))
    np.testing.assert_allclose(got, np.fft.fft(x) / 32, rtol=1e-3, atol=1e-2)
    # runtime shrink to 16 points: only the first 4 stages active -> /2
    rt2 = RuntimeConfig.make(fft_size=16)
    got2 = np.asarray(fft_op(jnp.asarray(x), rt2.log2_fft_size, cfg))
    np.testing.assert_allclose(got2[:16], np.fft.fft(x[:16]) / 2, rtol=1e-3, atol=1e-2)
    # all-zero expand logic == DIV_N (the tested reference configuration)
    cfg0 = FftConfig(max_size=256, runtime_size=False, expand_logic=(0,) * 8)
    got3 = np.asarray(fft_op(jnp.asarray(x), None, cfg0))
    np.testing.assert_allclose(got3, np.fft.fft(x) / 256, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("n", [16, 256, 1024])
def test_rfft_matches_numpy(n, rng):
    from rsp_chains.ops.fft import rfft_op

    x = rng.randn(3, n).astype(np.float32)
    got = np.asarray(rfft_op(jnp.asarray(x)))
    want = np.fft.rfft(x, axis=-1)
    assert got.shape == (3, n // 2 + 1)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-2 * np.sqrt(n))


def test_bit_reversed_output_order(rng):
    """FFTParams.useBitReverse=false (RspChain.scala:111): the raw SDF datapath
    emits bin k at slot bitrev(k); with the flag off the op reproduces that
    stream order exactly (a permutation of the natural-order output)."""
    from rsp_chains.ops.fft import _bitrev_idx

    cfg_nat = FftConfig(max_size=256, runtime_size=False)
    cfg_rev = FftConfig(max_size=256, runtime_size=False, use_bit_reverse=False)
    x = (rng.randn(256) + 1j * rng.randn(256)).astype(np.complex64)
    nat = np.asarray(fft_op(jnp.asarray(x), None, cfg_nat))
    rev = np.asarray(fft_op(jnp.asarray(x), None, cfg_rev))
    idx = _bitrev_idx(256)
    np.testing.assert_allclose(rev, nat[idx], rtol=0, atol=0)
    # bitrev is an involution: permuting back recovers natural order
    np.testing.assert_allclose(rev[idx], nat, rtol=0, atol=0)


def test_bit_reversed_runtime_size(rng):
    """Bit-reversed order applies per active runtime size: the first n bins
    are the permuted n-point spectrum, the tail stays zero."""
    from rsp_chains.ops.fft import _bitrev_idx

    cfg = FftConfig(max_size=1024, runtime_size=True, use_bit_reverse=False)
    x = (rng.randn(1024) + 1j * rng.randn(1024)).astype(np.complex64)
    rt = RuntimeConfig.make(fft_size=256)
    got = np.asarray(fft_op(jnp.asarray(x), rt.log2_fft_size, cfg))
    want = fft_golden(x, n=256, scaling="div_n")[_bitrev_idx(256)]
    np.testing.assert_allclose(got[:256], want, rtol=1e-4, atol=1e-4)
    assert np.all(got[256:] == 0)
