"""Matched filter / pulse compression + Doppler tests (BASELINE configs 2-3)."""

import numpy as np
import jax.numpy as jnp
import pytest

from rsp_chains.configs import DopplerConfig, MatchedFilterConfig
from rsp_chains.ops.matched_filter import matched_filter, overlap_save_fir
from rsp_chains.ops.doppler import doppler_fft
from rsp_chains.golden import (
    lfm_chirp, chirp_with_targets, matched_filter_golden, range_doppler_golden,
)


def test_matched_filter_peak_at_delay():
    chirp = lfm_chirp(128, 0.0, 0.25)
    n = 1024
    delay = 300
    x = np.zeros(n, np.complex128)
    x[delay:delay + 128] = chirp
    y = np.asarray(matched_filter(jnp.asarray(x, jnp.complex64),
                                  jnp.asarray(chirp, jnp.complex64)))
    assert np.argmax(np.abs(y)) == delay


def test_matched_filter_matches_golden_circular():
    chirp = lfm_chirp(64)
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 512) + 1j * rng.randn(2, 512)).astype(np.complex64)
    got = np.asarray(matched_filter(jnp.asarray(x), jnp.asarray(chirp, jnp.complex64),
                                    MatchedFilterConfig(normalize=False)))
    want = matched_filter_golden(x, chirp, mode="circular")
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("t,m,b", [(1000, 33, 256), (4096, 128, None), (700, 16, 128)])
def test_overlap_save_matches_direct_convolution(t, m, b):
    rng = np.random.RandomState(1)
    x = (rng.randn(t) + 1j * rng.randn(t)).astype(np.complex64)
    taps = (rng.randn(m) + 1j * rng.randn(m)).astype(np.complex64)
    got = np.asarray(overlap_save_fir(jnp.asarray(x), jnp.asarray(taps), b))
    want = np.convolve(x, taps, mode="full")[:t]
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-2 * np.sqrt(m))


def test_overlap_save_batched():
    rng = np.random.RandomState(2)
    x = (rng.randn(3, 500) + 1j * rng.randn(3, 500)).astype(np.complex64)
    taps = (rng.randn(17) + 1j * rng.randn(17)).astype(np.complex64)
    got = np.asarray(overlap_save_fir(jnp.asarray(x), jnp.asarray(taps)))
    for i in range(3):
        want = np.convolve(x[i], taps, mode="full")[:500]
        np.testing.assert_allclose(got[i], want, rtol=1e-3, atol=0.1)


def test_doppler_fft_matches_golden():
    chirp = lfm_chirp(64)
    cpi = chirp_with_targets(64, 256, chirp, [(50, 1.0, 0.125)], noise_db=-60)
    cfg = DopplerConfig(num_pulses=64, window="hann", fft_shift=True)
    got = np.asarray(doppler_fft(jnp.asarray(cpi, jnp.complex64), cfg))
    from rsp_chains.ops.windows import window
    w = window("hann", 64).astype(np.float64)
    rng_fft = cpi * w[:, None]
    want = np.fft.fftshift(np.fft.fft(rng_fft, axis=0) / 64, axes=0)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_doppler_target_lands_on_expected_bin():
    chirp = lfm_chirp(64)
    fd = 0.125  # cycles/pulse -> bin P*fd above center after fftshift
    p = 64
    cpi = chirp_with_targets(p, 256, chirp, [(50, 1.0, fd)], noise_db=-80)
    mf = np.asarray(matched_filter(jnp.asarray(cpi, jnp.complex64),
                                   jnp.asarray(chirp, jnp.complex64)))
    dop = np.asarray(doppler_fft(jnp.asarray(mf), DopplerConfig(num_pulses=p, window=None)))
    mag = np.abs(dop)
    pulse_bin, range_bin = np.unravel_index(np.argmax(mag), mag.shape)
    assert range_bin == 50
    assert pulse_bin == p // 2 + int(fd * p)


def test_range_doppler_golden_consistency():
    """range_doppler_golden composes fft_golden + windowed Doppler; the op
    pipeline (matched filter omitted) matches it."""
    rng = np.random.RandomState(3)
    cpi = (rng.randn(2, 32, 256) + 1j * rng.randn(2, 32, 256))
    from rsp_chains.ops.fft import fft_op
    from rsp_chains.configs import FftConfig
    from rsp_chains.ops.windows import window

    w = window("hann", 32).astype(np.float64)
    want = range_doppler_golden(cpi, doppler_window=w, fft_shift=True)
    rngfft = np.asarray(fft_op(jnp.asarray(cpi, jnp.complex64), None,
                               FftConfig(max_size=256, runtime_size=False)))
    dop = np.asarray(doppler_fft(jnp.asarray(rngfft),
                                 DopplerConfig(num_pulses=32, window="hann")))
    np.testing.assert_allclose(dop, want, rtol=1e-3, atol=1e-4)


def test_barker_code_compression():
    """Barker-13 pulse compression: peak-to-sidelobe ratio 13 (the defining
    property), via the same matched-filter op."""
    from rsp_chains.golden import barker_code

    code = barker_code(13)
    y = np.abs(np.asarray(matched_filter(
        jnp.asarray(np.pad(code, (0, 256 - 13)), jnp.complex64),
        jnp.asarray(code, jnp.complex64),
        MatchedFilterConfig(normalize=False))))
    assert np.argmax(y) == 0
    assert np.isclose(y.max(), 13.0, atol=1e-3)
    side = y.copy(); side[0] = 0
    assert side.max() <= 1.0 + 1e-3   # Barker sidelobe bound


def test_frank_code_length():
    from rsp_chains.golden import frank_code

    c = frank_code(4)
    assert len(c) == 16
    np.testing.assert_allclose(np.abs(c), 1.0)


def test_matched_filter_os_matches_linear_golden():
    """method='overlap_save': linear correlation, interior-aligned like the
    circular form, zero-history edges (golden full-mode slice)."""
    from rsp_chains.ops.matched_filter import matched_filter_os

    chirp = lfm_chirp(64)
    rng = np.random.RandomState(4)
    x = (rng.randn(2, 512) + 1j * rng.randn(2, 512)).astype(np.complex64)
    got = np.asarray(matched_filter_os(jnp.asarray(x),
                                       np.asarray(chirp, np.complex64),
                                       MatchedFilterConfig(
                                           method="overlap_save",
                                           normalize=False)))
    m = len(chirp)
    want = matched_filter_golden(x, chirp, mode="full")[..., m - 1 : m - 1 + 512]
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-2 * np.sqrt(m))


def test_matched_filter_os_peak_at_delay():
    from rsp_chains.ops.matched_filter import matched_filter_os

    chirp = lfm_chirp(128, 0.0, 0.25)
    x = np.zeros(1024, np.complex128)
    x[300:428] = chirp
    y = np.asarray(matched_filter_os(jnp.asarray(x, jnp.complex64),
                                     np.asarray(chirp, np.complex64)))
    assert np.argmax(np.abs(y)) == 300


def test_matched_filter_stage_dispatches_on_method():
    from rsp_chains.configs import ChainConfig, FftConfig
    from rsp_chains.presets import matched_filter_stage

    chirp = lfm_chirp(32)
    cfg = ChainConfig(
        fft=FftConfig(max_size=256),
        matched_filter=MatchedFilterConfig(num_taps=32,
                                           method="overlap_save"))
    assert matched_filter_stage(cfg, chirp).name == "matched_filter_os"


def test_overlap_save_small_block_size_clamped():
    """block_size below num_taps-1 (valid for the old gather form) is raised
    to a covering power of two — output identical (overlap-save is invariant
    to the block partition)."""
    rng = np.random.RandomState(5)
    x = (rng.randn(300) + 1j * rng.randn(300)).astype(np.complex64)
    taps = (rng.randn(64) + 1j * rng.randn(64)).astype(np.complex64)
    got = np.asarray(overlap_save_fir(jnp.asarray(x), jnp.asarray(taps), 32))
    want = np.convolve(x, taps, mode="full")[:300]
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-1)


def test_matched_filter_os_traced_pair_taps():
    """C-pair taps stay on-device (no host fetch): usable under jit."""
    import jax

    from rsp_chains.cplx import C
    from rsp_chains.ops.matched_filter import matched_filter_os

    chirp = np.asarray(lfm_chirp(32), np.complex64)
    rng = np.random.RandomState(6)
    x = (rng.randn(256) + 1j * rng.randn(256)).astype(np.complex64)

    def f(xr, xi, tr, ti):
        return matched_filter_os(C(xr, xi), C(tr, ti),
                                 MatchedFilterConfig(normalize=False))

    y = jax.jit(f)(jnp.real(x), jnp.imag(x),
                   jnp.asarray(chirp.real), jnp.asarray(chirp.imag))
    got = np.asarray(y.re) + 1j * np.asarray(y.im)
    want = matched_filter_golden(x, chirp, mode="full")[31 : 31 + 256]
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=5e-2)


def test_matched_filter_config_rejects_bad_method():
    with pytest.raises(ValueError, match="matched-filter method"):
        MatchedFilterConfig(method="direct")


def test_matched_filter_accepts_traced_taps():
    """Device/traced taps must stay on-device in ALL filter entry points (a
    np.asarray on a tracer raises; on a device array it forces a device->host
    copy inside the chain)."""
    import jax

    from rsp_chains.configs import MatchedFilterConfig
    from rsp_chains.cplx import as_pair
    from rsp_chains.ops.matched_filter import (
        matched_filter, matched_filter_os, overlap_save_fir,
    )

    rng = np.random.RandomState(0)
    x = as_pair((rng.randn(2, 256) + 1j * rng.randn(2, 256))
                .astype(np.complex64))
    taps_np = (rng.randn(16) + 1j * rng.randn(16)).astype(np.complex64)
    cfg = MatchedFilterConfig(num_taps=16, fft_size=256)

    for f in (lambda a, t: matched_filter(a, t, cfg),
              lambda a, t: matched_filter_os(a, t, cfg),
              lambda a, t: overlap_save_fir(a, t)):
        got = jax.jit(f)(x, jnp.asarray(taps_np))       # traced complex taps
        want = f(x, taps_np)                            # host taps
        np.testing.assert_allclose(np.asarray(got.re), np.asarray(want.re),
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(np.asarray(got.im), np.asarray(want.im),
                                   rtol=1e-5, atol=1e-4)
