"""Tests that need an NVIDIA GPU (marker ``gpu``; they skip elsewhere). Run on
the card with ``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -o addopts=""``."""

import numpy as np
import pytest

from rsp_chains import (
    CfarConfig, CfarVariant, ChainConfig, RuntimeConfig, fft_mag_cfar_chain,
)
from rsp_chains.cplx import as_pair
from rsp_chains.golden import cfar_golden, fft_golden, jpl_mag


@pytest.mark.gpu
def test_ca_chain_on_the_card_matches_golden(gpu, rng):
    """The CA chain compiled for the card agrees with the float64 golden,
    and its FFT matmuls keep full float32 precision there (TF32 would miss
    the 1e-4 bar)."""
    cfg = ChainConfig(cfar=CfarConfig(max_ref_window=64,
                                      variant=CfarVariant.CA,
                                      include_cash=False))
    rt = RuntimeConfig.make(fft_size=1024, ref_window_size=32,
                            guard_window_size=4, threshold_scaler=3.5,
                            div_sum=5)
    x = (rng.randn(8, 1024) + 1j * rng.randn(8, 1024)).astype(np.complex64)
    x[:, :] += 6 * np.exp(2j * np.pi * 128 * np.arange(1024) / 1024)
    out = fft_mag_cfar_chain(cfg).jit()(as_pair(x), rt)
    assert out.threshold.devices() == {gpu[0]}
    thr_g, pk_g = cfar_golden(jpl_mag(fft_golden(x.astype(np.complex128))),
                              ref_window=32, guard_window=4,
                              threshold_scaler=3.5, div_sum=5)
    scale = np.abs(thr_g).max()
    assert np.abs(np.asarray(out.threshold) - thr_g).max() <= 1e-4 * scale
    assert np.asarray(out.peaks)[:, 128].all()
