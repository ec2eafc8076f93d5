"""Device-path purity: the device representation of complex values is the
real pair (``cplx.C``), so every entry point must lower to a program with NO
complex type anywhere — inputs, constants, intermediates, or outputs. The
pair representation must be airtight end to end."""

import jax
import numpy as np
import pytest

from rsp_chains import (
    CfarConfig, CfarVariant, ChainConfig, DopplerConfig, FftConfig,
    MatchedFilterConfig, RuntimeConfig,
    fft_mag_cfar_chain, range_doppler_chain, rsp_chain_vanilla,
    rx_fft_mag_cfar_tx_chain, chain_with_mem,
)
from rsp_chains.cplx import as_pair
from rsp_chains.golden import lfm_chirp, three_tone_signal


def _assert_no_complex(fn, *args):
    text = jax.jit(fn).lower(*args).as_text()
    assert "complex<" not in text, "complex dtype leaked into the device program"


def _rt(**kw):
    base = dict(fft_size=1024, ref_window_size=32, guard_window_size=4,
                threshold_scaler=3.5, div_sum=5)
    base.update(kw)
    return RuntimeConfig.make(**base)


def test_core_chain_pair_path():
    # small window elaboration: this test only checks dtypes in the lowered
    # program, and trace time scales with the roll/sort machinery size
    cfg = ChainConfig(fft=FftConfig(max_size=1024),
                      cfar=CfarConfig(max_ref_window=16, max_guard_window=4,
                                      variant=CfarVariant.GOSCA,
                                      include_cash=True))
    chain = fft_mag_cfar_chain(cfg)
    x = as_pair(three_tone_signal(1024, shift_range_factor=12))
    _assert_no_complex(chain.__call__, x, _rt())


def test_self_stimulus_chain():
    chain = rsp_chain_vanilla()
    _assert_no_complex(lambda rt: chain(None, rt), _rt(nco_freq_word=16))


def test_rom_chain():
    chain = chain_with_mem()
    _assert_no_complex(lambda rt: chain(None, rt), _rt())


def test_rx_tx_wire_chain():
    cfg = ChainConfig(fft=FftConfig(max_size=1024),
                      cfar=CfarConfig(max_ref_window=16, max_guard_window=4))
    chain = rx_fft_mag_cfar_tx_chain(cfg)
    words = np.zeros(1024, np.uint32)
    _assert_no_complex(chain.__call__, words, _rt(ref_window_size=8,
                                                  guard_window_size=2))


def test_range_doppler_flagship():
    chirp = lfm_chirp(128)
    cfg = ChainConfig(fft=FftConfig(max_size=1024),
                      matched_filter=MatchedFilterConfig(num_taps=128),
                      doppler=DopplerConfig(num_pulses=64),
                      cfar=CfarConfig(max_ref_window=64))
    chain = range_doppler_chain(cfg, taps=chirp)
    rng = np.random.RandomState(0)
    x = as_pair((rng.randn(2, 64, 1024) + 1j * rng.randn(2, 64, 1024)).astype(np.complex64))
    _assert_no_complex(chain.__call__, x, _rt(threshold_scaler=8.0))


def test_graft_entry_flagship():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    _assert_no_complex(fn, *args)


def test_pallas_fused_chain():
    """The CA-only elaboration of the whole chain."""
    cfg = ChainConfig(fft=FftConfig(max_size=1024),
                      cfar=CfarConfig(max_ref_window=64, variant=CfarVariant.CA,
                                      include_cash=False))
    chain = fft_mag_cfar_chain(cfg)
    x = as_pair(three_tone_signal(1024, shift_range_factor=12))
    _assert_no_complex(chain.__call__, x, _rt())


def test_sharded_rd_pipeline():
    from rsp_chains.parallel import make_mesh
    from rsp_chains.parallel.sharded import make_sharded_rd_pipeline

    mesh = make_mesh(channels=2, range_shards=2)
    chirp = lfm_chirp(64)
    cfg = ChainConfig(fft=FftConfig(max_size=1024),
                      matched_filter=MatchedFilterConfig(num_taps=64),
                      doppler=DopplerConfig(num_pulses=16),
                      cfar=CfarConfig(max_ref_window=64))
    pipe = make_sharded_rd_pipeline(cfg, mesh, chirp)
    rng = np.random.RandomState(0)
    x = as_pair((rng.randn(2, 16, 1024) + 1j * rng.randn(2, 16, 1024)).astype(np.complex64))
    text = pipe.lower(x, _rt(threshold_scaler=8.0)).as_text()
    assert "complex<" not in text
