"""Self-stimulus chain (RspChainVanilla analog): PLFG->NCO->FFT->MAG->CFAR.

Spectral contract: start value s => peak at FFT bin s * N / (4 * tableSize)
(comment at RspChainVanillaTester.scala:85; s=16, N=1024, tableSize=128 -> bin 32)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rsp_chains import (
    ChainConfig, CfarConfig, CfarVariant, FftConfig, NcoConfig, RuntimeConfig,
    rsp_chain_vanilla,
)
from rsp_chains.ops.nco import nco
from rsp_chains.ops.plfg import PlfgProgram, Segment, chirp_profile, lfm_program
from rsp_chains.golden import nco_golden
from rsp_chains.configs import PlfgConfig


def _cfg():
    return ChainConfig(
        nco=NcoConfig(table_size=128, phase_width=9),
        fft=FftConfig(max_size=1024),
        cfar=CfarConfig(max_ref_window=64, variant=CfarVariant.CA, include_cash=False),
    )


def test_nco_quantized_matches_golden():
    """Bit-faithful LUT path vs the reference NCO golden
    (RspChainTesterUtils.scala:174-181): tone at bin 32 of a 1024-pt frame."""
    cfg = NcoConfig(table_size=128, phase_width=9, quantized_lut=True)
    # bin 32 <=> word 16: phase step 16/512 = 32/1024 cycles
    words = jnp.full((1024,), 16.0, jnp.float32)
    got = np.asarray(nco(words, cfg))
    want = nco_golden(1024, 32, 1024)
    np.testing.assert_allclose(got.real, want.real, atol=2)  # +/-2 LSB tolerance
    np.testing.assert_allclose(got.imag, want.imag, atol=2)


def test_nco_float_path_spectral_purity():
    cfg = NcoConfig(table_size=128, phase_width=9, quantized_lut=False)
    words = jnp.full((1024,), 16.0, jnp.float32)
    x = np.asarray(nco(words, cfg))
    spec = np.abs(np.fft.fft(x))
    assert np.argmax(spec) == 32


@pytest.mark.parametrize("start", [8, 16, 64])
def test_self_stimulus_peak_bin_contract(start):
    cfg = _cfg()
    chain = rsp_chain_vanilla(cfg)
    rt = RuntimeConfig.make(fft_size=1024, ref_window_size=32, guard_window_size=4,
                            threshold_scaler=3.5, div_sum=5, nco_freq_word=start)
    out = chain.jit()(None, rt)
    expected_bin = start * 1024 // (4 * 128)
    peaks = np.asarray(out.peaks)
    assert peaks[expected_bin], f"expected peak at bin {expected_bin}"
    # runtime re-steer (different start value) must not recompile
    rt2 = RuntimeConfig.make(fft_size=1024, ref_window_size=32, guard_window_size=4,
                             threshold_scaler=3.5, div_sum=5,
                             nco_freq_word=start * 2 if start < 64 else 32)
    chain.jit()(None, rt2)
    assert chain.jit()._cache_size() == 1


def test_plfg_profile_compiler():
    """Frames -> chirps -> segments sequencing (register semantics,
    RspChainVanillaTester.scala:80-94)."""
    prog = PlfgProgram(
        chirps=((Segment(4, 0.0), Segment(4, 1.0)), (Segment(8, -0.5),)),
        repeat_counts=(2, 1),
        chirp_ordinals=(0, 1),
        num_frames=2,
    )
    prof = chirp_profile(prog, PlfgConfig(max_num_samples_width=8))
    # chirp0: 4 zeros then ramp 0..3 (level carries): [0,0,0,0, 0,1,2,3]
    chirp0 = np.array([0, 0, 0, 0, 0, 1, 2, 3], np.float32)
    chirp1 = -0.5 * np.arange(8, dtype=np.float32)
    frame = np.concatenate([chirp0, chirp0, chirp1])
    np.testing.assert_allclose(prof, np.tile(frame, 2))


def test_plfg_validation():
    cfg = PlfgConfig(max_num_segments=2)
    bad = PlfgProgram(chirps=((Segment(4), Segment(4), Segment(4)),))
    with pytest.raises(ValueError):
        bad.validate(cfg)


def test_lfm_chirp_spectrum_spreads():
    """An LFM program sweeps energy across bins (pulse compression front end)."""
    cfg = _cfg()
    prog = lfm_program(1024, sweep_words=64.0)
    chain = rsp_chain_vanilla(cfg, prog)
    rt = RuntimeConfig.make(fft_size=1024, ref_window_size=32, guard_window_size=4,
                            threshold_scaler=10.0, div_sum=5, nco_freq_word=16)
    out = chain.jit()(None, rt)
    # chirp energy spread: the noise-estimate-driven threshold is nonzero across
    # a wide swath of bins (tone would concentrate it)
    spec_occupancy = (np.asarray(out.threshold) > 0).sum()
    assert spec_occupancy > 100


def test_nco_interpolated_lut_reduces_spurs():
    """LUT interpolation suppresses phase-truncation spurs: worst spur of the
    interpolated table is lower than plain truncation for an off-grid tone."""
    base = dict(table_size=128, phase_width=9, quantized_lut=True)
    words = jnp.full((4096,), 16.37, jnp.float32)  # off-grid frequency
    def worst_spur(cfg):
        x = np.asarray(nco(words, cfg)).astype(np.complex128)
        spec = np.abs(np.fft.fft(x * np.hanning(len(x))))
        peak = np.argmax(spec)
        spec[max(0, peak - 8):peak + 8] = 0
        return spec.max() / np.abs(np.fft.fft(x * np.hanning(len(x)))).max()
    plain = worst_spur(NcoConfig(**base, n_interpolation_terms=0))
    interp = worst_spur(NcoConfig(**base, n_interpolation_terms=1))
    assert interp < plain


def test_nco_rasterized_exact_period():
    """Rasterized mode: integer phase => every period is bit-identical."""
    cfg = NcoConfig(table_size=128, phase_width=9, quantized_lut=True,
                    rasterized_mode=True)
    words = jnp.full((1024,), 16.0, jnp.float32)  # period = 512/16 = 32 samples
    x = np.asarray(nco(words, cfg))
    np.testing.assert_array_equal(x[:32], x[32:64])
    np.testing.assert_array_equal(x[:32], x[-32:])


def test_nco_dither_decorrelates_but_keeps_tone():
    cfg = NcoConfig(table_size=128, phase_width=9, quantized_lut=True,
                    dither_enable=True)
    words = jnp.full((1024,), 16.0, jnp.float32)
    x = np.asarray(nco(words, cfg))
    spec = np.abs(np.fft.fft(x))
    assert np.argmax(spec) == 32  # tone survives
    x2 = np.asarray(nco(words, cfg, dither_seed=0x5EED))
    np.testing.assert_array_equal(x, x2)  # deterministic


def test_nco_wide_accumulator_narrow_lut():
    """phase_width > log2(4*table_size): only the top accumulator bits index the
    LUT (finer frequency resolution, same table), like the hardware."""
    cfg = NcoConfig(table_size=128, phase_width=12, quantized_lut=True)
    # word 128 at 12-bit accumulator = 128/4096 cycles/sample -> bin 32 of 1024
    words = jnp.full((1024,), 128.0, jnp.float32)
    x = np.asarray(nco(words, cfg))
    spec = np.abs(np.fft.fft(x))
    assert np.argmax(spec) == 32


def test_runtime_plfg_reprogramming_no_recompile():
    """VERDICT r2 item 7: a new PlfgProgram (within elaborated maxima) on a
    RUNNING compiled chain — the chirp-RAM-write analog
    (RspChainVanillaTester.scala:86-94). The compiled profile rides
    ``rt.plfg_profile`` as a traced operand: two different programs through
    ONE executable, and the peak-bin contract holds for each."""
    from rsp_chains.ops.plfg import compile_program

    cfg = _cfg()
    n = cfg.fft.max_size
    chain = rsp_chain_vanilla(cfg)
    jf = chain.jit()

    # program A: one constant-tone chirp (offsets all zero) -> bin s*N/(4*T)
    prog_a = PlfgProgram(chirps=((Segment(num_samples=256),) ,),
                         repeat_counts=(4,), chirp_ordinals=(0,))
    # program B: constant OFFSET profile — two segments whose first sample
    # ramps to +8 words then holds (reset_to_start=False carries the level),
    # shifting the tone by 8*N/(4*T) = 16 bins for the same start register
    prog_b = PlfgProgram(chirps=((Segment(num_samples=1, increment=8.0),
                                  Segment(num_samples=255)),),
                         repeat_counts=(4,), chirp_ordinals=(0,))
    prof_a = compile_program(prog_a, cfg.plfg, n)
    prof_b = compile_program(prog_b, cfg.plfg, n)

    def rt_with(prof):
        return RuntimeConfig.make(fft_size=n, nco_freq_word=16,
                                  ref_window_size=32, guard_window_size=4,
                                  div_sum=5, plfg_profile=prof)

    out_a = jf(None, rt_with(prof_a))
    out_b = jf(None, rt_with(prof_b))
    assert jf._cache_size() == 1, "PLFG reprogramming triggered a recompile"

    bins_a = np.flatnonzero(np.asarray(out_a.peaks))
    bins_b = np.flatnonzero(np.asarray(out_b.peaks))
    assert 32 in bins_a.tolist(), bins_a
    # B's held offset +8 moves the tone to bin (16+8)*1024/512 = 48; the
    # single ramp sample adds only a -48 dB transient
    assert 48 in bins_b.tolist(), bins_b
    assert 32 not in bins_b.tolist(), bins_b

    # the register path reproduces the compiled-in default exactly
    chain_b = rsp_chain_vanilla(cfg, program=prog_b)
    want_b = chain_b.jit()(None, RuntimeConfig.make(
        fft_size=n, nco_freq_word=16, ref_window_size=32,
        guard_window_size=4, div_sum=5))
    np.testing.assert_array_equal(np.asarray(out_b.peaks),
                                  np.asarray(want_b.peaks))
    np.testing.assert_allclose(np.asarray(out_b.threshold),
                               np.asarray(want_b.threshold), rtol=1e-6)


def test_merge_regs_preserves_plfg_profile():
    """Control-plane pokes (jtag2mm analog) must not drop the profile RAM:
    merge_regs carries array state across scalar register writes."""
    prof = np.arange(64, dtype=np.float32)
    rt = RuntimeConfig.make(fft_size=64, ref_window_size=8,
                            guard_window_size=2, plfg_profile=prof)
    rt2 = rt.merge_regs(threshold_scaler=9.0)
    assert float(rt2.threshold_scaler) == 9.0
    np.testing.assert_array_equal(np.asarray(rt2.plfg_profile), prof)
    # peek stays JSON-safe (scalars only)
    assert "plfg_profile" not in rt.peek()
    import pytest as _pytest
    with _pytest.raises(ValueError, match="unknown registers"):
        rt.merge_regs(nonexistent=1)
