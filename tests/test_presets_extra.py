"""Beamformed RD and integrated-search presets — the reachability layer for
ops/beamform.py, ops/integrate.py and ops/detect.py (every op must be
reachable from a preset, like the r1 real_rx fix for rfft_op)."""

import numpy as np
import pytest
import jax.numpy as jnp

from rsp_chains import (
    CfarConfig,
    CfarVariant,
    ChainConfig,
    DopplerConfig,
    FftConfig,
    MatchedFilterConfig,
    RuntimeConfig,
)
from rsp_chains.cplx import as_pair
from rsp_chains.golden import chirp_with_targets, lfm_chirp
from rsp_chains.ops.beamform import ula_steering
from rsp_chains.presets import beamformed_rd_chain, integrated_search_chain

P, N = 16, 256
TAPS = lfm_chirp(32, 0.0, 0.25)


def _cfg():
    return ChainConfig(
        fft=FftConfig(max_size=N),
        matched_filter=MatchedFilterConfig(num_taps=len(TAPS), fft_size=N),
        doppler=DopplerConfig(num_pulses=P, window=None),
        cfar=CfarConfig(max_ref_window=16, max_guard_window=4,
                        max_fft_size=N, variant=CfarVariant.CA,
                        include_cash=False),
    )


def _rt(**kw):
    kw.setdefault("fft_size", N)
    kw.setdefault("ref_window_size", 8)
    kw.setdefault("guard_window_size", 2)
    kw.setdefault("threshold_scaler", 8.0)
    kw.setdefault("div_sum", 4)
    return RuntimeConfig.make(**kw)


def test_beamformed_rd_target_lands_in_expected_beam():
    cfg = _cfg()
    angles = np.deg2rad(np.linspace(-60, 60, 8))
    chain = beamformed_rd_chain(cfg, taps=TAPS, angles_rad=angles,
                                num_channels=8)
    assert chain.stages[0].name == "beamform"

    fd, delay, tgt_deg = 0.25, 50, 10.0
    cpi = chirp_with_targets(P, N, TAPS, [(delay, 1.0, fd)], noise_db=-60)
    a = ula_steering(8, np.deg2rad([tgt_deg]))[0]
    x = (a[:, None, None] * cpi[None]).astype(np.complex64)   # [C, P, N]

    out = chain.jit()(as_pair(x), _rt())
    pk = np.asarray(out.peaks)                                # [B, P, N]
    beam_star = int(np.argmin(np.abs(angles - np.deg2rad(tgt_deg))))
    assert pk[beam_star, P // 2 + int(fd * P), delay]
    # the target beam carries the strongest threshold response of all beams
    energy = np.asarray(out.threshold).sum(axis=(1, 2))
    assert int(np.argmax(energy)) == beam_star


def test_integrated_search_noncoherent_matches_manual_composition():
    from rsp_chains.ops.cfar import cfar_op
    from rsp_chains.ops.integrate import noncoherent_integration
    from rsp_chains.ops.logmag import logmag
    from rsp_chains.ops.matched_filter import matched_filter

    cfg = _cfg()
    chain = integrated_search_chain(cfg, taps=TAPS, mode="noncoherent")
    rng = np.random.RandomState(0)
    x = (rng.randn(2, P, N) + 1j * rng.randn(2, P, N)).astype(np.complex64)
    rt = _rt(threshold_scaler=3.0)
    got = chain.jit()(as_pair(x), rt)
    m = logmag(matched_filter(as_pair(x), TAPS, cfg.matched_filter),
               rt.mag_mode, cfg.mag)
    want = cfar_op(noncoherent_integration(m), rt, cfg.cfar)
    np.testing.assert_allclose(np.asarray(got.threshold),
                               np.asarray(want.threshold), rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(got.peaks),
                                  np.asarray(want.peaks))
    assert got.threshold.shape == (2, N)


def test_integrated_search_gain_over_single_pulse():
    """Non-coherent integration raises detection: a target invisible to a
    single pulse's CFAR at high scaler is detected on the integrated map."""
    cfg = _cfg()
    cpi = chirp_with_targets(P, N, TAPS, [(100, 0.45, 0.0)], noise_db=-12)
    rt = _rt(threshold_scaler=4.0)
    chain = integrated_search_chain(cfg, taps=TAPS, mode="noncoherent")
    out = chain.jit()(as_pair(cpi), rt)
    assert np.asarray(out.peaks)[100]


@pytest.mark.slow
def test_integrated_search_binary_m_of_n():
    cfg = _cfg()
    cpi = chirp_with_targets(P, N, TAPS, [(80, 1.0, 0.0)], noise_db=-30)
    rt = _rt(threshold_scaler=4.0)
    chain = integrated_search_chain(cfg, taps=TAPS, mode="binary",
                                    m_of_n=P // 2)
    out = chain.jit()(as_pair(cpi), rt)
    pk = np.asarray(out.peaks)
    assert pk.shape == (N,)
    assert pk[80]

    from rsp_chains.ops.cfar import cfar_op
    from rsp_chains.ops.integrate import binary_integration
    from rsp_chains.ops.logmag import logmag
    from rsp_chains.ops.matched_filter import matched_filter

    m = logmag(matched_filter(as_pair(cpi), TAPS, cfg.matched_filter),
               rt.mag_mode, cfg.mag)
    per_pulse = cfar_op(m, rt, cfg.cfar)
    want = binary_integration(per_pulse.peaks, P // 2)
    np.testing.assert_array_equal(pk, np.asarray(want))


def test_integrated_search_coherent_mode_runs():
    cfg = _cfg()
    cpi = chirp_with_targets(P, N, TAPS, [(60, 1.0, 0.0)], noise_db=-30)
    chain = integrated_search_chain(cfg, taps=TAPS, mode="coherent")
    out = chain.jit()(as_pair(cpi), _rt(threshold_scaler=4.0))
    assert np.asarray(out.peaks)[60]


@pytest.mark.slow
def test_compact_detections_through_cli_run_top_k(capsys):
    """The --top-k serving egress path end to end through the CLI."""
    from rsp_chains import cli

    rc = cli.main(["run", "--preset", "fft_mag_cfar", "--top-k", "8"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "top-8 frame 0" in out


def test_cli_register_value_parsing():
    """REG=VAL values: ints stay ints, floats and scientific notation parse
    (``threshold_scaler=1e3`` used to crash on the dot-sniffing int path)."""
    from rsp_chains.cli import _reg_value, _runtime

    assert _reg_value("32") == 32 and isinstance(_reg_value("32"), int)
    assert _reg_value("3.5") == 3.5
    assert _reg_value("1e3") == 1000.0
    rt = _runtime(["threshold_scaler=1e3", "ref_window_size=16"])
    assert float(rt.threshold_scaler) == 1000.0
    assert int(rt.ref_window_size) == 16


@pytest.mark.slow
def test_cli_plot_covers_every_preset(tmp_path, monkeypatch):
    """``plot`` must produce a figure for the presets that used to crash the
    generic 1-D branch: wire-format (packed words out), real-ADC (real frames
    in, N/2 bins out), and the 2-D CPI presets. Small elaborations via a
    patched ``_build_chain`` — the default 8ch x 256p x 1024bin beamformed
    CPI is too large for the CPU suite."""
    from rsp_chains import cli
    from rsp_chains import presets as P
    from rsp_chains.configs import (
        CfarConfig, ChainConfig, DopplerConfig, FftConfig, MatchedFilterConfig,
    )

    def small(n=256):
        return dict(
            fft=FftConfig(max_size=n),
            cfar=CfarConfig(max_ref_window=16, max_guard_window=4,
                            max_fft_size=n),
        )

    builders = {
        "rx_tx": lambda: P.rx_fft_mag_cfar_tx_chain(ChainConfig(**small())),
        "real_rx": lambda: P.real_rx_chain(ChainConfig(**small())),
        "beamformed_rd": lambda: P.beamformed_rd_chain(ChainConfig(
            **small(),
            matched_filter=MatchedFilterConfig(num_taps=32, fft_size=256),
            doppler=DopplerConfig(num_pulses=16))),
        "integrated_search": lambda: P.integrated_search_chain(ChainConfig(
            **small(),
            matched_filter=MatchedFilterConfig(num_taps=32, fft_size=256))),
    }
    monkeypatch.setattr(cli, "_build_chain",
                        lambda preset, *a: builders[preset]())

    for preset in builders:
        out = tmp_path / f"{preset}.pdf"
        rc = cli.main(["plot", "--preset", preset, "--output", str(out),
                       "--set", "fft_size=256", "--set", "ref_window_size=8",
                       "--set", "guard_window_size=2"])
        assert rc == 0
        assert out.exists() and out.stat().st_size > 0, preset


def test_rx_rd_tx_wire_format_round_trip():
    """Packed beat words [.., P, N] -> RD chain -> packed CFAR words:
    decoded thresholds/peaks equal the float RD chain on the same int16 CPI."""
    from rsp_chains import packing
    from rsp_chains.presets import range_doppler_chain, rx_rd_tx_chain

    from rsp_chains.cplx import C
    from rsp_chains.io import native

    cfg = _cfg()
    rng = np.random.RandomState(12)
    re = rng.randint(-20000, 20000, (2, P, N)).astype(np.int32)
    im = rng.randint(-20000, 20000, (2, P, N)).astype(np.int32)
    pair = C(jnp.asarray(re, jnp.float32), jnp.asarray(im, jnp.float32))
    words = packing.pack_iq(pair)
    rt = _rt(threshold_scaler=3.0)

    wire = rx_rd_tx_chain(cfg, taps=TAPS)
    out_words = np.asarray(wire.jit()(words, rt))

    ref = range_doppler_chain(cfg, taps=TAPS).jit()(pair, rt)
    thr_w, bins, pk_w = native.unpack_cfar_words(out_words,
                                                 cfg.fft.log2_max)
    np.testing.assert_array_equal(
        pk_w.astype(bool), np.asarray(ref.peaks).reshape(-1))
    # threshold is truncated into the word's integer field
    np.testing.assert_allclose(
        thr_w.astype(np.float64),
        np.clip(np.floor(np.asarray(ref.threshold).reshape(-1)), 0, None),
        atol=1.0)


def test_beamformed_rd_fft_beam_space():
    """fft_beams=True: DFT beam space (ops.fft_beamform) ahead of the RD
    chain; a spatial-frequency-aligned wavefront lands in its DFT beam."""
    cfg = _cfg()
    c = 8
    k_beam = 2                      # spatial frequency k/C = 2/8
    chain = beamformed_rd_chain(cfg, taps=TAPS, num_channels=c,
                                fft_beams=True)
    assert chain.stages[0].name == "fft_beamform"
    fd, delay = 0.25, 50
    cpi = chirp_with_targets(P, N, TAPS, [(delay, 1.0, fd)], noise_db=-60)
    # plain DFT beams (no weight conjugation): beam k collects the
    # wavefront with element phase e^{+2pi i k c / C}
    a = np.exp(2j * np.pi * k_beam * np.arange(c) / c)
    x = (a[:, None, None] * cpi[None]).astype(np.complex64)
    out = chain.jit()(as_pair(x), _rt())
    energy = np.asarray(out.threshold).sum(axis=(1, 2))
    assert int(np.argmax(energy)) == k_beam
    assert np.asarray(out.peaks)[k_beam, P // 2 + int(fd * P), delay]


def test_range_doppler_no_mf_config_means_no_filter(rng):
    """matched_filter=None elaborations run NO filter stage — matching
    parallel.sharded's semantics so sharded == unsharded holds — and
    explicit taps without an elaborated MF config are rejected."""
    import dataclasses

    from rsp_chains.ops.doppler import doppler_fft
    from rsp_chains.ops.cfar import cfar_op
    from rsp_chains.ops.logmag import logmag
    from rsp_chains.presets import range_doppler_chain

    cfg = dataclasses.replace(_cfg(), matched_filter=None)
    with pytest.raises(ValueError, match="matched_filter is None"):
        range_doppler_chain(cfg, taps=TAPS)

    chain = range_doppler_chain(cfg)
    assert not any("matched" in s for s in chain.stage_names)
    x = (rng.randn(1, P, N) + 1j * rng.randn(1, P, N)).astype(np.complex64)
    rt = _rt()
    got = chain.jit()(as_pair(x), rt)
    want = cfar_op(logmag(doppler_fft(as_pair(x), cfg.doppler), rt.mag_mode),
                   rt, cfg.cfar)
    np.testing.assert_allclose(np.asarray(got.threshold),
                               np.asarray(want.threshold),
                               rtol=1e-4, atol=1e-5)


def test_rd_fusable_rejects_overlarge_cfar_pad(rng):
    """Elaborations whose CFAR windows exceed the roll paths' 128-cell pad
    (the gather windows take over) build and run the RD chain, equal to the
    stage composition."""
    import dataclasses

    from rsp_chains.configs import CfarConfig, CfarVariant
    from rsp_chains.ops.cfar import cfar_op
    from rsp_chains.ops.doppler import doppler_fft
    from rsp_chains.ops.logmag import logmag
    from rsp_chains.ops.matched_filter import matched_filter
    from rsp_chains.presets import range_doppler_chain

    big = CfarConfig(max_ref_window=128, max_guard_window=8, max_fft_size=N,
                     variant=CfarVariant.CA, include_cash=False)
    cfg = dataclasses.replace(_cfg(), cfar=big)
    chain = range_doppler_chain(cfg, taps=TAPS)
    assert chain.stage_names == ("matched_filter", "doppler_fft", "logmag",
                                 "cfar")
    x = (rng.randn(1, P, N) + 1j * rng.randn(1, P, N)).astype(np.complex64)
    rt = _rt(ref_window_size=64)
    out = chain.jit()(as_pair(x), rt)
    assert np.asarray(out.threshold).shape == (1, P, N)
    rd = doppler_fft(matched_filter(as_pair(x), TAPS, cfg.matched_filter),
                     cfg.doppler)
    want = cfar_op(logmag(rd, rt.mag_mode), rt, cfg.cfar)
    np.testing.assert_allclose(np.asarray(out.threshold),
                               np.asarray(want.threshold), rtol=1e-4, atol=1e-5)


def test_real_rx_chain_honors_sqrt_n_scaling_and_rejects_window(rng):
    import dataclasses

    from rsp_chains import ChainConfig, FftConfig, RuntimeConfig
    from rsp_chains.configs import CfarConfig, CfarVariant, FftScaling
    from rsp_chains.presets import real_rx_chain

    n = 512
    base = ChainConfig(
        fft=FftConfig(max_size=n, scaling=FftScaling.SQRT_N),
        cfar=CfarConfig(max_ref_window=16, max_guard_window=4,
                        max_fft_size=n // 2, variant=CfarVariant.CA,
                        include_cash=False))
    with pytest.raises(ValueError, match="window"):
        real_rx_chain(dataclasses.replace(
            base, fft=dataclasses.replace(base.fft, window="hann")))
    with pytest.raises(ValueError, match="expand"):
        real_rx_chain(dataclasses.replace(
            base, fft=dataclasses.replace(
                base.fft, scaling=FftScaling.NONE,
                expand_logic=(1,) * 9)))

    chain = real_rx_chain(base)
    x = rng.randn(2, n).astype(np.float32)
    rt = RuntimeConfig.make(fft_size=n, cfar_fft_size=n // 2,
                            ref_window_size=8, guard_window_size=2,
                            threshold_scaler=3.0, div_sum=3)
    got = chain.jit()(x, rt)
    # golden: one-sided sqrt(N)-scaled spectrum magnitude drives the CFAR
    spec = np.fft.fft(x, axis=-1)[:, : n // 2] / np.sqrt(n)
    from rsp_chains.golden import cfar_golden, jpl_mag

    mag = jpl_mag(spec)
    thr_g = np.stack([cfar_golden(mag[i], ref_window=8, guard_window=2,
                                  threshold_scaler=3.0, div_sum=3)[0]
                      for i in range(2)])
    np.testing.assert_allclose(np.asarray(got.threshold), thr_g,
                               rtol=2e-3, atol=2e-3)


def test_cli_rd_2d_preset_run_and_plot(tmp_path, monkeypatch):
    """The 2-D map detector is CLI-reachable: ``run/plot --preset rd_2d``
    with --set2d register overrides (small elaboration via patched builder)."""
    from rsp_chains import cli
    from rsp_chains.configs import (
        ChainConfig, DopplerConfig, FftConfig, MatchedFilterConfig,
    )

    real_init = cli._Rd2dChain.__init__

    def small_init(self, set2d):
        real_init(self, set2d)
        from rsp_chains.ops.cfar_2d import Cfar2dConfig, rd_2d_cfar_chain

        self.cfg = ChainConfig(
            fft=FftConfig(max_size=256),
            matched_filter=MatchedFilterConfig(num_taps=32, fft_size=256),
            doppler=DopplerConfig(num_pulses=16),
        )
        self._run = rd_2d_cfar_chain(self.cfg, cfg2d=self.cfg2d)

    monkeypatch.setattr(cli._Rd2dChain, "__init__", small_init)
    rc = cli.main(["run", "--preset", "rd_2d", "--set", "fft_size=256",
                   "--set2d", "ref_range=4", "--set2d", "guard_range=1",
                   "--set2d", "threshold_scaler=8.0"])
    assert rc == 0
    out = tmp_path / "rd2d.pdf"
    rc = cli.main(["plot", "--preset", "rd_2d", "--set", "fft_size=256",
                   "--set2d", "ref_range=4", "--output", str(out)])
    assert rc == 0 and out.exists() and out.stat().st_size > 0
    # out-of-range 2-D register writes are rejected like the 1-D require()s
    import pytest as _pytest
    with _pytest.raises(ValueError, match="elaborated maxima"):
        cli.main(["run", "--preset", "rd_2d", "--set2d", "ref_range=999"])
