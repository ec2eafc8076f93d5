"""The range-Doppler and pulse-compression presets: equivalence with the numpy
goldens and with their stage composition. Shapes stay small (P=16, N=256)."""

import dataclasses

import numpy as np
import jax

from rsp_chains import (
    CfarConfig,
    CfarVariant,
    ChainConfig,
    DopplerConfig,
    FftConfig,
    MatchedFilterConfig,
    RuntimeConfig,
    pulse_compression_chain,
    range_doppler_chain,
)
from rsp_chains.cplx import as_pair, join
from rsp_chains.golden import (
    cfar_golden, chirp_with_targets, lfm_chirp, range_doppler_golden,
)
from rsp_chains.golden.models import MAG_GOLDENS
from rsp_chains.ops.cfar import cfar_op
from rsp_chains.ops.doppler import doppler_fft
from rsp_chains.ops.logmag import logmag
from rsp_chains.ops.matched_filter import matched_filter
from rsp_chains.ops.windows import window

P, N = 16, 256
TAPS = lfm_chirp(32, 0.0, 0.25)


def _cfg(variant=CfarVariant.CA, include_cash=False, window="hann"):
    return ChainConfig(
        fft=FftConfig(max_size=N),
        matched_filter=MatchedFilterConfig(num_taps=len(TAPS), fft_size=N),
        doppler=DopplerConfig(num_pulses=P, window=window),
        cfar=CfarConfig(max_ref_window=16, max_guard_window=4,
                        max_fft_size=N, variant=variant,
                        include_cash=include_cash),
    )


def _rt(**kw):
    kw.setdefault("fft_size", N)
    kw.setdefault("ref_window_size", 8)
    kw.setdefault("guard_window_size", 2)
    kw.setdefault("threshold_scaler", 3.0)
    kw.setdefault("div_sum", 4)
    return RuntimeConfig.make(**kw)


def _cpi(b=2, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, P, N) + 1j * rng.randn(b, P, N)).astype(np.complex64)


def _golden_map(cpi, cfg):
    w = cfg.doppler.window
    return range_doppler_golden(
        np.asarray(cpi, np.complex128), matched_taps=TAPS,
        doppler_window=None if w is None else window(w, P))


def _golden_rd(cpi, rt, cfg):
    """range_doppler_golden -> magnitude golden -> cfar_golden per row, over
    the runtime CFAR frame."""
    r = rt.peek()
    mag = MAG_GOLDENS[r["mag_mode"]](_golden_map(cpi, cfg))
    act = r["cfar_fft_size"]
    thr = np.zeros(mag.shape)
    pk = np.zeros(mag.shape, bool)
    thr[..., :act], pk[..., :act] = cfar_golden(
        mag[..., :act], ref_window=r["ref_window_size"],
        guard_window=r["guard_window_size"],
        threshold_scaler=r["threshold_scaler"], mode=r["cfar_mode"],
        algorithm=r["cfar_algorithm"], div_sum=r["div_sum"],
        index_lagg=r["index_lagg"], index_lead=r["index_lead"],
        sub_window=r["sub_window_size"], log_or_linear=r["log_or_linear"],
        peak_grouping=r["peak_grouping"])
    return thr, pk


def _assert_close(got, thr_w, pk_w, max_flips=2):
    scale = max(np.abs(thr_w).max(), 1e-9)
    assert np.abs(np.asarray(got.threshold) - thr_w).max() / scale < 1e-4
    flips = int(np.sum(np.asarray(got.peaks) != pk_w))
    assert flips <= max_flips, flips


def test_rd_chain_matches_golden():
    cfg = _cfg()
    cpi = _cpi()
    rt = _rt()
    got = range_doppler_chain(cfg, taps=TAPS).jit()(as_pair(cpi), rt)
    _assert_close(got, *_golden_rd(cpi, rt, cfg))


def test_rd_go_so_modes_and_runtime_registers_no_recompile():
    cfg = _cfg()
    cpi = _cpi(b=1, seed=1)
    f = range_doppler_chain(cfg, taps=TAPS).jit()
    cases = [
        dict(cfar_mode=0, ref_window_size=8, guard_window_size=2, div_sum=3),
        dict(cfar_mode=1, ref_window_size=16, guard_window_size=4, div_sum=4),
        dict(cfar_mode=2, ref_window_size=4, guard_window_size=1, div_sum=2),
        dict(peak_grouping=1),
        dict(log_or_linear=0, mag_mode=3, threshold_scaler=1.5),
        dict(mag_mode=1),
        dict(cfar_fft_size=N // 2),  # runtime CFAR active-range register
    ]
    for kw in cases:
        rt = _rt(**kw)
        _assert_close(f(as_pair(cpi), rt), *_golden_rd(cpi, rt, cfg))
    assert f._cache_size() == 1


def test_rd_map_matches_mf_doppler_golden():
    cfg = _cfg()
    cpi = _cpi(b=1, seed=2)
    got = join(doppler_fft(matched_filter(as_pair(cpi), TAPS,
                                          cfg.matched_filter), cfg.doppler))
    want = _golden_map(cpi, cfg)
    assert np.abs(np.asarray(got) - want).max() / np.abs(want).max() < 1e-5


def test_rd_target_lands_on_expected_cell():
    cfg = _cfg(window=None)
    fd, delay = 0.25, 50
    cpi = chirp_with_targets(P, N, TAPS, [(delay, 1.0, fd)], noise_db=-60)
    rt = _rt(threshold_scaler=8.0)
    out = range_doppler_chain(cfg, taps=TAPS).jit()(as_pair(cpi[None]), rt)
    pk = np.asarray(out.peaks)[0]
    # detection at Doppler bin P/2 + fd*P (fftshifted), range bin = delay
    assert pk[P // 2 + int(fd * P), delay]
    # and that cell is the strongest of the golden RD map
    mag = np.abs(_golden_map(cpi, cfg))
    assert np.unravel_index(np.argmax(mag), mag.shape) == \
        (P // 2 + int(fd * P), delay)


def test_rd_preset_stage_list_and_golden():
    cfg = _cfg()
    chain = range_doppler_chain(cfg, taps=TAPS)
    assert chain.stage_names == ("matched_filter", "doppler_fft", "logmag",
                                 "cfar")
    cpi = _cpi(b=1, seed=3)
    rt = _rt()
    _assert_close(chain.jit()(as_pair(cpi), rt), *_golden_rd(cpi, rt, cfg))


def test_rd_preset_gosca_matches_golden():
    cfg = _cfg(variant=CfarVariant.GOSCA, include_cash=True)
    chain = range_doppler_chain(cfg, taps=TAPS)
    cpi = _cpi(b=1, seed=4)
    rt = _rt(cfar_algorithm=1, index_lagg=6, index_lead=6)
    _assert_close(chain.jit()(as_pair(cpi), rt), *_golden_rd(cpi, rt, cfg))


def test_rd_preset_any_pulse_count_builds_stage_list():
    """The stage list does not depend on the pulse count."""
    cfg = dataclasses.replace(_cfg(), doppler=DopplerConfig(num_pulses=12,
                                                            window="hann"))
    chain = range_doppler_chain(cfg, taps=TAPS)
    assert chain.stage_names[0] == "matched_filter"


# ---------------------------------------------------------------------------
# collapsed pulse compression (config 2)
# ---------------------------------------------------------------------------


def _pc_cfg(runtime_size=True):
    return ChainConfig(
        fft=FftConfig(max_size=N, runtime_size=runtime_size),
        matched_filter=MatchedFilterConfig(num_taps=len(TAPS), fft_size=N),
        cfar=CfarConfig(max_ref_window=16, max_guard_window=4,
                        max_fft_size=N, variant=CfarVariant.CA,
                        include_cash=False),
    )


def _xla_pc(x, rt, cfg):
    from rsp_chains.ops.fft import fft_op

    y = matched_filter(x, TAPS, cfg.matched_filter)
    s = fft_op(y, rt.log2_fft_size, cfg.fft)
    m = logmag(s, rt.mag_mode, cfg.mag)
    return cfar_op(m, rt, cfg.cfar)


def test_pulse_compression_collapse_matches_composition_full_size():
    cfg = _pc_cfg()
    chain = pulse_compression_chain(cfg, taps=TAPS)
    assert chain.stage_names == ("spectral_mf", "logmag", "cfar")
    rng = np.random.RandomState(5)
    x = as_pair((rng.randn(3, N) + 1j * rng.randn(3, N)).astype(np.complex64))
    rt = _rt()
    got = chain.jit()(x, rt)
    want = _xla_pc(x, rt, cfg)
    scale = np.abs(np.asarray(want.threshold)).max()
    assert np.abs(np.asarray(got.threshold)
                  - np.asarray(want.threshold)).max() / scale < 1e-4


def test_pulse_compression_runtime_small_size_branch():
    """Below the elaborated max the collapse is invalid; the cond's literal
    branch must reproduce the stage composition exactly."""
    cfg = _pc_cfg()
    chain = pulse_compression_chain(cfg, taps=TAPS)
    rng = np.random.RandomState(6)
    x = as_pair((rng.randn(2, N) + 1j * rng.randn(2, N)).astype(np.complex64))
    rt = _rt(fft_size=N // 2)
    got = chain.jit()(x, rt)
    want = _xla_pc(x, rt, cfg)
    thr_w = np.asarray(want.threshold)
    np.testing.assert_allclose(np.asarray(got.threshold), thr_w,
                               rtol=1e-4, atol=1e-5 * np.abs(thr_w).max())


def test_pulse_compression_spectral_mf_path_for_gosca():
    """Non-CA elaborations keep the spectral_mf collapse + the GOS tail."""
    cfg = dataclasses.replace(
        _pc_cfg(),
        cfar=CfarConfig(max_ref_window=16, max_guard_window=4, max_fft_size=N,
                        variant=CfarVariant.GOSCA, include_cash=True))
    chain = pulse_compression_chain(cfg, taps=TAPS)
    assert chain.stages[0].name == "spectral_mf"
    rng = np.random.RandomState(9)
    x = as_pair((rng.randn(2, N) + 1j * rng.randn(2, N)).astype(np.complex64))
    rt = _rt(cfar_algorithm=1, index_lagg=6, index_lead=6)
    got = chain.jit()(x, rt)
    want = _xla_pc(x, rt, cfg)
    scale = np.abs(np.asarray(want.threshold)).max()
    assert np.abs(np.asarray(got.threshold)
                  - np.asarray(want.threshold)).max() / scale < 1e-4


def test_pulse_compression_n4096_lowers():
    """The 4096-point elaboration (BASELINE config 2) traces and lowers."""
    cfg = ChainConfig(
        fft=FftConfig(max_size=4096),
        matched_filter=MatchedFilterConfig(num_taps=128, fft_size=4096),
        cfar=CfarConfig(max_ref_window=16, max_guard_window=4,
                        max_fft_size=4096, variant=CfarVariant.CA,
                        include_cash=False),
    )
    taps = lfm_chirp(128, 0.0, 0.25)
    chain = pulse_compression_chain(cfg, taps=taps)
    assert chain.stage_names[0] == "spectral_mf"
    rng = np.random.RandomState(10)
    x = as_pair((rng.randn(1, 4096) + 1j * rng.randn(1, 4096))
                .astype(np.complex64))
    rt = RuntimeConfig.make(fft_size=4096, ref_window_size=8,
                            guard_window_size=2, threshold_scaler=8.0,
                            div_sum=4)
    jax.jit(chain.__call__).lower(x, rt)  # must trace + lower cleanly


def test_sharded_rd_pipeline_matches_unsharded():
    """The (ch, rng) sharded RD step equals the unsharded chain (CPU mesh)."""
    from rsp_chains.parallel import make_mesh
    from rsp_chains.parallel.sharded import make_sharded_rd_pipeline

    n = 512
    cfg = ChainConfig(
        fft=FftConfig(max_size=n),
        matched_filter=MatchedFilterConfig(num_taps=len(TAPS), fft_size=n),
        doppler=DopplerConfig(num_pulses=P),
        cfar=CfarConfig(max_ref_window=16, max_guard_window=4,
                        max_fft_size=n, variant=CfarVariant.CA,
                        include_cash=False),
    )
    mesh = make_mesh(channels=2, range_shards=4)
    rng = np.random.RandomState(8)
    x = (rng.randn(2, P, n) + 1j * rng.randn(2, P, n)).astype(np.complex64)
    rt = RuntimeConfig.make(fft_size=n, ref_window_size=8,
                            guard_window_size=2, threshold_scaler=3.0,
                            div_sum=4)

    out_s = make_sharded_rd_pipeline(cfg, mesh, TAPS)(as_pair(x), rt)
    out_u = range_doppler_chain(cfg, taps=TAPS).jit()(as_pair(x), rt)
    thr_u = np.asarray(out_u.threshold)
    scale = np.abs(thr_u).max()
    assert np.abs(np.asarray(out_s.threshold) - thr_u).max() / scale < 1e-4
    np.testing.assert_array_equal(np.asarray(out_s.peaks),
                                  np.asarray(out_u.peaks))


def test_pc_no_recompile_across_runtime_sizes():
    """The full/small runtime-size branches live under ONE lax.cond — the
    fft-size register stays a traced scalar (no recompile)."""
    cfg = _pc_cfg()
    chain = pulse_compression_chain(cfg, taps=TAPS)
    jc = chain.jit()
    rng = np.random.RandomState(11)
    x = as_pair((rng.randn(2, N) + 1j * rng.randn(2, N)).astype(np.complex64))
    jc(x, _rt())
    jc(x, _rt(fft_size=N // 2))
    assert jc._cache_size() == 1


def test_rd_512_pulses_lowers():
    """The 512-pulse elaboration traces and lowers cleanly."""
    cfg = ChainConfig(
        fft=FftConfig(max_size=256),
        matched_filter=MatchedFilterConfig(num_taps=32, fft_size=256),
        doppler=DopplerConfig(num_pulses=512),
        cfar=CfarConfig(max_ref_window=16, max_guard_window=4,
                        max_fft_size=256, variant=CfarVariant.CA,
                        include_cash=False),
    )
    chain = range_doppler_chain(cfg, taps=TAPS)
    assert chain.stage_names[0] == "matched_filter"
    rng = np.random.RandomState(13)
    x = as_pair((rng.randn(1, 512, 256)
                 + 1j * rng.randn(1, 512, 256)).astype(np.complex64))
    rt = RuntimeConfig.make(fft_size=256, ref_window_size=8,
                            guard_window_size=2, threshold_scaler=8.0,
                            div_sum=3)
    jax.jit(chain.__call__).lower(x, rt)
