"""2-D (range x Doppler) CA-CFAR — op vs index-wise golden, register
contract, and the RD-map detector chain."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rsp_chains.golden import cfar_2d_golden
from rsp_chains.ops.cfar_2d import (
    Cfar2dConfig, Cfar2dRuntime, cfar_2d_op, rd_2d_cfar_chain,
)

CFG = Cfar2dConfig(max_ref_range=8, max_guard_range=3,
                   max_ref_doppler=4, max_guard_doppler=2)


def _rt2(**kw):
    kw.setdefault("ref_range", 4)
    kw.setdefault("guard_range", 1)
    kw.setdefault("ref_doppler", 2)
    kw.setdefault("guard_doppler", 1)
    kw.setdefault("threshold_scaler", 3.0)
    return Cfar2dRuntime.make(validate_against=CFG, **kw)


def _golden_rd_2d(cpi, taps, rt2, window=None):
    """range_doppler_golden (matched-filter range stage) -> JPL magnitude ->
    cfar_2d_golden for one [P, N] CPI."""
    from rsp_chains.golden import jpl_mag, range_doppler_golden

    rd = range_doppler_golden(np.asarray(cpi, np.complex128),
                              matched_taps=np.asarray(taps),
                              doppler_window=window)
    return cfar_2d_golden(
        jpl_mag(rd), ref_range=int(rt2.ref_range),
        guard_range=int(rt2.guard_range), ref_doppler=int(rt2.ref_doppler),
        guard_doppler=int(rt2.guard_doppler),
        threshold_scaler=float(rt2.threshold_scaler),
        log_or_linear=int(rt2.log_or_linear),
        peak_grouping=int(rt2.peak_grouping),
        active_range=int(rt2.active_range))


def _map(rng, p=12, n=48):
    m = np.abs(rng.randn(p, n)).astype(np.float32)
    m[rng.randint(p), rng.randint(n)] *= 30
    return m


@pytest.mark.parametrize("kw", [
    dict(),
    dict(ref_range=8, guard_range=3, ref_doppler=4, guard_doppler=2),
    dict(ref_range=1, guard_range=0, ref_doppler=1, guard_doppler=0),
    dict(log_or_linear=0, threshold_scaler=1.5),
    dict(peak_grouping=1),
    dict(active_range=32),
])
def test_cfar_2d_matches_golden(kw, rng):
    m = _map(rng)
    rt2 = _rt2(**kw)
    out = cfar_2d_op(jnp.asarray(m), rt2, CFG)
    thr_g, pk_g = cfar_2d_golden(
        m, ref_range=int(rt2.ref_range), guard_range=int(rt2.guard_range),
        ref_doppler=int(rt2.ref_doppler),
        guard_doppler=int(rt2.guard_doppler),
        threshold_scaler=float(rt2.threshold_scaler),
        log_or_linear=int(rt2.log_or_linear),
        peak_grouping=int(rt2.peak_grouping),
        active_range=int(rt2.active_range),
    )
    np.testing.assert_allclose(np.asarray(out.threshold), thr_g,
                               rtol=1e-5, atol=1e-5, err_msg=str(kw))
    np.testing.assert_array_equal(np.asarray(out.peaks), pk_g)


def test_cfar_2d_batched_and_no_recompile(rng):
    m = np.abs(rng.randn(2, 16, 64)).astype(np.float32)
    f = jax.jit(lambda x, r: cfar_2d_op(x, r, CFG))
    out = f(jnp.asarray(m), _rt2())
    assert out.threshold.shape == (2, 16, 64)
    f(jnp.asarray(m), _rt2(ref_range=8, guard_range=3, ref_doppler=4,
                           guard_doppler=2, threshold_scaler=5.0,
                           peak_grouping=1, active_range=40))
    assert f._cache_size() == 1


def test_cfar_2d_runtime_validation():
    with pytest.raises(ValueError, match="exceeds elaborated maxima"):
        _rt2(ref_range=9)
    with pytest.raises(ValueError, match=">= 1"):
        _rt2(ref_doppler=0)
    with pytest.raises(ValueError, match=">= 0"):
        _rt2(guard_range=-1)


def test_rd_2d_cfar_chain_detects_target():
    from rsp_chains import (
        CfarConfig, CfarVariant, ChainConfig, DopplerConfig, FftConfig,
        MatchedFilterConfig, RuntimeConfig,
    )
    from rsp_chains.cplx import as_pair
    from rsp_chains.golden import chirp_with_targets, lfm_chirp

    p, n = 16, 256
    taps = lfm_chirp(32, 0.0, 0.25)
    cfg = ChainConfig(
        fft=FftConfig(max_size=n),
        matched_filter=MatchedFilterConfig(num_taps=32, fft_size=n),
        doppler=DopplerConfig(num_pulses=p, window=None),
        cfar=CfarConfig(max_ref_window=16, max_guard_window=4, max_fft_size=n,
                        variant=CfarVariant.CA, include_cash=False),
    )
    fd, delay = 0.25, 50
    cpi = chirp_with_targets(p, n, taps, [(delay, 1.0, fd)], noise_db=-60)
    rt = RuntimeConfig.make(fft_size=n, ref_window_size=8,
                            guard_window_size=2, threshold_scaler=8.0,
                            div_sum=3)
    rt2 = _rt2(threshold_scaler=8.0)
    out = rd_2d_cfar_chain(cfg, taps=taps, cfg2d=CFG)(
        as_pair(cpi[None]), rt, rt2)
    pk = np.asarray(out.peaks)[0]
    assert pk[p // 2 + int(fd * p), delay]

    # and the whole chain agrees with the numpy golden
    thr_w, pk_w = _golden_rd_2d(cpi, taps, rt2)
    scale = np.abs(thr_w).max()
    assert np.abs(np.asarray(out.threshold)[0] - thr_w).max() / scale < 1e-4
    np.testing.assert_array_equal(pk, pk_w)


@pytest.mark.parametrize("p,n,kw", [
    (4, 16, dict(ref_range=8, guard_range=3, ref_doppler=4, guard_doppler=2)),
    (8, 32, dict(active_range=1)),
    (8, 32, dict(active_range=0)),
])
def test_cfar_2d_degenerate_geometries(p, n, kw, rng):
    """Windows larger than the map / single-cell or empty active ranges: the
    count-normalized PARTIAL semantics must keep op == golden (no div-by-zero,
    no out-of-frame contributions)."""
    m = np.abs(rng.randn(p, n)).astype(np.float32)
    rt2 = _rt2(**kw)
    out = cfar_2d_op(jnp.asarray(m), rt2, CFG)
    thr_g, pk_g = cfar_2d_golden(
        m, ref_range=int(rt2.ref_range), guard_range=int(rt2.guard_range),
        ref_doppler=int(rt2.ref_doppler),
        guard_doppler=int(rt2.guard_doppler),
        threshold_scaler=float(rt2.threshold_scaler),
        active_range=int(rt2.active_range),
    )
    np.testing.assert_allclose(np.asarray(out.threshold), thr_g,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(out.peaks), pk_g)


def test_cfar_2d_range_sharded_equals_unsharded(rng):
    """2-D map detector over a range-sharded RD map (ppermute halo exchange)
    equals the unsharded op exactly — including a runtime active range that
    ends mid-shard."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from rsp_chains.parallel import make_mesh
    from rsp_chains.parallel.sharded import cfar_2d_halo_shard

    mesh = make_mesh(channels=2, range_shards=4)
    m = np.abs(rng.randn(2, 16, 256)).astype(np.float32)
    rt2 = _rt2(ref_range=8, guard_range=3, active_range=200,
               peak_grouping=1)   # grouping neighbors cross shard edges too

    spec = P("ch", None, "rng")
    sharded = jax.jit(jax.shard_map(
        lambda x, r: cfar_2d_halo_shard(x, r, CFG),
        mesh=mesh, in_specs=(spec, P()),
        out_specs=__import__("rsp_chains.ops.cfar", fromlist=["CfarOutput"])
        .CfarOutput(spec, spec, None, None),
        check_vma=False,
    ))
    x = jax.device_put(jnp.asarray(m), NamedSharding(mesh, spec))
    out_s = sharded(x, rt2)
    out_u = cfar_2d_op(jnp.asarray(m), rt2, CFG)
    np.testing.assert_allclose(np.asarray(out_s.threshold),
                               np.asarray(out_u.threshold),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(out_s.peaks),
                                  np.asarray(out_u.peaks))


def test_cfar_2d_clamps_raw_register_writes(rng):
    """Oversized extents written past make()'s validation (server JSON frames
    / dataclasses.replace — the r2 guard-window lesson) clamp to the
    elaborated maxima instead of overflowing the padding/bit ladders."""
    import dataclasses

    m = _map(rng)
    rt2 = dataclasses.replace(
        _rt2(), ref_range=jnp.asarray(28, jnp.int32),
        guard_range=jnp.asarray(9, jnp.int32),
        ref_doppler=jnp.asarray(31, jnp.int32))
    out = cfar_2d_op(jnp.asarray(m), rt2, CFG)
    thr_g, pk_g = cfar_2d_golden(
        m, ref_range=CFG.max_ref_range, guard_range=CFG.max_guard_range,
        ref_doppler=CFG.max_ref_doppler, guard_doppler=1,
        threshold_scaler=3.0)
    np.testing.assert_allclose(np.asarray(out.threshold), thr_g,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(out.peaks), pk_g)


def test_rd_chain_rejects_lsb_keep_elaboration():
    from rsp_chains import (
        CfarConfig, CfarVariant, ChainConfig, DopplerConfig, FftConfig,
        MatchedFilterConfig, range_doppler_chain,
    )

    n = 256
    keep = (False,) + (True,) * 7
    cfg = ChainConfig(
        fft=FftConfig(max_size=n, keep_msb_or_lsb=keep),
        matched_filter=MatchedFilterConfig(num_taps=32, fft_size=n),
        doppler=DopplerConfig(num_pulses=16),
        cfar=CfarConfig(max_ref_window=16, max_guard_window=4, max_fft_size=n,
                        variant=CfarVariant.CA, include_cash=False),
    )
    with pytest.raises(ValueError, match="no analog in the range-Doppler"):
        range_doppler_chain(cfg)


def test_cfar_2d_large_elaboration_recenter(rng):
    """Elaborated maxima past 255 half-extent cells: the recenter roll's bit
    count must follow the maxima like the sum ladder does (a fixed 8-bit cap
    silently applied the window 256 cells off-center)."""
    big = Cfar2dConfig(max_ref_range=256, max_guard_range=8,
                       max_ref_doppler=2, max_guard_doppler=1)
    m = np.abs(rng.randn(4, 1024)).astype(np.float32)
    rt2 = Cfar2dRuntime.make(ref_range=250, guard_range=8, ref_doppler=1,
                             guard_doppler=0, threshold_scaler=2.0,
                             validate_against=big)
    out = cfar_2d_op(jnp.asarray(m), rt2, big)
    from rsp_chains.golden import cfar_2d_golden

    thr_g, pk_g = cfar_2d_golden(
        m, ref_range=250, guard_range=8, ref_doppler=1, guard_doppler=0,
        threshold_scaler=2.0, log_or_linear=1, peak_grouping=0,
        active_range=1 << 30)
    np.testing.assert_allclose(np.asarray(out.threshold), thr_g,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(out.peaks), pk_g)


def test_rd_2d_chain_no_matched_filter_means_no_filter(rng):
    """cfg.matched_filter=None: no filter stage (matching the sharded
    semantics); explicit taps with no MF config is rejected."""
    from rsp_chains import ChainConfig, DopplerConfig, FftConfig, RuntimeConfig
    from rsp_chains.configs import CfarConfig, CfarVariant
    from rsp_chains.cplx import as_pair
    from rsp_chains.ops.doppler import doppler_fft

    n, p = 256, 16
    cfg = ChainConfig(
        fft=FftConfig(max_size=n),
        doppler=DopplerConfig(num_pulses=p),
        cfar=CfarConfig(max_ref_window=8, max_guard_window=2, max_fft_size=n,
                        variant=CfarVariant.CA, include_cash=False))
    with pytest.raises(ValueError, match="matched_filter is None"):
        rd_2d_cfar_chain(cfg, taps=np.ones(8, np.complex64))

    run = rd_2d_cfar_chain(cfg)
    x = (rng.randn(1, p, n) + 1j * rng.randn(1, p, n)).astype(np.complex64)
    rt = RuntimeConfig.make(fft_size=n, ref_window_size=8,
                            guard_window_size=2, threshold_scaler=3.0,
                            div_sum=3)
    rt2 = Cfar2dRuntime.make(ref_range=4, guard_range=1, ref_doppler=2,
                             guard_doppler=1, threshold_scaler=3.0)
    out = run(as_pair(x), rt, rt2)
    # the map is the PLAIN Doppler transform of x — no filtering happened
    want_map = doppler_fft(as_pair(x), cfg.doppler)
    got_thr = np.asarray(out.threshold)
    assert got_thr.shape == (1, p, n)
    from rsp_chains.golden import cfar_2d_golden
    from rsp_chains.ops.logmag import logmag

    mag = np.asarray(logmag(want_map, rt.mag_mode))
    thr_g, _ = cfar_2d_golden(mag[0], ref_range=4, guard_range=1,
                              ref_doppler=2, guard_doppler=1,
                              threshold_scaler=3.0, log_or_linear=1,
                              peak_grouping=0, active_range=1 << 30)
    np.testing.assert_allclose(got_thr[0], thr_g, rtol=1e-4, atol=1e-5)


def _rd_cfg(p=16, n=256):
    from rsp_chains import (
        CfarConfig, CfarVariant, ChainConfig, DopplerConfig, FftConfig,
        MatchedFilterConfig,
    )

    return ChainConfig(
        fft=FftConfig(max_size=n),
        matched_filter=MatchedFilterConfig(num_taps=32, fft_size=n),
        doppler=DopplerConfig(num_pulses=p, window=None),
        cfar=CfarConfig(max_ref_window=16, max_guard_window=4, max_fft_size=n,
                        variant=CfarVariant.CA, include_cash=False),
    )


def test_fused_rd_2d_kernel_register_sweep_matches_xla(rng):
    """The RD+2-D-CFAR chain equals the numpy golden across the 2-D register
    grid, with ONE compiled executable (the 2-D register file is traced —
    VERDICT r2 item 8)."""
    import jax

    from rsp_chains import RuntimeConfig
    from rsp_chains.cplx import as_pair
    from rsp_chains.golden import lfm_chirp

    p, n = 16, 256
    taps = lfm_chirp(32, 0.0, 0.25)
    cfg = _rd_cfg(p, n)
    jf = jax.jit(rd_2d_cfar_chain(cfg, taps=taps, cfg2d=CFG))

    cpi = (rng.randn(2, p, n) + 1j * rng.randn(2, p, n)).astype(np.complex64)
    x = as_pair(cpi)
    rt = RuntimeConfig.make(fft_size=n, ref_window_size=8,
                            guard_window_size=2, threshold_scaler=8.0,
                            div_sum=3)
    sweeps = [
        dict(),
        dict(ref_range=8, guard_range=3, ref_doppler=4, guard_doppler=2),
        dict(ref_range=1, guard_range=0, ref_doppler=1, guard_doppler=0),
        dict(log_or_linear=0, threshold_scaler=1.5),
        dict(peak_grouping=1),
        dict(active_range=64),
    ]
    for kw in sweeps:
        rt2 = _rt2(**kw)
        got = jf(x, rt, rt2)
        assert got.threshold.shape == (2, p, n)
        thr_w, pk_w = _golden_rd_2d(cpi[0], taps, rt2)
        scale = max(np.abs(thr_w).max(), 1e-30)
        assert (np.abs(np.asarray(got.threshold)[0] - thr_w).max() / scale
                < 1e-4), kw
        np.testing.assert_array_equal(np.asarray(got.peaks)[0], pk_w,
                                      err_msg=str(kw))
    assert jf._cache_size() == 1


# ---------------------------------------------------------------------------
# Ordered-statistic (OS) variant


OS_CFG = Cfar2dConfig(max_ref_range=4, max_guard_range=1,
                      max_ref_doppler=2, max_guard_doppler=1,
                      include_os=True)


def _rt2_os(**kw):
    kw.setdefault("ref_range", 3)
    kw.setdefault("guard_range", 1)
    kw.setdefault("ref_doppler", 2)
    kw.setdefault("guard_doppler", 1)
    kw.setdefault("threshold_scaler", 3.0)
    kw.setdefault("algorithm", 1)
    kw.setdefault("os_rank", 20)
    return Cfar2dRuntime.make(validate_against=OS_CFG, **kw)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(ref_range=4, guard_range=1, ref_doppler=2, guard_doppler=1,
         os_rank=50),
    dict(ref_range=1, guard_range=0, ref_doppler=1, guard_doppler=0,
         os_rank=5),
    dict(os_rank=0),
    dict(os_rank=75),                       # clamps to the valid count
    dict(log_or_linear=0, threshold_scaler=1.5),
    dict(peak_grouping=1),
    dict(active_range=24),
])
def test_cfar_2d_os_matches_golden(kw, rng):
    m = _map(rng)
    rt2 = _rt2_os(**kw)
    out = cfar_2d_op(jnp.asarray(m), rt2, OS_CFG)
    thr_g, pk_g = cfar_2d_golden(
        m, ref_range=int(rt2.ref_range), guard_range=int(rt2.guard_range),
        ref_doppler=int(rt2.ref_doppler),
        guard_doppler=int(rt2.guard_doppler),
        threshold_scaler=float(rt2.threshold_scaler),
        log_or_linear=int(rt2.log_or_linear),
        peak_grouping=int(rt2.peak_grouping),
        active_range=int(rt2.active_range),
        algorithm=1, os_rank=int(rt2.os_rank),
    )
    np.testing.assert_allclose(np.asarray(out.threshold), thr_g,
                               rtol=1e-5, atol=1e-5, err_msg=str(kw))
    np.testing.assert_array_equal(np.asarray(out.peaks), pk_g)


def test_cfar_2d_os_runtime_switch_no_recompile(rng):
    """One compiled executable serves CA and OS registers (the 1-D
    variant-mux contract, carried to the map detector)."""
    m = jnp.asarray(_map(rng))
    f = jax.jit(lambda x, r: cfar_2d_op(x, r, OS_CFG))
    out_os = f(m, _rt2_os())
    out_ca = f(m, _rt2_os(algorithm=0))
    assert f._cache_size() == 1
    thr_ca, _ = cfar_2d_golden(
        np.asarray(m), ref_range=3, guard_range=1, ref_doppler=2,
        guard_doppler=1, threshold_scaler=3.0, algorithm=0)
    np.testing.assert_allclose(np.asarray(out_ca.threshold), thr_ca,
                               rtol=1e-5, atol=1e-5)
    assert not np.allclose(np.asarray(out_os.threshold),
                           np.asarray(out_ca.threshold))


def test_cfar_2d_os_validation():
    with pytest.raises(ValueError, match="include_os"):
        _rt2(algorithm=1)                  # CA-only elaboration
    with pytest.raises(ValueError, match="os_rank"):
        _rt2_os(os_rank=-1)
    with pytest.raises(ValueError, match="annulus"):
        _rt2_os(os_rank=OS_CFG.os_stack)
    with pytest.raises(ValueError, match="algorithm"):
        _rt2_os(algorithm=2)
    with pytest.raises(ValueError, match="stack"):
        Cfar2dConfig(include_os=True)      # default maxima: stack > 256


def test_cfar_2d_os_degenerate_map(rng):
    """Map smaller than the annulus: PARTIAL clamping must keep op == golden
    with no NaN/inf escaping (empty sides select 0)."""
    m = np.abs(rng.randn(3, 5)).astype(np.float32)
    rt2 = _rt2_os(os_rank=7)
    out = cfar_2d_op(jnp.asarray(m), rt2, OS_CFG)
    thr_g, pk_g = cfar_2d_golden(
        m, ref_range=3, guard_range=1, ref_doppler=2, guard_doppler=1,
        threshold_scaler=3.0, algorithm=1, os_rank=7)
    assert np.isfinite(np.asarray(out.threshold)).all()
    np.testing.assert_allclose(np.asarray(out.threshold), thr_g,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(out.peaks), pk_g)


def test_rd_2d_chain_os_not_fused(rng):
    """include_os elaborations detect through the full chain."""
    from rsp_chains import ChainConfig, DopplerConfig, MatchedFilterConfig
    from rsp_chains.configs import FftConfig, RuntimeConfig
    from rsp_chains.cplx import as_pair
    from rsp_chains.golden import chirp_with_targets, lfm_chirp

    p, n = 16, 256
    taps = lfm_chirp(32, 0.0, 0.25)
    cfg = ChainConfig(fft=FftConfig(max_size=n),
                      matched_filter=MatchedFilterConfig(num_taps=32,
                                                         fft_size=n),
                      doppler=DopplerConfig(num_pulses=p, window=None))
    fd, delay = 0.25, 50
    cpi = chirp_with_targets(p, n, taps, [(delay, 1.0, fd)], noise_db=-60)
    run = rd_2d_cfar_chain(cfg, taps=taps, cfg2d=OS_CFG)
    rt = RuntimeConfig.make(fft_size=n)
    out = jax.jit(lambda x, r, r2: run(x, r, r2))(
        as_pair(cpi[None]), rt, _rt2_os(threshold_scaler=8.0, os_rank=48))
    pk = np.asarray(out.peaks)[0]
    assert pk[p // 2 + int(fd * p), delay]


def test_cfar_2d_os_range_sharded_equals_unsharded(rng):
    """OS rank select over a range-sharded map (ppermute halo exchange)
    equals the unsharded op exactly — the stacked-offset validity planes see
    the same PARTIAL window through the halo."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from rsp_chains.parallel import make_mesh
    from rsp_chains.parallel.sharded import cfar_2d_halo_shard

    mesh = make_mesh(channels=2, range_shards=4)
    m = np.abs(rng.randn(2, 16, 256)).astype(np.float32)
    rt2 = _rt2_os(ref_range=4, guard_range=1, active_range=200,
                  os_rank=40, peak_grouping=1)

    spec = P("ch", None, "rng")
    sharded = jax.jit(jax.shard_map(
        lambda x, r: cfar_2d_halo_shard(x, r, OS_CFG),
        mesh=mesh, in_specs=(spec, P()),
        out_specs=__import__("rsp_chains.ops.cfar", fromlist=["CfarOutput"])
        .CfarOutput(spec, spec, None, None),
        check_vma=False,
    ))
    x = jax.device_put(jnp.asarray(m), NamedSharding(mesh, spec))
    out_s = sharded(x, rt2)
    out_u = cfar_2d_op(jnp.asarray(m), rt2, OS_CFG)
    np.testing.assert_allclose(np.asarray(out_s.threshold),
                               np.asarray(out_u.threshold),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(out_s.peaks),
                                  np.asarray(out_u.peaks))


@pytest.mark.slow
def test_cli_rd_2d_os_preset(tmp_path, rng):
    """--set2d algorithm=1 elaborates the OS maxima, shrinks the default
    window to fit, and detects on the synthetic fixture."""
    from rsp_chains import cli

    ch = cli._build_chain("rd_2d", ["algorithm=1", "threshold_scaler=8.0",
                                    "peak_grouping=1"])
    assert ch.cfg2d.include_os
    assert int(ch.rt2.ref_range) <= ch.cfg2d.max_ref_range
    assert int(ch.rt2.os_rank) == ch.cfg2d.os_stack // 2
    import jax as _jax
    from rsp_chains.configs import RuntimeConfig

    x = jnp.asarray(cli._default_cpi("rd_2d", ch.cfg))
    out = ch.jit()(x, RuntimeConfig.make(fft_size=1024))
    pk = np.argwhere(np.asarray(out.peaks))
    assert len(pk) >= 1
    assert any(int(d) == 154 for d, _ in pk)  # fd=0.1 -> row 128 + 25.6
