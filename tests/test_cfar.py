"""CFAR tests: every variant x mode against the golden model, runtime
reconfiguration, frame masking, packing (register semantics: SURVEY §2.5)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rsp_chains.configs import (
    CfarAlgorithm,
    CfarConfig,
    CfarMode,
    CfarVariant,
    RuntimeConfig,
)
from rsp_chains.ops.cfar import cfar_op
from rsp_chains.golden import cfar_golden


def _mag(rng, n=256):
    m = np.abs(rng.randn(n)) * 10 + 1
    m[40] = 500.0  # a clear target
    m[41] = 300.0
    m[200] = 400.0
    return m.astype(np.float32)


CA_CASES = [
    (CfarMode.CELL_AVERAGING, dict()),
    (CfarMode.GREATEST_OF, dict()),
    (CfarMode.SMALLEST_OF, dict()),
]


@pytest.mark.parametrize("mode,extra", CA_CASES)
@pytest.mark.parametrize("w,g", [(16, 2), (32, 4), (8, 1)])
def test_ca_family_matches_golden(mode, extra, w, g, rng):
    mag = _mag(rng)
    cfg = CfarConfig(max_ref_window=32, max_guard_window=8,
                     variant=CfarVariant.CA, include_cash=False)
    rt = RuntimeConfig.make(fft_size=256, cfar_mode=mode, ref_window_size=w,
                            guard_window_size=g, threshold_scaler=3.5, **extra)
    out = cfar_op(jnp.asarray(mag), rt, cfg)
    thr_g, pk_g = cfar_golden(
        mag, ref_window=w, guard_window=g, threshold_scaler=3.5,
        mode=int(mode), algorithm=0, div_sum=int(np.log2(w)),
    )
    np.testing.assert_allclose(np.asarray(out.threshold), thr_g, rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(np.asarray(out.peaks), pk_g)


@pytest.mark.parametrize("mode", [CfarMode.CELL_AVERAGING, CfarMode.GREATEST_OF,
                                  CfarMode.SMALLEST_OF])
@pytest.mark.parametrize("rank", [3, 12, 24])
def test_gos_matches_golden(mode, rank, rng):
    mag = _mag(rng)
    w, g = 32, 4
    cfg = CfarConfig(max_ref_window=32, variant=CfarVariant.GOS, include_cash=False)
    rt = RuntimeConfig.make(fft_size=256, cfar_mode=mode,
                            cfar_algorithm=CfarAlgorithm.GOS,
                            ref_window_size=w, guard_window_size=g,
                            index_lagg=rank, index_lead=rank, threshold_scaler=3.0)
    out = cfar_op(jnp.asarray(mag), rt, cfg)
    thr_g, pk_g = cfar_golden(
        mag, ref_window=w, guard_window=g, threshold_scaler=3.0,
        mode=int(mode), algorithm=1, index_lagg=rank, index_lead=rank,
    )
    np.testing.assert_allclose(np.asarray(out.threshold), thr_g, rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(np.asarray(out.peaks), pk_g)


@pytest.mark.parametrize("sw", [4, 8])
def test_cash_matches_golden(sw, rng):
    mag = _mag(rng)
    w, g = 32, 4
    cfg = CfarConfig(max_ref_window=32, variant=CfarVariant.CA, include_cash=True)
    rt = RuntimeConfig.make(fft_size=256, cfar_mode=CfarMode.CASH,
                            ref_window_size=w, guard_window_size=g,
                            sub_window_size=sw, threshold_scaler=3.0)
    out = cfar_op(jnp.asarray(mag), rt, cfg)
    thr_g, pk_g = cfar_golden(
        mag, ref_window=w, guard_window=g, threshold_scaler=3.0,
        mode=3, sub_window=sw,
    )
    np.testing.assert_allclose(np.asarray(out.threshold), thr_g, rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(np.asarray(out.peaks), pk_g)


def test_gosca_runtime_algorithm_switch(rng):
    """GOSCA variant: the base+5 register switches CA vs GOS at runtime
    (RspChainVanillaTester.scala:124-132) without recompilation."""
    mag = _mag(rng)
    cfg = CfarConfig(max_ref_window=32, variant=CfarVariant.GOSCA, include_cash=False)
    f = jax.jit(lambda m, rt: cfar_op(m, rt, cfg))
    mj = jnp.asarray(mag)
    rt_ca = RuntimeConfig.make(fft_size=256, cfar_algorithm=CfarAlgorithm.CA,
                               ref_window_size=16, guard_window_size=2)
    rt_gos = RuntimeConfig.make(fft_size=256, cfar_algorithm=CfarAlgorithm.GOS,
                                ref_window_size=16, guard_window_size=2,
                                index_lagg=8, index_lead=8)
    out_ca = f(mj, rt_ca)
    out_gos = f(mj, rt_gos)
    assert f._cache_size() == 1
    thr_ca, _ = cfar_golden(mag, ref_window=16, guard_window=2, threshold_scaler=3.5,
                            mode=0, algorithm=0, div_sum=4)
    thr_gos, _ = cfar_golden(mag, ref_window=16, guard_window=2, threshold_scaler=3.5,
                             mode=0, algorithm=1, index_lagg=8, index_lead=8)
    np.testing.assert_allclose(np.asarray(out_ca.threshold), thr_ca, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(np.asarray(out_gos.threshold), thr_gos, rtol=1e-5, atol=1e-3)


def test_runtime_fft_size_masks_frame(rng):
    """The cfar base+0 fftSize register: cells beyond the active size produce no
    output and are never read by windows."""
    n, n_active = 256, 128
    mag = _mag(rng, n)
    mag[n_active:] = 1e9  # poison inactive region
    cfg = CfarConfig(max_ref_window=32, variant=CfarVariant.CA, include_cash=False)
    rt = RuntimeConfig.make(fft_size=n_active, ref_window_size=16, guard_window_size=2)
    out = cfar_op(jnp.asarray(mag), rt, cfg)
    thr_g, pk_g = cfar_golden(mag[:n_active], ref_window=16, guard_window=2,
                              threshold_scaler=3.5, mode=0, div_sum=4)
    np.testing.assert_allclose(np.asarray(out.threshold)[:n_active], thr_g,
                               rtol=1e-5, atol=1e-3)
    assert np.all(np.asarray(out.threshold)[n_active:] == 0)
    assert not np.any(np.asarray(out.peaks)[n_active:])


def test_peak_grouping(rng):
    mag = _mag(rng)
    cfg = CfarConfig(max_ref_window=32, variant=CfarVariant.CA, include_cash=False)
    rt = RuntimeConfig.make(fft_size=256, ref_window_size=16, guard_window_size=2,
                            peak_grouping=1)
    out = cfar_op(jnp.asarray(mag), rt, cfg)
    _, pk_g = cfar_golden(mag, ref_window=16, guard_window=2, threshold_scaler=3.5,
                          mode=0, div_sum=4, peak_grouping=1)
    np.testing.assert_array_equal(np.asarray(out.peaks), pk_g)
    # bin 41 (shoulder of the 500-peak at bin 40) must be grouped away
    assert not np.asarray(out.peaks)[41]


def test_log_domain_additive_threshold(rng):
    mag = np.log2(_mag(rng)).astype(np.float32)
    cfg = CfarConfig(max_ref_window=32, variant=CfarVariant.CA, include_cash=False)
    rt = RuntimeConfig.make(fft_size=256, ref_window_size=16, guard_window_size=2,
                            log_or_linear=0, threshold_scaler=2.0)
    out = cfar_op(jnp.asarray(mag), rt, cfg)
    thr_g, pk_g = cfar_golden(mag, ref_window=16, guard_window=2,
                              threshold_scaler=2.0, mode=0, div_sum=4,
                              log_or_linear=0)
    np.testing.assert_allclose(np.asarray(out.threshold), thr_g, rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(np.asarray(out.peaks), pk_g)


def test_batched_matches_per_row(rng):
    mags = np.stack([_mag(rng), _mag(rng) * 2, np.abs(rng.randn(256)) + 1]).astype(np.float32)
    cfg = CfarConfig(max_ref_window=32, variant=CfarVariant.GOSCA, include_cash=True)
    rt = RuntimeConfig.make(fft_size=256, ref_window_size=16, guard_window_size=2)
    out = cfar_op(jnp.asarray(mags), rt, cfg)
    for i in range(3):
        row = cfar_op(jnp.asarray(mags[i]), rt, cfg)
        np.testing.assert_allclose(np.asarray(out.threshold[i]),
                                   np.asarray(row.threshold), rtol=1e-6)


def test_runtime_validation_requires():
    """Ported require() constraints (RspChainVanillaTester.scala:50-61)."""
    with pytest.raises(ValueError):
        RuntimeConfig.make(ref_window_size=33)  # not a power of two
    with pytest.raises(ValueError):
        RuntimeConfig.make(ref_window_size=4, guard_window_size=8)  # ref <= guard
    with pytest.raises(ValueError):
        RuntimeConfig.make(fft_size=1000)  # not a power of two
    with pytest.raises(ValueError):
        RuntimeConfig.make(ref_window_size=16, index_lead=16)  # rank >= window
    with pytest.raises(ValueError):
        RuntimeConfig.make(ref_window_size=16, sub_window_size=16)
    with pytest.raises(ValueError):
        RuntimeConfig.make(ref_window_size=128,
                           validate_against=CfarConfig(max_ref_window=64))


def test_wrap_edge_policy_matches_golden(rng):
    """EdgePolicy.WRAP: circular windows (spectrum treated as periodic)."""
    from rsp_chains.configs import EdgePolicy

    mag = _mag(rng)
    w, g = 16, 2
    cfg = CfarConfig(max_ref_window=32, variant=CfarVariant.GOSCA,
                     include_cash=False, edge_policy=EdgePolicy.WRAP)
    for algo, rank in ((CfarAlgorithm.CA, None), (CfarAlgorithm.GOS, 8)):
        rt = RuntimeConfig.make(fft_size=256, cfar_algorithm=algo,
                                ref_window_size=w, guard_window_size=g,
                                index_lagg=rank, index_lead=rank,
                                threshold_scaler=3.0)
        out = cfar_op(jnp.asarray(mag), rt, cfg)
        thr_g, pk_g = cfar_golden(
            mag, ref_window=w, guard_window=g, threshold_scaler=3.0,
            mode=0, algorithm=int(algo), index_lagg=rank, index_lead=rank,
            div_sum=4, edge_policy="wrap",
        )
        np.testing.assert_allclose(np.asarray(out.threshold), thr_g,
                                   rtol=1e-5, atol=1e-3)
        np.testing.assert_array_equal(np.asarray(out.peaks), pk_g)


def test_reflect_edge_policy_matches_golden(rng):
    """EdgePolicy.REFLECT: windows mirror at the frame edges."""
    from rsp_chains.configs import EdgePolicy

    mag = _mag(rng)
    w, g = 16, 2
    cfg = CfarConfig(max_ref_window=32, variant=CfarVariant.GOSCA,
                     include_cash=False, edge_policy=EdgePolicy.REFLECT)
    for algo, rank in ((CfarAlgorithm.CA, None), (CfarAlgorithm.GOS, 8)):
        rt = RuntimeConfig.make(fft_size=256, cfar_algorithm=algo,
                                ref_window_size=w, guard_window_size=g,
                                index_lagg=rank, index_lead=rank,
                                threshold_scaler=3.0)
        out = cfar_op(jnp.asarray(mag), rt, cfg)
        thr_g, pk_g = cfar_golden(
            mag, ref_window=w, guard_window=g, threshold_scaler=3.0,
            mode=0, algorithm=int(algo), index_lagg=rank, index_lead=rank,
            div_sum=4, edge_policy="reflect",
        )
        np.testing.assert_allclose(np.asarray(out.threshold), thr_g,
                                   rtol=1e-5, atol=1e-3)
        np.testing.assert_array_equal(np.asarray(out.peaks), pk_g)


def test_guard_window_clamped_to_elaborated_max(rng):
    """A runtime guard register beyond the elaborated max_guard_window clamps
    (the hardware cannot express it; the roll paths' SHIFT_BITS decomposition
    would silently drop high bits otherwise — ADVICE r1)."""
    mag = _mag(rng)
    cfg = CfarConfig(max_ref_window=32, max_guard_window=8,
                     variant=CfarVariant.CA, include_cash=False)
    import dataclasses

    rt_max = RuntimeConfig.make(fft_size=256, ref_window_size=16,
                                guard_window_size=8, threshold_scaler=3.0)
    # bypass make()'s require()s the way an unvalidated ingress would
    rt_big = dataclasses.replace(
        rt_max, guard_window_size=jnp.asarray(100, jnp.int32))
    out_big = cfar_op(jnp.asarray(mag), rt_big, cfg)
    out_max = cfar_op(jnp.asarray(mag), rt_max, cfg)
    np.testing.assert_array_equal(np.asarray(out_big.threshold),
                                  np.asarray(out_max.threshold))

    # the same clamp through a chain's mag+CFAR tail stages
    from rsp_chains.chain import Chain
    from rsp_chains.configs import ChainConfig, FftConfig
    from rsp_chains.cplx import C
    from rsp_chains.presets import tail_stages

    ccfg = ChainConfig(fft=FftConfig(max_size=128), cfar=cfg)
    tail = Chain(ccfg, tail_stages(ccfg)).jit()
    spec = C(jnp.asarray(mag.reshape(2, 128)), jnp.zeros((2, 128), jnp.float32))
    rt_m = RuntimeConfig.make(fft_size=128, ref_window_size=16,
                              guard_window_size=8, threshold_scaler=3.0)
    rt_b = dataclasses.replace(
        rt_m, guard_window_size=jnp.asarray(100, jnp.int32))
    k_big = tail(spec, rt_b)
    k_max = tail(spec, rt_m)
    np.testing.assert_array_equal(np.asarray(k_big.threshold),
                                  np.asarray(k_max.threshold))


def test_cfar_fft_size_register_is_independent(rng):
    """The reference writes FFT base+0 and CFAR base+0 separately
    (RspChainVanillaTester.scala:96,113); r1 derived one from the other, making
    mismatched settings inexpressible. cfar_fft_size now masks the CFAR frame
    independently of the FFT's active size."""
    mag = _mag(rng)
    cfg = CfarConfig(max_ref_window=32, variant=CfarVariant.CA, include_cash=False)
    rt = RuntimeConfig.make(fft_size=256, cfar_fft_size=128, ref_window_size=16,
                            guard_window_size=2, threshold_scaler=3.0, div_sum=4)
    out = cfar_op(jnp.asarray(mag), rt, cfg)
    thr = np.asarray(out.threshold)
    assert np.all(thr[128:] == 0.0)
    # and the masked frame equals a straight 128-cell run
    rt128 = RuntimeConfig.make(fft_size=128, ref_window_size=16,
                               guard_window_size=2, threshold_scaler=3.0, div_sum=4)
    out128 = cfar_op(jnp.asarray(mag[:128]), rt128, cfg)
    np.testing.assert_allclose(thr[:128], np.asarray(out128.threshold),
                               rtol=1e-6, atol=1e-6)
