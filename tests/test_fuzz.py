"""Seeded fuzz sweep: random runtime register files x random signals, op vs
golden. Covers register-space corners no hand-written case hits."""

import numpy as np
import jax.numpy as jnp
import pytest

pytestmark = pytest.mark.slow

from rsp_chains.configs import (
    CfarConfig, CfarVariant, MagMode, RuntimeConfig,
)
from rsp_chains.ops.cfar import cfar_op
from rsp_chains.ops.logmag import logmag
from rsp_chains.golden import cfar_golden
from rsp_chains.golden.models import MAG_GOLDENS


@pytest.mark.parametrize("trial", range(20))
def test_cfar_random_register_files(trial):
    rng = np.random.RandomState(1000 + trial)
    n = int(rng.choice([128, 256, 512]))
    mag = (np.abs(rng.randn(n)) * rng.uniform(1, 100)).astype(np.float32)
    for _ in range(rng.randint(1, 4)):
        mag[rng.randint(n)] *= rng.uniform(5, 50)

    w = int(rng.choice([4, 8, 16, 32]))
    g = int(rng.randint(1, min(w, 8)))
    mode = int(rng.randint(0, 4))
    algorithm = int(rng.randint(0, 2))
    sw = max(2, min(int(rng.choice([2, 4])), w // 2))  # require() : sw < w
    # independent per-side ranks: the r5 shared-select gate must stay exact
    # both when the rank registers agree and when they differ
    rank = int(rng.randint(0, w))
    rank_lead = int(rng.randint(0, w))
    scaler = float(rng.uniform(1.0, 8.0))
    div = int(np.log2(w))
    pg = int(rng.randint(0, 2))

    cfg = CfarConfig(max_ref_window=32, max_guard_window=8,
                     variant=CfarVariant.GOSCA, include_cash=True)
    rt = RuntimeConfig.make(
        fft_size=n, cfar_mode=mode, cfar_algorithm=algorithm,
        ref_window_size=w, guard_window_size=g, sub_window_size=sw,
        index_lagg=rank, index_lead=rank_lead, threshold_scaler=scaler,
        div_sum=div, peak_grouping=pg,
    )
    out = cfar_op(jnp.asarray(mag), rt, cfg)
    thr_g, pk_g = cfar_golden(
        mag, ref_window=w, guard_window=g, threshold_scaler=scaler,
        mode=mode, algorithm=algorithm, div_sum=div, index_lagg=rank,
        index_lead=rank_lead, sub_window=sw, peak_grouping=pg,
    )
    np.testing.assert_allclose(np.asarray(out.threshold), thr_g,
                               rtol=1e-4, atol=1e-2,
                               err_msg=f"regs: w={w} g={g} mode={mode} "
                                       f"alg={algorithm} rank={rank} sw={sw}")
    np.testing.assert_array_equal(np.asarray(out.peaks), pk_g)


@pytest.mark.parametrize("trial", range(8))
def test_mag_random_modes(trial):
    rng = np.random.RandomState(2000 + trial)
    x = (rng.randn(256) * rng.uniform(1, 1000)
         + 1j * rng.randn(256) * rng.uniform(1, 1000)).astype(np.complex64)
    mode = int(rng.randint(0, 4))
    got = np.asarray(logmag(jnp.asarray(x), jnp.asarray(mode, jnp.int32)))
    want = MAG_GOLDENS[mode](x)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("trial", range(6))
def test_full_chain_random_register_files(trial):
    """End-to-end: random runtime register files through the public chain vs
    the composed golden pipeline (FFT -> mag -> CFAR)."""
    from rsp_chains import ChainConfig, FftConfig, as_pair, fft_mag_cfar_chain
    from rsp_chains.golden import fft_golden, three_tone_signal
    from rsp_chains.golden.models import MAG_GOLDENS, cfar_golden

    rng = np.random.RandomState(3000 + trial)
    iq = three_tone_signal(1024, shift_range_factor=12, seed=int(rng.randint(1e6)))
    n = int(rng.choice([256, 512, 1024]))
    w = int(rng.choice([8, 16, 32]))
    g = int(rng.randint(1, min(w, 8)))
    mag_mode = int(rng.randint(0, 3))  # log2 mode needs log-domain scaler choice
    mode = int(rng.randint(0, 3))
    algo = int(rng.randint(0, 2))
    rank = int(rng.randint(0, w))
    rank_lead = int(rng.randint(0, w))
    scaler = float(rng.uniform(2.0, 6.0))

    cfg = ChainConfig(
        fft=FftConfig(max_size=1024),
        cfar=CfarConfig(max_ref_window=32, max_guard_window=8,
                        variant=CfarVariant.GOSCA, include_cash=False))
    chain = fft_mag_cfar_chain(cfg)
    rt = RuntimeConfig.make(
        fft_size=n, mag_mode=mag_mode, cfar_mode=mode, cfar_algorithm=algo,
        ref_window_size=w, guard_window_size=g, index_lagg=rank,
        index_lead=rank_lead, threshold_scaler=scaler, div_sum=int(np.log2(w)))
    out = chain.jit()(as_pair(iq), rt)

    spec = fft_golden(iq, n=n)
    mag_g = MAG_GOLDENS[mag_mode](spec)
    thr_g, pk_g = cfar_golden(mag_g, ref_window=w, guard_window=g,
                              threshold_scaler=scaler, mode=mode, algorithm=algo,
                              index_lagg=rank, index_lead=rank_lead,
                              div_sum=int(np.log2(w)))
    np.testing.assert_allclose(np.asarray(out.threshold)[:n], thr_g,
                               rtol=1e-3, atol=1e-2,
                               err_msg=f"n={n} w={w} g={g} mag={mag_mode} "
                                       f"mode={mode} algo={algo} rank={rank}")
    np.testing.assert_array_equal(np.asarray(out.peaks)[:n], pk_g)
    assert not np.asarray(out.peaks)[n:].any()


@pytest.mark.parametrize("trial", range(6))
def test_fused_rd_random_register_files(trial):
    """Random register files through the range-Doppler chain vs the numpy
    golden (matched filter -> Doppler -> mag -> CFAR)."""
    from rsp_chains import range_doppler_chain
    from rsp_chains.configs import (
        ChainConfig, DopplerConfig, FftConfig, MatchedFilterConfig,
    )
    from rsp_chains.cplx import as_pair
    from rsp_chains.golden import lfm_chirp, range_doppler_golden
    from rsp_chains.ops.windows import window

    rng = np.random.RandomState(3000 + trial)
    p, n = 16, 256
    taps = lfm_chirp(32, 0.0, 0.25)
    cfg = ChainConfig(
        fft=FftConfig(max_size=n),
        matched_filter=MatchedFilterConfig(num_taps=32, fft_size=n),
        doppler=DopplerConfig(num_pulses=p, window="hann"),
        cfar=CfarConfig(max_ref_window=16, max_guard_window=4,
                        max_fft_size=n, variant=CfarVariant.CA,
                        include_cash=False),
    )
    w = int(rng.choice([4, 8, 16]))
    rt = RuntimeConfig.make(
        fft_size=n,
        cfar_mode=int(rng.randint(0, 3)),
        ref_window_size=w,
        guard_window_size=int(rng.randint(1, min(w, 5))),
        threshold_scaler=float(rng.uniform(1.0, 8.0)),
        div_sum=int(np.log2(w)),
        peak_grouping=int(rng.randint(0, 2)),
        mag_mode=int(rng.choice([0, 1, 2])),
        log_or_linear=int(rng.randint(0, 2)),
    )
    cpi = (rng.randn(2, p, n) + 1j * rng.randn(2, p, n)).astype(np.complex64)
    got = range_doppler_chain(cfg, taps=taps).jit()(as_pair(cpi), rt)
    regs = rt.peek()
    rd = range_doppler_golden(cpi.astype(np.complex128), matched_taps=taps,
                              doppler_window=window("hann", p))
    thr_w, pk_w = cfar_golden(
        MAG_GOLDENS[regs["mag_mode"]](rd), ref_window=w,
        guard_window=regs["guard_window_size"],
        threshold_scaler=regs["threshold_scaler"], mode=regs["cfar_mode"],
        div_sum=regs["div_sum"], log_or_linear=regs["log_or_linear"],
        peak_grouping=regs["peak_grouping"])
    scale = max(np.abs(thr_w).max(), 1e-9)
    assert np.abs(np.asarray(got.threshold) - thr_w).max() / scale < 1e-4
    flips = int(np.sum(np.asarray(got.peaks) != pk_w))
    assert flips <= 2, flips


@pytest.mark.parametrize("trial", range(12))
def test_cfar_2d_random_register_files(trial):
    """2-D detector fuzz: random map shapes x random register files (CA and
    OS), op vs the literal index-wise golden."""
    from rsp_chains.golden import cfar_2d_golden
    from rsp_chains.ops.cfar_2d import (
        Cfar2dConfig, Cfar2dRuntime, cfar_2d_op,
    )

    rng = np.random.RandomState(2000 + trial)
    p = int(rng.choice([6, 12, 20]))
    n = int(rng.choice([24, 48, 96]))
    m = (np.abs(rng.randn(p, n)) * rng.uniform(1, 50)).astype(np.float32)
    for _ in range(rng.randint(1, 3)):
        m[rng.randint(p), rng.randint(n)] *= rng.uniform(5, 40)

    cfg = Cfar2dConfig(max_ref_range=4, max_guard_range=2,
                       max_ref_doppler=3, max_guard_doppler=1,
                       include_os=True)
    kw = dict(
        ref_range=int(rng.randint(1, 5)),
        guard_range=int(rng.randint(0, 3)),
        ref_doppler=int(rng.randint(1, 4)),
        guard_doppler=int(rng.randint(0, 2)),
        threshold_scaler=float(rng.uniform(1.0, 8.0)),
        log_or_linear=int(rng.randint(0, 2)),
        peak_grouping=int(rng.randint(0, 2)),
        active_range=int(rng.randint(4, n + 8)),
        algorithm=int(rng.randint(0, 2)),
        os_rank=int(rng.randint(0, cfg.os_stack)),
    )
    rt2 = Cfar2dRuntime.make(validate_against=cfg, **kw)
    out = cfar_2d_op(jnp.asarray(m), rt2, cfg)
    thr_g, pk_g = cfar_2d_golden(
        m, ref_range=kw["ref_range"], guard_range=kw["guard_range"],
        ref_doppler=kw["ref_doppler"], guard_doppler=kw["guard_doppler"],
        threshold_scaler=kw["threshold_scaler"],
        log_or_linear=kw["log_or_linear"],
        peak_grouping=kw["peak_grouping"], active_range=kw["active_range"],
        algorithm=kw["algorithm"], os_rank=kw["os_rank"],
    )
    np.testing.assert_allclose(np.asarray(out.threshold), thr_g,
                               rtol=1e-4, atol=1e-4, err_msg=str(kw))
    np.testing.assert_array_equal(np.asarray(out.peaks), pk_g,
                                  err_msg=str(kw))
