"""The bit-true integer presets against the int64 numpy goldens
(``golden.int_models``): BIT-equality throughout (the integer chain's contract
is exactness, not SNR-closeness)."""

import math

import numpy as np
import jax.numpy as jnp
import pytest

from rsp_chains.configs import (
    CfarConfig, CfarVariant, ChainConfig, FftConfig, FixedPointConfig,
    RuntimeConfig,
)
from rsp_chains.cplx import C
from rsp_chains.golden import int_models
from rsp_chains.ops.bit_true import _isqrt32
from rsp_chains.presets import fft_mag_cfar_chain

N = 256
BIT_TRUE = FixedPointConfig(enabled=True, width=16, bin_point=0, bit_true=True)
CA = CfarConfig(max_ref_window=32, max_guard_window=8,
                variant=CfarVariant.CA, include_cash=False)
GOSCA = CfarConfig(max_ref_window=16, max_guard_window=4,
                   variant=CfarVariant.GOSCA, include_cash=True, max_fft_size=N)


def _iq(rng, frames=3, n=N, amp=30000):
    re = rng.randint(-amp, amp, (frames, n)).astype(np.int32)
    im = rng.randint(-amp, amp, (frames, n)).astype(np.int32)
    return re, im


def _golden(re, im, rt: RuntimeConfig, wmax: int, gosca: bool):
    """int FFT over the runtime size (bins beyond it zero) -> the magnitude
    register's integer golden -> integer CFAR golden, per frame."""
    r = rt.peek()
    n = r["fft_size"]
    gr = np.zeros(re.shape, np.int64)
    gi = np.zeros(im.shape, np.int64)
    gr[:, :n], gi[:, :n] = int_models.int_fft_golden(re[:, :n], im[:, :n])
    mag = {0: int_models.int_abs_golden, 1: int_models.int_sqr_golden,
           2: int_models.int_jpl_golden,
           3: int_models.int_log2_golden}[r["mag_mode"]](gr, gi)
    thr = np.zeros(mag.shape, np.int64)
    pk = np.zeros(mag.shape, bool)
    common = dict(ref_window=r["ref_window_size"],
                  guard_window=r["guard_window_size"], div_sum=r["div_sum"],
                  threshold_scaler=r["threshold_scaler"],
                  mode=r["cfar_mode"], peak_grouping=r["peak_grouping"],
                  log_or_linear=r["log_or_linear"],
                  n_active=min(r["cfar_fft_size"], re.shape[-1]))
    for f in range(mag.shape[0]):
        if gosca:
            thr[f], pk[f] = int_models.int_gosca_cfar_golden(
                mag[f], wmax=wmax, algorithm=r["cfar_algorithm"],
                rank_lagg=r["index_lagg"], rank_lead=r["index_lead"],
                sub_window=r["sub_window_size"], **common)
        else:
            thr[f], pk[f] = int_models.int_ca_cfar_golden(mag[f], **common)
    return thr, pk


def _assert_bit_equal(out, thr, pk):
    np.testing.assert_array_equal(np.asarray(out.threshold), thr)
    np.testing.assert_array_equal(np.asarray(out.peaks), pk)


def test_isqrt_matches_math_isqrt():
    """The integer magnitude's isqrt (float seed + exact correction) equals
    math.isqrt on boundary and adversarial values, up to int32 max."""
    vals = [0, 1, 2, 3, 4, 8, 9, 15, 16, 2**31 - 1,
            46340**2, 46340**2 - 1, 46340**2 + 1]
    vals += [k * k for k in range(1, 3000, 53)]
    vals += [k * k - 1 for k in range(2, 3000, 53)]
    vals += list(np.random.RandomState(0).randint(0, 2**31 - 1, 2000))
    got = np.asarray(_isqrt32(jnp.asarray(np.asarray(vals, np.int32))))
    np.testing.assert_array_equal(got, [math.isqrt(int(v)) for v in vals])


@pytest.mark.parametrize("ll,pg", [(0, 0), (0, 1), (1, 1)])
def test_bit_true_chain_log_domain_and_grouping(ll, pg, rng):
    cfg = ChainConfig(fft=FftConfig(max_size=N), cfar=CA, fixed_point=BIT_TRUE)
    rt = RuntimeConfig.make(fft_size=N, ref_window_size=8,
                            guard_window_size=2, threshold_scaler=2.0,
                            div_sum=3, log_or_linear=ll, peak_grouping=pg)
    re, im = _iq(rng)
    out = fft_mag_cfar_chain(cfg).jit()(C(jnp.asarray(re), jnp.asarray(im)), rt)
    _assert_bit_equal(out, *_golden(re, im, rt, 32, gosca=False))


def test_bit_true_register_dispatch_no_recompile(rng):
    """One executable covers the runtime surface of a GOSCA+CASH
    elaboration — CA and GOS algorithms, CASH mode, the LUT-log2 magnitude
    and a shrunken FFT size — each bit-equal to the golden."""
    cfg = ChainConfig(fft=FftConfig(max_size=N, runtime_size=True),
                      cfar=GOSCA, fixed_point=BIT_TRUE)
    jf = fft_mag_cfar_chain(cfg).jit()
    re, im = _iq(rng)
    x = C(jnp.asarray(re), jnp.asarray(im))
    for kw in (dict(),
               dict(cfar_algorithm=1),
               dict(cfar_mode=3, sub_window_size=4),
               dict(mag_mode=3, log_or_linear=0, threshold_scaler=600.0),
               dict(fft_size=N // 2)):
        base = dict(fft_size=N, ref_window_size=8, guard_window_size=2,
                    threshold_scaler=3.0, div_sum=3, index_lagg=4,
                    index_lead=4, sub_window_size=2)
        base.update(kw)
        rt = RuntimeConfig.make(**base)
        _assert_bit_equal(jf(x, rt), *_golden(re, im, rt, 16, gosca=True))
    assert jf._cache_size() == 1


def test_preset_routes_bit_true_to_int_stages(rng):
    """A bit-true elaboration builds the integer FFT, magnitude and CFAR
    stages, and the chain is bit-equal to the golden."""
    cfg = ChainConfig(fft=FftConfig(max_size=N), cfar=CA, fixed_point=BIT_TRUE)
    chain = fft_mag_cfar_chain(cfg)
    assert chain.stage_names == ("fft_int", "logmag_int", "cfar_int")
    rt = RuntimeConfig.make(fft_size=N, ref_window_size=16,
                            guard_window_size=2, threshold_scaler=3.5,
                            div_sum=4)
    re, im = _iq(rng)
    out = chain.jit()(C(jnp.asarray(re), jnp.asarray(im)), rt)
    _assert_bit_equal(out, *_golden(re, im, rt, 32, gosca=False))


def test_bit_true_gosca_preset_matches_golden(rng):
    """The reference's shipped configuration — integer GOSCA + CASH — at a
    GOS register point with unequal ranks and grouping."""
    cfg = ChainConfig(fft=FftConfig(max_size=N), cfar=GOSCA,
                      fixed_point=BIT_TRUE)
    rt = RuntimeConfig.make(fft_size=N, cfar_algorithm=1, cfar_mode=1,
                            ref_window_size=16, guard_window_size=4,
                            index_lagg=7, index_lead=2, threshold_scaler=3.5,
                            div_sum=4, peak_grouping=1)
    re, im = _iq(rng)
    out = fft_mag_cfar_chain(cfg).jit()(C(jnp.asarray(re), jnp.asarray(im)), rt)
    _assert_bit_equal(out, *_golden(re, im, rt, 16, gosca=True))
