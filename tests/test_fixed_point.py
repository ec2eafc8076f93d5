"""Fixed-point fidelity mode (SURVEY §7 hard part (e)): quantized stage
boundaries reproduce 16-bit hardware-style streams within the reference's
tolerance / an SNR bound."""

import numpy as np
import jax.numpy as jnp
import pytest

from rsp_chains import (
    ChainConfig, CfarConfig, CfarVariant, FftConfig, FixedPointConfig,
    RuntimeConfig, fft_mag_cfar_chain,
)
from rsp_chains.configs import Rounding
from rsp_chains.numerics import quantize, round_to_int, snr_db
from rsp_chains.golden import three_tone_signal, fft_golden, jpl_mag


def test_round_half_up_matches_dsptools():
    x = jnp.asarray([0.5, 1.5, -0.5, -1.5, 2.49, -2.49])
    got = np.asarray(round_to_int(x, Rounding.HALF_UP))
    np.testing.assert_array_equal(got, [1, 2, 0, -1, 2, -2])


def test_quantize_grid_and_saturation():
    cfg = FixedPointConfig(enabled=True, width=16, bin_point=12)
    x = jnp.asarray([0.123456, 100.0, -100.0])
    q = np.asarray(quantize(x, cfg))
    assert q[0] == np.floor(0.123456 * 4096 + 0.5) / 4096
    assert q[1] == 32767 / 4096    # saturated positive
    assert q[2] == -32768 / 4096   # saturated negative


def test_quantize_disabled_is_identity(rng):
    x = jnp.asarray(rng.randn(32))
    np.testing.assert_array_equal(np.asarray(quantize(x, FixedPointConfig())), x)


def test_fixed_point_chain_snr_vs_float():
    """The int16/bp-12 pipeline tracks the float pipeline within an SNR bound on
    the canonical three-tone vector (the fixed-point analog of the reference's
    +/-2 LSB golden checks).

    Convention: the bp-12 grid represents values in [-8, 8); the reference's
    integer test vectors (amplitude ~0.4 * 2^12) are raw fixed-point *bits*, so
    the value-domain signal is bits / 2^12."""
    iq = three_tone_signal(1024, shift_range_factor=12) / 4096.0
    rt = RuntimeConfig.make(fft_size=1024, ref_window_size=32, guard_window_size=4,
                            threshold_scaler=3.5, div_sum=5)
    base = dict(fft=FftConfig(max_size=1024),
                cfar=CfarConfig(max_ref_window=64, variant=CfarVariant.CA,
                                include_cash=False))
    f_float = fft_mag_cfar_chain(ChainConfig(**base)).jit()
    f_fixed = fft_mag_cfar_chain(ChainConfig(
        **base, fixed_point=FixedPointConfig(enabled=True, width=16, bin_point=12)
    )).jit()
    x = jnp.asarray(iq, jnp.complex64)
    thr_float = np.asarray(f_float(x, rt).threshold)
    thr_fixed = np.asarray(f_fixed(x, rt).threshold)
    assert snr_db(thr_float, thr_fixed) > 40.0
    # detections at the tone bins survive quantization
    pk = np.asarray(f_fixed(x, rt).peaks)
    for b in (128, 256, 512):
        assert pk[b]


def test_fixed_point_mag_within_2lsb_of_integer_golden():
    """JPL magnitude of a quantized-integer spectrum matches the integer golden
    within the reference's +/-2 LSB tolerance (RspChainTesterUtils.scala:231-237)."""
    iq = three_tone_signal(1024, shift_range_factor=12)
    spec = fft_golden(iq, scaling="div_n")
    spec_q = np.trunc(spec.real * 4096) / 4096 + 1j * (np.trunc(spec.imag * 4096) / 4096)
    got = jpl_mag(spec_q) * 4096
    want = jpl_mag(np.trunc(spec.real * 4096) + 1j * np.trunc(spec.imag * 4096))
    assert np.max(np.abs(got - want)) <= 2.0


def test_snr_helper():
    ref = np.ones(100)
    assert snr_db(ref, ref) == np.inf
    assert 19.9 < snr_db(ref, ref + 0.1) < 20.1


# ---------------------------------------------------------------------------
# bit-true integer path (ops/bit_true.py vs golden/int_models.py)
# ---------------------------------------------------------------------------


def _int_iq(rng, n=1024, amp=8000):
    re = rng.randint(-amp, amp, size=n).astype(np.int32)
    im = rng.randint(-amp, amp, size=n).astype(np.int32)
    return re, im


def test_int_fft_matches_golden_exactly(rng):
    from rsp_chains.cplx import C
    from rsp_chains.ops.bit_true import fft_int_op
    from rsp_chains.golden.int_models import int_fft_golden

    n = 256
    re, im = _int_iq(rng, n)
    cfg = FftConfig(max_size=n)
    out = fft_int_op(C(jnp.asarray(re), jnp.asarray(im)),
                     jnp.asarray(int(np.log2(n)), jnp.int32), cfg)
    gr, gi = int_fft_golden(re, im)
    np.testing.assert_array_equal(np.asarray(out.re), gr)
    np.testing.assert_array_equal(np.asarray(out.im), gi)


def test_int_fft_runtime_size_branch_exact(rng):
    from rsp_chains.cplx import C
    from rsp_chains.ops.bit_true import fft_int_op
    from rsp_chains.golden.int_models import int_fft_golden

    n_max, n = 256, 128
    re, im = _int_iq(rng, n_max)
    cfg = FftConfig(max_size=n_max)
    out = fft_int_op(C(jnp.asarray(re), jnp.asarray(im)),
                     jnp.asarray(int(np.log2(n)), jnp.int32), cfg)
    gr, gi = int_fft_golden(re[:n], im[:n])
    np.testing.assert_array_equal(np.asarray(out.re)[:n], gr)
    np.testing.assert_array_equal(np.asarray(out.im)[:n], gi)
    assert np.all(np.asarray(out.re)[n:] == 0)


def test_int_fft_close_to_float(rng):
    """Truncation-noise sanity vs the float FFT/N: the reference's testers
    assert +/-2 LSB against *their* (unvendored) datapath ordering
    (RspChainTesterUtils.scala:221-237); this spec's 10-stage RoundHalfUp
    pipeline measures <=3 LSB worst-case at N=1024, 99% within 2."""
    from rsp_chains.golden.int_models import int_fft_golden

    n = 1024
    re, im = _int_iq(rng, n)
    gr, gi = int_fft_golden(re, im)
    want = np.fft.fft(re + 1j * im) / n
    er = np.abs(gr - np.round(want.real))
    ei = np.abs(gi - np.round(want.imag))
    assert max(er.max(), ei.max()) <= 3
    assert np.percentile(np.concatenate([er, ei]), 99) <= 2


def test_bit_true_packed_output_words_exact(rng):
    """VERDICT r1 item 7 'done' criterion: packed output words of the
    binPoint-0 wire chain are EXACTLY equal to the integer golden pipeline."""
    from rsp_chains import packing, rx_fft_mag_cfar_tx_chain
    from rsp_chains.configs import (
        CfarConfig, CfarVariant, ChainConfig, FftConfig, FixedPointConfig,
        RuntimeConfig,
    )
    from rsp_chains.golden.int_models import (
        int_ca_cfar_golden, int_fft_golden, int_jpl_golden,
    )

    n = 1024
    re, im = _int_iq(rng, n, amp=20000)
    cfg = ChainConfig(
        fft=FftConfig(max_size=n),
        cfar=CfarConfig(max_ref_window=64, max_guard_window=8,
                        variant=CfarVariant.CA, include_cash=False),
        fixed_point=FixedPointConfig(enabled=True, width=16, bin_point=0,
                                     bit_true=True),
    )
    chain = rx_fft_mag_cfar_tx_chain(cfg)
    assert chain.stage_names == ("rx_unpack", "fft_int", "logmag_int",
                                 "cfar_int", "tx_pack")
    rt = RuntimeConfig.make(fft_size=n, ref_window_size=32, guard_window_size=4,
                            threshold_scaler=3.5, div_sum=5)
    words_in = np.asarray(packing.pack_iq(
        jnp.asarray(re + 1j * im, jnp.complex64)))
    words_out = np.asarray(chain.jit()(jnp.asarray(words_in, jnp.uint32), rt))

    gr, gi = int_fft_golden(re, im)
    gmag = int_jpl_golden(gr, gi)
    gthr, gpk = int_ca_cfar_golden(gmag, ref_window=32, guard_window=4,
                                   div_sum=5, threshold_scaler=3.5)
    want = np.asarray(packing.pack_cfar_words(
        jnp.asarray(gthr, jnp.int32), jnp.asarray(gpk), int(np.log2(n))))
    np.testing.assert_array_equal(words_out, want)
    # the frame must actually detect something, or exactness proves nothing
    assert gpk.sum() > 0


def test_int_fft_keep_lsb_wraparound_exact(rng):
    """keepMSBorLSB = LSB stages (FFTParams, RspChainVanillaTester.scala:214):
    non-expanding stages keep the LSBs with WRAPAROUND overflow. Near-full-
    scale input forces real wraps; op == index-wise golden exactly."""
    from rsp_chains.cplx import C
    from rsp_chains.ops.bit_true import fft_int_op
    from rsp_chains.golden.int_models import int_fft_golden

    n = 256
    p = int(np.log2(n))
    # LSB-keep on the first three stages, MSB on the rest
    keep = tuple(s >= 3 for s in range(p))
    re = rng.randint(-32768, 32768, size=n).astype(np.int32)
    im = rng.randint(-32768, 32768, size=n).astype(np.int32)
    cfg = FftConfig(max_size=n, keep_msb_or_lsb=keep)
    out = fft_int_op(C(jnp.asarray(re), jnp.asarray(im)),
                     jnp.asarray(p, jnp.int32), cfg)
    gr, gi = int_fft_golden(re, im, keep_msb=keep)
    np.testing.assert_array_equal(np.asarray(out.re), gr)
    np.testing.assert_array_equal(np.asarray(out.im), gi)
    # the scenario actually wrapped somewhere (full-scale sums overflow), and
    # differs from the all-MSB pipeline
    gr_msb, _ = int_fft_golden(re, im)
    assert not np.array_equal(gr, gr_msb)


def test_float_fft_rejects_lsb_keep():
    from rsp_chains.ops.fft import fft_op

    n = 64
    keep = (False,) + (True,) * (int(np.log2(n)) - 1)
    cfg = FftConfig(max_size=n, keep_msb_or_lsb=keep, runtime_size=False)
    x = jnp.zeros(n, jnp.complex64)
    with pytest.raises(ValueError, match="no float analog"):
        fft_op(x, None, cfg)


def test_float_preset_with_lsb_keep_refuses_even_static_size():
    """With runtime_size=False only one branch exists — the preset must not
    route an LSB-keep elaboration into the float FFT silently."""
    from rsp_chains import fft_mag_cfar_chain
    from rsp_chains.cplx import as_pair
    from rsp_chains.golden import three_tone_signal

    n = 256
    keep = (False,) + (True,) * (int(np.log2(n)) - 1)
    cfg = ChainConfig(
        fft=FftConfig(max_size=n, keep_msb_or_lsb=keep, runtime_size=False),
        cfar=CfarConfig(max_ref_window=16, max_guard_window=4, max_fft_size=n,
                        variant=CfarVariant.CA, include_cash=False))
    chain = fft_mag_cfar_chain(cfg)
    rt = RuntimeConfig.make(fft_size=n, ref_window_size=8,
                            guard_window_size=2, threshold_scaler=3.5,
                            div_sum=3)
    x = as_pair(three_tone_signal(n, shift_range_factor=12))
    with pytest.raises(ValueError, match="no float analog"):
        chain.jit()(x, rt)


def test_int_fft_expanding_stages_exact_vs_int64_golden():
    """Expanding stages skip the pre-twiddle trim, so the device path's direct
    int32 product would overflow from the first grown stage on; the split-
    product path must stay bit-exact against the int64 numpy golden at
    FULL-SCALE input."""
    import jax.numpy as jnp

    from rsp_chains.cplx import C
    from rsp_chains.golden.int_models import int_fft_golden
    from rsp_chains.ops.bit_true import _fft_int_fixed

    n = 64
    rng = np.random.RandomState(7)
    xr = rng.randint(-32768, 32768, (3, n)).astype(np.int32)
    xi = rng.randint(-32768, 32768, (3, n)).astype(np.int32)
    xr[0, :] = 32767   # adversarial full-scale rows
    xi[0, :] = -32768
    for el in ((1, 1, 0, 0, 0, 0), (1, 0, 1, 0, 1, 0), (1,) * 6):
        got_r, got_i = _fft_int_fixed(jnp.asarray(xr), jnp.asarray(xi), n,
                                      expand_logic=el)
        want_r, want_i = int_fft_golden(xr, xi, expand_logic=el)
        np.testing.assert_array_equal(np.asarray(got_r), want_r, err_msg=str(el))
        np.testing.assert_array_equal(np.asarray(got_i), want_i, err_msg=str(el))


def test_int_fft_rejects_too_many_expanding_stages():
    import jax.numpy as jnp
    import pytest

    from rsp_chains.ops.bit_true import _fft_int_fixed

    n = 1024
    x = jnp.zeros((1, n), jnp.int32)
    with pytest.raises(ValueError, match="expanding stages"):
        _fft_int_fixed(x, x, n, expand_logic=(1,) * 10)


def test_int_cfar_large_window_elaboration():
    """Window shifts past the old fixed 8-bit/128-pad caps: guard+ref beyond
    255 must still take sums from the right cells (vs the int golden)."""
    import jax.numpy as jnp

    from rsp_chains.configs import CfarConfig, CfarVariant, RuntimeConfig
    from rsp_chains.golden.int_models import int_ca_cfar_golden
    from rsp_chains.ops.bit_true import ca_cfar_int

    n = 1024
    cfg = CfarConfig(max_ref_window=256, max_guard_window=16, max_fft_size=n,
                     variant=CfarVariant.CA, include_cash=False)
    rt = RuntimeConfig.make(fft_size=n, ref_window_size=256,
                            guard_window_size=16, threshold_scaler=2.0,
                            div_sum=8)
    rng = np.random.RandomState(3)
    mag = rng.randint(0, 4096, (2, n)).astype(np.int32)
    got = ca_cfar_int(jnp.asarray(mag), rt, cfg)
    for i in range(2):
        want_thr, want_pk = int_ca_cfar_golden(
            mag[i], ref_window=256, guard_window=16, div_sum=8,
            threshold_scaler=2.0, mode=0, log_or_linear=1, peak_grouping=0,
            n_active=n)
        np.testing.assert_array_equal(np.asarray(got.threshold)[i], want_thr)
        np.testing.assert_array_equal(np.asarray(got.peaks)[i], want_pk)


def test_int_mag_modes_match_golden_exactly(rng):
    """The full integer LogMagMux menu (abs/sqr/jpl/log2) == index-wise golden
    (RspChainTesterUtils.scala:197-216 menu; LUT log2 on the protoLog grid)."""
    from rsp_chains.cplx import C
    from rsp_chains.configs import LogMagConfig
    from rsp_chains.golden.int_models import (
        int_abs_golden, int_jpl_golden, int_log2_golden, int_sqr_golden,
    )
    from rsp_chains.ops.bit_true import mag_int_op

    re, im = _int_iq(rng, 512, amp=32768)
    # adversarial corners: zeros, +/- full scale, tiny values, perfect squares
    re[:8] = [0, 0, 32767, -32768, 1, -1, 3, 300]
    im[:8] = [0, 1, 32767, -32768, 0, -1, 4, 400]
    cfg = LogMagConfig()
    x = C(jnp.asarray(re), jnp.asarray(im))
    goldens = {
        0: int_abs_golden(re, im),
        1: int_sqr_golden(re, im),
        2: int_jpl_golden(re, im),
        3: int_log2_golden(re, im, cfg.data_width_log, cfg.bin_point_log,
                           cfg.log2_lookup_width),
    }
    for mode, want in goldens.items():
        got = np.asarray(mag_int_op(x, jnp.asarray(mode, jnp.int32), cfg))
        np.testing.assert_array_equal(got, want, err_msg=f"mag mode {mode}")


@pytest.mark.slow
def test_int_gosca_cfar_register_sweep_matches_golden(rng):
    """Integer GOSCA+CASH CFAR == index-wise golden across the runtime
    register grid the reference tester drives (algorithm CA/GOS, modes
    CA/GO/SO/CASH, rank and sub-window registers —
    RspChainVanillaTester.scala:119-141)."""
    from rsp_chains.configs import CfarConfig, CfarVariant, RuntimeConfig
    from rsp_chains.golden.int_models import int_gosca_cfar_golden
    from rsp_chains.ops.bit_true import cfar_int

    n = 256
    cfg = CfarConfig(max_ref_window=16, max_guard_window=4, max_fft_size=n,
                     variant=CfarVariant.GOSCA, include_cash=True)
    mag = rng.randint(0, 30000, (2, n)).astype(np.int32)
    sweeps = [
        dict(cfar_algorithm=1, cfar_mode=0, ref_window_size=16,
             guard_window_size=2, index_lagg=7, index_lead=3),
        dict(cfar_algorithm=1, cfar_mode=1, ref_window_size=8,
             guard_window_size=4, index_lagg=0, index_lead=7),
        dict(cfar_algorithm=1, cfar_mode=2, ref_window_size=16,
             guard_window_size=1, index_lagg=15, index_lead=15,
             peak_grouping=1),
        dict(cfar_algorithm=0, cfar_mode=3, ref_window_size=16,
             guard_window_size=2, sub_window_size=4),
        dict(cfar_algorithm=1, cfar_mode=3, ref_window_size=8,
             guard_window_size=2, sub_window_size=3),
        dict(cfar_algorithm=0, cfar_mode=1, ref_window_size=16,
             guard_window_size=4, div_sum=4),
        dict(cfar_algorithm=1, cfar_mode=0, ref_window_size=16,
             guard_window_size=2, index_lagg=8, index_lead=8,
             log_or_linear=0, threshold_scaler=500.0),
    ]
    for kw in sweeps:
        kw.setdefault("threshold_scaler", 2.5)
        rt = RuntimeConfig.make(fft_size=n, **kw)
        got = cfar_int(jnp.asarray(mag), rt, cfg)
        p = rt.peek()
        for i in range(2):
            want_thr, want_pk = int_gosca_cfar_golden(
                mag[i], ref_window=p["ref_window_size"],
                guard_window=p["guard_window_size"], div_sum=p["div_sum"],
                threshold_scaler=p["threshold_scaler"], wmax=16,
                algorithm=p["cfar_algorithm"], mode=p["cfar_mode"],
                rank_lagg=p["index_lagg"], rank_lead=p["index_lead"],
                sub_window=p["sub_window_size"],
                peak_grouping=p["peak_grouping"],
                log_or_linear=p["log_or_linear"], n_active=n)
            np.testing.assert_array_equal(np.asarray(got.threshold)[i],
                                          want_thr, err_msg=str(kw))
            np.testing.assert_array_equal(np.asarray(got.peaks)[i],
                                          want_pk, err_msg=str(kw))


@pytest.mark.slow
def test_int_gosca_runtime_fft_size_register(rng):
    """The runtime cfar fftSize register masks the active frame in the
    integer GOSCA path exactly like the golden's n_active."""
    from rsp_chains.configs import CfarConfig, CfarVariant, RuntimeConfig
    from rsp_chains.golden.int_models import int_gosca_cfar_golden
    from rsp_chains.ops.bit_true import cfar_int

    n, n_act = 256, 192
    cfg = CfarConfig(max_ref_window=16, max_guard_window=4, max_fft_size=n,
                     variant=CfarVariant.GOSCA, include_cash=True)
    mag = rng.randint(0, 30000, n).astype(np.int32)
    rt = RuntimeConfig.make(fft_size=n, cfar_fft_size=n_act,
                            cfar_algorithm=1, cfar_mode=0, ref_window_size=16,
                            guard_window_size=2, index_lagg=5, index_lead=9,
                            threshold_scaler=2.5)
    got = cfar_int(jnp.asarray(mag), rt, cfg)
    want_thr, want_pk = int_gosca_cfar_golden(
        mag, ref_window=16, guard_window=2, div_sum=4, threshold_scaler=2.5,
        wmax=16, algorithm=1, mode=0, rank_lagg=5, rank_lead=9,
        sub_window=4, n_active=n_act)
    np.testing.assert_array_equal(np.asarray(got.threshold), want_thr)
    np.testing.assert_array_equal(np.asarray(got.peaks), want_pk)
    assert np.all(np.asarray(got.threshold)[n_act:] == 0)


def test_bit_true_gosca_packed_wire_words_exact(rng):
    """VERDICT r2 item 3 'done' criterion: packed wire words of the integer
    GOSCA chain (the reference's SHIPPED RspChainVanilla configuration,
    RspChain.scala:118,130-140) are EXACTLY equal to the integer golden
    pipeline across GOS/GO/SO/CASH register writes."""
    from rsp_chains import packing, rx_fft_mag_cfar_tx_chain
    from rsp_chains.configs import (
        CfarConfig, CfarVariant, ChainConfig, FftConfig, FixedPointConfig,
        RuntimeConfig,
    )
    from rsp_chains.golden.int_models import (
        int_fft_golden, int_gosca_cfar_golden, int_jpl_golden,
    )

    n = 512
    re, im = _int_iq(rng, n, amp=20000)
    cfg = ChainConfig(
        fft=FftConfig(max_size=n),
        cfar=CfarConfig(max_ref_window=16, max_guard_window=4,
                        variant=CfarVariant.GOSCA, include_cash=True,
                        max_fft_size=n),
        fixed_point=FixedPointConfig(enabled=True, width=16, bin_point=0,
                                     bit_true=True),
    )
    chain = rx_fft_mag_cfar_tx_chain(cfg)
    assert chain.stage_names == ("rx_unpack", "fft_int", "logmag_int",
                                 "cfar_int", "tx_pack")
    jf = chain.jit()
    words_in = np.asarray(packing.pack_iq(
        jnp.asarray(re + 1j * im, jnp.complex64)))

    gr, gi = int_fft_golden(re, im)
    gmag = int_jpl_golden(gr, gi)

    sweeps = [
        dict(cfar_algorithm=1, cfar_mode=0, index_lagg=7, index_lead=3),
        dict(cfar_algorithm=1, cfar_mode=1, index_lagg=15, index_lead=0),
        dict(cfar_algorithm=0, cfar_mode=3, sub_window_size=4),
        dict(cfar_algorithm=1, cfar_mode=2, peak_grouping=1),
    ]
    detected_any = 0
    for kw in sweeps:
        rt = RuntimeConfig.make(fft_size=n, ref_window_size=16,
                                guard_window_size=2, threshold_scaler=2.0,
                                **kw)
        words_out = np.asarray(jf(jnp.asarray(words_in, jnp.uint32), rt))
        p = rt.peek()
        gthr, gpk = int_gosca_cfar_golden(
            gmag, ref_window=16, guard_window=2, div_sum=p["div_sum"],
            threshold_scaler=2.0, wmax=16, algorithm=p["cfar_algorithm"],
            mode=p["cfar_mode"], rank_lagg=p["index_lagg"],
            rank_lead=p["index_lead"], sub_window=p["sub_window_size"],
            peak_grouping=p["peak_grouping"], n_active=n)
        want = np.asarray(packing.pack_cfar_words(
            jnp.asarray(gthr, jnp.int32), jnp.asarray(gpk), int(np.log2(n))))
        np.testing.assert_array_equal(words_out, want, err_msg=str(kw))
        detected_any += int(gpk.sum())
    assert detected_any > 0
    # one compiled executable across the whole register sweep
    assert jf._cache_size() == 1
