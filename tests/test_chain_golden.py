"""The FFT -> magnitude -> CFAR presets against the numpy float64 goldens
(``golden.models``), across the runtime register surface: CFAR modes x
windows, magnitude modes, runtime frame shrink, grouping, GOS ranks, CASH
sub-windows, runtime FFT sizes and the wire format."""

import dataclasses
import functools

import numpy as np
import jax.numpy as jnp
import pytest

from rsp_chains import packing
from rsp_chains.chain import Chain
from rsp_chains.configs import (
    CfarAlgorithm, CfarConfig, CfarMode, CfarVariant, ChainConfig, FftConfig,
    MagMode, RuntimeConfig,
)
from rsp_chains.cplx import as_pair
from rsp_chains.golden import cfar_golden, fft_golden
from rsp_chains.golden.models import MAG_GOLDENS
from rsp_chains.presets import (
    fft_mag_cfar_chain, rx_fft_mag_cfar_tx_chain, tail_stages,
)

CA = CfarConfig(max_ref_window=64, max_guard_window=8, variant=CfarVariant.CA,
                include_cash=False)
GOSCA = CfarConfig(max_ref_window=16, max_guard_window=4,
                   variant=CfarVariant.GOSCA, include_cash=False)
GOSCA_CASH = CfarConfig(max_ref_window=16, max_guard_window=4,
                        variant=CfarVariant.GOSCA, include_cash=True)


@functools.lru_cache(maxsize=None)
def _tail(cfar: CfarConfig, n: int = 256):
    """The preset mag+CFAR tail (spectrum in), jitted once per elaboration."""
    cfg = ChainConfig(fft=FftConfig(max_size=n), cfar=cfar)
    return Chain(cfg, tail_stages(cfg)).jit()


@functools.lru_cache(maxsize=None)
def _chain(cfg: ChainConfig):
    return fft_mag_cfar_chain(cfg).jit()


def _spec(rng, shape=(4, 256)):
    x = (rng.randn(*shape) * 50 + 1j * rng.randn(*shape) * 50).astype(np.complex64)
    x[..., 40] = 4000 + 100j
    x[..., 200] = 2500 - 500j
    return x


def _frames(rng, frames, n):
    return (rng.randn(frames, n) + 1j * rng.randn(frames, n)).astype(np.complex64)


def _golden_cfar(mag, rt: RuntimeConfig):
    """cfar_golden over the active cells [0, cfar_fft_size); zeros beyond."""
    r = rt.peek()
    n = mag.shape[-1]
    act = min(r["cfar_fft_size"], n)
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


def _golden_chain(x, rt: RuntimeConfig, n_max: int):
    """fft_golden over the runtime FFT size (bins beyond it zero) -> magnitude
    golden -> CFAR golden."""
    r = rt.peek()
    n = r["fft_size"]
    spec = np.zeros(x.shape[:-1] + (n_max,), np.complex128)
    spec[..., :n] = fft_golden(np.asarray(x, np.complex128)[..., :n])
    return _golden_cfar(MAG_GOLDENS[r["mag_mode"]](spec), rt), spec


def _assert_matches(out, thr_g, pk_g, mag_g=None, rtol=1e-4):
    """Thresholds within ``rtol`` of the golden's threshold scale; peaks
    equal except on razor-edge cells whose margin is inside that tolerance
    (float32 on device vs float64 golden)."""
    thr = np.asarray(out.threshold, np.float64)
    scale = max(np.abs(thr_g).max(), 1e-30)
    assert np.abs(thr - thr_g).max() <= rtol * scale, \
        np.abs(thr - thr_g).max() / scale
    pk = np.asarray(out.peaks)
    diff = pk != pk_g
    if diff.any():
        assert mag_g is not None, f"{int(diff.sum())} peak flips"
        margin = np.abs(np.asarray(mag_g) - thr_g)[diff]
        assert (margin <= rtol * scale).all(), f"{int(diff.sum())} peak flips"


def _tail_case(spec, rt, cfar=CA, rtol=1e-4):
    out = _tail(cfar)(as_pair(spec), rt)
    mag = MAG_GOLDENS[rt.peek()["mag_mode"]](spec.astype(np.complex128))
    thr_g, pk_g = _golden_cfar(mag, rt)
    _assert_matches(out, thr_g, pk_g, mag, rtol)
    return out, thr_g, pk_g


def _chain_case(cfg, x, rt):
    out = _chain(cfg)(as_pair(x), rt)
    (thr_g, pk_g), spec = _golden_chain(x, rt, cfg.fft.max_size)
    mag = MAG_GOLDENS[rt.peek()["mag_mode"]](spec)
    _assert_matches(out, thr_g, pk_g, mag)
    return out, thr_g, pk_g


# ---------------------------------------------------------------------------
# CA-family mag+CFAR tail
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", [CfarMode.CELL_AVERAGING, CfarMode.GREATEST_OF,
                                  CfarMode.SMALLEST_OF])
@pytest.mark.parametrize("w,g", [(32, 4), (16, 2), (64, 8), (2, 1)])
def test_ca_tail_matches_golden(mode, w, g, rng):
    rt = RuntimeConfig.make(fft_size=256, cfar_mode=mode, ref_window_size=w,
                            guard_window_size=g, threshold_scaler=3.5)
    _tail_case(_spec(rng), rt)


@pytest.mark.parametrize("mag_mode", [MagMode.ABS, MagMode.SQR, MagMode.JPL,
                                      MagMode.LOG2])
def test_mag_modes_match_golden(mag_mode, rng):
    rt = RuntimeConfig.make(fft_size=256, mag_mode=mag_mode, ref_window_size=16,
                            guard_window_size=2,
                            log_or_linear=0 if mag_mode == MagMode.LOG2 else 1,
                            threshold_scaler=2.0 if mag_mode == MagMode.LOG2 else 3.5)
    _tail_case(_spec(rng), rt)


def test_runtime_frame_shrink(rng):
    spec = _spec(rng)
    spec[..., 128:] = 1e6  # poison the inactive region
    rt = RuntimeConfig.make(fft_size=128, ref_window_size=16, guard_window_size=2)
    out, _, _ = _tail_case(spec, rt)
    assert np.all(np.asarray(out.threshold)[..., 128:] == 0)
    assert not np.any(np.asarray(out.peaks)[..., 128:])


def test_peak_grouping(rng):
    rt = RuntimeConfig.make(fft_size=256, ref_window_size=16, guard_window_size=2,
                            peak_grouping=1)
    _tail_case(_spec(rng), rt)


@pytest.mark.parametrize("mode", [CfarMode.CELL_AVERAGING, CfarMode.GREATEST_OF])
@pytest.mark.parametrize("w,g,pg", [(16, 2, 0), (4, 3, 1), (64, 8, 1)])
def test_ca_register_grid_matches_golden(mode, w, g, pg, rng):
    rt = RuntimeConfig.make(fft_size=256, cfar_mode=mode, ref_window_size=w,
                            guard_window_size=g, peak_grouping=pg,
                            threshold_scaler=3.5)
    _tail_case(_spec(rng), rt)


def test_gosca_algorithm_register_selects_ca_or_gos(rng):
    """A GOSCA elaboration with the runtime algorithm register set to CA
    gives the CA golden, set to GOS the order-statistic golden
    (RspChainVanillaTester.scala:124-132) — and flipping the register does
    NOT recompile."""
    cfar = dataclasses.replace(GOSCA_CASH, max_fft_size=256)
    spec = _spec(rng)
    kw = dict(fft_size=256, ref_window_size=8, guard_window_size=2,
              threshold_scaler=3.0, index_lagg=4, index_lead=4)
    got_ca, _, _ = _tail_case(spec, RuntimeConfig.make(cfar_algorithm=0, **kw),
                              cfar)
    got_gos, _, _ = _tail_case(spec, RuntimeConfig.make(cfar_algorithm=1, **kw),
                               cfar)
    assert _tail(cfar)._cache_size() == 1   # register flip, no recompile
    assert not np.array_equal(np.asarray(got_ca.threshold),
                              np.asarray(got_gos.threshold))


def test_frame_batch_not_multiple_of_eight(rng):
    rt = RuntimeConfig.make(fft_size=256, ref_window_size=16, guard_window_size=2)
    _tail_case(_spec(rng, shape=(3, 256)), rt)


def test_chain_three_tone_matches_golden():
    from rsp_chains.golden import three_tone_signal

    cfg = ChainConfig(fft=FftConfig(max_size=1024), cfar=CA)
    assert fft_mag_cfar_chain(cfg).stage_names == ("fft", "logmag", "cfar")
    iq = three_tone_signal(1024, shift_range_factor=12).astype(np.complex64)
    rt = RuntimeConfig.make(fft_size=1024, ref_window_size=32, guard_window_size=4,
                            threshold_scaler=3.5, div_sum=5)
    out, _, pk_g = _chain_case(cfg, iq, rt)
    assert {128, 256, 512} <= set(np.flatnonzero(pk_g).tolist())


# ---------------------------------------------------------------------------
# GOS / GOSCA / CASH
# ---------------------------------------------------------------------------


def test_gos_chain_with_window_detects_tones():
    """A windowed-FFT GOSCA elaboration composes the three XLA stages and
    still detects the three tones."""
    from rsp_chains.golden import three_tone_signal

    cfg = ChainConfig(fft=FftConfig(max_size=1024, window="hann"), cfar=GOSCA)
    chain = fft_mag_cfar_chain(cfg)
    assert chain.stage_names == ("fft", "logmag", "cfar")
    iq = jnp.asarray(three_tone_signal(1024, shift_range_factor=12), jnp.complex64)
    rt = RuntimeConfig.make(fft_size=1024, cfar_algorithm=CfarAlgorithm.GOS,
                            ref_window_size=16, guard_window_size=4,
                            index_lagg=8, index_lead=8, threshold_scaler=3.5)
    peaks = np.flatnonzero(np.asarray(chain.jit()(iq, rt).peaks))
    assert {128, 256, 512} <= set(peaks.tolist())


@pytest.mark.parametrize("algorithm", [0, 1])
def test_cash_sub_window_exceeds_ref_window(algorithm, rng):
    """Runtime sub_window_size > ref_window_size: no sub-window fits, so the
    CASH statistic is 0 and the threshold is pure scaler — the golden
    semantics. RuntimeConfig.make validates this combination away, but the
    server's JSON config frames and CLI --set can write raw registers
    (dataclasses.replace below), so the chain must clamp defensively
    (the r2 guard-window lesson, ADVICE round 1)."""
    spec = _spec(rng, shape=(2, 256))
    rt = RuntimeConfig.make(fft_size=256, cfar_mode=CfarMode.CASH,
                            cfar_algorithm=algorithm, ref_window_size=8,
                            guard_window_size=2, sub_window_size=4,
                            threshold_scaler=3.0)
    rt = dataclasses.replace(rt, sub_window_size=jnp.asarray(16, jnp.int32))
    out = _tail(GOSCA_CASH)(as_pair(spec), rt)
    mag = MAG_GOLDENS[2](spec.astype(np.complex128))
    thr_g, pk_g = _golden_cfar(mag, rt)
    _assert_matches(out, thr_g, pk_g, mag)


@pytest.mark.parametrize("alg,mode,ll,pg", [
    (1, 0, 1, 0), (1, 1, 0, 1), (1, 2, 1, 1), (0, 0, 1, 0), (1, 3, 1, 0),
])
def test_gosca_register_grid_matches_golden(alg, mode, ll, pg, rng):
    """The algorithm/mode/log/grouping register surface of a GOSCA+CASH
    elaboration, full and shrunken CFAR frame."""
    cfar = dataclasses.replace(GOSCA_CASH, max_fft_size=256)
    spec = _spec(rng)
    for fft_size in (256, 128):
        rt = RuntimeConfig.make(fft_size=256, cfar_fft_size=fft_size,
                                cfar_mode=mode, ref_window_size=8,
                                guard_window_size=2, threshold_scaler=3.0,
                                log_or_linear=ll, peak_grouping=pg,
                                cfar_algorithm=alg, index_lagg=4, index_lead=4,
                                sub_window_size=2)
        _tail_case(spec, rt, cfar)


@pytest.mark.parametrize("wsz,lead_off", [(16, 0), (8, 0), (8, -1), (4, 1)])
def test_gos_window_and_rank_grid(wsz, lead_off, rng):
    """GOS statistics across window sizes with equal and unequal lag/lead
    ranks."""
    cfar = dataclasses.replace(GOSCA_CASH, max_fft_size=256)
    rt = RuntimeConfig.make(fft_size=256, cfar_mode=0, ref_window_size=wsz,
                            guard_window_size=2, threshold_scaler=3.0,
                            log_or_linear=1, peak_grouping=1, cfar_algorithm=1,
                            index_lagg=wsz // 2, index_lead=wsz // 2 + lead_off,
                            sub_window_size=2)
    _tail_case(_spec(rng), rt, cfar)


def test_gos_rank_beyond_valid_cells_clamps(rng):
    """Near the frame edges fewer than ``rank + 1`` window cells are valid:
    the rank clamps to the last valid cell like the golden
    (``sorted[min(k, len - 1)]``)."""
    cfar = dataclasses.replace(GOSCA, max_fft_size=256)
    rt = RuntimeConfig.make(fft_size=256, cfar_algorithm=1, cfar_mode=1,
                            ref_window_size=16, guard_window_size=4,
                            index_lagg=15, index_lead=15, threshold_scaler=2.0)
    out, thr_g, _ = _tail_case(_spec(rng), rt, cfar)
    assert np.all(np.asarray(out.threshold)[..., :3] > 0)   # edge cells set


@pytest.mark.parametrize("mode", [CfarMode.CELL_AVERAGING,
                                  CfarMode.GREATEST_OF])
@pytest.mark.parametrize("rank", [0, 7])
def test_gos_chain_matches_golden(mode, rank, rng):
    """FFT -> mag -> GOS CFAR through the preset."""
    cfg = ChainConfig(fft=FftConfig(max_size=256), cfar=GOSCA)
    rt = RuntimeConfig.make(fft_size=256, cfar_mode=mode,
                            cfar_algorithm=CfarAlgorithm.GOS,
                            ref_window_size=8, guard_window_size=2,
                            index_lagg=rank, index_lead=rank,
                            threshold_scaler=3.0)
    _chain_case(cfg, _frames(rng, 3, 256), rt)


def test_gos_chain_cash_mode(rng):
    cfg = ChainConfig(fft=FftConfig(max_size=256), cfar=GOSCA_CASH)
    rt = RuntimeConfig.make(fft_size=256, cfar_mode=CfarMode.CASH,
                            cfar_algorithm=CfarAlgorithm.GOS,
                            ref_window_size=8, guard_window_size=2,
                            sub_window_size=4, threshold_scaler=3.0)
    _chain_case(cfg, _frames(rng, 2, 256), rt)


# ---------------------------------------------------------------------------
# whole chain: sizes, registers, precision, stage lists
# ---------------------------------------------------------------------------

CA32 = CfarConfig(max_ref_window=32, variant=CfarVariant.CA, include_cash=False)


@pytest.mark.parametrize("n", [256, 512])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_chain_matches_golden(n, mode, rng):
    cfg = ChainConfig(fft=FftConfig(max_size=n), cfar=CA32)
    rt = RuntimeConfig.make(fft_size=n, cfar_mode=mode, ref_window_size=16,
                            guard_window_size=2, threshold_scaler=3.0,
                            div_sum=4)
    _chain_case(cfg, _frames(rng, 3, n), rt)


@pytest.mark.parametrize("n", [256, 512])
def test_chain_div_sum_register(n, rng):
    """The CA divider register independent of the window (div_sum 3 with
    16-cell windows: the hardware's shift, not a mean)."""
    cfg = ChainConfig(fft=FftConfig(max_size=n), cfar=CA32)
    rt = RuntimeConfig.make(fft_size=n, ref_window_size=16, guard_window_size=2,
                            threshold_scaler=3.0, div_sum=3)
    _chain_case(cfg, _frames(rng, 3, n), rt)


def test_chain_fft_precision_highest(rng):
    """The four-step FFT's matmuls run at HIGHEST precision: the spectrum
    matches the float64 FFT to float32 accuracy (a TF32 or bf16 pass would
    miss by orders of magnitude)."""
    from rsp_chains.ops.fft import fft_op

    x = _frames(rng, 3, 256) * 100
    got = np.asarray(fft_op(jnp.asarray(x), None,
                            FftConfig(max_size=256, runtime_size=False)))
    want = fft_golden(x.astype(np.complex128))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_chain_runtime_size_branches(rng):
    """The runtime FFT-size register: full and half size through ONE jitted
    chain, each equal to the golden at its size."""
    cfg = ChainConfig(fft=FftConfig(max_size=256),
                      cfar=CfarConfig(max_ref_window=16, max_guard_window=4,
                                      variant=CfarVariant.CA,
                                      include_cash=False))
    x = _frames(rng, 2, 256)
    for size, w, g in ((256, 8, 2), (128, 4, 1)):
        rt = RuntimeConfig.make(fft_size=size, ref_window_size=w,
                                guard_window_size=g, threshold_scaler=3.0,
                                div_sum=int(np.log2(w)))
        _chain_case(cfg, x, rt)
    assert _chain(cfg)._cache_size() == 1


def test_bit_reversed_elaboration_keeps_xla_fft_stage(rng):
    """use_bit_reverse=False emits RAW SDF (bit-reversed) cell order; the
    chain output must be the bit-reversed ordering for both the float and
    wire tops."""
    from rsp_chains.ops.cfar import cfar_op
    from rsp_chains.ops.fft import fft_op
    from rsp_chains.ops.logmag import logmag

    n = 256
    cfar = CfarConfig(max_ref_window=16, max_guard_window=4,
                      variant=CfarVariant.CA, include_cash=False)
    cfg_rev = ChainConfig(fft=FftConfig(max_size=n, use_bit_reverse=False),
                          cfar=cfar)
    ch = fft_mag_cfar_chain(cfg_rev)
    assert "fft" in ch.stage_names, ch.stage_names
    assert "fft" in rx_fft_mag_cfar_tx_chain(cfg_rev).stage_names

    cfg_nat = dataclasses.replace(
        cfg_rev, fft=dataclasses.replace(cfg_rev.fft, use_bit_reverse=True))
    x = _frames(rng, 2, n)
    rt = RuntimeConfig.make(fft_size=n, ref_window_size=8, guard_window_size=2,
                            threshold_scaler=3.0, div_sum=3)
    got = ch.jit()(as_pair(x), rt)
    want = fft_mag_cfar_chain(cfg_nat).jit()(as_pair(x), rt)
    # CFAR ran over the reversed-order cells: compare against the stage
    # composition elaborated with the same bit-reversed FFT
    spec = fft_op(as_pair(x), rt.log2_fft_size, cfg_rev.fft)
    want_rev = cfar_op(logmag(spec, rt.mag_mode), rt, cfg_nat.cfar)
    np.testing.assert_allclose(np.asarray(got.threshold),
                               np.asarray(want_rev.threshold),
                               rtol=1e-4, atol=1e-5)
    # sanity: the orders genuinely differ
    assert not np.allclose(np.asarray(got.threshold),
                           np.asarray(want.threshold))


def test_chain_builder_stage_lists():
    """Every elaboration builds one stage list: FFT, magnitude, CFAR (the
    integer stages when bit-true), framed by unpack/pack on the wire top."""
    from rsp_chains.configs import FixedPointConfig

    base = ChainConfig(fft=FftConfig(max_size=256), cfar=GOSCA)
    assert fft_mag_cfar_chain(base).stage_names == ("fft", "logmag", "cfar")
    windowed = dataclasses.replace(
        base, fft=FftConfig(max_size=256, window="hann"))
    assert fft_mag_cfar_chain(windowed).stage_names == ("fft", "logmag", "cfar")
    bit_true = dataclasses.replace(base, fixed_point=FixedPointConfig(
        enabled=True, bit_true=True))
    assert fft_mag_cfar_chain(bit_true).stage_names == (
        "fft_int", "logmag_int", "cfar_int")
    assert rx_fft_mag_cfar_tx_chain(base).stage_names == (
        "rx_unpack", "fft", "logmag", "cfar", "tx_pack")


# ---------------------------------------------------------------------------
# the wire format
# ---------------------------------------------------------------------------


def _wire_case(rng, rt_list, pg=0):
    n = 256
    cfg = ChainConfig(fft=FftConfig(max_size=n),
                      cfar=CfarConfig(max_ref_window=16, max_guard_window=4,
                                      variant=CfarVariant.CA,
                                      include_cash=False))
    jf = rx_fft_mag_cfar_tx_chain(cfg).jit()
    iq = (rng.randint(-20000, 20000, (2, n))
          + 1j * rng.randint(-20000, 20000, (2, n))).astype(np.complex64)
    words = jnp.asarray(packing.pack_iq(jnp.asarray(iq)), jnp.uint32)
    for rt in rt_list:
        got = np.asarray(jf(words, rt))
        (thr_g, pk_g), spec = _golden_chain(iq, rt, n)
        thr_f, bins, pk_f = packing.unpack_cfar_words(got, int(np.log2(n)))
        np.testing.assert_array_equal(bins, np.broadcast_to(np.arange(n),
                                                            bins.shape))
        np.testing.assert_array_equal(pk_f.astype(bool), pk_g)
        ref_i = np.floor(np.clip(thr_g, 0, None))
        assert np.abs(thr_f.astype(np.float64) - ref_i).max() <= 1
    assert jf._cache_size() == 1


def test_wire_chain_words_match_golden(rng):
    _wire_case(rng, [RuntimeConfig.make(fft_size=256, ref_window_size=8,
                                        guard_window_size=2,
                                        threshold_scaler=3.0, div_sum=3)])


@pytest.mark.parametrize("pg", [0, 1])
def test_wire_chain_grouping_and_cfar_frame(pg, rng):
    _wire_case(rng, [RuntimeConfig.make(fft_size=256, cfar_fft_size=size,
                                        ref_window_size=8, guard_window_size=2,
                                        threshold_scaler=3.0, div_sum=3,
                                        peak_grouping=pg)
                     for size in (256, 128)])


def test_wire_chain_matches_golden_runtime_sizes(rng):
    """Packed words in -> packed words out equals the golden chain, including
    the runtime-size register's small branch, with one compile."""
    _wire_case(rng, [RuntimeConfig.make(fft_size=size, ref_window_size=w,
                                        guard_window_size=g,
                                        threshold_scaler=3.0,
                                        div_sum=int(np.log2(w)))
                     for size, w, g in ((256, 8, 2), (128, 4, 1))])


def test_pulse_compression_collapse_matches_golden(rng):
    """The collapsed pulse-compression chain (FFT times the reference
    spectrum) equals matched filter -> FFT -> mag -> CFAR in numpy."""
    from rsp_chains.configs import MatchedFilterConfig
    from rsp_chains.golden import jpl_mag, lfm_chirp, matched_filter_golden
    from rsp_chains.presets import pulse_compression_chain

    n = 256
    taps = lfm_chirp(32, 0.0, 0.25)
    cfg = ChainConfig(fft=FftConfig(max_size=n),
                      matched_filter=MatchedFilterConfig(num_taps=32,
                                                         fft_size=n),
                      cfar=CfarConfig(max_ref_window=16, max_guard_window=4,
                                      variant=CfarVariant.CA,
                                      include_cash=False))
    chain = pulse_compression_chain(cfg, taps=taps)
    assert chain.stage_names[0] == "spectral_mf"
    rt = RuntimeConfig.make(fft_size=n, ref_window_size=8, guard_window_size=2,
                            threshold_scaler=3.0, div_sum=3)
    x = _frames(rng, 2, n)
    out = chain.jit()(as_pair(x), rt)
    y = matched_filter_golden(x.astype(np.complex128), taps, "circular")
    mag = jpl_mag(fft_golden(y / np.sqrt(np.sum(np.abs(taps) ** 2))))
    thr_g, pk_g = _golden_cfar(mag, rt)
    _assert_matches(out, thr_g, pk_g, mag)
