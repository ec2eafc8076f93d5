"""Sharded execution tests on the 8-device virtual CPU mesh: every sharded path
must equal its unsharded op (SURVEY §4: the multi-chip coverage the reference
lacks)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rsp_chains import (
    CfarAlgorithm, CfarConfig, CfarMode, CfarVariant, ChainConfig, DopplerConfig,
    FftConfig, MatchedFilterConfig, RuntimeConfig, fft_mag_cfar_chain,
)
from rsp_chains.golden import three_tone_signal, lfm_chirp
from rsp_chains.ops.cfar import cfar_op
from rsp_chains.ops.logmag import logmag
from rsp_chains.parallel import (
    make_mesh, make_sharded_pipeline, range_sharded_fir, range_sharded_mag_cfar,
    channel_sharded,
)
from rsp_chains.parallel.sharded import make_sharded_rd_pipeline


def _cfg(variant=CfarVariant.GOSCA, cash=True):
    return ChainConfig(
        fft=FftConfig(max_size=1024),
        cfar=CfarConfig(max_ref_window=64, max_guard_window=8, variant=variant,
                        include_cash=cash),
    )


def _rt(**kw):
    base = dict(fft_size=1024, ref_window_size=32, guard_window_size=4,
                threshold_scaler=3.5, div_sum=5)
    base.update(kw)
    return RuntimeConfig.make(**base)


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh(channels=2, range_shards=4)


@pytest.mark.parametrize("rtkw", [
    dict(),
    dict(cfar_mode=CfarMode.GREATEST_OF),
    dict(cfar_algorithm=CfarAlgorithm.GOS, index_lagg=16, index_lead=16),
    dict(cfar_mode=CfarMode.CASH, sub_window_size=8),
    dict(fft_size=512),  # runtime frame shrink across shard boundaries
])
@pytest.mark.slow
def test_range_sharded_mag_cfar_equals_unsharded(mesh8, rtkw):
    cfg = _cfg()
    rt = _rt(**rtkw)
    rng = np.random.RandomState(3)
    spec = (rng.randn(2, 1024) + 1j * rng.randn(2, 1024)).astype(np.complex64)

    sharded = range_sharded_mag_cfar(cfg, mesh8)
    out_s = sharded(jnp.asarray(spec), rt)

    mag = logmag(jnp.asarray(spec), rt.mag_mode, cfg.mag)
    out_u = cfar_op(mag, rt, cfg.cfar)

    np.testing.assert_allclose(np.asarray(out_s.threshold),
                               np.asarray(out_u.threshold), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(out_s.peaks), np.asarray(out_u.peaks))


def test_full_sharded_pipeline_equals_chain(mesh8):
    cfg = _cfg()
    rt = _rt()
    iq = np.stack([three_tone_signal(1024, shift_range_factor=12, seed=s)
                   for s in (1, 2)]).astype(np.complex64)
    pipe = make_sharded_pipeline(cfg, mesh8)
    out_s = pipe(jnp.asarray(iq), rt)
    out_u = fft_mag_cfar_chain(cfg).jit()(jnp.asarray(iq), rt)
    np.testing.assert_allclose(np.asarray(out_s.threshold),
                               np.asarray(out_u.threshold), rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(np.asarray(out_s.peaks), np.asarray(out_u.peaks))


def test_range_sharded_fir_equals_convolution(mesh8):
    rng = np.random.RandomState(5)
    x = (rng.randn(2, 2048) + 1j * rng.randn(2, 2048)).astype(np.complex64)
    taps = (rng.randn(33) + 1j * rng.randn(33)).astype(np.complex64)
    f = range_sharded_fir(taps, mesh8)
    got = np.asarray(f(jnp.asarray(x)))
    for i in range(2):
        want = np.convolve(x[i], taps, mode="full")[:2048]
        np.testing.assert_allclose(got[i], want, rtol=1e-3, atol=0.1)


def test_channel_sharded_chain(mesh8):
    cfg = _cfg()
    rt = _rt()
    iq = np.stack([three_tone_signal(1024, shift_range_factor=12, seed=s)
                   for s in range(2)]).astype(np.complex64)
    chain = fft_mag_cfar_chain(cfg)
    f = channel_sharded(chain.__call__, mesh8, batch_ndim=1)
    out = f(jnp.asarray(iq), rt)
    out_u = chain.jit()(jnp.asarray(iq), rt)
    np.testing.assert_allclose(np.asarray(out.threshold),
                               np.asarray(out_u.threshold), rtol=1e-5, atol=1e-4)


def test_sharded_rd_pipeline_runs_and_matches(mesh8):
    n_range, p = 1024, 16
    chirp = lfm_chirp(64, 0.0, 0.25)
    cfg = ChainConfig(
        fft=FftConfig(max_size=n_range),
        matched_filter=MatchedFilterConfig(num_taps=64, fft_size=n_range),
        doppler=DopplerConfig(num_pulses=p),
        cfar=CfarConfig(max_ref_window=64, max_guard_window=8,
                        variant=CfarVariant.GOSCA, include_cash=True),
    )
    rt = _rt(threshold_scaler=8.0)
    rng = np.random.RandomState(7)
    x = (rng.randn(2, p, n_range) + 1j * rng.randn(2, p, n_range)).astype(np.complex64)

    pipe = make_sharded_rd_pipeline(cfg, mesh8, chirp)
    out_s = pipe(jnp.asarray(x), rt)

    from rsp_chains import range_doppler_chain
    out_u = range_doppler_chain(cfg, taps=chirp).jit()(jnp.asarray(x), rt)
    np.testing.assert_allclose(np.asarray(out_s.threshold),
                               np.asarray(out_u.threshold), rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(np.asarray(out_s.peaks), np.asarray(out_u.peaks))


@pytest.mark.slow
def test_graft_entry_dryrun():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert out.peaks.shape == args[0].shape

    ge.dryrun_multichip(8)


def test_pod_mesh_cpi_sharding():
    """Multi-host scaffold on the virtual 8-device platform: (cpi, ch, rng)
    mesh; CPI blocks process independently and match unsharded output."""
    from rsp_chains.parallel.multihost import make_pod_mesh, shard_cpi_stream

    mesh = make_pod_mesh(time_blocks=2, channels=2, range_shards=2)
    assert mesh.axis_names == ("cpi", "ch", "rng")

    cfg = _cfg()
    chain = fft_mag_cfar_chain(cfg)
    rt = _rt()
    iq = np.stack([
        np.stack([three_tone_signal(1024, shift_range_factor=12, seed=s + 10 * t)
                  for s in range(2)])
        for t in range(2)
    ]).astype(np.complex64)  # [T=2, C=2, N]
    run = shard_cpi_stream(chain.__call__, mesh)
    out = run(jnp.asarray(iq), rt)
    want = chain.jit()(jnp.asarray(iq), rt)
    np.testing.assert_allclose(np.asarray(out.threshold),
                               np.asarray(want.threshold), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(out.peaks), np.asarray(want.peaks))


def _cfg_small(variant=CfarVariant.CA, cash=False, max_ref=64):
    return ChainConfig(
        fft=FftConfig(max_size=1024),
        cfar=CfarConfig(max_ref_window=max_ref, max_guard_window=8,
                        variant=variant, include_cash=cash),
    )


@pytest.mark.parametrize("rtkw", [
    dict(),
    dict(cfar_mode=CfarMode.GREATEST_OF),
    dict(fft_size=512),  # runtime frame shrink across shard boundaries
])
def test_range_sharded_fused_ca_tail_equals_unsharded(mesh8, rtkw):
    """The range-sharded CA tail (ppermute halo + cfar_halo_shard) equals
    the unsharded op."""
    cfg = _cfg_small()
    rt = _rt(**rtkw)
    rng = np.random.RandomState(3)
    spec = (rng.randn(2, 1024) + 1j * rng.randn(2, 1024)).astype(np.complex64)
    from rsp_chains.cplx import as_pair

    out_s = range_sharded_mag_cfar(cfg, mesh8)(as_pair(spec), rt)
    mag = logmag(jnp.asarray(spec), rt.mag_mode, cfg.mag)
    out_u = cfar_op(mag, rt, cfg.cfar)
    np.testing.assert_allclose(np.asarray(out_s.threshold),
                               np.asarray(out_u.threshold), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(out_s.peaks), np.asarray(out_u.peaks))


@pytest.mark.slow
def test_range_sharded_fused_gos_tail_equals_unsharded(mesh8):
    """GOS elaboration: the range-sharded GOS tail equals the unsharded op."""
    cfg = _cfg_small(variant=CfarVariant.GOSCA, max_ref=8)
    rt = _rt(ref_window_size=8, guard_window_size=2, div_sum=3,
             cfar_algorithm=CfarAlgorithm.GOS, index_lagg=4, index_lead=4)
    rng = np.random.RandomState(4)
    spec = (rng.randn(1, 1024) + 1j * rng.randn(1, 1024)).astype(np.complex64)
    from rsp_chains.cplx import as_pair

    out_s = range_sharded_mag_cfar(cfg, mesh8)(as_pair(spec), rt)
    mag = logmag(jnp.asarray(spec), rt.mag_mode, cfg.mag)
    out_u = cfar_op(mag, rt, cfg.cfar)
    np.testing.assert_allclose(np.asarray(out_s.threshold),
                               np.asarray(out_u.threshold), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(out_s.peaks), np.asarray(out_u.peaks))


def test_channel_only_mesh_runs_whole_chain_kernel():
    """A pure channel mesh (rng=1) runs the whole chain per channel shard —
    equal to the unsharded chain."""
    mesh = make_mesh(channels=8, range_shards=1)
    cfg = ChainConfig(
        fft=FftConfig(max_size=256),
        cfar=CfarConfig(max_ref_window=16, max_guard_window=4,
                        max_fft_size=256, variant=CfarVariant.CA,
                        include_cash=False),
    )
    rt = RuntimeConfig.make(fft_size=256, ref_window_size=8,
                            guard_window_size=2, threshold_scaler=3.5,
                            div_sum=4)
    iq = np.stack([three_tone_signal(256, shift_range_factor=10, seed=s)
                   for s in range(8)]).astype(np.complex64)
    pipe = make_sharded_pipeline(cfg, mesh)
    out_s = pipe(jnp.asarray(iq), rt)
    chain = fft_mag_cfar_chain(cfg)
    out_u = chain.jit()(jnp.asarray(iq), rt)
    np.testing.assert_allclose(np.asarray(out_s.threshold),
                               np.asarray(out_u.threshold),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(out_s.peaks),
                                  np.asarray(out_u.peaks))


def test_halo_wider_than_shard_raises(mesh8):
    """A halo wider than the local shard silently truncated before (the
    neighbor's neighbor is needed); it must be a loud error."""
    import jax

    from rsp_chains.parallel.halo import extend_with_halo
    from rsp_chains.parallel.mesh import RANGE_AXIS
    from jax.sharding import PartitionSpec as P

    x = jnp.ones((2, 256))
    with pytest.raises(ValueError, match="halo"):
        jax.shard_map(
            lambda xl: extend_with_halo(xl, halo=128, axis_name=RANGE_AXIS),
            mesh=mesh8, in_specs=P(None, RANGE_AXIS),
            out_specs=P(None, RANGE_AXIS), check_vma=False,
        )(x)
