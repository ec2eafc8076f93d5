"""The ``ppermute`` halo exchange (``parallel/halo.py``) on an 8-shard range
ring of the virtual CPU mesh, against slices of the unsharded array."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from rsp_chains.configs import (
    CfarConfig, CfarVariant, ChainConfig, FftConfig, RuntimeConfig,
)
from rsp_chains.parallel.halo import exchange_halo, extend_with_halo
from rsp_chains.parallel.mesh import RANGE_AXIS

SHARDS, N, HALO = 8, 1024, 64


@pytest.fixture(scope="module")
def ring():
    return Mesh(np.array(jax.devices()[:SHARDS]), (RANGE_AXIS,))


def _padded(x, halo):
    """The unsharded reference: zeros beyond the global frame edges."""
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(halo, halo)])


def test_halo_exchange_equals_neighbor_slices(ring):
    x = np.random.RandomState(0).randn(2, N).astype(np.float32)
    spec = P(None, RANGE_AXIS)
    left, right = jax.jit(jax.shard_map(
        lambda xl: exchange_halo(xl, HALO, RANGE_AXIS), mesh=ring,
        in_specs=(spec,), out_specs=(spec, spec)))(jnp.asarray(x))
    left = np.asarray(left).reshape(2, SHARDS, HALO)
    right = np.asarray(right).reshape(2, SHARDS, HALO)
    xp = _padded(x, HALO)
    n_loc = N // SHARDS
    for r in range(SHARDS):
        lo = r * n_loc + HALO       # shard r's first cell in padded coordinates
        np.testing.assert_array_equal(left[:, r], xp[:, lo - HALO:lo])
        np.testing.assert_array_equal(right[:, r],
                                      xp[:, lo + n_loc:lo + n_loc + HALO])


def test_mag_then_extend_equals_global_window(ring):
    """The magnitude of a sharded spectrum extended by its neighbors' halos
    equals the window of the unsharded magnitude around each shard."""
    from rsp_chains.cplx import C
    from rsp_chains.ops.logmag import logmag

    rng = np.random.RandomState(1)
    re = rng.randn(2, N).astype(np.float32)
    im = rng.randn(2, N).astype(np.float32)
    mag_mode = jnp.asarray(2, jnp.int32)  # JPL
    spec = P(None, RANGE_AXIS)
    ext = jax.jit(jax.shard_map(
        lambda a, b: extend_with_halo(logmag(C(a, b), mag_mode), HALO,
                                      RANGE_AXIS),
        mesh=ring, in_specs=(spec, spec), out_specs=spec))(
            jnp.asarray(re), jnp.asarray(im))
    n_loc = N // SHARDS
    ext = np.asarray(ext).reshape(2, SHARDS, n_loc + 2 * HALO)
    mag = _padded(np.asarray(logmag(C(jnp.asarray(re), jnp.asarray(im)),
                                    mag_mode)), HALO)
    for r in range(SHARDS):
        np.testing.assert_allclose(
            ext[:, r], mag[:, r * n_loc:r * n_loc + n_loc + 2 * HALO],
            rtol=1e-6, atol=1e-6)


def test_sharded_tail_ppermute_halo_equals_unsharded(ring):
    """The full range-sharded tail (halo exchange + CFAR on the extended
    block) equals the unsharded op."""
    from rsp_chains.cplx import as_pair
    from rsp_chains.ops.cfar import cfar_op
    from rsp_chains.ops.logmag import logmag
    from rsp_chains.parallel.sharded import range_sharded_mag_cfar

    cfg = ChainConfig(
        fft=FftConfig(max_size=N),
        cfar=CfarConfig(max_ref_window=64, max_guard_window=8,
                        variant=CfarVariant.CA, include_cash=False),
    )
    rt = RuntimeConfig.make(fft_size=N, ref_window_size=32,
                            guard_window_size=4, threshold_scaler=3.5,
                            div_sum=5)
    rng = np.random.RandomState(2)
    spec = (rng.randn(2, N) + 1j * rng.randn(2, N)).astype(np.complex64)
    out_s = range_sharded_mag_cfar(cfg, ring)(as_pair(spec), rt)
    mag = logmag(jnp.asarray(spec), rt.mag_mode, cfg.mag)
    out_u = cfar_op(mag, rt, cfg.cfar)
    np.testing.assert_allclose(np.asarray(out_s.threshold),
                               np.asarray(out_u.threshold), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(out_s.peaks), np.asarray(out_u.peaks))
