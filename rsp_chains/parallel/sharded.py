"""Sharded chain execution (SURVEY §2.15; BASELINE configs 3-5).

Three levels, in order of communication cost:

1. **Channel sharding** (``channel_sharded``): N hardware chain instances become a
   leading ``ch`` mesh axis; zero collectives. The preferred scaling axis.
2. **Range sharding of the window stages** (``range_sharded_mag_cfar``,
   ``range_sharded_fir``): the post-FFT magnitude spectrum (or time-domain stream)
   is sharded over ``rng``; CFAR guard+reference windows / FIR history cross shard
   edges via one neighbor ``ppermute`` halo exchange per direction.
3. **Full pipeline** (``make_sharded_pipeline``): one jitted program — per-channel
   FFT (no comms), a resharding constraint that makes XLA scatter the range axis,
   then the halo-exchanged CFAR tail under ``shard_map``. This is the
   multi-device shape of the reference's whole streaming fabric.

Exactness: every sharded path is tested for bit-equality (up to float
accumulation) with its unsharded op on the 8-device CPU mesh (tests/test_sharded.py).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from ..configs import CfarConfig, ChainConfig, RuntimeConfig
from ..ops.cfar import CfarOutput, cfar_op
from ..ops.fft import fft_op
from ..ops.logmag import logmag
from .halo import exchange_halo, extend_with_halo
from .mesh import CHANNEL_AXIS, RANGE_AXIS


def channel_sharded(fn: Callable, mesh: jax.sharding.Mesh, batch_ndim: int = 1):
    """Shard a chain over its leading channel axis — the analog of elaborating N
    independent chain instances. ``fn(x, rt)`` with x: [C, ..., N]."""
    spec = P(CHANNEL_AXIS, *([None] * batch_ndim))
    in_sharding = NamedSharding(mesh, spec)
    jf = jax.jit(fn, in_shardings=(in_sharding, None))
    return jf


def cfar_halo_shard(
    mag_local: jnp.ndarray,
    rt: RuntimeConfig,
    cfg: CfarConfig,
    axis_name: str = RANGE_AXIS,
) -> CfarOutput:
    """CFAR on a range-sharded magnitude array: runs inside ``shard_map``.

    Exchanges halo = max_guard + max_ref cells with ring neighbors (sized for the
    elaborated maximum so runtime window growth never re-shards — SURVEY §7 hard
    part (d)), then runs the standard ``cfar_op`` on the extended block with the
    valid global cell range mapped into local coordinates."""
    halo = cfg.max_ref_window + cfg.max_guard_window
    n_loc = mag_local.shape[-1]
    r = lax.axis_index(axis_name)
    start = r * n_loc
    ext = extend_with_halo(mag_local, halo, axis_name)
    n_ext = ext.shape[-1]
    active_lo = jnp.clip(halo - start, 0, n_ext).astype(jnp.int32)
    active_hi = jnp.clip(rt.cfar_fft_size - start + halo, 0, n_ext).astype(jnp.int32)
    out = cfar_op(ext, rt, cfg, active_lo=active_lo, active_hi=active_hi)
    sl = lambda a: None if a is None else a[..., halo : halo + n_loc]
    return CfarOutput(sl(out.threshold), sl(out.peaks), sl(out.noise), sl(out.cut))


def cfar_2d_halo_shard(
    mag_local: jnp.ndarray,
    rt2,
    cfg2d,
    axis_name: str = RANGE_AXIS,
) -> CfarOutput:
    """2-D (range x Doppler) CA-CFAR on a range-sharded RD map: runs inside
    ``shard_map``. The Doppler axis is shard-local (maps shard per channel /
    range, never per pulse), so only the range axis exchanges a halo of
    ``max_guard_range + max_ref_range`` cells — sized for the elaborated
    maxima like the 1-D tail, so runtime window growth never re-shards."""
    from ..ops.cfar_2d import cfar_2d_op

    halo = cfg2d.max_ref_range + cfg2d.max_guard_range
    n_loc = mag_local.shape[-1]
    r = lax.axis_index(axis_name)
    start = r * n_loc
    ext = extend_with_halo(mag_local, halo, axis_name)
    n_ext = ext.shape[-1]
    lo = jnp.clip(halo - start, 0, n_ext).astype(jnp.int32)
    hi = jnp.clip(rt2.active_range - start + halo, 0, n_ext).astype(jnp.int32)
    out = cfar_2d_op(ext, rt2, cfg2d, active_lo=lo, active_hi=hi)
    sl = lambda a: None if a is None else a[..., halo : halo + n_loc]
    return CfarOutput(sl(out.threshold), sl(out.peaks), None, None)


def _cfar_out_specs(cfg: CfarConfig, spec):
    """shard_map out_specs matching CfarOutput's elaborated emission set."""
    return CfarOutput(
        spec, spec,
        spec if cfg.emit_noise else None,
        spec if cfg.send_cut else None,
    )


def _spectrum_tail_local(cfg: ChainConfig, axis_name: str = RANGE_AXIS):
    """Local (per-shard) logmag + ``cfar_halo_shard`` over a range-sharded
    spectrum block."""
    def tail(spec_local, rt: RuntimeConfig) -> CfarOutput:
        mag = logmag(spec_local, rt.mag_mode, cfg.mag)
        return cfar_halo_shard(mag, rt, cfg.cfar, axis_name)

    return tail


def range_sharded_mag_cfar(cfg: ChainConfig, mesh: jax.sharding.Mesh):
    """logmag+CFAR over a spectrum sharded on the range axis. Returns a jitted
    ``f(spectrum, rt) -> CfarOutput`` with spectrum [..., N] sharded over rng."""
    def wrapped(spectrum, rt):
        nb = spectrum.ndim - 1
        spec = P(*([None] * nb), RANGE_AXIS)
        sm = jax.shard_map(
            _spectrum_tail_local(cfg), mesh=mesh,
            in_specs=(spec, P()),
            out_specs=_cfar_out_specs(cfg.cfar, spec),
        )
        return sm(spectrum, rt)

    return jax.jit(wrapped)


def range_sharded_fir(taps, mesh: jax.sharding.Mesh, block_size: Optional[int] = None):
    """Overlap-save FIR over a range-sharded time axis: each shard pulls a
    (num_taps - 1)-sample left halo from its neighbor, then runs the local
    overlap-save convolution. Returns jitted ``f(x) -> y`` (x [..., T] sharded)."""
    from ..ops.matched_filter import overlap_save_fir

    taps = jnp.asarray(taps)
    m = taps.shape[0]

    def local_fn(x_local):
        left, _ = exchange_halo(x_local, m - 1, RANGE_AXIS)
        ext = jnp.concatenate([left, x_local], axis=-1)
        y = overlap_save_fir(ext, taps, block_size)
        return y[..., m - 1 :]

    def wrapped(x):
        nb = x.ndim - 1
        spec = P(*([None] * nb), RANGE_AXIS)
        return jax.shard_map(
            local_fn, mesh=mesh, in_specs=(spec,), out_specs=spec,
        )(x)

    return jax.jit(wrapped)


def make_sharded_pipeline(cfg: ChainConfig, mesh: jax.sharding.Mesh):
    """Full fft->mag->cfar pipeline over a (ch, rng) mesh in ONE jitted program.

    Input x: [C, ..., N] complex frames, sharded over ``ch`` (fast-time axis
    replicated within a channel group). The FFT runs per channel shard with no
    communication; a sharding constraint then scatters the spectrum's range axis
    over ``rng`` (XLA inserts the collective); the CFAR tail runs under
    shard_map with halo exchange."""

    def step(x, rt: RuntimeConfig):
        y = fft_op(x, rt.log2_fft_size, cfg.fft)
        nb = y.ndim - 1
        spec = P(CHANNEL_AXIS, *([None] * (nb - 1)), RANGE_AXIS)
        y = lax.with_sharding_constraint(y, NamedSharding(mesh, spec))

        sm = jax.shard_map(
            _spectrum_tail_local(cfg), mesh=mesh,
            in_specs=(spec, P()),
            out_specs=_cfar_out_specs(cfg.cfar, spec),
        )
        return sm(y, rt)

    return jax.jit(step)


def make_sharded_rd_pipeline(cfg: ChainConfig, mesh: jax.sharding.Mesh, taps):
    """Flagship multi-chip step: the 2-D range-Doppler chain over a (ch, rng) mesh
    in ONE jitted program (BASELINE configs 3-5).

    Input x: [C, P, N] CPI blocks (C channels, P pulses, N fast-time samples),
    sharded over ``ch``. Per-channel stages (matched filter, Doppler FFT) run with
    zero communication; a sharding constraint scatters the range axis over ``rng``
    (XLA emits the all-to-all); the CFAR tail runs under shard_map with
    ppermute halo exchange at shard edges."""
    from ..ops.doppler import doppler_fft
    from ..ops.matched_filter import matched_filter, matched_filter_os
    import numpy as _np

    taps = _np.asarray(taps)  # host-side; the op splits to a real pair
    mf_cfg = cfg.matched_filter
    dop_cfg = cfg.doppler

    def step(x, rt: RuntimeConfig):
        if mf_cfg is None:
            y = x
        elif mf_cfg.method == "overlap_save":
            # honor the method register like the single-device preset —
            # the circular filter has different (wraparound) edge
            # semantics and would break sharded==unsharded equality
            y = matched_filter_os(x, taps, mf_cfg)
        else:
            y = matched_filter(x, taps, mf_cfg)
        if dop_cfg is not None:
            y = doppler_fft(y, dop_cfg)
        nb = y.ndim - 1
        spec = P(CHANNEL_AXIS, *([None] * (nb - 1)), RANGE_AXIS)
        y = lax.with_sharding_constraint(y, NamedSharding(mesh, spec))

        sm = jax.shard_map(
            _spectrum_tail_local(cfg), mesh=mesh,
            in_specs=(spec, P()),
            out_specs=_cfar_out_specs(cfg.cfar, spec),
        )
        return sm(y, rt)

    return jax.jit(step)
