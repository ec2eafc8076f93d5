"""2-D (range x Doppler) CA-CFAR over range-Doppler maps — a north-star
addition (the reference's CFAR is strictly 1-D along range;
BASELINE config 3's map detector generalizes it to the standard 2-D
rectangular-annulus cell-averaging detector used on RD maps).

Geometry per cell-under-test (d, r): the noise estimate is the mean of the
training band between two centered rectangles — outer half-extents
``guard + ref`` and inner (guard) half-extents ``guard`` per axis:

        ┌─────────────────────────────┐  ▲
        │  training band (averaged)   │  │ 2·(g_d+w_d)+1
        │   ┌─────────────────┐       │  │
        │   │  guard (excl.)  │       │  │
        │   │      CUT        │       │  │
        │   └─────────────────┘       │  │
        └─────────────────────────────┘  ▼

Edges follow ``EdgePolicy.PARTIAL`` semantics (the only policy defined for
maps): cells outside the frame / the runtime-active range contribute nothing
and the divisor is the actual number of training cells — computed with the
same sliding sums applied to the validity mask, so no gathers anywhere. All
window
extents are traced scalars bounded by the elaborated maxima: reconfiguration
never recompiles, mirroring the 1-D register-file contract.

Unlike the 1-D block (whose ``divSum`` power-of-two shift mirrors the
hardware divider), the 2-D detector divides by the true training-cell count —
the annulus population varies at frame edges, so a fixed shift would bias
edge thresholds.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..configs import ChainConfig
from .cfar import CfarOutput

@dataclass(frozen=True)
class Cfar2dConfig:
    """Elaboration maxima for the 2-D detector (per-axis window bounds).

    ``include_os`` compiles in the ordered-statistic body (2-D analog of the
    1-D GOS rank select, ``ops/cfar.py``): the runtime ``algorithm`` register
    then muxes CA/OS on one executable. OS materializes one rolled copy of the
    map per elaborated annulus offset for ONE map at a time (``lax.map`` over
    the batch — see the body), so peak memory is the stack cap below (~256x)
    times a single [P, N] map regardless of channel count."""

    max_ref_range: int = 16
    max_guard_range: int = 4
    max_ref_doppler: int = 8
    max_guard_doppler: int = 2
    include_os: bool = False

    @property
    def os_stack(self) -> int:
        """Elaborated training-stack size: every offset of the outer rectangle
        except the CUT itself (inner-rectangle offsets are masked at runtime —
        the guard extents are registers)."""
        return ((2 * (self.max_ref_doppler + self.max_guard_doppler) + 1)
                * (2 * (self.max_ref_range + self.max_guard_range) + 1) - 1)

    def __post_init__(self):
        assert self.max_ref_range >= 1 and self.max_ref_doppler >= 1
        assert self.max_guard_range >= 0 and self.max_guard_doppler >= 0
        if self.include_os and self.os_stack > 256:
            raise ValueError(
                f"include_os with annulus stack {self.os_stack} > 256: the OS "
                "body stacks one rolled map per elaborated offset — elaborate "
                "smaller per-axis maxima for ordered-statistic detection")


@jax.tree_util.register_dataclass
@dataclass
class Cfar2dRuntime:
    """Runtime registers of the 2-D detector (traced scalars, no recompile)."""

    ref_range: jnp.ndarray        # int32, >= 1
    guard_range: jnp.ndarray     # int32, >= 0
    ref_doppler: jnp.ndarray      # int32, >= 1
    guard_doppler: jnp.ndarray    # int32, >= 0
    threshold_scaler: jnp.ndarray  # float32
    log_or_linear: jnp.ndarray    # int32: 1 = multiply, 0 = add (log domain)
    peak_grouping: jnp.ndarray    # int32: 1 = keep 8-neighbour local maxima
    active_range: jnp.ndarray     # int32: valid range cells [0, active_range)
    algorithm: jnp.ndarray        # int32: 0 = CA, 1 = OS (needs include_os)
    os_rank: jnp.ndarray          # int32: 0-based rank among valid cells

    @staticmethod
    def make(*, ref_range: int, guard_range: int, ref_doppler: int,
             guard_doppler: int, threshold_scaler: float,
             log_or_linear: int = 1, peak_grouping: int = 0,
             active_range: int = 1 << 30,
             algorithm: int = 0, os_rank: int = 0,
             validate_against: Optional[Cfar2dConfig] = None
             ) -> "Cfar2dRuntime":
        if ref_range < 1 or ref_doppler < 1:
            raise ValueError("reference extents must be >= 1")
        if guard_range < 0 or guard_doppler < 0:
            raise ValueError("guard extents must be >= 0")
        if algorithm not in (0, 1):
            raise ValueError("algorithm must be 0 (CA) or 1 (OS)")
        if os_rank < 0:
            raise ValueError("os_rank must be >= 0")
        if validate_against is not None:
            c = validate_against
            if (ref_range > c.max_ref_range
                    or guard_range > c.max_guard_range
                    or ref_doppler > c.max_ref_doppler
                    or guard_doppler > c.max_guard_doppler):
                raise ValueError("2-D window exceeds elaborated maxima")
            if algorithm == 1 and not c.include_os:
                raise ValueError(
                    "algorithm=OS requires an include_os=True elaboration")
            if algorithm == 1 and os_rank >= c.os_stack:
                raise ValueError("os_rank exceeds the elaborated annulus")
        i32 = lambda v: jnp.asarray(v, jnp.int32)
        return Cfar2dRuntime(
            ref_range=i32(ref_range), guard_range=i32(guard_range),
            ref_doppler=i32(ref_doppler), guard_doppler=i32(guard_doppler),
            threshold_scaler=jnp.asarray(threshold_scaler, jnp.float32),
            log_or_linear=i32(log_or_linear), peak_grouping=i32(peak_grouping),
            active_range=i32(active_range),
            algorithm=i32(algorithm), os_rank=i32(os_rank),
        )


def _centered_box(x, half, axis: int, max_half: int):
    """Sliding sum over offsets [-half, +half] of runtime half-extent along
    ``axis`` — gather-free: a dyadic right-aligned ladder bit-composed by
    static rolls, recentered by one bit-decomposed roll. The caller supplies a
    zero margin > 2·max_half + 1 on both sides of ``axis`` so circular wraps
    land in zeros."""
    w = 2 * half + 1
    # right-aligned sliding sum R_w[i] = sum x[i-w+1 .. i], w composed by bits:
    # when bit b of w is set, R_{m+2^b}[i] = B_b[i] + R_m[i - 2^b]
    acc = jnp.zeros_like(x)
    blk = x
    n_bits = max(int(np.ceil(np.log2(2 * max_half + 2))), 1)
    for b in range(n_bits):
        bit = ((w >> b) & 1) == 1
        acc = jnp.where(bit, blk + jnp.roll(acc, 1 << b, axis=axis), acc)
        if b < n_bits - 1:
            blk = blk + jnp.roll(blk, 1 << b, axis=axis)
    # recenter: S[i] = R[i + half] — bit count derived from the SAME maxima
    # as the ladder (a fixed cap would silently drop high bits of large
    # elaborations and apply the window off-center)
    for b in range(max(int(max_half).bit_length(), 1)):
        acc = jnp.where(((half >> b) & 1) == 1,
                        jnp.roll(acc, -(1 << b), axis=axis), acc)
    return acc


def cfar_2d_op(
    mag: jnp.ndarray,
    rt2: Cfar2dRuntime,
    cfg: Cfar2dConfig = Cfar2dConfig(),
    *,
    active_lo: jnp.ndarray | None = None,
    active_hi: jnp.ndarray | None = None,
) -> CfarOutput:
    """2-D CA-CFAR over the trailing [P, N] (Doppler, range) axes of ``mag``.

    Returns ``CfarOutput`` with per-cell thresholds and detections over the
    full map. The valid range cells are [``active_lo``, ``active_hi``)
    (traced scalars, defaulting to [0, ``rt2.active_range``) — the runtime
    CFAR fftSize analog; the sharded tail passes the halo-offset window of a
    range-sharded block). Doppler always spans the full map."""
    p, n = mag.shape[-2], mag.shape[-1]
    pad_d = 2 * (cfg.max_ref_doppler + cfg.max_guard_doppler) + 2
    pad_r = 2 * (cfg.max_ref_range + cfg.max_guard_range) + 2

    if active_hi is None:
        active_hi = rt2.active_range
    if active_lo is None:
        active_lo = jnp.int32(0)
    r_cell = jnp.arange(n, dtype=jnp.int32)
    active = jnp.broadcast_to((r_cell >= active_lo) & (r_cell < active_hi),
                              mag.shape)
    m = jnp.where(active, mag.astype(jnp.float32), 0.0)

    padcfg = [(0, 0)] * (mag.ndim - 2) + [(pad_d, pad_d), (pad_r, pad_r)]
    mp = jnp.pad(m, padcfg)
    vp = jnp.pad(active.astype(jnp.float32), padcfg)

    # clamp runtime registers to the elaborated maxima (the r2 guard-window
    # lesson, ADVICE round 1: raw register writes — server JSON frames,
    # dataclasses.replace — bypass make()'s validation, and an oversized
    # extent would overflow the padding and the bit ladders silently)
    w_r = jnp.clip(rt2.ref_range, 1, cfg.max_ref_range)
    g_r = jnp.clip(rt2.guard_range, 0, cfg.max_guard_range)
    w_d = jnp.clip(rt2.ref_doppler, 1, cfg.max_ref_doppler)
    g_d = jnp.clip(rt2.guard_doppler, 0, cfg.max_guard_doppler)
    a_d = g_d + w_d
    a_r = g_r + w_r
    max_ad = cfg.max_guard_doppler + cfg.max_ref_doppler
    max_ar = cfg.max_guard_range + cfg.max_ref_range

    def box2(x, hd, hr, mhd, mhr):
        return _centered_box(_centered_box(x, hd, -2, mhd), hr, -1, mhr)

    outer = box2(mp, a_d, a_r, max_ad, max_ar)
    inner = box2(mp, g_d, g_r,
                 cfg.max_guard_doppler, cfg.max_guard_range)
    c_out = box2(vp, a_d, a_r, max_ad, max_ar)
    c_in = box2(vp, g_d, g_r,
                cfg.max_guard_doppler, cfg.max_guard_range)

    sl = tuple([slice(None)] * (mag.ndim - 2)
               + [slice(pad_d, pad_d + p), slice(pad_r, pad_r + n)])
    train_sum = (outer - inner)[sl]
    train_cnt = (c_out - c_in)[sl]
    noise = train_sum / jnp.maximum(train_cnt, 1.0)

    if cfg.include_os:
        # Ordered-statistic body (2-D analog of ops/cfar.py's gather-free
        # rank select): one rolled copy of the padded map per elaborated
        # outer-rectangle offset, runtime annulus membership as a scalar mask
        # per offset, sort along the stack, one-hot-select the clamped rank.
        # The (0,0) offset is excluded statically — guard extents >= 0 keep
        # the CUT inside the runtime inner rectangle. A raw register write of
        # algorithm=1 on an include_os=False elaboration is inert (no OS body
        # compiled in): the mux below only exists under include_os.
        #
        # Memory bounding: the stack goes on axis 0 of a single [P, N] map
        # and the batch runs under lax.map; the stack buffer is filled by a
        # fori_loop over offsets (traced dd/dr, dynamic rolls) rather than
        # jnp.stack of S separate arrays, whose concat operands XLA may lay
        # out padded. The fori_loop keeps ONE [S, P, N] buffer live
        # (stack*P*N floats, <=256 maps' worth by the elaboration cap),
        # independent of batch.
        pd2, pr2 = sl[-2], sl[-1]
        n_r = 2 * max_ar + 1
        n_off = (2 * max_ad + 1) * n_r
        center = max_ad * n_r + max_ar                 # the (0, 0) offset
        n_stk = n_off - 1

        def _os_one(args):
            mp1, vp1 = args                      # padded [Pp, Np] map + mask

            # fori_loop with TRACED dd/dr (dynamic-slice rolls): a static
            # unroll of the offsets loses the loop's in-place buffer update,
            # so every step of the dynamic_update_slice chain would copy the
            # whole [S, P, N] buffer.
            def body(s, carry):
                buf, nv = carry
                o = jnp.where(s >= center, s + 1, s)   # skip (0,0) statically
                dd = o // n_r - max_ad
                dr = o % n_r - max_ar
                member = ((jnp.abs(dd) <= a_d) & (jnp.abs(dr) <= a_r)
                          & ~((jnp.abs(dd) <= g_d) & (jnp.abs(dr) <= g_r)))
                v = jnp.roll(jnp.roll(mp1, -dd, axis=-2),
                             -dr, axis=-1)[pd2, pr2]
                ok = member & (jnp.roll(jnp.roll(vp1, -dd, axis=-2),
                                        -dr, axis=-1)[pd2, pr2] > 0.5)
                row = jnp.where(ok, v, jnp.float32(jnp.inf))
                return (jax.lax.dynamic_update_slice(buf, row[None],
                                                     (s, 0, 0)),
                        nv + ok.astype(jnp.int32))

            buf, nv = jax.lax.fori_loop(
                0, n_stk, body,
                (jnp.full((n_stk, p, n), jnp.inf, jnp.float32),
                 jnp.zeros((p, n), jnp.int32)))
            sv = jnp.sort(buf, axis=0)
            idx = jnp.clip(jnp.minimum(rt2.os_rank, nv - 1), 0, n_stk - 1)
            ks = jnp.arange(n_stk, dtype=jnp.int32).reshape(-1, 1, 1)
            one = jnp.sum(jnp.where(ks == idx[None], sv, 0.0), axis=0)
            return jnp.where(nv > 0, one, 0.0)

        lead = mp.shape[:-2]
        mp_f = mp.reshape((-1,) + mp.shape[-2:])
        vp_f = vp.reshape((-1,) + vp.shape[-2:])
        os_noise = jax.lax.map(_os_one, (mp_f, vp_f)).reshape(lead + (p, n))
        noise = jnp.where(rt2.algorithm == 1, os_noise, noise)

    thr = jnp.where(rt2.log_or_linear == 1,
                    noise * rt2.threshold_scaler,
                    noise + rt2.threshold_scaler)
    thr = jnp.where(active, thr, 0.0)
    peaks = (m > thr) & active

    # 8-neighbour local-maximum grouping (the 2-D analog of the base+4
    # register; frame edges compare against -inf)
    ninf = jnp.float32(-jnp.inf)
    mrow = jnp.pad(jnp.where(active, m, ninf), padcfg, constant_values=ninf)
    is_max = jnp.ones(mag.shape, bool)
    for dd in (-1, 0, 1):
        for dr in (-1, 0, 1):
            if dd == 0 and dr == 0:
                continue
            nb = jnp.roll(jnp.roll(mrow, dd, axis=-2), dr, axis=-1)[sl]
            is_max = is_max & (m >= nb)
    grouped = peaks & is_max
    peaks = jnp.where(rt2.peak_grouping == 1, grouped, peaks)

    return CfarOutput(threshold=thr, peaks=peaks, noise=None, cut=None)


def rd_2d_cfar_chain(cfg: Optional[ChainConfig] = None,
                     taps=None,
                     cfg2d: Cfar2dConfig = Cfar2dConfig()):
    """Range-Doppler chain with the 2-D map detector: matched filter ->
    Doppler -> |.| -> 2-D CFAR. Returns ``f(x, rt, rt2) -> CfarOutput`` (not
    a ``Chain`` — the 2-D detector has its own register record)."""
    from ..configs import DopplerConfig
    from ..cplx import as_pair
    from ..ops.logmag import logmag
    from ..presets import doppler_stage, matched_filter_stage

    cfg = cfg or ChainConfig(doppler=DopplerConfig())
    if cfg.matched_filter is None:
        # matched_filter=None means NO filter stage (see
        # presets.range_doppler_chain / parallel.sharded) — never fabricate one
        if taps is not None:
            raise ValueError(
                "taps given but cfg.matched_filter is None — elaborate a "
                "MatchedFilterConfig for the filter stage to exist")
        mf = None
    else:
        if taps is None:
            from ..golden.fixtures import lfm_chirp

            taps = lfm_chirp(cfg.matched_filter.num_taps)
        mf = matched_filter_stage(cfg, np.asarray(taps))
    front = ([mf] if mf is not None else []) + [doppler_stage(cfg)]

    def run(x, rt, rt2: Cfar2dRuntime) -> CfarOutput:
        # stage scopes as in Chain.__call__, so traces attribute device time
        y = as_pair(x)
        for st in front:
            with jax.named_scope(st.name):
                y = st.fn(y, rt)
        with jax.named_scope("logmag"):
            m = logmag(y, rt.mag_mode, cfg.mag)
        with jax.named_scope("cfar_2d"):
            return cfar_2d_op(m, rt2, cfg2d)

    return run
