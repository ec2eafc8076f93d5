"""CFAR — constant false-alarm-rate detector (SURVEY §2.5).

Whole-frame rebuild of the reference's ``AXI4CFARBlock`` (constructor
``RspChain.scala:45``, ``CFARParams`` at ``RspChainVanillaTester.scala:228-239``).
The hardware slides guard+reference windows past the cell under test one cell per
cycle; here the whole frame is processed at once:

* **CA family** (Cell-Averaging / Greatest-Of / Smallest-Of): leading/lagging
  reference sums come from one exclusive prefix-sum (``cumsum``) and two gathers per
  side — O(N) work, no windows materialized, divided by the power-of-two ``divSum``
  register exactly as the hardware shifter does
  (``RspChainVanillaTester.scala:119-122``).
* **GOS** (order statistics): per-cell windows of the elaborated maximum size are
  gathered into a ``[..., N, Wmax]`` tensor, masked to the runtime window size,
  sorted, and the rank registers ``indexLagg``/``indexLead``
  (``RspChainVanillaTester.scala:137-141``) select the statistics.
* **CASH** (cell-averaging statistic Hofele, elaborated via ``includeCASH``,
  ``RspChain.scala:137-138``): sliding sub-window sums of the runtime
  ``subWindowSize`` within each side's reference window via a second cumsum over
  the gathered windows; the per-side statistic is the minimum sub-window mean and
  the two sides combine greatest-of [inferred — submodule not vendored; matches
  ``golden.models.cfar_golden``].

Runtime register semantics follow the reconstructed map
(``RspChainVanillaTester.scala:113-146``): all mode/window/rank/scaler fields are
traced scalars — any of them can change per call with zero recompilation. The
runtime ``fftSize`` register masks the active frame: cells at index >= n produce
threshold 0 / no detection and are never read by any window (indices are clamped to
the active extent, matching a streaming implementation that only ever saw n cells).

Elaboration-time ``CfarConfig.variant`` decides which statistic datapaths are traced
at all (CACFARType / GOSCFARType / GOSCACFARType), mirroring which variants get
silicon in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..configs import CfarConfig, CfarVariant, EdgePolicy, RuntimeConfig


class CfarOutput(NamedTuple):
    """Per-bin CFAR result, the array analog of the 32-bit
    ``{threshold | bin | peak}`` output beats (``RspChainVanillaTester.scala:164-172``).

    ``noise`` / ``cut`` are ``None`` unless elaborated in (``CfarConfig.emit_noise``
    / ``send_cut``): every emitted array is an HBM write per frame, and the chain
    is bandwidth-bound — emit only what the deployment consumes."""

    threshold: jnp.ndarray         # float32 [..., N]
    peaks: jnp.ndarray             # bool    [..., N]
    noise: jnp.ndarray | None = None  # float32 [..., N] — pre-scaler noise estimate
    cut: jnp.ndarray | None = None    # float32 [..., N] — cell under test (sendCut)


def _gather_windows(mag, lo, hi, g, w, cfg: CfarConfig):
    """Gather per-cell lag/lead reference windows into [..., N, Wmax] tensors with
    validity masks (valid cell range [lo, hi) in local coordinates). Used by the
    GOS and CASH paths, and by the CA path under EdgePolicy.WRAP.

    WRAP (circular frame, the natural reading of a spectrum as periodic): window
    positions wrap modulo the active cell count; every in-window cell is valid
    whenever the active region is non-degenerate."""
    n = mag.shape[-1]
    wmax = cfg.max_ref_window
    i = jnp.arange(n, dtype=jnp.int32)[:, None]           # [N, 1]
    k = jnp.arange(wmax, dtype=jnp.int32)[None, :]        # [1, Wmax]

    lag_pos = i - g - w + k                               # cells i-g-w .. i-g-1
    lead_pos = i + g + 1 + k                              # cells i+g+1 .. i+g+w
    if cfg.edge_policy is EdgePolicy.WRAP:
        n_act = jnp.maximum(hi - lo, 1)
        lag_pos = lo + jnp.mod(lag_pos - lo, n_act)
        lead_pos = lo + jnp.mod(lead_pos - lo, n_act)
        lag_valid = jnp.broadcast_to(k < w, lag_pos.shape)
        lead_valid = jnp.broadcast_to(k < w, lead_pos.shape)
    elif cfg.edge_policy is EdgePolicy.REFLECT:
        n_act = jnp.maximum(hi - lo, 1)
        period = jnp.maximum(2 * n_act - 2, 1)

        def refl(pos):
            m = jnp.mod(pos - lo, period)
            return lo + jnp.where(m < n_act, m, period - m)

        lag_pos = refl(lag_pos)
        lead_pos = refl(lead_pos)
        lag_valid = jnp.broadcast_to(k < w, lag_pos.shape)
        lead_valid = jnp.broadcast_to(k < w, lead_pos.shape)
    else:
        lag_valid = (k < w) & (lag_pos >= lo) & (lag_pos < hi)
        lead_valid = (k < w) & (lead_pos >= lo) & (lead_pos < hi)

    def take(pos):
        flat = jnp.clip(pos, 0, n - 1).reshape(-1)
        out = jnp.take(mag, flat, axis=-1)
        return out.reshape(mag.shape[:-1] + (n, wmax))

    return take(lag_pos), lag_valid, take(lead_pos), lead_valid


def _ca_sums(mag, lo, hi, g, w):
    """Leading/lagging reference-window sums via exclusive prefix sums.

    lag(i)  = sum mag[i-g-w : i-g],  lead(i) = sum mag[i+g+1 : i+g+1+w],
    window extents clamped to the valid cell range [lo, hi)
    (EdgePolicy.PARTIAL)."""
    n = mag.shape[-1]
    p = jnp.concatenate(
        [jnp.zeros(mag.shape[:-1] + (1,), mag.dtype), jnp.cumsum(mag, axis=-1)],
        axis=-1,
    )  # p[..., j] = sum(mag[..., :j])
    i = jnp.arange(n, dtype=jnp.int32)

    def psum_at(idx):
        idx = jnp.clip(idx, lo, hi)
        return jnp.take_along_axis(
            p, jnp.broadcast_to(idx, p.shape[:-1] + (n,)), axis=-1
        )

    lag = psum_at(i - g) - psum_at(i - g - w)
    lead = psum_at(i + g + 1 + w) - psum_at(i + g + 1)
    return lag, lead


def _gos_stats(lag_win, lag_valid, lead_win, lead_valid, rank_lagg, rank_lead):
    """Order statistics: k-th smallest valid cell per side (rank registers
    base+9/+10). Invalid cells sort to +inf; rank clamps to the number of valid
    cells like the golden (`sorted[min(k, len-1)]`), 0 when the side is empty."""
    big = jnp.float32(jnp.inf)

    def side(winv, valid, rank):
        valid = jnp.broadcast_to(valid, winv.shape)  # masks carry no batch dims
        vals = jnp.where(valid, winv, big)
        s = jnp.sort(vals, axis=-1)
        nv = jnp.sum(valid, axis=-1).astype(jnp.int32)      # [..., N]
        idx = jnp.clip(jnp.minimum(rank, nv - 1), 0, s.shape[-1] - 1)
        got = jnp.take_along_axis(s, idx[..., None], axis=-1)[..., 0]
        return jnp.where(nv > 0, got, 0.0)

    return side(lag_win, lag_valid, rank_lagg), side(lead_win, lead_valid, rank_lead)


def _cash_stat(win, valid, sub_w, wmax):
    """CASH per-side statistic: min over sliding sub-window means of size sub_w
    within the (contiguous) valid cells of the reference window."""
    v = jnp.where(valid, win, 0.0)
    c = jnp.concatenate(
        [jnp.zeros(v.shape[:-1] + (1,), v.dtype), jnp.cumsum(v, axis=-1)], axis=-1
    )
    cv = jnp.concatenate(
        [
            jnp.zeros(valid.shape[:-1] + (1,), jnp.int32),
            jnp.cumsum(valid.astype(jnp.int32), axis=-1),
        ],
        axis=-1,
    )
    t = jnp.arange(wmax, dtype=jnp.int32)                  # sub-window start offsets
    hi = jnp.clip(t + sub_w, 0, wmax)
    sub_sum = jnp.take(c, hi, axis=-1) - jnp.take(c, t, axis=-1)
    sub_cnt = jnp.take(cv, hi, axis=-1) - jnp.take(cv, t, axis=-1)
    ok = (sub_cnt == sub_w) & (t + sub_w <= wmax)
    means = jnp.where(ok, sub_sum / jnp.maximum(sub_w, 1).astype(v.dtype), jnp.inf)
    est = jnp.min(means, axis=-1)
    return jnp.where(jnp.isfinite(est), est, 0.0)


# ---------------------------------------------------------------------------
# roll-based (gather-free) implementations — the default path
#
# Under the PARTIAL edge policy every window access is expressible as a
# ROTATION: static rolls are concat-slices XLA fuses into elementwise code,
# and runtime shift amounts decompose into conditional power-of-two rolls.
# A 128-cell zero pad absorbs rotation wrap-around.
# ---------------------------------------------------------------------------

_PAD = 128
_SHIFT_BITS = 8  # runtime shifts up to 255


def _roll_dyn(x, s, axis=-1, left=False):
    """Circular roll by traced amount ``s`` via bit-decomposed static rolls."""
    for k in range(_SHIFT_BITS):
        sh = -(1 << k) if left else (1 << k)
        x = jnp.where(((s >> k) & 1) == 1, jnp.roll(x, sh, axis=axis), x)
    return x


def _masked_padded(mag, lo, hi):
    """Zero cells outside [lo, hi) and add a _PAD zero margin on each side."""
    n = mag.shape[-1]
    cell = jnp.arange(n, dtype=jnp.int32)
    m = jnp.where((cell >= lo) & (cell < hi), mag, 0.0)
    z = jnp.zeros(mag.shape[:-1] + (_PAD,), mag.dtype)
    return jnp.concatenate([z, m, z], axis=-1)


def _ca_sums_roll(mag, lo, hi, g, log2w, wmax):
    """Gather-free CA window sums: dyadic box sums + runtime rotations.

    Identical semantics to ``_ca_sums`` for power-of-two runtime windows (the
    reference requires isPow2(refWindowSize))."""
    n = mag.shape[-1]
    row = _masked_padded(mag, lo, hi)
    sel = row  # box width 1
    box = row
    for k in range(int(wmax).bit_length() - 1):
        box = box + jnp.roll(box, 1 << k, axis=-1)
        sel = jnp.where(log2w == k + 1, box, sel)
    # sel[j] = sum row[j-w+1 .. j]
    w = (jnp.int32(1) << log2w)
    lag = _roll_dyn(sel, g + 1)[..., _PAD : _PAD + n]         # sel[i - g - 1]
    lead = _roll_dyn(sel, g + w, left=True)[..., _PAD : _PAD + n]  # sel[i + g + w]
    return lag, lead


def _windows_roll(mag, lo, hi, g, w, cfg: CfarConfig):
    """Roll-stacked per-cell windows: [..., Wmax, N] with the window offset on
    axis -2 (sublanes) and range cells on lanes — plus validity masks
    [Wmax, N]. win_lag[..., k, i] = mag[i - g - w + k] etc."""
    n = mag.shape[-1]
    wmax = cfg.max_ref_window
    row = _masked_padded(mag, lo, hi)
    lag_base = _roll_dyn(row, g + w)            # [j] = row[j - g - w]
    lead_base = _roll_dyn(row, g + 1, left=True)  # [j] = row[j + g + 1]
    lag = jnp.stack([jnp.roll(lag_base, -k, axis=-1) for k in range(wmax)],
                    axis=-2)[..., :, _PAD : _PAD + n]
    lead = jnp.stack([jnp.roll(lead_base, -k, axis=-1) for k in range(wmax)],
                     axis=-2)[..., :, _PAD : _PAD + n]
    kk = jnp.arange(wmax, dtype=jnp.int32)[:, None]
    ii = jnp.arange(n, dtype=jnp.int32)[None, :]
    lag_pos = ii - g - w + kk
    lead_pos = ii + g + 1 + kk
    lag_valid = (kk < w) & (lag_pos >= lo) & (lag_pos < hi)
    lead_valid = (kk < w) & (lead_pos >= lo) & (lead_pos < hi)
    return lag, lag_valid, lead, lead_valid


def _gos_stats_roll(lag_win, lag_valid, lead_win, lead_valid, rank_lagg, rank_lead):
    """Order statistics over the window axis (-2), gather-free: sort along the
    window axis, then one-hot-select the (validity-clamped) rank."""
    big = jnp.float32(jnp.inf)

    def side(winv, valid, rank):
        valid_b = jnp.broadcast_to(valid, winv.shape)
        vals = jnp.where(valid_b, winv, big)
        s = jnp.sort(vals, axis=-2)
        nv = jnp.sum(valid_b, axis=-2).astype(jnp.int32)        # [..., N]
        idx = jnp.clip(jnp.minimum(rank, nv - 1), 0, s.shape[-2] - 1)
        kk = jnp.arange(s.shape[-2], dtype=jnp.int32)[:, None]  # [Wmax, 1]
        onehot = (kk == idx[..., None, :])
        got = jnp.sum(jnp.where(onehot, s, 0.0), axis=-2)
        return jnp.where(nv > 0, got, 0.0)

    return side(lag_win, lag_valid, rank_lagg), side(lead_win, lead_valid, rank_lead)


def _cash_stat_roll(win, valid, sub_w, wmax):
    """CASH statistic over the window axis (-2), gather-free: the sub-window
    shift becomes a rotation of the cumulative sums along axis -2."""
    valid_b = jnp.broadcast_to(valid, win.shape)
    v = jnp.where(valid_b, win, 0.0)
    zrow = jnp.zeros(v.shape[:-2] + (1,) + v.shape[-1:], v.dtype)
    c = jnp.concatenate([zrow, jnp.cumsum(v, axis=-2)], axis=-2)      # [.., W+1, N]
    cv = jnp.concatenate(
        [jnp.zeros(valid_b.shape[:-2] + (1,) + valid_b.shape[-1:], jnp.int32),
         jnp.cumsum(valid_b.astype(jnp.int32), axis=-2)], axis=-2)
    c_sh = _roll_dyn(c, sub_w, axis=-2, left=True)     # [t] = c[t + sw] (wraps masked)
    cv_sh = _roll_dyn(cv, sub_w, axis=-2, left=True)
    sub_sum = (c_sh - c)[..., :wmax, :]
    sub_cnt = (cv_sh - cv)[..., :wmax, :]
    tt = jnp.arange(wmax, dtype=jnp.int32)[:, None]
    ok = (sub_cnt == sub_w) & (tt + sub_w <= wmax)
    means = jnp.where(ok, sub_sum / jnp.maximum(sub_w, 1).astype(v.dtype), jnp.inf)
    est = jnp.min(means, axis=-2)
    return jnp.where(jnp.isfinite(est), est, 0.0)


def cfar_op(
    mag: jnp.ndarray,
    rt: RuntimeConfig,
    cfg: CfarConfig = CfarConfig(),
    *,
    active_lo: jnp.ndarray | None = None,
    active_hi: jnp.ndarray | None = None,
) -> CfarOutput:
    """Run CFAR over the last axis of ``mag`` (float32 [..., N], N = elaborated
    frame size). All runtime behaviour comes from traced scalars in ``rt``.

    ``active_lo``/``active_hi`` (traced int32 scalars) bound the valid cell range in
    *local* coordinates. They default to [0, runtime fftSize) — the register
    semantics of a standalone frame. The range-sharded path
    (``parallel.sharded``) passes the local-coordinate bounds of the global frame
    so halo cells beyond the true frame edges are excluded from window statistics
    exactly as at an unsharded edge."""
    mag = mag.astype(jnp.float32)
    n = mag.shape[-1]
    n_active = jnp.minimum(rt.cfar_fft_size, n).astype(jnp.int32)
    if active_lo is None:
        active_lo = jnp.int32(0)
    if active_hi is None:
        active_hi = n_active
    # clamp BOTH runtime windows to their elaborated maxima: values beyond them
    # are inexpressible in hardware, and the roll paths' bit-decomposed shifts
    # silently drop high bits past the zero-pad reach (ADVICE r1)
    g = jnp.clip(rt.guard_window_size, 0, cfg.max_guard_window).astype(jnp.int32)
    w = jnp.minimum(rt.ref_window_size, cfg.max_ref_window).astype(jnp.int32)

    variant = cfg.variant
    has_ca = variant in (CfarVariant.CA, CfarVariant.GOSCA)
    has_gos = variant in (CfarVariant.GOS, CfarVariant.GOSCA)
    has_cash = cfg.include_cash
    wrap = cfg.edge_policy is not EdgePolicy.PARTIAL  # WRAP/REFLECT: mod/mirror
    # gather-free rotations need the zero pad to cover every window reach;
    # WRAP/REFLECT's mod/mirror indexing stays on the gather path
    use_roll = (not wrap) and (cfg.max_ref_window + cfg.max_guard_window + 1 <= _PAD)
    log2w = jnp.round(jnp.log2(jnp.maximum(w, 1).astype(jnp.float32))).astype(jnp.int32)

    zero = jnp.zeros_like(mag)

    if has_gos or has_cash or wrap:
        if use_roll:
            lag_win, lag_valid, lead_win, lead_valid = _windows_roll(
                mag, active_lo, active_hi, g, w, cfg
            )
        else:
            lag_win, lag_valid, lead_win, lead_valid = _gather_windows(
                mag, active_lo, active_hi, g, w, cfg
            )

    if has_ca:
        if wrap:
            # circular windows cannot come from one linear prefix sum — sum the
            # gathered (mod-indexed) windows directly
            lag_sum = jnp.sum(jnp.where(lag_valid, lag_win, 0.0), axis=-1)
            lead_sum = jnp.sum(jnp.where(lead_valid, lead_win, 0.0), axis=-1)
        elif use_roll:
            lag_sum, lead_sum = _ca_sums_roll(
                mag, active_lo, active_hi, g, log2w, cfg.max_ref_window)
        else:
            lag_sum, lead_sum = _ca_sums(mag, active_lo, active_hi, g, w)
        div = jnp.exp2(rt.div_sum.astype(jnp.float32))
        ca_lag, ca_lead = lag_sum / div, lead_sum / div
    else:
        ca_lag = ca_lead = zero

    if has_gos:
        gos_fn = _gos_stats_roll if use_roll else _gos_stats
        os_lag, os_lead = gos_fn(
            lag_win, lag_valid, lead_win, lead_valid, rt.index_lagg, rt.index_lead
        )
    else:
        os_lag = os_lead = zero

    # per-side statistic select (base+5 CA/GOS register, only if GOSCA elaborated)
    if variant is CfarVariant.GOSCA:
        use_gos = (rt.cfar_algorithm == 1)
        side_lag = jnp.where(use_gos, os_lag, ca_lag)
        side_lead = jnp.where(use_gos, os_lead, ca_lead)
    elif variant is CfarVariant.GOS:
        side_lag, side_lead = os_lag, os_lead
    else:
        side_lag, side_lead = ca_lag, ca_lead

    def mode_ca(_):
        return 0.5 * (side_lag + side_lead)

    def mode_go(_):
        return jnp.maximum(side_lag, side_lead)

    def mode_so(_):
        return jnp.minimum(side_lag, side_lead)

    if has_cash:
        def mode_cash(_):
            sw = jnp.clip(rt.sub_window_size, cfg.min_sub_window, cfg.max_ref_window)
            cash_fn = _cash_stat_roll if use_roll else _cash_stat
            est_lag = cash_fn(lag_win, lag_valid, sw, cfg.max_ref_window)
            est_lead = cash_fn(lead_win, lead_valid, sw, cfg.max_ref_window)
            return jnp.maximum(est_lag, est_lead)
    else:
        mode_cash = mode_ca  # CASH not elaborated -> mode 3 degrades to CA

    noise = jax.lax.switch(
        jnp.clip(rt.cfar_mode, 0, 3), [mode_ca, mode_go, mode_so, mode_cash], None
    )

    # linear: multiplicative scaler; log domain: additive (SURVEY §2.5 —
    # in log domain averaging becomes addition)
    threshold = jnp.where(
        rt.log_or_linear == 1,
        noise * rt.threshold_scaler,
        noise + rt.threshold_scaler,
    )

    cell = jnp.arange(n, dtype=jnp.int32)
    active = (cell >= active_lo) & (cell < active_hi)
    threshold = jnp.where(active, threshold, 0.0)
    peaks = (mag > threshold) & active

    # peak grouping (base+4): keep only local maxima of the magnitude; neighbors
    # outside the valid cell range count as -inf (frame-edge semantics).
    # DELIBERATE under WRAP/REFLECT too: the edge policy governs how the noise
    # ESTIMATE windows treat the frame boundary, while grouping is a
    # neighbor-adjacency test on the physical frame — a first/last cell has no
    # physical neighbor beyond the edge, so it can qualify as a local maximum
    # without a wrapped comparison. The golden model (golden/models.py) shares
    # this contract; tests/test_cfar.py pins it.
    neg = jnp.float32(-jnp.inf)
    left = jnp.concatenate([jnp.full(mag.shape[:-1] + (1,), neg), mag[..., :-1]], -1)
    right = jnp.concatenate([mag[..., 1:], jnp.full(mag.shape[:-1] + (1,), neg)], -1)
    left = jnp.where(cell - 1 >= active_lo, left, neg)
    right = jnp.where(cell + 1 < active_hi, right, neg)
    grouped = peaks & (mag >= left) & (mag >= right)
    peaks = jnp.where(rt.peak_grouping == 1, grouped, peaks)

    return CfarOutput(
        threshold=threshold,
        peaks=peaks,
        noise=noise if cfg.emit_noise else None,
        cut=mag if cfg.send_cut else None,
    )
