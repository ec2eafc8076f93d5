"""Bit-true integer chain path — exact 16-bit fixed-point stream emulation.

The reference computes *in* 16-bit fixed point with per-stage truncation:
``FixedPoint(16, 0.BP)`` data, ``expandLogic``/``keepMSBorLSB`` per FFT stage
(``/root/reference/src/main/scala/RspChain.scala:108-118``), RoundHalfUp
(``RspChainVanillaTester.scala:201``), and ±2-LSB golden tolerance
(``RspChainTesterUtils.scala:221-237``). The float fidelity mode
(``chain.py``/``numerics.py``) quantizes only at stage *boundaries*; this module
is the exact-arithmetic emulation: every value is an integer carried in int32,
every divider is an arithmetic shift with round-half-up, and packed int16 wire
streams are bit-exact against the independent numpy golden
(``golden.int_models``), not merely SNR-close.

Arithmetic spec (the DSP submodules are not vendored — the per-operation
ordering below is this framework's documented contract, chosen to match the
hardware conventions that ARE visible: RoundHalfUp everywhere, div-2 keepMSB
per non-expanding FFT stage, 16-bit twiddles/scaler fixed points):

* **FFT** (radix-2 DIF, natural-in / bit-reversed-out + final reorder):
  stage s on blocks of m = N>>s: ``y[j] = x[j] + x[j+m/2]``;
  ``y[j+m/2] = x[j] - x[j+m/2]``; then keepMSB halving ``(v + 1) >> 1`` when
  ``expandLogic[s] == 0`` (BEFORE the twiddle so 16-bit headroom is preserved);
  then the twiddle ``W_m^j`` quantized to 1.15 fixed point
  (``round(cos * 2^15)``, exact unity for W^0), product rounded
  ``(p + 2^14) >> 15``.
* **JPL magnitude**: u = max(|re|,|im|), v = min:
  ``max(u + (v >> 3), u - (u >> 3) + (v >> 1))`` with truncating shifts — the
  shift-add form of the float JPL ``max(u + v/8, 7u/8 + v/2)``.
* **CA CFAR**: integer window sums (exact adds); per-side divider
  ``sum >> divSum`` (non-negative, truncating — the hardware shifter);
  linear threshold ``(noise * round(scaler * 2^6) + 2^5) >> 6``
  (protoScaler FixedPoint(16, 6.BP), ``RspChainVanillaTester.scala:231``);
  log-domain threshold ``noise + round(scaler)``.

All ops are int32 jnp tensors under jit with the usual traced runtime
registers; gather-free (static rolls — the shifts are compile-time constants).
Perf note: this is the conformance path, not the throughput path.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..configs import CfarConfig, FftConfig, RuntimeConfig
from ..cplx import C
from .cfar import CfarOutput


def rhu(v, k: int):
    """Round-half-up arithmetic right shift: floor((v + 2^(k-1)) / 2^k)."""
    if k == 0:
        return v
    return (v + (1 << (k - 1))) >> k


@functools.lru_cache(maxsize=None)
def stage_twiddles(n: int):
    """Per-stage 1.15 fixed-point twiddle lane vectors for the radix-2 DIF
    pipeline, and the final bit-reversal permutation. Lanes on the 'a' half of
    each butterfly get exact unity (2^15) so one uniform multiply-round per
    stage is exact for them."""
    p = int(np.log2(n))
    i = np.arange(n)
    stages = []
    for s in range(p):
        m = n >> s
        half = m >> 1
        j = i & (half - 1)
        w = np.exp(-2j * np.pi * j / m)
        wr = np.round(w.real * 32768.0).astype(np.int64)
        wi = np.round(w.imag * 32768.0).astype(np.int64)
        b_lane = (i & half) != 0
        wr = np.where(b_lane, wr, 32768)
        wi = np.where(b_lane, wi, 0)
        stages.append((wr.astype(np.int32), wi.astype(np.int32)))
    rev = np.zeros(n, np.int32)
    for k in range(n):
        rev[k] = int(format(k, f"0{p}b")[::-1], 2)
    return stages, rev


def wrap16(v):
    """Trim to the 16-bit two's-complement grid with WRAPAROUND overflow —
    the hardware's keepMSBorLSB = LSB stage trim (the grown MSB is dropped;
    dsptools Wrap overflow)."""
    return ((v + 32768) & 0xFFFF) - 32768


def _fft_int_fixed(xr, xi, n: int, expand_logic: Optional[tuple],
                   keep_msb: Optional[tuple] = None):
    """Static-size integer FFT of the first n lanes; returns int32 pair.

    ``keep_msb[s]`` (default all-True): on a non-expanding stage, True halves
    with RoundHalfUp (keep MSBs — the chains' tested setting); False keeps the
    LSBs with wraparound overflow (``FFTParams.keepMSBorLSB``,
    ``RspChainVanillaTester.scala:214``). LSB stages also wrap the post-
    twiddle product back to the 16-bit proto (their unhalved 17-bit butterfly
    can overflow it; MSB stages cannot)."""
    if expand_logic is not None and sum(1 for e in expand_logic if e) > 7:
        # the split-product twiddle path is int32-exact while the grown data
        # stays within ~23 bits (partial products reach ~46341·2^(8.5+g));
        # beyond 7 expanding stages the exact pipeline needs 64-bit products
        raise ValueError("bit-true FFT supports at most 7 expanding stages")

    def _rhu15_wide(a, b, wa, wb):
        """``rhu(a·wa + b·wb, 15)`` exactly in int32 for data operands wider
        than 16 bits (EXPANDING stages skip the pre-twiddle trim, so the
        direct product a·wa overflows int32 from the first grown stage on):
        an 8-bit split of the data keeps every partial within int32, and the
        floor-shift recombination is exact —
        floor((H·2^8 + T)/2^15) = floor((H + floor(T/2^8))/2^7)."""
        al = a & 255
        ah = (a - al) >> 8
        bl = b & 255
        bh = (b - bl) >> 8
        h = ah * wa + bh * wb
        t = al * wa + bl * wb + (1 << 14)
        return (h + (t >> 8)) >> 7

    stages, rev = stage_twiddles(n)
    grown = 0   # expanding stages so far: the data width grows PERSISTENTLY
    for s, (wr_np, wi_np) in enumerate(stages):
        half = (n >> s) >> 1
        # butterfly via static rolls: a-lanes (bit clear) add their +half
        # partner; b-lanes subtract themselves from their -half partner
        iota = np.arange(n)
        b_lane = jnp.asarray((iota & half) != 0)
        add_r = xr + jnp.roll(xr, -half, axis=-1)
        add_i = xi + jnp.roll(xi, -half, axis=-1)
        sub_r = jnp.roll(xr, half, axis=-1) - xr
        sub_i = jnp.roll(xi, half, axis=-1) - xi
        sr = jnp.where(b_lane, sub_r, add_r)
        si = jnp.where(b_lane, sub_i, add_i)
        lsb_stage = False
        expanding = expand_logic is not None and expand_logic[s]
        if not expanding:
            if keep_msb is None or keep_msb[s]:
                sr, si = rhu(sr, 1), rhu(si, 1)  # keepMSB: halve pre-twiddle
            else:
                sr, si = wrap16(sr), wrap16(si)  # keepLSB: wraparound trim
                lsb_stage = True
        wr = jnp.asarray(wr_np)
        wi = jnp.asarray(wi_np)
        if expanding:
            grown += 1
        if grown:
            # expansion is PERSISTENT: once any stage has grown the data past
            # 16 bits, every later stage's direct int32 product can overflow
            # (a non-expanding trim removes one butterfly bit, not the
            # accumulated growth) — use the split-product path, bit-identical
            # to int64 arithmetic
            xr = _rhu15_wide(sr, si, wr, -wi)
            xi = _rhu15_wide(sr, si, wi, wr)
        else:
            xr = rhu(sr * wr - si * wi, 15)
            xi = rhu(sr * wi + si * wr, 15)
        if lsb_stage:
            xr, xi = wrap16(xr), wrap16(xi)
    rev_j = jnp.asarray(rev)
    return jnp.take(xr, rev_j, axis=-1), jnp.take(xi, rev_j, axis=-1)


def _fft_int_branch(x: C, n: int, cfg: FftConfig) -> C:
    xr = x.re.astype(jnp.int32)[..., :n]
    xi = x.im.astype(jnp.int32)[..., :n]
    el = cfg.expand_logic
    km = cfg.keep_msb_or_lsb
    yr, yi = _fft_int_fixed(xr, xi, n, None if el is None else tuple(el),
                            None if km is None else tuple(km))
    pad = x.shape[-1] - n
    if pad:
        cfgpad = [(0, 0)] * (yr.ndim - 1) + [(0, pad)]
        yr, yi = jnp.pad(yr, cfgpad), jnp.pad(yi, cfgpad)
    return C(yr, yi)


def fft_int_op(
    x: C,
    log2_fft_size: Optional[jnp.ndarray] = None,
    cfg: FftConfig = FftConfig(),
) -> C:
    """Runtime-sized integer FFT stage: same elaborate-max / runtime-register
    contract as ``fft_op`` (lax.switch over compiled log2 sizes), but every
    branch is the exact-arithmetic pipeline above. Input pair values must be
    16-bit integers (int32 or integer-valued float32)."""
    assert x.shape[-1] == cfg.max_size
    if not cfg.runtime_size or log2_fft_size is None:
        return _fft_int_branch(x, cfg.max_size, cfg)
    lo, hi = cfg.min_log2_size, cfg.log2_max
    branches = [functools.partial(_fft_int_branch, n=1 << p, cfg=cfg)
                for p in range(lo, hi + 1)]
    idx = jnp.clip(log2_fft_size - lo, 0, hi - lo)
    return jax.lax.switch(idx, branches, x)


def jpl_mag_int(re: jnp.ndarray, im: jnp.ndarray) -> jnp.ndarray:
    """Integer JPL magnitude (shift-add form, truncating shifts)."""
    ar, ai = jnp.abs(re), jnp.abs(im)
    u, v = jnp.maximum(ar, ai), jnp.minimum(ar, ai)
    return jnp.maximum(u + (v >> 3), u - (u >> 3) + (v >> 1))


def sqr_mag_int(re: jnp.ndarray, im: jnp.ndarray) -> jnp.ndarray:
    """Integer square magnitude re² + im² (``RspChainTesterUtils.scala:205-208``:
    ``(c.real*c.real + c.imag*c.imag).toInt``). Each square of 16-bit data fits
    int32 (≤ 2^30); their sum can exceed int32 by one bit at full scale —
    saturated to int32 max, matching Scala's ``Double.toInt`` clamp (the
    reference tester pre-scales inputs to avoid the overflow entirely)."""
    x1 = re * re
    x2 = im * im
    s = x1 + x2
    # both terms are >= 0 and the true sum is <= 2^31, so a wrapped (negative)
    # result can only mean overflow-by-one-bit
    return jnp.where(s < 0, jnp.int32(2**31 - 1), s)


def _isqrt32(x: jnp.ndarray) -> jnp.ndarray:
    """Exact integer floor(sqrt(x)) for int32 x ≥ 0: float32 seed (within ±1
    of the true root for x < 2^31) plus integer corrections. The compare
    ``s² > x`` is done as ``s > x // s`` so no intermediate overflows."""
    s = jnp.floor(jnp.sqrt(jnp.maximum(x, 0).astype(jnp.float32))).astype(jnp.int32)
    s = jnp.maximum(s, 1)
    for _ in range(2):
        s = jnp.where(s > x // s, s - 1, s)
        s = jnp.maximum(s, 1)
    for _ in range(2):
        nxt = s + 1
        s = jnp.where(nxt <= x // nxt, nxt, s)
    return jnp.where(x <= 0, 0, s)


def abs_mag_int(re: jnp.ndarray, im: jnp.ndarray) -> jnp.ndarray:
    """Integer magnitude floor(|re + j·im|) — the golden menu's default case
    (``RspChainTesterUtils.scala:214``: ``c.abs.toInt``), exact integer sqrt of
    the (saturating) square sum."""
    return _isqrt32(sqr_mag_int(re, im))


@functools.lru_cache(maxsize=None)
def _log2_frac_lut(width: int) -> np.ndarray:
    """Hardware-style fractional log2 LUT: entry k = floor(log2(1 + k·2^-W)·2^W)
    — the value the LUT ROM holds for mantissa bucket k (MAGParams.log2LookUpWidth,
    ``RspChain.scala:125``)."""
    k = np.arange(1 << width, dtype=np.float64)
    return np.floor(np.log2(1.0 + k / (1 << width)) * (1 << width)).astype(np.int32)


def log2_mag_int(re: jnp.ndarray, im: jnp.ndarray, cfg=None) -> jnp.ndarray:
    """Integer LUT log2 of the JPL magnitude on the protoLog grid
    (``RspChainTesterUtils.scala:209-211``; protoLog FixedPoint(16, 9.BP),
    ``RspChainVanillaTester.scala:222-224``).

    Contract (the LogMagMux submodule is not vendored — this is the documented
    integer arithmetic, mirrored index-wise by ``golden.int_models.
    int_log2_golden``): j = jplMag; e = floor(log2 j); mantissa bucket = top
    ``log2_lookup_width`` bits of j's fraction (truncated); output raw value
    on the 2^-bin_point_log grid = (e·2^L + LUT[bucket]) rescaled from the
    2^-L grid, clamped to the 16-bit proto; j = 0 clamps to the proto minimum
    (the golden's log2(0) = -inf)."""
    from ..configs import LogMagConfig

    cfg = cfg or LogMagConfig()
    L = cfg.log2_lookup_width
    B = cfg.bin_point_log
    j = jpl_mag_int(re, im)
    # e = floor(log2(j)) for j >= 1, via dyadic compares (no count-leading-zeros op in jnp)
    e = jnp.zeros_like(j)
    for k in range(1, 31):
        e = e + (j >= (1 << k)).astype(jnp.int32)
    # mantissa bucket: floor(j / 2^(e-L)) - 2^L (truncation IS the hardware's
    # dropped low mantissa bits); e < L shifts left exactly
    idx = jnp.where(e >= L, j >> jnp.maximum(e - L, 0),
                    j << jnp.maximum(L - e, 0)) - (1 << L)
    idx = jnp.clip(idx, 0, (1 << L) - 1)
    frac = jnp.take(jnp.asarray(_log2_frac_lut(L)), idx)
    raw_l = e * (1 << L) + frac
    raw_b = (raw_l >> (L - B)) if L >= B else (raw_l << (B - L))
    lo = -(1 << (cfg.data_width_log - 1))
    hi = (1 << (cfg.data_width_log - 1)) - 1
    return jnp.clip(jnp.where(j > 0, raw_b, lo), lo, hi)


def mag_int_op(x: C, mag_mode: jnp.ndarray, cfg=None) -> jnp.ndarray:
    """The full LogMagMux menu in integer arithmetic, runtime-muxed on the
    traced mode register like the float ``ops.logmag.logmag`` — closing the
    register the bit-true pipeline previously pinned to JPL
    (``RspChainTesterUtils.scala:197-216``)."""
    re = x.re.astype(jnp.int32)
    im = x.im.astype(jnp.int32)
    return jax.lax.switch(
        jnp.clip(mag_mode, 0, 3),
        [lambda _: abs_mag_int(re, im),
         lambda _: sqr_mag_int(re, im),
         lambda _: jpl_mag_int(re, im),
         lambda _: log2_mag_int(re, im, cfg)],
        None)


def _shift_params(cfg: CfarConfig):
    """Zero-pad width and dynamic-shift bit count from the ELABORATED maxima
    (a fixed 128/8-bit cap would silently drop high shift bits of large
    elaborations and take window sums from the wrong cells)."""
    max_shift = int(cfg.max_ref_window + cfg.max_guard_window)
    return max(128, max_shift + 1), max(8, max_shift.bit_length())


def _roll_dyn(xv, s, bits: int, left: bool = False):
    """Circular roll by traced ``s`` via bit-decomposed static rolls."""
    for k in range(bits):
        sh = -(1 << k) if left else (1 << k)
        xv = jnp.where(((s >> k) & 1) == 1, jnp.roll(xv, sh, axis=-1), xv)
    return xv


def _int_ca_sums(m, g, w, log2w, cfg: CfarConfig):
    """Integer lag/lead reference-window sums (undivided): zero-padded dyadic
    box ladder + runtime rotations — exact adds throughout."""
    n = m.shape[-1]
    padw, bits = _shift_params(cfg)
    z = jnp.zeros(m.shape[:-1] + (padw,), jnp.int32)
    row = jnp.concatenate([z, m, z], axis=-1)
    sel = row
    box = row
    for k in range(int(cfg.max_ref_window).bit_length() - 1):
        box = box + jnp.roll(box, 1 << k, axis=-1)
        sel = jnp.where(log2w == k + 1, box, sel)
    lag = _roll_dyn(sel, g + 1, bits)[..., padw : padw + n]
    lead = _roll_dyn(sel, g + w, bits, left=True)[..., padw : padw + n]
    return lag, lead


def _int_thr_peaks(mag, noise, rt: RuntimeConfig, active, n_active, cell):
    """Shared integer threshold + detection tail: 6-fractional-bit scaler
    (linear) / additive round (log domain), active-frame masking, optional
    local-maximum peak grouping."""
    scaler_q = jnp.round(rt.threshold_scaler * 64.0).astype(jnp.int32)
    thr_lin = rhu(noise * scaler_q, 6)
    thr_log = noise + jnp.round(rt.threshold_scaler).astype(jnp.int32)
    thr = jnp.where(rt.log_or_linear == 1, thr_lin, thr_log)
    thr = jnp.where(active, thr, 0)
    peaks = (mag > thr) & active

    big = jnp.int32(-(1 << 30))
    left_n = jnp.concatenate(
        [jnp.full(mag.shape[:-1] + (1,), big), mag[..., :-1]], -1)
    right_n = jnp.concatenate(
        [mag[..., 1:], jnp.full(mag.shape[:-1] + (1,), big)], -1)
    right_n = jnp.where(cell + 1 < n_active, right_n, big)
    grouped = peaks & (mag >= left_n) & (mag >= right_n)
    peaks = jnp.where(rt.peak_grouping == 1, grouped, peaks)
    return thr, peaks


def ca_cfar_int(
    mag: jnp.ndarray,
    rt: RuntimeConfig,
    cfg: CfarConfig = CfarConfig(),
) -> CfarOutput:
    """Integer CA/GO/SO CFAR with the exact hardware dividers: window sums by
    dyadic rolls (exact adds), per-side ``>> divSum``, threshold through the
    6-fractional-bit scaler. Peak grouping and active-frame masking follow
    ``cfar_op``. PARTIAL edges, CA family only (``cfar_int`` adds the
    GOS/GOSCA + CASH datapaths)."""
    mag = mag.astype(jnp.int32)
    n = mag.shape[-1]
    n_active = jnp.minimum(rt.cfar_fft_size, n).astype(jnp.int32)
    g = jnp.clip(rt.guard_window_size, 0, cfg.max_guard_window).astype(jnp.int32)
    w = jnp.minimum(rt.ref_window_size, cfg.max_ref_window).astype(jnp.int32)
    log2w = jnp.round(jnp.log2(jnp.maximum(w, 1).astype(jnp.float32))).astype(jnp.int32)

    cell = jnp.arange(n, dtype=jnp.int32)
    active = cell < n_active
    m = jnp.where(active, mag, 0)
    lag, lead = _int_ca_sums(m, g, w, log2w, cfg)
    div = rt.div_sum.astype(jnp.int32)
    s_lag = jnp.right_shift(lag, div)     # non-negative: truncating shifter
    s_lead = jnp.right_shift(lead, div)
    mode = rt.cfar_mode
    noise = jnp.where(
        mode == 1, jnp.maximum(s_lag, s_lead),
        jnp.where(mode == 2, jnp.minimum(s_lag, s_lead),
                  (s_lag + s_lead) >> 1))
    thr, peaks = _int_thr_peaks(mag, noise, rt, active, n_active, cell)
    return CfarOutput(threshold=thr, peaks=peaks)


def _int_windows(m, n_active, g, w, cfg: CfarConfig):
    """Roll-stacked integer per-cell windows: [..., Wmax, N] int32 with the
    window offset on axis -2 (the integer mirror of ``ops.cfar._windows_roll``,
    PARTIAL edges), plus validity masks [Wmax, N].
    ``win_lag[..., k, i] = m[i - g - w + k]``, valid iff k < w and the cell is
    inside [0, n_active)."""
    n = m.shape[-1]
    wmax = cfg.max_ref_window
    padw, bits = _shift_params(cfg)
    z = jnp.zeros(m.shape[:-1] + (padw,), jnp.int32)
    row = jnp.concatenate([z, m, z], axis=-1)

    lag_base = _roll_dyn(row, g + w, bits)              # [j] = row[j - g - w]
    lead_base = _roll_dyn(row, g + 1, bits, left=True)  # [j] = row[j + g + 1]
    lag = jnp.stack([jnp.roll(lag_base, -k, axis=-1) for k in range(wmax)],
                    axis=-2)[..., :, padw : padw + n]
    lead = jnp.stack([jnp.roll(lead_base, -k, axis=-1) for k in range(wmax)],
                     axis=-2)[..., :, padw : padw + n]
    kk = jnp.arange(wmax, dtype=jnp.int32)[:, None]
    ii = jnp.arange(n, dtype=jnp.int32)[None, :]
    lag_pos = ii - g - w + kk
    lead_pos = ii + g + 1 + kk
    lag_valid = (kk < w) & (lag_pos >= 0) & (lag_pos < n_active)
    lead_valid = (kk < w) & (lead_pos >= 0) & (lead_pos < n_active)
    return lag, lag_valid, lead, lead_valid


_INT_BIG = jnp.int32(2**31 - 1)


def _int_gos_side(win, valid, rank):
    """Integer rank select: k-th smallest valid window cell (rank registers
    base+9/+10, ``RspChainVanillaTester.scala:137-141``). Sorting integers is
    exact; invalid cells sort to int32 max; the rank clamps to the valid count
    like the float ``ops.cfar._gos_stats_roll``; empty side -> 0."""
    valid_b = jnp.broadcast_to(valid, win.shape)
    vals = jnp.where(valid_b, win, _INT_BIG)
    s = jnp.sort(vals, axis=-2)
    nv = jnp.sum(valid_b, axis=-2).astype(jnp.int32)
    idx = jnp.clip(jnp.minimum(rank, nv - 1), 0, s.shape[-2] - 1)
    kk = jnp.arange(s.shape[-2], dtype=jnp.int32)[:, None]
    got = jnp.sum(jnp.where(kk == idx[..., None, :], s, 0), axis=-2)
    return jnp.where(nv > 0, got, 0)


def _int_cash_side(win, valid, sub_w, wmax):
    """Integer CASH per-side statistic: min over sliding sub-window SUMS of
    exactly ``sub_w`` valid cells inside the reference window, divided once by
    ``sub_w`` with truncation (min commutes with the shared monotone division,
    so this is the float path's min-of-means with an integer divider — a
    hardware shifter when sub_w is a power of two). Empty -> 0."""
    valid_b = jnp.broadcast_to(valid, win.shape)
    v = jnp.where(valid_b, win, 0)
    zrow = jnp.zeros(v.shape[:-2] + (1,) + v.shape[-1:], jnp.int32)
    c = jnp.concatenate([zrow, jnp.cumsum(v, axis=-2)], axis=-2)
    cv = jnp.concatenate(
        [jnp.zeros(valid_b.shape[:-2] + (1,) + valid_b.shape[-1:], jnp.int32),
         jnp.cumsum(valid_b.astype(jnp.int32), axis=-2)], axis=-2)
    # c_sh[t] = c[t + sub_w] via a bit-decomposed roll on the window axis
    n_bits = max(int(wmax).bit_length(), 1)

    def roll_up(xv, s):
        for k in range(n_bits):
            xv = jnp.where(((s >> k) & 1) == 1,
                           jnp.roll(xv, -(1 << k), axis=-2), xv)
        return xv

    sub_sum = (roll_up(c, sub_w) - c)[..., :wmax, :]
    sub_cnt = (roll_up(cv, sub_w) - cv)[..., :wmax, :]
    tt = jnp.arange(wmax, dtype=jnp.int32)[:, None]
    ok = (sub_cnt == sub_w) & (tt + sub_w <= wmax)
    sums = jnp.where(ok, sub_sum, _INT_BIG)
    est = jnp.min(sums, axis=-2)
    found = jnp.any(ok, axis=-2)
    return jnp.where(found, est // jnp.maximum(sub_w, 1), 0)


def cfar_int(
    mag: jnp.ndarray,
    rt: RuntimeConfig,
    cfg: CfarConfig = CfarConfig(),
) -> CfarOutput:
    """Integer CFAR covering every elaborated variant: CA/GOS/GOSCA statistic
    datapaths with the runtime algorithm register selecting (base+5,
    ``RspChainVanillaTester.scala:124-132``), modes CA/GO/SO/CASH (base+6),
    GOS rank registers, CASH sub-window register — the integer mirror of
    ``ops.cfar.cfar_op``'s register semantics with ``ca_cfar_int``'s exact
    hardware arithmetic (truncating shifters, 6-fractional-bit scaler).
    The reference's shipped ``RspChainVanilla`` elaborates GOSCA + CASH in
    integer fixed point (``RspChain.scala:118,130-140``); this closes bit-true
    wire-word parity for those modes. PARTIAL edges."""
    from ..configs import CfarVariant

    has_gos = cfg.variant in (CfarVariant.GOS, CfarVariant.GOSCA)
    has_cash = cfg.include_cash
    if not has_gos and not has_cash:
        return ca_cfar_int(mag, rt, cfg)

    mag = mag.astype(jnp.int32)
    n = mag.shape[-1]
    n_active = jnp.minimum(rt.cfar_fft_size, n).astype(jnp.int32)
    g = jnp.clip(rt.guard_window_size, 0, cfg.max_guard_window).astype(jnp.int32)
    w = jnp.minimum(rt.ref_window_size, cfg.max_ref_window).astype(jnp.int32)
    log2w = jnp.round(jnp.log2(jnp.maximum(w, 1).astype(jnp.float32))).astype(jnp.int32)

    cell = jnp.arange(n, dtype=jnp.int32)
    active = cell < n_active
    m = jnp.where(active, mag, 0)

    lag, lead = _int_ca_sums(m, g, w, log2w, cfg)
    div = rt.div_sum.astype(jnp.int32)
    ca_lag = jnp.right_shift(lag, div)
    ca_lead = jnp.right_shift(lead, div)

    lag_win, lag_valid, lead_win, lead_valid = _int_windows(m, n_active, g, w, cfg)

    if has_gos:
        os_lag = _int_gos_side(lag_win, lag_valid, rt.index_lagg)
        os_lead = _int_gos_side(lead_win, lead_valid, rt.index_lead)
    else:
        os_lag = os_lead = jnp.zeros_like(m)

    if cfg.variant is CfarVariant.GOSCA:
        use_gos = rt.cfar_algorithm == 1
        s_lag = jnp.where(use_gos, os_lag, ca_lag)
        s_lead = jnp.where(use_gos, os_lead, ca_lead)
    elif cfg.variant is CfarVariant.GOS:
        s_lag, s_lead = os_lag, os_lead
    else:
        s_lag, s_lead = ca_lag, ca_lead

    mode = rt.cfar_mode
    noise = jnp.where(
        mode == 1, jnp.maximum(s_lag, s_lead),
        jnp.where(mode == 2, jnp.minimum(s_lag, s_lead),
                  (s_lag + s_lead) >> 1))
    if has_cash:
        sw = jnp.clip(rt.sub_window_size, cfg.min_sub_window,
                      cfg.max_ref_window).astype(jnp.int32)
        est_lag = _int_cash_side(lag_win, lag_valid, sw, cfg.max_ref_window)
        est_lead = _int_cash_side(lead_win, lead_valid, sw, cfg.max_ref_window)
        noise = jnp.where(mode == 3, jnp.maximum(est_lag, est_lead), noise)

    thr, peaks = _int_thr_peaks(mag, noise, rt, active, n_active, cell)
    return CfarOutput(threshold=thr, peaks=peaks)
