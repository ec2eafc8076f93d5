"""Golden models (pure numpy, float64) — the analog of the reference's Breeze-based
goldens in ``src/test/scala/RspChainTesterUtils.scala:120-216``.

Every op in ``rsp_chains.ops`` has a golden here; tests hard-assert against them
(improving on the reference's dump-only testers, SURVEY §4)."""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# magnitude goldens (RspChainTesterUtils.scala:120-127, 197-216)
# ---------------------------------------------------------------------------


def jpl_mag(x: np.ndarray) -> np.ndarray:
    """JPL magnitude approximation: max(u + v/8, 7u/8 + v/2) with
    u = max(|re|,|im|), v = min(|re|,|im|) (``RspChainTesterUtils.scala:120-127``)."""
    u = np.maximum(np.abs(x.real), np.abs(x.imag))
    v = np.minimum(np.abs(x.real), np.abs(x.imag))
    return np.maximum(u + v / 8.0, 7.0 * u / 8.0 + v / 2.0)


def sqr_mag(x: np.ndarray) -> np.ndarray:
    """Squared magnitude (``RspChainTesterUtils.scala:205-207``)."""
    return x.real**2 + x.imag**2


def log2_mag(x: np.ndarray) -> np.ndarray:
    """log2 of the JPL magnitude (``RspChainTesterUtils.scala:209-211``)."""
    j = jpl_mag(x)
    return np.log2(np.maximum(j, np.finfo(np.float64).tiny))


def abs_mag(x: np.ndarray) -> np.ndarray:
    return np.abs(x)


MAG_GOLDENS = {0: abs_mag, 1: sqr_mag, 2: jpl_mag, 3: log2_mag}


# ---------------------------------------------------------------------------
# FFT golden (Breeze fourierTr + /N scaling, FftMagCfarChainTester.scala:77)
# ---------------------------------------------------------------------------


def fft_golden(x: np.ndarray, n: int | None = None, scaling: str = "div_n") -> np.ndarray:
    """DFT along the last axis with the reference's scaling convention
    (tester golden divides by fftSize, ``FftMagCfarChainTester.scala:77``)."""
    n = n if n is not None else x.shape[-1]
    y = np.fft.fft(x[..., :n], n=n, axis=-1)
    if scaling == "div_n":
        y = y / n
    elif scaling == "sqrt_n":
        y = y / np.sqrt(n)
    elif scaling != "none":
        raise ValueError(scaling)
    return y


# ---------------------------------------------------------------------------
# NCO golden (RspChainTesterUtils.scala:174-181)
# ---------------------------------------------------------------------------


def nco_golden(num_samples: int, bin_with_peak: int, fft_size: int,
               amplitude: float = 2**14) -> np.ndarray:
    """Expected NCO output: Complex(cos, sin) at relative frequency
    bin/fftSize, scaled to +/-2^14, sampled at i = 1..numSamples (the reference's
    golden starts at i=1: ``RspChainTesterUtils.scala:177-178``)."""
    i = np.arange(1, num_samples + 1, dtype=np.float64)
    ph = 2.0 * np.pi * bin_with_peak / fft_size * i
    return np.trunc(amplitude * np.cos(ph)).astype(np.float64) + 1j * np.trunc(
        amplitude * np.sin(ph)
    )


# ---------------------------------------------------------------------------
# CFAR golden — all variants/modes (register semantics: SURVEY §2.5)
# ---------------------------------------------------------------------------


def cfar_golden(
    mag: np.ndarray,
    *,
    ref_window: int,
    guard_window: int,
    threshold_scaler: float,
    mode: int = 0,            # 0 CA / 1 GO / 2 SO / 3 CASH
    algorithm: int = 0,       # 0 CA-family / 1 GOS
    div_sum: int | None = None,
    index_lagg: int | None = None,
    index_lead: int | None = None,
    sub_window: int | None = None,
    log_or_linear: int = 1,   # 1 linear (multiply), 0 log (add)
    peak_grouping: int = 0,
    edge_policy: str = "partial",
):
    """Reference-model sliding-window CFAR over the last axis.

    Returns (threshold, peaks) float/bool arrays of the same shape as ``mag``.

    Semantics reconstructed from the register map and runtime constraints
    (``RspChainVanillaTester.scala:35-62,100-146``); CASH sub-window statistic is the
    minimum sliding sub-window mean over each side's reference cells [inferred —
    submodule not vendored], lead/lagg combined per the CA/GO/SO mode registers.
    """
    mag = np.asarray(mag, np.float64)
    if mag.ndim > 1:
        flat = mag.reshape(-1, mag.shape[-1])
        outs = [cfar_golden(
            row, ref_window=ref_window, guard_window=guard_window,
            threshold_scaler=threshold_scaler, mode=mode, algorithm=algorithm,
            div_sum=div_sum, index_lagg=index_lagg, index_lead=index_lead,
            sub_window=sub_window, log_or_linear=log_or_linear,
            peak_grouping=peak_grouping, edge_policy=edge_policy,
        ) for row in flat]
        thr = np.stack([o[0] for o in outs]).reshape(mag.shape)
        pk = np.stack([o[1] for o in outs]).reshape(mag.shape)
        return thr, pk

    n = mag.shape[0]
    w, g = int(ref_window), int(guard_window)
    if div_sum is None:
        div_sum = int(np.log2(w))
    thr = np.zeros(n)
    for i in range(n):
        lag_lo, lag_hi = i - g - w, i - g          # [lag_lo, lag_hi) cells
        lead_lo, lead_hi = i + g + 1, i + g + 1 + w
        if edge_policy == "partial":
            lag = mag[max(lag_lo, 0):max(lag_hi, 0)]
            lead = mag[min(lead_lo, n):min(lead_hi, n)]
        elif edge_policy == "wrap":
            lag = mag[(np.arange(lag_lo, lag_hi)) % n]
            lead = mag[(np.arange(lead_lo, lead_hi)) % n]
        elif edge_policy == "reflect":
            def refl(idx):
                period = max(2 * n - 2, 1)
                m = np.mod(idx, period)
                return np.where(m < n, m, period - m)
            lag = mag[refl(np.arange(lag_lo, lag_hi))]
            lead = mag[refl(np.arange(lead_lo, lead_hi))]
        else:
            raise ValueError(edge_policy)

        if mode == 3:  # CASH
            sw = int(sub_window)
            def cash_side(side):
                if len(side) < sw:
                    return np.inf
                sums = np.convolve(side, np.ones(sw), mode="valid")
                return np.min(sums) / sw
            est_lag, est_lead = cash_side(lag), cash_side(lead)
            est_lag = 0.0 if not np.isfinite(est_lag) else est_lag
            est_lead = 0.0 if not np.isfinite(est_lead) else est_lead
            noise = max(est_lag, est_lead)
        elif algorithm == 1:  # GOS rank-order statistics
            kl = int(index_lagg) if index_lagg is not None else w // 2
            ke = int(index_lead) if index_lead is not None else w // 2
            sl = np.sort(lag) if len(lag) else np.array([0.0])
            se = np.sort(lead) if len(lead) else np.array([0.0])
            ol = sl[min(kl, len(sl) - 1)]
            oe = se[min(ke, len(se) - 1)]
            noise = {0: (ol + oe) / 2.0, 1: max(ol, oe), 2: min(ol, oe)}[mode]
        else:  # CA family: sums divided by power-of-2 shifts (div_sum register)
            s_lag = lag.sum() / (2.0**div_sum)
            s_lead = lead.sum() / (2.0**div_sum)
            noise = {
                0: (s_lag + s_lead) / 2.0,
                1: max(s_lag, s_lead),
                2: min(s_lag, s_lead),
            }[mode]

        if log_or_linear == 1:
            thr[i] = noise * threshold_scaler
        else:
            thr[i] = noise + threshold_scaler

    peaks = mag > thr
    if peak_grouping:
        left = np.roll(mag, 1); left[0] = -np.inf
        right = np.roll(mag, -1); right[-1] = -np.inf
        peaks = peaks & (mag >= left) & (mag >= right)
    return thr, peaks


# ---------------------------------------------------------------------------
# matched filter + range-Doppler goldens (BASELINE configs 2-3)
# ---------------------------------------------------------------------------


def matched_filter_golden(x: np.ndarray, taps: np.ndarray, mode: str = "circular") -> np.ndarray:
    """Pulse compression along the last axis: correlation of x with the reference
    pulse (= convolution with conj(time-reversed taps))."""
    n = x.shape[-1]
    h = np.conj(taps)[::-1]
    if mode == "circular":
        Nf = n
        X = np.fft.fft(x, n=Nf, axis=-1)
        H = np.fft.fft(np.conj(taps), n=Nf)
        return np.fft.ifft(X * np.conj(np.fft.fft(taps, n=Nf)), axis=-1)
    if mode == "full":
        return np.apply_along_axis(lambda r: np.convolve(r, h, mode="full"), -1, x)
    if mode == "same":
        return np.apply_along_axis(lambda r: np.convolve(r, h, mode="same"), -1, x)
    if mode == "valid":
        return np.apply_along_axis(lambda r: np.convolve(r, h, mode="valid"), -1, x)
    raise ValueError(mode)


def range_doppler_golden(
    cpi: np.ndarray, *, range_scaling: str = "div_n",
    doppler_window: np.ndarray | None = None, fft_shift: bool = True,
    doppler_scaling: str = "div_n", matched_taps: np.ndarray | None = None,
) -> np.ndarray:
    """2-D range-Doppler map golden: range FFT over the last (fast-time) axis then
    Doppler FFT over the pulse axis (axis -2). With ``matched_taps`` the range
    stage is instead the circular matched filter normalized by the replica's
    energy (``range_doppler_chain``'s pulse compression; ``range_scaling`` is
    then unused)."""
    if matched_taps is None:
        rng = fft_golden(cpi, scaling=range_scaling)
    else:
        taps = np.asarray(matched_taps)
        rng = (matched_filter_golden(cpi, taps, "circular")
               / np.sqrt(np.sum(np.abs(taps) ** 2)))
    if doppler_window is not None:
        rng = rng * doppler_window[..., :, None]
    dop = np.fft.fft(rng, axis=-2)
    if doppler_scaling == "div_n":
        dop = dop / rng.shape[-2]
    elif doppler_scaling == "sqrt_n":
        dop = dop / np.sqrt(rng.shape[-2])
    if fft_shift:
        dop = np.fft.fftshift(dop, axes=-2)
    return dop


def cfar_2d_golden(mag: np.ndarray, *, ref_range: int, guard_range: int,
                   ref_doppler: int, guard_doppler: int,
                   threshold_scaler: float, log_or_linear: int = 1,
                   peak_grouping: int = 0, active_range: int | None = None,
                   algorithm: int = 0, os_rank: int = 0):
    """Index-wise 2-D CFAR golden (rectangular annulus, PARTIAL edges;
    mirrors ``ops.cfar_2d.cfar_2d_op``). ``algorithm`` 0 = CA
    (count-normalized mean), 1 = OS (``os_rank``-th smallest training cell,
    0-based, clamped to the valid count like the 1-D GOS golden). ``mag``:
    [P, N] (Doppler, range). Deliberately a literal double loop — not the
    op's roll/vector formulation — so equality is a real cross-check."""
    mag = np.asarray(mag, np.float64)
    p, n = mag.shape
    n_act = n if active_range is None else min(active_range, n)
    a_d, a_r = guard_doppler + ref_doppler, guard_range + ref_range
    thr = np.zeros((p, n))
    pk = np.zeros((p, n), bool)
    for d in range(p):
        for r in range(n_act):
            cells = []
            for dd in range(d - a_d, d + a_d + 1):
                for rr in range(r - a_r, r + a_r + 1):
                    if not (0 <= dd < p and 0 <= rr < n_act):
                        continue
                    if (abs(dd - d) <= guard_doppler
                            and abs(rr - r) <= guard_range):
                        continue
                    cells.append(mag[dd, rr])
            c = len(cells)
            if algorithm == 1:
                noise = sorted(cells)[min(os_rank, c - 1)] if c else 0.0
            else:
                noise = sum(cells) / max(c, 1)
            t = noise * threshold_scaler if log_or_linear == 1 \
                else noise + threshold_scaler
            thr[d, r] = t
            pk[d, r] = mag[d, r] > t
    if peak_grouping:
        keep = pk.copy()
        for d in range(p):
            for r in range(n_act):
                ok = True
                for dd in (-1, 0, 1):
                    for rr in (-1, 0, 1):
                        if dd == 0 and rr == 0:
                            continue
                        di, ri = d + dd, r + rr
                        if 0 <= di < p and 0 <= ri < n_act \
                                and mag[di, ri] > mag[d, r]:
                            ok = False
                keep[d, r] = pk[d, r] and ok
        pk = keep
    return thr, pk
