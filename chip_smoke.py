"""Smoke proof that the radar chains run on an NVIDIA GPU.

Drives every preset once through its public entry point (``presets`` ->
``Chain.jit()``, the wire chain also through ``io.StreamingPipeline`` and
``io.server``) at deployment size on one card, and compares each with the
numpy float64 references in ``rsp_chains.golden``, which share no code with
the chains. Prints one line per phase; its times are smoke readings (median of
a few blocked calls), not benchmarks.

    python chip_smoke.py              # every single-card phase
    python chip_smoke.py --cards 4    # only the sharded paths, 2 ch x 2 rng
    python chip_smoke.py --trace DIR  # also one profiler trace per phase

The last line of stdout is ``{"ok": true, "device": {...}}``, printed only
when every phase passed. Off the GPU the script exits non-zero before any
phase runs. One process drives the card(s): a second JAX process on the same
card would fail for want of memory.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import threading
import time

import numpy as np

import rsp_chains as rsp
from rsp_chains import golden, packing
from rsp_chains.cplx import C
from rsp_chains.golden import int_models
from rsp_chains.utils.device import (
    card_description, enable_compile_cache, require_gpu,
)

# float phases: max |thr - thr_golden| over the threshold scale, and peak
# flips per compared cell (float32 on the card vs float64 golden)
FLOAT_THR_BAR = 1e-4
FLOAT_FLIP_BAR = 1e-5
# wire phases: the packed threshold field is the integer-truncated threshold,
# so a float rounding difference can move it across an integer boundary
WIRE_MAX_LSB = 2.0
WIRE_MEAN_LSB = 0.05
SMOKE_CALLS = 5
# share of the card's allocator limit a phase's compiled footprint may take
FIT_SHARE = 0.9

N = 1024          # range cells per frame
PULSES = 256      # frames per channel (pulses of a CPI)
RT_CA = dict(fft_size=N, ref_window_size=32, guard_window_size=4,
             threshold_scaler=3.5, div_sum=5)
RT_GOS = dict(RT_CA, cfar_algorithm=1, index_lagg=16, index_lead=16)


class PhaseFailed(AssertionError):
    """A phase's output missed its bar against the reference."""


# ---------------------------------------------------------------------------
# comparison with the references, and the bars
# ---------------------------------------------------------------------------


def float_errors(thr, pk, thr_ref, pk_ref) -> dict:
    """Threshold error relative to the reference's threshold scale, and peak
    flips, of a float phase."""
    thr = np.asarray(thr, np.float64)
    thr_ref = np.asarray(thr_ref, np.float64)
    scale = max(float(np.max(np.abs(thr_ref))), 1e-30)
    return {"dthr": float(np.max(np.abs(thr - thr_ref))) / scale,
            "flips": int(np.sum(np.asarray(pk) != np.asarray(pk_ref))),
            "cells": int(np.asarray(pk_ref).size),
            "detections": int(np.sum(pk_ref))}


def check_float(errs: dict) -> None:
    if not errs["dthr"] <= FLOAT_THR_BAR:
        raise PhaseFailed(f"threshold error {errs['dthr']:.3e} > "
                          f"{FLOAT_THR_BAR:g} of the threshold scale")
    if errs["flips"] > FLOAT_FLIP_BAR * errs["cells"]:
        raise PhaseFailed(f"{errs['flips']} peak flips in {errs['cells']} "
                          f"cells > {FLOAT_FLIP_BAR:g}")
    if errs["detections"] == 0:
        raise PhaseFailed("the reference detects nothing: the comparison "
                          "proves nothing")


def exact_errors(thr, pk, thr_ref, pk_ref) -> dict:
    """Largest threshold difference and peak flips of a bit-true phase."""
    d = np.abs(np.asarray(thr, np.int64) - np.asarray(thr_ref, np.int64))
    return {"dthr": int(d.max()),
            "flips": int(np.sum(np.asarray(pk) != np.asarray(pk_ref))),
            "cells": int(np.asarray(pk_ref).size),
            "detections": int(np.sum(pk_ref))}


def check_exact(errs: dict) -> None:
    if errs["dthr"] != 0 or errs["flips"] != 0:
        raise PhaseFailed(f"not bit-exact: threshold difference "
                          f"{errs['dthr']}, {errs['flips']} peak flips")
    if errs["detections"] == 0:
        raise PhaseFailed("the reference detects nothing")


def wire_errors(words, thr_ref, pk_ref, log2n: int) -> dict:
    """Packed CFAR words vs the float reference: threshold-field error in
    LSBs (max and mean) and peak flips."""
    thr_f, _, pk_f = packing.unpack_cfar_words(np.asarray(words), log2n)
    top = float((1 << (31 - log2n)) - 1)
    ref_i = np.floor(np.clip(np.asarray(thr_ref, np.float64), 0.0, top))
    err = np.abs(ref_i - thr_f.astype(np.float64))
    return {"max_lsb": float(err.max()), "mean_lsb": float(err.mean()),
            "flips": int(np.sum(pk_f.astype(bool) != np.asarray(pk_ref))),
            "cells": int(np.asarray(pk_ref).size),
            "detections": int(np.sum(pk_ref))}


def check_wire(errs: dict) -> None:
    if errs["max_lsb"] > WIRE_MAX_LSB or errs["mean_lsb"] > WIRE_MEAN_LSB:
        raise PhaseFailed(f"threshold field off by {errs['max_lsb']} LSB max, "
                          f"{errs['mean_lsb']:.4f} LSB mean")
    if errs["flips"] > FLOAT_FLIP_BAR * errs["cells"]:
        raise PhaseFailed(f"{errs['flips']} peak flips in {errs['cells']}")
    if errs["detections"] == 0:
        raise PhaseFailed("the reference detects nothing")


def footprint(compiled) -> int:
    """Device bytes a compiled executable needs: arguments, outputs and
    XLA's temporaries."""
    m = compiled.memory_analysis()
    return int(m.argument_size_in_bytes + m.output_size_in_bytes
               + m.temp_size_in_bytes)


def fit_channels(compile_at, limit_bytes: int, want: int = 64):
    """The largest power-of-two channel count <= ``want`` whose compiled
    footprint fits ``FIT_SHARE`` of the card, and its executable.
    ``compile_at(c)`` compiles the phase for ``c`` channels. Footprints grow
    about linearly in channels, so each miss jumps to the count that the
    measured footprint predicts will fit."""
    budget = FIT_SHARE * limit_bytes
    c = want
    while c >= 1:
        compiled = compile_at(c)
        need = footprint(compiled)
        if need <= budget:
            return c, compiled
        guess = int(c * budget / need)
        c = min(c // 2, 1 << max(guess.bit_length() - 1, 0)) if guess else 0
    raise PhaseFailed(f"not even one channel fits {budget / 2**30:.1f} GiB")


# ---------------------------------------------------------------------------
# inputs and references
# ---------------------------------------------------------------------------


def tone_frames(rng, shape, n=N, scale=1.0):
    """Complex-normal noise plus three tones at bins N/8, N/4, N/2 (the
    reference's three-tone test frame), as float32 (re, im) host arrays."""
    t = np.arange(n)
    tones = sum(a * np.exp(2j * np.pi * b * t / n)
                for b, a in ((n // 8, 6.0), (n // 4, 4.0), (n // 2, 3.0)))
    re = rng.standard_normal(shape + (n,), np.float32)
    im = rng.standard_normal(shape + (n,), np.float32)
    re += tones.real.astype(np.float32)
    im += tones.imag.astype(np.float32)
    if scale != 1.0:
        re = np.clip(np.round(re * scale), -32767, 32767)
        im = np.clip(np.round(im * scale), -32767, 32767)
    return re, im


def pack_words(re, im):
    """Integer-valued IQ -> 32-bit beat words (real in [31:16]) on the host."""
    r = re.astype(np.int16).view(np.uint16).astype(np.uint32)
    i = im.astype(np.int16).view(np.uint16).astype(np.uint32)
    return (r << 16) | i


def frames_of(a, sel):
    """Rows ``sel`` of ``a`` viewed as [frames, N]."""
    return np.asarray(a).reshape(-1, a.shape[-1])[sel]


def golden_ca_chain(x, rt: dict, algorithm=0):
    """fft_golden -> jpl_mag -> cfar_golden on complex frames [F, N]."""
    mag = golden.jpl_mag(golden.fft_golden(x))
    return golden.cfar_golden(
        mag, ref_window=rt["ref_window_size"],
        guard_window=rt["guard_window_size"],
        threshold_scaler=rt["threshold_scaler"], div_sum=rt.get("div_sum"),
        algorithm=algorithm, index_lagg=rt.get("index_lagg"),
        index_lead=rt.get("index_lead"))


def golden_int_chain(re, im, rt: dict, gosca: bool):
    """int_fft_golden -> int_jpl_golden -> integer CFAR golden per frame."""
    gr, gi = int_models.int_fft_golden(re, im)
    mag = int_models.int_jpl_golden(gr, gi)
    thr = np.zeros_like(mag)
    pk = np.zeros(mag.shape, bool)
    for f in range(mag.shape[0]):
        if gosca:
            thr[f], pk[f] = int_models.int_gosca_cfar_golden(
                mag[f], ref_window=rt["ref_window_size"],
                guard_window=rt["guard_window_size"], div_sum=rt["div_sum"],
                threshold_scaler=rt["threshold_scaler"], wmax=64,
                algorithm=rt["cfar_algorithm"], rank_lagg=rt["index_lagg"],
                rank_lead=rt["index_lead"],
                sub_window=max(2, rt["ref_window_size"] // 4))
        else:
            thr[f], pk[f] = int_models.int_ca_cfar_golden(
                mag[f], ref_window=rt["ref_window_size"],
                guard_window=rt["guard_window_size"], div_sum=rt["div_sum"],
                threshold_scaler=rt["threshold_scaler"])
    return thr, pk


# targets of the range-Doppler CPIs: (delay, amplitude, Doppler in cycles per
# pulse); the Dopplers fall on whole bins, so each target lights one row
TARGETS = ((N // 4, 1.0, 0.125), (N // 2, 0.5, -0.25), (3 * N // 4, 0.7, 0.3125))
TARGET_ROWS = tuple(PULSES // 2 + int(fd * PULSES) for _, _, fd in TARGETS)


def rd_inputs(rng, ch, taps):
    """CPIs [ch, PULSES, N]: complex-normal noise (std 0.05) plus delayed,
    Doppler-shifted copies of the LFM replica (``TARGETS``)."""
    cpi = golden.chirp_with_targets(PULSES, N, taps, list(TARGETS),
                                    noise_db=-300)
    re = rng.standard_normal((ch, PULSES, N), np.float32) * 0.05
    im = rng.standard_normal((ch, PULSES, N), np.float32) * 0.05
    re += cpi.real.astype(np.float32)
    im += cpi.imag.astype(np.float32)
    return re, im


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


class Smoke:
    """Runs the phases on ``jax.devices()[0]`` and prints one line each."""

    def __init__(self, trace_dir=None):
        import jax

        self.jax = jax
        self.dev = jax.devices()[0]
        self.limit = int(self.dev.memory_stats()["bytes_limit"])
        self.trace_dir = trace_dir
        self.rng = np.random.default_rng(20240611)

    # -- helpers -------------------------------------------------------------

    def compile(self, jitted, *args):
        t0 = time.perf_counter()
        compiled = jitted.lower(*args).compile()
        return compiled, time.perf_counter() - t0

    def smoke_ms(self, fn, *args) -> float:
        ts = []
        for _ in range(SMOKE_CALLS):
            t0 = time.perf_counter()
            self.jax.block_until_ready(fn(*args))
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts)) * 1e3

    def stage_ms(self, name, compiled, stages, *args):
        """Device ms per stage of one traced call (``--trace`` only)."""
        if self.trace_dir is None:
            return None
        from rsp_chains.utils import profiling

        d = os.path.join(self.trace_dir, name)
        with profiling.trace(d):
            self.jax.block_until_ready(compiled(*args))
        per, kernels, busy, window = profiling.device_time_by_stage(
            profiling.xplane_file(d), stages,
            profiling.hlo_op_names(compiled.as_text()))
        out = {k: round(v * 1e3, 4) for k, v in sorted(per.items())}
        out["device_busy"] = round(busy * 1e3, 4)
        out["trace_window"] = round(window * 1e3, 4)
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:4]
        out["top_kernels"] = {k[:60]: round(v * 1e3, 4) for k, v in top}
        return out

    def report(self, name, shape, compile_s, ms, errs, compiled, extra=None,
               stage_ms=None):
        rec = {"phase": name, "shape": "x".join(map(str, shape)),
               "compile_s": round(compile_s, 2),
               "smoke_median_ms": round(ms, 3),
               "errors": errs,
               "footprint_gib": round(footprint(compiled) / 2**30, 3),
               "peak_bytes_in_use": int(
                   self.dev.memory_stats()["peak_bytes_in_use"])}
        if extra:
            rec.update(extra)
        if stage_ms is not None:
            rec["stage_device_ms"] = stage_ms
        print("phase " + json.dumps(rec), flush=True)

    def device_pair(self, re, im):
        return C(self.jax.device_put(re), self.jax.device_put(im))

    # -- float chains --------------------------------------------------------

    def float_chain(self, name, cfg, rt_kw, algorithm, channels):
        jax = self.jax
        chain = rsp.fft_mag_cfar_chain(cfg)
        rt = rsp.RuntimeConfig.make(**rt_kw)

        def compile_at(c):
            spec = jax.ShapeDtypeStruct((c, PULSES, N), np.float32)
            return self.compile(chain.jit(), C(spec, spec), rt)[0]

        t0 = time.perf_counter()
        if channels is None:
            channels, compiled = fit_channels(compile_at, self.limit)
        else:
            compiled = compile_at(channels)
        compile_s = time.perf_counter() - t0
        re, im = tone_frames(self.rng, (channels, PULSES))
        x = self.device_pair(re, im)
        out = compiled(x, rt)
        sel = np.linspace(0, channels * PULSES - 1, 256).astype(int)
        ref = golden_ca_chain(frames_of(re, sel) + 1j * frames_of(im, sel),
                              rt_kw, algorithm)
        errs = float_errors(frames_of(out.threshold, sel),
                            frames_of(out.peaks, sel), *ref)
        check_float(errs)
        ms = self.smoke_ms(compiled, x, rt)
        self.report(name, (channels, PULSES, N), compile_s, ms, errs, compiled,
                    {"compared_frames": len(sel)},
                    self.stage_ms(name, compiled, chain.stage_names, x, rt))

    def ca_chain(self):
        cfg = rsp.ChainConfig(cfar=rsp.CfarConfig(
            max_ref_window=64, variant=rsp.CfarVariant.CA, include_cash=False))
        self.float_chain("ca_chain", cfg, RT_CA, 0, channels=64)

    def gos_chain(self):
        cfg = rsp.ChainConfig(cfar=rsp.CfarConfig(
            max_ref_window=64, variant=rsp.CfarVariant.GOSCA,
            include_cash=True))
        self.float_chain("gos_chain", cfg, RT_GOS, 1, channels=None)

    # -- wire format through the serving stack -------------------------------

    def wire_serving(self):
        jax = self.jax
        from rsp_chains.io.server import ChainServer, request_frames
        from rsp_chains.io.stream import StreamingPipeline

        ch, n_cpi, log2n = 16, 8, int(np.log2(N))
        cfg = rsp.ChainConfig(cfar=rsp.CfarConfig(
            max_ref_window=64, variant=rsp.CfarVariant.CA, include_cash=False))
        rt = rsp.RuntimeConfig.make(**RT_CA)
        wire = rsp.rx_fft_mag_cfar_tx_chain(cfg)
        spec = jax.ShapeDtypeStruct((ch, PULSES, N), np.uint32)
        compiled, compile_s = self.compile(wire.jit(), spec, rt)

        cpis, refs = [], []
        sel = np.linspace(0, ch * PULSES - 1, 32).astype(int)
        for _ in range(n_cpi):
            re, im = tone_frames(self.rng, (ch, PULSES), scale=250.0)
            cpis.append(pack_words(re, im))
            refs.append(golden_ca_chain(
                frames_of(re, sel) + 1j * frames_of(im, sel), RT_CA))

        results, done = {}, threading.Event()

        def on_result(seq, out, metrics):
            results[seq] = frames_of(out, sel)
            if len(results) == n_cpi:
                done.set()

        pipe = StreamingPipeline(compiled, rt, depth=4, on_result=on_result)
        t0 = time.perf_counter()
        with pipe:
            for k, words in enumerate(cpis):
                pipe.submit(k, words)
            done.wait(timeout=300)
        wall = time.perf_counter() - t0
        if len(results) != n_cpi or pipe.stats.frames_failed:
            raise PhaseFailed(f"stream delivered {len(results)}/{n_cpi} CPIs, "
                              f"{pipe.stats.frames_failed} failed")
        got = np.concatenate([results[k] for k in range(n_cpi)])
        thr_ref = np.concatenate([r[0] for r in refs])
        pk_ref = np.concatenate([r[1] for r in refs])
        errs = wire_errors(got, thr_ref, pk_ref, log2n)
        check_wire(errs)

        # the TCP server: framed single-frame requests from an in-process
        # client; the server packs the CfarOutput of the float chain itself
        chain_s = rsp.fft_mag_cfar_chain(cfg)
        fspec = jax.ShapeDtypeStruct((1, N), np.float32)
        compiled_s, _ = self.compile(chain_s.jit(), C(fspec, fspec), rt)
        re, im = tone_frames(self.rng, (4,), scale=250.0)
        with ChainServer(compiled_s, rt, frame_len=N, log2_fft_size=log2n,
                         cfar_cfg=cfg.cfar) as srv:
            replies = request_frames("127.0.0.1", srv.port,
                                     list(re + 1j * im), timeout=120)
        if len(replies) != 4:
            raise PhaseFailed(f"server answered {len(replies)}/4 requests")
        replies = sorted(replies, key=lambda f: f.seq)
        ref = golden_ca_chain(re + 1j * im, RT_CA)
        srv_errs = wire_errors(np.stack([f.words for f in replies]), *ref,
                               log2n)
        check_wire(srv_errs)

        x = jax.device_put(cpis[0])
        ms = self.smoke_ms(compiled, x, rt)
        self.report("wire_serving", (ch, PULSES, N), compile_s, ms, errs,
                    compiled,
                    {"stream_cpis": n_cpi,
                     "stream_wall_ms_per_cpi": round(wall / n_cpi * 1e3, 3),
                     "stream_phase_ms": pipe.stats.phase_ms_per_cpi(),
                     "server_requests": len(replies),
                     "server_errors": srv_errs},
                    self.stage_ms("wire_serving", compiled, wire.stage_names,
                                  x, rt))

    # -- bit-true integer chains ---------------------------------------------

    def bit_true(self, name, cfar, rt_kw, gosca, channels):
        jax = self.jax
        cfg = rsp.ChainConfig(cfar=cfar, fixed_point=rsp.FixedPointConfig(
            enabled=True, width=16, bin_point=0, bit_true=True))
        chain = rsp.fft_mag_cfar_chain(cfg)
        rt = rsp.RuntimeConfig.make(**rt_kw)

        def compile_at(c):
            spec = jax.ShapeDtypeStruct((c, PULSES, N), np.int32)
            return self.compile(chain.jit(), C(spec, spec), rt)[0]

        t0 = time.perf_counter()
        if channels is None:
            channels, compiled = fit_channels(compile_at, self.limit)
        else:
            compiled = compile_at(channels)
        compile_s = time.perf_counter() - t0
        re, im = tone_frames(self.rng, (channels, PULSES), scale=250.0)
        re, im = re.astype(np.int32), im.astype(np.int32)
        x = self.device_pair(re, im)
        out = compiled(x, rt)
        sel = np.linspace(0, channels * PULSES - 1, 16).astype(int)
        ref = golden_int_chain(frames_of(re, sel), frames_of(im, sel), rt_kw,
                               gosca)
        errs = exact_errors(frames_of(out.threshold, sel),
                            frames_of(out.peaks, sel), *ref)
        check_exact(errs)
        ms = self.smoke_ms(compiled, x, rt)
        self.report(name, (channels, PULSES, N), compile_s, ms, errs, compiled,
                    {"compared_frames": len(sel)},
                    self.stage_ms(name, compiled, chain.stage_names, x, rt))

    def bit_true_ca(self):
        self.bit_true("bit_true_ca", rsp.CfarConfig(
            max_ref_window=64, variant=rsp.CfarVariant.CA,
            include_cash=False), RT_CA, False, channels=64)

    def bit_true_gosca(self):
        self.bit_true("bit_true_gosca", rsp.CfarConfig(
            max_ref_window=64, variant=rsp.CfarVariant.GOSCA,
            include_cash=True), RT_GOS, True, channels=None)

    # -- two-dimensional chains ----------------------------------------------

    def range_doppler(self):
        jax = self.jax
        ch = 16
        taps = golden.lfm_chirp(128, 0.0, 0.25)
        cfg = rsp.ChainConfig(
            matched_filter=rsp.MatchedFilterConfig(num_taps=128, fft_size=N),
            doppler=rsp.DopplerConfig(num_pulses=PULSES),
            cfar=rsp.CfarConfig(max_ref_window=64,
                                variant=rsp.CfarVariant.GOSCA,
                                include_cash=True))
        chain = rsp.range_doppler_chain(cfg, taps=taps)
        rt = rsp.RuntimeConfig.make(**dict(RT_GOS, threshold_scaler=6.0))
        spec = jax.ShapeDtypeStruct((ch, PULSES, N), np.float32)
        compiled, compile_s = self.compile(chain.jit(), C(spec, spec), rt)
        re, im = rd_inputs(self.rng, ch, taps)
        x = self.device_pair(re, im)
        out = compiled(x, rt)
        from rsp_chains.ops.windows import window

        rd = golden.range_doppler_golden(
            re.astype(np.float64) + 1j * im, matched_taps=taps,
            doppler_window=window("hann", PULSES).astype(np.float64))
        # every channel's target rows and one noise row: 16 x 4 = 64 rows
        sel = np.asarray([c * PULSES + r for c in range(ch)
                          for r in TARGET_ROWS + (0,)])
        ref = golden.cfar_golden(
            golden.jpl_mag(frames_of(rd, sel)), ref_window=32, guard_window=4,
            threshold_scaler=6.0, div_sum=5, algorithm=1, index_lagg=16,
            index_lead=16)
        errs = float_errors(frames_of(out.threshold, sel),
                            frames_of(out.peaks, sel), *ref)
        check_float(errs)
        ms = self.smoke_ms(compiled, x, rt)
        self.report("range_doppler", (ch, PULSES, N), compile_s, ms, errs,
                    compiled, {"compared_doppler_rows": len(sel)},
                    self.stage_ms("range_doppler", compiled,
                                  chain.stage_names, x, rt))

    def pulse_compression(self):
        jax = self.jax
        ch, n = 16, 4096
        taps = golden.lfm_chirp(128, 0.0, 0.25)
        cfg = rsp.ChainConfig(
            fft=rsp.FftConfig(max_size=n),
            matched_filter=rsp.MatchedFilterConfig(num_taps=128, fft_size=n),
            cfar=rsp.CfarConfig(max_ref_window=64, max_fft_size=n,
                                variant=rsp.CfarVariant.CA,
                                include_cash=False))
        chain = rsp.pulse_compression_chain(cfg, taps=taps)
        rt_kw = dict(RT_CA, fft_size=n, threshold_scaler=8.0)
        rt = rsp.RuntimeConfig.make(**rt_kw)
        spec = jax.ShapeDtypeStruct((ch, PULSES, n), np.float32)
        compiled, compile_s = self.compile(chain.jit(), C(spec, spec), rt)
        re, im = tone_frames(self.rng, (ch, PULSES), n=n)
        x = self.device_pair(re, im)
        out = compiled(x, rt)
        sel = np.linspace(0, ch * PULSES - 1, 64).astype(int)
        xs = frames_of(re, sel).astype(np.float64) + 1j * frames_of(im, sel)
        y = golden.matched_filter_golden(xs, taps, "circular")
        y = y / np.sqrt(np.sum(np.abs(taps) ** 2))
        ref = golden.cfar_golden(
            golden.jpl_mag(golden.fft_golden(y)), ref_window=32,
            guard_window=4, threshold_scaler=8.0, div_sum=5)
        errs = float_errors(frames_of(out.threshold, sel),
                            frames_of(out.peaks, sel), *ref)
        check_float(errs)
        ms = self.smoke_ms(compiled, x, rt)
        self.report("pulse_compression", (ch, PULSES, n), compile_s, ms, errs,
                    compiled, {"compared_frames": len(sel)},
                    self.stage_ms("pulse_compression", compiled,
                                  chain.stage_names, x, rt))

    def rd_2d(self):
        jax = self.jax
        from rsp_chains.ops.cfar_2d import (
            Cfar2dConfig, Cfar2dRuntime, rd_2d_cfar_chain,
        )
        from rsp_chains.ops.windows import window

        ch = 16
        taps = golden.lfm_chirp(128, 0.0, 0.25)
        cfg = rsp.ChainConfig(
            matched_filter=rsp.MatchedFilterConfig(num_taps=128, fft_size=N),
            doppler=rsp.DopplerConfig(num_pulses=PULSES))
        cfg2d = Cfar2dConfig()
        rt = rsp.RuntimeConfig.make(**RT_CA)
        rt2 = Cfar2dRuntime.make(ref_range=8, guard_range=2, ref_doppler=4,
                                 guard_doppler=1, threshold_scaler=6.0,
                                 active_range=N, validate_against=cfg2d)
        run = jax.jit(rd_2d_cfar_chain(cfg, taps=taps, cfg2d=cfg2d))
        spec = jax.ShapeDtypeStruct((ch, PULSES, N), np.float32)
        compiled, compile_s = self.compile(run, C(spec, spec), rt, rt2)
        re, im = rd_inputs(self.rng, ch, taps)
        x = self.device_pair(re, im)
        out = compiled(x, rt, rt2)
        maps = (0, ch - 1)
        rd = golden.range_doppler_golden(
            re[list(maps)].astype(np.float64) + 1j * im[list(maps)],
            matched_taps=taps,
            doppler_window=window("hann", PULSES).astype(np.float64))
        refs = [golden.cfar_2d_golden(
            golden.jpl_mag(rd[i]), ref_range=8, guard_range=2, ref_doppler=4,
            guard_doppler=1, threshold_scaler=6.0) for i in range(len(maps))]
        thr = np.asarray(out.threshold)[list(maps)]
        pk = np.asarray(out.peaks)[list(maps)]
        errs = float_errors(thr, pk, np.stack([r[0] for r in refs]),
                            np.stack([r[1] for r in refs]))
        check_float(errs)
        ms = self.smoke_ms(compiled, x, rt, rt2)
        self.report("rd_2d", (ch, PULSES, N), compile_s, ms, errs, compiled,
                    {"compared_maps": len(maps)},
                    self.stage_ms("rd_2d", compiled,
                                  ("matched_filter", "doppler_fft", "logmag",
                                   "cfar_2d"), x, rt, rt2))

    PHASES = ("ca_chain", "gos_chain", "wire_serving", "bit_true_ca",
              "bit_true_gosca", "range_doppler", "pulse_compression", "rd_2d")

    def run(self):
        for name in self.PHASES:
            getattr(self, name)()
            gc.collect()   # free the phase's device arrays before the next


# ---------------------------------------------------------------------------
# four cards: the sharded paths against the same chain on one card
# ---------------------------------------------------------------------------


def sharded_equal(name, got, want, flips_allowed=0) -> dict:
    """Sharded vs one-card output: thresholds within FLOAT_THR_BAR of the
    threshold scale, peaks equal."""
    thr_w = np.asarray(want.threshold, np.float64)
    scale = max(float(np.max(np.abs(thr_w))), 1e-30)
    dthr = float(np.max(np.abs(np.asarray(got.threshold) - thr_w))) / scale
    flips = int(np.sum(np.asarray(got.peaks) != np.asarray(want.peaks)))
    if dthr > FLOAT_THR_BAR or flips > flips_allowed:
        raise PhaseFailed(f"{name}: sharded differs from one card "
                          f"(dthr {dthr:.3e}, {flips} peak flips)")
    return {"dthr": dthr, "flips": flips,
            "detections": int(np.sum(np.asarray(want.peaks)))}


def run_cards4(rng) -> None:
    """``make_sharded_pipeline``, ``make_sharded_rd_pipeline`` and the
    range-sharded 2-D detector on a 2 ch x 2 rng mesh, each against the same
    chain on one card."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from rsp_chains.ops.cfar import CfarOutput
    from rsp_chains.ops.cfar_2d import Cfar2dConfig, Cfar2dRuntime, cfar_2d_op
    from rsp_chains.ops.logmag import logmag
    from rsp_chains.parallel import CHANNEL_AXIS, RANGE_AXIS, make_mesh
    from rsp_chains.parallel.sharded import (
        cfar_2d_halo_shard, make_sharded_pipeline, make_sharded_rd_pipeline,
    )

    devices = jax.devices()
    if len(devices) < 4:
        raise PhaseFailed(f"--cards 4 needs 4 devices, found {len(devices)}")
    mesh = make_mesh(channels=2, range_shards=2)
    one = devices[0]
    ch = 16
    taps = golden.lfm_chirp(128, 0.0, 0.25)
    ch_spec = NamedSharding(mesh, P(CHANNEL_AXIS, None, None))

    def inputs(re, im):
        return (C(jax.device_put(re, one), jax.device_put(im, one)),
                C(jax.device_put(re, ch_spec), jax.device_put(im, ch_spec)))

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        first = time.perf_counter() - t0
        ts = []
        for _ in range(SMOKE_CALLS):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args))
            ts.append(time.perf_counter() - t0)
        return out, round(first, 2), round(float(np.median(ts)) * 1e3, 3)

    def line(name, errs, first_s, ms, first_one, ms_one):
        print("phase " + json.dumps({
            "phase": name, "shape": f"{ch}x{PULSES}x{N}", "mesh": "2ch x 2rng",
            "errors": errs, "first_call_s": first_s,
            "smoke_median_ms": ms, "one_card_first_call_s": first_one,
            "one_card_smoke_median_ms": ms_one}), flush=True)

    # leg 1: the 1-D chain, per-shard FFT -> range scatter -> halo CFAR
    cfg1 = rsp.ChainConfig(cfar=rsp.CfarConfig(
        max_ref_window=32, max_guard_window=8, variant=rsp.CfarVariant.CA,
        include_cash=False))
    rt = rsp.RuntimeConfig.make(**RT_CA)
    x_one, x_mesh = inputs(*tone_frames(rng, (ch, PULSES)))
    got, f_s, ms = timed(make_sharded_pipeline(cfg1, mesh), x_mesh, rt)
    want, f_1, ms_1 = timed(rsp.fft_mag_cfar_chain(cfg1).jit(), x_one, rt)
    line("sharded_chain", sharded_equal("sharded_chain", got, want),
         f_s, ms, f_1, ms_1)

    # leg 2: the range-Doppler chain, per-channel MF + Doppler -> range
    # scatter -> halo GOSCA tail
    cfg_rd = rsp.ChainConfig(
        matched_filter=rsp.MatchedFilterConfig(num_taps=128, fft_size=N),
        doppler=rsp.DopplerConfig(num_pulses=PULSES),
        cfar=rsp.CfarConfig(max_ref_window=32, max_guard_window=8,
                            variant=rsp.CfarVariant.GOSCA, include_cash=True))
    rt_rd = rsp.RuntimeConfig.make(**dict(RT_GOS, threshold_scaler=5.0,
                                          index_lagg=24, index_lead=24))
    x_one, x_mesh = inputs(*rd_inputs(rng, ch, taps))
    got, f_s, ms = timed(make_sharded_rd_pipeline(cfg_rd, mesh, taps),
                         x_mesh, rt_rd)
    want, f_1, ms_1 = timed(rsp.range_doppler_chain(cfg_rd, taps=taps).jit(),
                            x_one, rt_rd)
    line("sharded_rd", sharded_equal("sharded_rd", got, want),
         f_s, ms, f_1, ms_1)

    # leg 3: the range-sharded 2-D detector on the RD magnitude map
    from rsp_chains.ops.doppler import doppler_fft
    from rsp_chains.ops.matched_filter import matched_filter

    cfg2d = Cfar2dConfig()
    rt2 = Cfar2dRuntime.make(ref_range=8, guard_range=2, ref_doppler=4,
                             guard_doppler=1, threshold_scaler=6.0,
                             active_range=N, validate_against=cfg2d)
    mag = jax.jit(lambda a: logmag(doppler_fft(
        matched_filter(a, taps, cfg_rd.matched_filter), cfg_rd.doppler),
        rt.mag_mode))(x_one)
    spec2 = P(CHANNEL_AXIS, None, RANGE_AXIS)
    sharded2d = jax.jit(jax.shard_map(
        lambda m, r2: cfar_2d_halo_shard(m, r2, cfg2d), mesh=mesh,
        in_specs=(spec2, P()), out_specs=CfarOutput(spec2, spec2, None, None)))
    got, f_s, ms = timed(sharded2d,
                         jax.device_put(mag, NamedSharding(mesh, spec2)), rt2)
    want, f_1, ms_1 = timed(jax.jit(lambda m, r2: cfar_2d_op(m, r2, cfg2d)),
                            mag, rt2)
    line("sharded_2d", sharded_equal("sharded_2d", got, want),
         f_s, ms, f_1, ms_1)


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: run only the sharded paths on a 2x2 mesh")
    ap.add_argument("--trace", metavar="DIR",
                    help="write one profiler trace per phase under DIR and "
                         "print device ms per stage")
    args = ap.parse_args(argv)

    import jax

    devices = require_gpu()
    enable_compile_cache()
    print(f"{card_description()} | jax {jax.__version__} | "
          f"{devices[0].device_kind} | devices {len(devices)}", flush=True)
    if args.cards == 4:
        run_cards4(np.random.default_rng(20240611))
    else:
        Smoke(args.trace).run()
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
