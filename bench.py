"""Benchmark of the radar chains on an NVIDIA GPU.

Times each preset at deployment size through its public entry point
(``presets`` -> ``Chain.jit()``), and the wire chain through
``io.StreamingPipeline`` fed from host numpy. Each line reports compile
seconds apart from the median of blocked calls after warm-up, with the card
it ran on. Correctness is ``chip_smoke.py``'s job; this script only times.

    python bench.py

Prints the card, then one JSON line per preset to stderr, and the headline
(the CA whole chain, Msamples/s) as the last line of stdout. Exits non-zero
off the GPU.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

CALLS = 20
N = 1024
PULSES = 256


def median_s(fn, *args, calls=CALLS) -> float:
    import jax

    jax.block_until_ready(fn(*args))            # warm-up
    ts = []
    for _ in range(calls):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def pair(rng, shape, dtype=np.float32, scale=1.0):
    import jax

    from rsp_chains.cplx import C

    re = rng.standard_normal(shape, np.float32) * scale
    im = rng.standard_normal(shape, np.float32) * scale
    if dtype != np.float32:
        re, im = np.round(re).astype(dtype), np.round(im).astype(dtype)
    return C(jax.device_put(re), jax.device_put(im))


def lines(rng):
    """(name, jitted chain, args) for every preset."""
    import rsp_chains as rsp
    from rsp_chains.golden import lfm_chirp
    from rsp_chains.ops.cfar_2d import Cfar2dRuntime, rd_2d_cfar_chain

    ca = rsp.CfarConfig(max_ref_window=64, variant=rsp.CfarVariant.CA,
                        include_cash=False)
    gosca = rsp.CfarConfig(max_ref_window=64, variant=rsp.CfarVariant.GOSCA,
                           include_cash=True)
    bit_true = rsp.FixedPointConfig(enabled=True, width=16, bin_point=0,
                                    bit_true=True)
    rt = rsp.RuntimeConfig.make(fft_size=N, ref_window_size=32,
                                guard_window_size=4, threshold_scaler=3.5,
                                div_sum=5)
    rt_gos = rsp.RuntimeConfig.make(fft_size=N, ref_window_size=32,
                                    guard_window_size=4, threshold_scaler=3.5,
                                    cfar_algorithm=1, index_lagg=16,
                                    index_lead=16)
    taps = lfm_chirp(128, 0.0, 0.25)
    mf = rsp.MatchedFilterConfig(num_taps=128, fft_size=N)
    dop = rsp.DopplerConfig(num_pulses=PULSES)
    big = (64, PULSES, N)
    cpi = (16, PULSES, N)

    yield ("ca_chain", rsp.fft_mag_cfar_chain(rsp.ChainConfig(cfar=ca)).jit(),
           (pair(rng, big), rt))
    yield ("gos_chain",
           rsp.fft_mag_cfar_chain(rsp.ChainConfig(cfar=gosca)).jit(),
           (pair(rng, big), rt_gos))
    words = rng.integers(0, 2**32, big, dtype=np.uint32)
    yield ("wire_chain",
           rsp.rx_fft_mag_cfar_tx_chain(rsp.ChainConfig(cfar=ca)).jit(),
           (words, rt))
    yield ("bit_true_ca", rsp.fft_mag_cfar_chain(rsp.ChainConfig(
        cfar=ca, fixed_point=bit_true)).jit(),
        (pair(rng, big, np.int32, 250.0), rt))
    yield ("bit_true_gosca", rsp.fft_mag_cfar_chain(rsp.ChainConfig(
        cfar=gosca, fixed_point=bit_true)).jit(),
        (pair(rng, big, np.int32, 250.0), rt_gos))
    yield ("range_doppler", rsp.range_doppler_chain(rsp.ChainConfig(
        matched_filter=mf, doppler=dop, cfar=gosca), taps=taps).jit(),
        (pair(rng, cpi), rt_gos))
    n_pc = 4096
    rt_pc = rsp.RuntimeConfig.make(fft_size=n_pc, ref_window_size=32,
                                   guard_window_size=4, threshold_scaler=8.0,
                                   div_sum=5)
    yield ("pulse_compression", rsp.pulse_compression_chain(rsp.ChainConfig(
        fft=rsp.FftConfig(max_size=n_pc),
        matched_filter=rsp.MatchedFilterConfig(num_taps=128, fft_size=n_pc),
        cfar=rsp.CfarConfig(max_ref_window=64, max_fft_size=n_pc,
                            variant=rsp.CfarVariant.CA, include_cash=False)),
        taps=taps).jit(), (pair(rng, (16, PULSES, n_pc)), rt_pc))
    import jax

    rt2 = Cfar2dRuntime.make(ref_range=8, guard_range=2, ref_doppler=4,
                             guard_doppler=1, threshold_scaler=6.0,
                             active_range=N)
    yield ("rd_2d", jax.jit(rd_2d_cfar_chain(rsp.ChainConfig(
        matched_filter=mf, doppler=dop), taps=taps)),
        (pair(rng, cpi), rt, rt2))


def stream_line(rng) -> dict:
    """The wire chain served by ``StreamingPipeline``: 16-channel CPIs of
    packed words submitted from host numpy, CPIs/s over the window."""
    import threading

    import rsp_chains as rsp
    from rsp_chains.io.stream import StreamingPipeline

    ca = rsp.CfarConfig(max_ref_window=64, variant=rsp.CfarVariant.CA,
                        include_cash=False)
    rt = rsp.RuntimeConfig.make(fft_size=N, ref_window_size=32,
                                guard_window_size=4, threshold_scaler=3.5,
                                div_sum=5)
    wire = rsp.rx_fft_mag_cfar_tx_chain(rsp.ChainConfig(cfar=ca)).jit()
    cpis = [rng.integers(0, 2**32, (16, PULSES, N), dtype=np.uint32)
            for _ in range(4)]
    n_cpi, warm = 40, 4
    done = threading.Event()
    seen = []

    def on_result(seq, out, metrics):
        seen.append(seq)
        if len(seen) == n_cpi + warm:
            done.set()

    pipe = StreamingPipeline(wire, rt, depth=8, on_result=on_result)
    with pipe:
        for k in range(warm):
            pipe.submit(k, cpis[k % len(cpis)])
        while len(seen) < warm:
            time.sleep(0.005)
        t0 = time.perf_counter()
        for k in range(n_cpi):
            pipe.submit(warm + k, cpis[k % len(cpis)])
        done.wait(timeout=600)
        dt = time.perf_counter() - t0
    if len(seen) != n_cpi + warm or pipe.stats.frames_failed:
        raise RuntimeError(f"stream delivered {len(seen)} CPIs, "
                           f"{pipe.stats.frames_failed} failed")
    samples = n_cpi * 16 * PULSES * N
    return {"line": f"stream_wire_16x{PULSES}x{N}", "cpis": n_cpi,
            "ms_per_cpi": dt / n_cpi * 1e3,
            "msamples_per_s": samples / dt / 1e6,
            "phase_ms_per_cpi": pipe.stats.phase_ms_per_cpi()}


def main() -> int:
    import jax

    from rsp_chains.utils.device import (
        card_description, enable_compile_cache, require_gpu,
    )

    devices = require_gpu()
    enable_compile_cache()
    device = {"platform": devices[0].platform, "kind": devices[0].device_kind,
              "count": len(devices), "card": card_description()}
    print(json.dumps({"device": device, "jax": jax.__version__}),
          file=sys.stderr, flush=True)
    rng = np.random.default_rng(0)
    headline = None
    for name, fn, args in lines(rng):
        t0 = time.perf_counter()
        compiled = fn.lower(*args).compile()
        compile_s = time.perf_counter() - t0
        dt = median_s(compiled, *args)
        x = args[0]
        shape = (x.re if hasattr(x, "re") else x).shape
        rec = {"line": f"{name}_{'x'.join(map(str, shape))}",
               "compile_s": compile_s, "ms_per_call": dt * 1e3,
               "msamples_per_s": int(np.prod(shape)) / dt / 1e6}
        print(json.dumps(rec), file=sys.stderr, flush=True)
        if name == "ca_chain":
            headline = rec
        del compiled, args
    print(json.dumps(stream_line(rng)), file=sys.stderr, flush=True)
    print(json.dumps({"metric": "fft_mag_cfar_chain_throughput",
                      "value": headline["msamples_per_s"],
                      "unit": "Msamples/s", "ms_per_call":
                      headline["ms_per_call"], "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
