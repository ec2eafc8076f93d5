"""Runnable tour of the framework: every preset chain on synthetic data.

    python examples/quickstart.py          # CPU (8 virtual devices) or a GPU
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if os.environ.get("RSP_FORCE_CPU", "1") == "1":
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np

import rsp_chains as rsp


def main():
    rt = rsp.RuntimeConfig.make(fft_size=1024, ref_window_size=32,
                                guard_window_size=4, threshold_scaler=3.5,
                                div_sum=5)

    # 1. the core chain on the canonical three-tone vector
    chain = rsp.fft_mag_cfar_chain()
    iq = rsp.golden.three_tone_signal(1024, shift_range_factor=12)
    out = chain.jit()(rsp.as_pair(iq), rt)
    print("fft_mag_cfar detections:", np.flatnonzero(np.asarray(out.peaks)))

    # 2. runtime re-configuration: same compiled function, no recompile
    rt2 = rsp.RuntimeConfig.make(fft_size=256, cfar_mode=rsp.CfarMode.GREATEST_OF,
                                 ref_window_size=16, guard_window_size=2)
    out2 = chain.jit()(rsp.as_pair(iq), rt2)
    print("after register writes:", np.flatnonzero(np.asarray(out2.peaks)),
          "| compiles:", chain.jit()._cache_size())

    # 3. self-stimulus chain (the hardware's PLFG->NCO front end)
    vans = rsp.rsp_chain_vanilla()
    outv = vans.jit()(None, rsp.RuntimeConfig.make(nco_freq_word=16,
                                                   ref_window_size=32,
                                                   guard_window_size=4, div_sum=5))
    print("self-stimulus peak bins:", np.flatnonzero(np.asarray(outv.peaks)),
          "(contract: word 16 -> bin 32)")

    # 4. 2-D range-Doppler on a synthetic two-target CPI
    chirp = rsp.golden.lfm_chirp(128, 0.0, 0.25)
    cpi = rsp.golden.chirp_with_targets(
        64, 1024, chirp, [(300, 1.0, 0.1), (600, 0.5, -0.2)], noise_db=-40)
    rd = rsp.range_doppler_chain(rsp.ChainConfig(
        doppler=rsp.DopplerConfig(num_pulses=64),
        matched_filter=rsp.MatchedFilterConfig(num_taps=128)), taps=chirp)
    outrd = rd.jit()(rsp.as_pair(cpi[None]),
                     rsp.RuntimeConfig.make(fft_size=1024, ref_window_size=32,
                                            guard_window_size=4,
                                            threshold_scaler=8.0, div_sum=5))
    pk = np.asarray(outrd.peaks)[0]
    print(f"range-Doppler: {pk.sum()} detections; "
          f"target cells hit: {bool(pk[38, 300])}, {bool(pk[19, 600])}")

    # 4b. 2-D map detector on the same CPI: one executable serves both the
    # CA annulus and (include_os elaborations) the ordered-statistic rank —
    # the algorithm/os_rank fields are traced registers like everything else
    import jax

    cfg2d = rsp.Cfar2dConfig(max_ref_range=4, max_guard_range=1,
                             max_ref_doppler=2, max_guard_doppler=1,
                             include_os=True)
    run2d = jax.jit(rsp.rd_2d_cfar_chain(rsp.ChainConfig(
        doppler=rsp.DopplerConfig(num_pulses=64),
        matched_filter=rsp.MatchedFilterConfig(num_taps=128)),
        taps=chirp, cfg2d=cfg2d))
    rt1 = rsp.RuntimeConfig.make(fft_size=1024)
    for alg, name in ((0, "CA"), (1, "OS")):
        rt2d = rsp.Cfar2dRuntime.make(
            ref_range=4, guard_range=1, ref_doppler=2, guard_doppler=1,
            threshold_scaler=8.0, peak_grouping=1, algorithm=alg,
            os_rank=cfg2d.os_stack // 2, validate_against=cfg2d)
        o2d = run2d(rsp.as_pair(cpi[None]), rt1, rt2d)
        p2d = np.asarray(o2d.peaks)[0]
        print(f"2-D {name}-CFAR: {p2d.sum()} detections; "
              f"targets hit: {bool(p2d[38, 300])}, {bool(p2d[19, 600])}")
    print("2-D compiles:", run2d._cache_size())

    # 5. served loop: framed bytes through the TCP server
    from rsp_chains.io.server import ChainServer, request_frames

    with ChainServer(chain.jit(), rt, frame_len=1024, log2_fft_size=10) as srv:
        results = request_frames("127.0.0.1", srv.port, [iq, iq * 0.5])
    thr, bins, peaks = rsp.packing.unpack_cfar_words(results[0].words, 10)
    print("served round trip: detections at", np.flatnonzero(peaks))


if __name__ == "__main__":
    main()
