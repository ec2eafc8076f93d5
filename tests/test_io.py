"""Host I/O tests: native packing, framing protocol, streaming harness."""

import numpy as np
import jax.numpy as jnp
import pytest

from rsp_chains.io import (
    Frame, FrameDecoder, FrameError, decode_frame, encode_frame, encode_iq_frame,
    StreamingPipeline, native,
)
from rsp_chains import packing


def test_native_pack_matches_jnp_packing(rng):
    iq = (rng.randint(-1000, 1000, 256) + 1j * rng.randint(-1000, 1000, 256)).astype(np.complex64)
    native_words = native.pack_iq_c64(iq)
    jnp_words = np.asarray(packing.pack_iq(jnp.asarray(iq)))
    np.testing.assert_array_equal(native_words, jnp_words)
    back = native.unpack_iq_c64(native_words)
    np.testing.assert_array_equal(back, iq)


def test_native_saturation_and_rounding():
    iq = np.array([40000.4 + 0.6j, -40000.0 - 2.5j], np.complex64)
    words = native.pack_iq_c64(iq)
    re = (words >> 16).astype(np.uint16).view(np.int16)
    im = (words & 0xFFFF).astype(np.uint16).view(np.int16)
    assert re[0] == 32767 and re[1] == -32768       # saturate
    assert im[0] == 1                                # round-half-up 0.6 -> 1
    assert im[1] == -2                               # floor(-2.5 + 0.5) = -2


def test_native_available():
    native._load()
    assert native.HAVE_NATIVE, "C++ packing library failed to build/load"


def test_frame_roundtrip(rng):
    iq = (rng.randn(512) * 100 + 1j * rng.randn(512) * 100).astype(np.complex64)
    buf = encode_iq_frame(iq, seq=7, last=True, channel=3)
    frame, consumed = decode_frame(buf)
    assert consumed == len(buf)
    assert frame.seq == 7 and frame.last and frame.channel == 3
    np.testing.assert_array_equal(frame.iq, np.round(iq.view(np.float32)).reshape(-1, 2)
                                  .astype(np.float32).view(np.complex64).reshape(-1))


def test_frame_crc_detects_corruption(rng):
    buf = bytearray(encode_frame(rng.randint(0, 2**32, 64, np.uint32).astype(np.uint32), 0))
    buf[20] ^= 0xFF
    with pytest.raises(FrameError):
        decode_frame(bytes(buf))


def test_decoder_resync_after_garbage(rng):
    words = rng.randint(0, 2**32, 32, np.uint32).astype(np.uint32)
    good = encode_frame(words, seq=1) + encode_frame(words, seq=2, last=True)
    stream = b"\x00garbage!" + good
    dec = FrameDecoder()
    frames = []
    # feed in awkward chunk sizes
    for i in range(0, len(stream), 13):
        frames.extend(dec.feed(stream[i:i + 13]))
    assert [f.seq for f in frames] == [1, 2]
    assert frames[1].last


def test_streaming_pipeline_end_to_end():
    from rsp_chains import (
        ChainConfig, CfarConfig, CfarVariant, FftConfig, RuntimeConfig,
        fft_mag_cfar_chain,
    )
    from rsp_chains.golden import three_tone_signal

    cfg = ChainConfig(fft=FftConfig(max_size=256),
                      cfar=CfarConfig(max_ref_window=16, variant=CfarVariant.CA,
                                      include_cash=False))
    chain = fft_mag_cfar_chain(cfg)
    rt = RuntimeConfig.make(fft_size=256, ref_window_size=8, guard_window_size=2,
                            threshold_scaler=3.5)
    results = {}
    events = []

    pipe = StreamingPipeline(
        chain.jit(), rt,
        on_result=lambda seq, out, m: results.__setitem__(seq, (out, m)),
        depth=4, on_watermark=lambda lvl: events.append(lvl),
    )
    iq = three_tone_signal(256, shift_range_factor=12).astype(np.complex64)
    with pipe:
        for s in range(10):
            pipe.submit(s, iq[None])
        import time
        t0 = time.time()
        while len(results) < 10 and time.time() - t0 < 60:
            time.sleep(0.01)
    assert len(results) == 10
    assert pipe.stats.frames_out == 10
    out, metrics = results[0]
    peaks = np.flatnonzero(np.asarray(out.peaks)[0])
    assert {32, 64, 128} <= set(peaks.tolist())
    assert metrics.samples == 256 and metrics.detections >= 3


def test_streaming_deferred_detections_and_phase_table():
    """r5 serving-cost features (VERDICT r4 item 3): detections_every=K
    accumulates the count on device (per-CPI metrics carry -1, no host
    fetch), the running total lands every K CPIs and on flush_detections();
    the phase table attributes serving cost per CPI."""
    from rsp_chains import (
        ChainConfig, CfarConfig, CfarVariant, FftConfig, RuntimeConfig,
        fft_mag_cfar_chain,
    )
    from rsp_chains.golden import three_tone_signal

    cfg = ChainConfig(fft=FftConfig(max_size=256),
                      cfar=CfarConfig(max_ref_window=16, variant=CfarVariant.CA,
                                      include_cash=False))
    chain = fft_mag_cfar_chain(cfg)
    rt = RuntimeConfig.make(fft_size=256, ref_window_size=8,
                            guard_window_size=2, threshold_scaler=3.5)
    iq = three_tone_signal(256, shift_range_factor=12).astype(np.complex64)
    mets = []
    pipe = StreamingPipeline(chain.jit(), rt, detections_every=3,
                             on_result=lambda s, o, m: mets.append(m))
    ref = StreamingPipeline(chain.jit(), rt,
                            on_result=lambda s, o, m: mets.append(None))
    import time

    with pipe:
        for s in range(6):
            pipe.submit(s, iq[None])
        t0 = time.time()
        while pipe.stats.frames_out < 6 and time.time() - t0 < 60:
            time.sleep(0.01)
    assert pipe.stats.frames_out == 6
    per_cpi = [m.detections for m in mets if m is not None]
    assert per_cpi == [-1] * 6          # deferred: no per-CPI scalar fetch
    # exact per-CPI count from the default pipeline for the expected total
    del mets[:]
    with ref:
        ref.submit(0, iq[None])
        t0 = time.time()
        while ref.stats.frames_out < 1 and time.time() - t0 < 60:
            time.sleep(0.01)
    one = ref.detections_total
    assert one >= 3
    assert pipe.detections_total == 6 * one     # updated at the K boundary
    assert pipe.flush_detections() == 6 * one
    phases = pipe.stats.phase_ms_per_cpi()
    assert set(phases) == {"t_queue_wait", "t_place", "t_dispatch",
                           "t_block", "t_result"}
    assert phases["t_dispatch"] > 0.0   # the chain dispatch was timed


def test_streaming_block_every_drains_all_results():
    """block_every=K amortizes the drain's block_until_ready over K CPIs
    (sound on a single device stream); every result must still be delivered
    and the owed tail completion paid at stop."""
    from rsp_chains import (
        ChainConfig, CfarConfig, CfarVariant, FftConfig, RuntimeConfig,
        fft_mag_cfar_chain,
    )
    from rsp_chains.golden import three_tone_signal

    cfg = ChainConfig(fft=FftConfig(max_size=256),
                      cfar=CfarConfig(max_ref_window=16, variant=CfarVariant.CA,
                                      include_cash=False))
    chain = fft_mag_cfar_chain(cfg)
    rt = RuntimeConfig.make(fft_size=256, ref_window_size=8,
                            guard_window_size=2, threshold_scaler=3.5)
    iq = three_tone_signal(256, shift_range_factor=12).astype(np.complex64)
    got = {}
    pipe = StreamingPipeline(chain.jit(), rt, block_every=4,
                             on_result=lambda s, o, m: got.__setitem__(s, o))
    import time

    with pipe:
        for s in range(7):                 # 7 % 4 != 0: a tail block is owed
            pipe.submit(s, iq[None])
        t0 = time.time()
        while pipe.stats.frames_out < 7 and time.time() - t0 < 60:
            time.sleep(0.01)
    assert pipe.stats.frames_out == 7 and pipe.stats.frames_failed == 0
    assert sorted(got) == list(range(7))
    # results are real and correct regardless of block cadence
    peaks = np.flatnonzero(np.asarray(got[6].peaks)[0])
    assert {32, 64, 128} <= set(peaks.tolist())


def test_streaming_on_result_exception_does_not_kill_drain():
    """A raising on_result callback (or a metrics-path device error) is
    contained per CPI: the stream keeps draining and reports the error via
    on_error (the r5 multihost hang was a metrics-path exception silently
    killing the drain thread)."""
    from rsp_chains import (
        ChainConfig, CfarConfig, CfarVariant, FftConfig, RuntimeConfig,
        fft_mag_cfar_chain,
    )
    from rsp_chains.golden import three_tone_signal

    cfg = ChainConfig(fft=FftConfig(max_size=256),
                      cfar=CfarConfig(max_ref_window=16, variant=CfarVariant.CA,
                                      include_cash=False))
    chain = fft_mag_cfar_chain(cfg)
    rt = RuntimeConfig.make(fft_size=256, ref_window_size=8,
                            guard_window_size=2, threshold_scaler=3.5)
    iq = three_tone_signal(256, shift_range_factor=12).astype(np.complex64)
    seen, errs = [], []

    def boom(seq, out, m):
        seen.append(seq)
        if seq == 1:
            raise RuntimeError("consumer bug")

    pipe = StreamingPipeline(chain.jit(), rt, on_result=boom,
                             on_error=lambda s, e: errs.append((s, str(e))))
    import time

    with pipe:
        for s in range(4):
            pipe.submit(s, iq[None])
        t0 = time.time()
        while pipe.stats.frames_out < 4 and time.time() - t0 < 60:
            time.sleep(0.01)
    assert pipe.stats.frames_out == 4          # the drain survived seq 1
    assert seen == [0, 1, 2, 3]
    assert [s for s, _ in errs] == [1]


def test_streaming_reconfigure_between_cpis():
    from rsp_chains import (
        ChainConfig, CfarConfig, CfarVariant, FftConfig, RuntimeConfig,
        fft_mag_cfar_chain,
    )
    from rsp_chains.golden import three_tone_signal

    cfg = ChainConfig(fft=FftConfig(max_size=256),
                      cfar=CfarConfig(max_ref_window=16, variant=CfarVariant.CA,
                                      include_cash=False))
    chain = fft_mag_cfar_chain(cfg)
    rt1 = RuntimeConfig.make(fft_size=256, ref_window_size=8, guard_window_size=2)
    rt2 = RuntimeConfig.make(fft_size=128, ref_window_size=8, guard_window_size=2)
    results = {}
    pipe = StreamingPipeline(chain.jit(), rt1,
                             on_result=lambda s, o, m: results.__setitem__(s, o))
    iq = three_tone_signal(256, shift_range_factor=12).astype(np.complex64)
    import time
    with pipe:
        pipe.submit(0, iq[None])
        t0 = time.time()
        while 0 not in results and time.time() - t0 < 60:
            time.sleep(0.01)
        pipe.reconfigure(rt2)
        pipe.submit(1, iq[None])
        while 1 not in results and time.time() - t0 < 60:
            time.sleep(0.01)
    # rt2 shrinks the active frame: bins >= 128 are zeroed
    assert np.all(np.asarray(results[1].threshold)[0, 128:] == 0)
    assert np.any(np.asarray(results[0].threshold)[0, 128:] != 0)


def test_streaming_elastic_error_recovery():
    """Fault injection: a CPI with a bad shape fails; the stream keeps running
    (failure detection / elastic recovery, SURVEY §5.3)."""
    from rsp_chains import (
        ChainConfig, CfarConfig, CfarVariant, FftConfig, RuntimeConfig,
        fft_mag_cfar_chain,
    )
    from rsp_chains.golden import three_tone_signal
    import time

    cfg = ChainConfig(fft=FftConfig(max_size=256),
                      cfar=CfarConfig(max_ref_window=16, variant=CfarVariant.CA,
                                      include_cash=False))
    chain = fft_mag_cfar_chain(cfg)
    rt = RuntimeConfig.make(fft_size=256, ref_window_size=8, guard_window_size=2)
    results, errors = {}, []
    pipe = StreamingPipeline(chain.jit(), rt,
                             on_result=lambda s, o, m: results.__setitem__(s, o),
                             on_error=lambda s, e: errors.append((s, type(e).__name__)))
    good = three_tone_signal(256, shift_range_factor=12).astype(np.complex64)[None]
    bad = np.zeros((1, 100), np.complex64)  # wrong frame length -> assert fails
    with pipe:
        pipe.submit(0, good)
        pipe.submit(1, bad)
        pipe.submit(2, good)
        t0 = time.time()
        while len(results) < 2 and time.time() - t0 < 60:
            time.sleep(0.01)
    assert set(results) == {0, 2}
    assert pipe.stats.frames_failed == 1
    assert errors and errors[0][0] == 1


def test_framing_corrupt_length_resyncs():
    """A header with valid magic but corrupted (huge) length must not wedge the
    decoder: the bounded-length check raises FrameError so one-byte resync
    engages and the following valid frame still decodes (ADVICE r1)."""
    import numpy as np
    from rsp_chains.io import framing

    good = framing.encode_frame(np.arange(8, dtype=np.uint32), seq=7)
    bad = bytearray(framing.encode_frame(np.arange(4, dtype=np.uint32), seq=1))
    # corrupt the n_words field (bytes 8..12) to a huge value
    bad[8:12] = (0x7FFFFFFF).to_bytes(4, "little")
    dec = framing.FrameDecoder()
    frames = list(dec.feed(bytes(bad) + good))
    assert [f.seq for f in frames] == [7]
    np.testing.assert_array_equal(frames[0].words, np.arange(8, dtype=np.uint32))


def _python_only_decode(data: bytes):
    """Force the Python decoder path (native.scan_frames monkey-bypassed)."""
    from rsp_chains.io import framing, native

    dec = framing.FrameDecoder()
    orig = native.scan_frames
    native.scan_frames = lambda *a, **k: None
    try:
        return list(dec.feed(data)), bytes(dec._buf)
    finally:
        native.scan_frames = orig


def test_native_scan_equals_python_decoder(rng):
    """The C++ scan_frames fast path yields exactly the Python decoder's
    frames across clean frames, garbage resync, a corrupted-CRC frame, an
    oversized length, and a trailing partial frame."""
    from rsp_chains.io import framing, native

    frames = [encode_frame(rng.randint(0, 1 << 32, 16, dtype=np.uint32), s)
              for s in range(4)]
    bad_crc = bytearray(frames[1])
    bad_crc[-1] ^= 0xFF
    big = bytearray(frames[2])
    big[8:12] = (framing.MAX_FRAME_WORDS + 1).to_bytes(4, "little")
    stream = (b"\x99" * 7 + frames[0] + bytes(bad_crc) + b"RSPC" + b"junk!"
              + frames[1] + bytes(big) + frames[2] + frames[3][:20])

    want, want_rest = _python_only_decode(stream)
    dec = framing.FrameDecoder()
    got = list(dec.feed(stream))
    if native.scan_frames(b"", 1) is None:
        pytest.skip("native library unavailable")
    assert [f.seq for f in got] == [f.seq for f in want] == [0, 1, 2]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.words, w.words)
        assert (g.last, g.config, g.channel) == (w.last, w.config, w.channel)
    # identical resume state: the partial trailing frame stays buffered
    assert bytes(dec._buf) == want_rest
    tail = list(dec.feed(frames[3][20:]))
    assert [f.seq for f in tail] == [3]


def test_native_scan_split_feeds(rng):
    from rsp_chains.io import framing

    f = encode_frame(rng.randint(0, 1 << 32, 64, dtype=np.uint32), 7,
                     last=True, channel=3)
    dec = framing.FrameDecoder()
    out = []
    for i in range(0, len(f), 11):
        out.extend(dec.feed(f[i:i + 11]))
    assert len(out) == 1 and out[0].seq == 7 and out[0].last \
        and out[0].channel == 3


def test_native_scan_abandoned_iterator_keeps_frames(rng):
    """Abandoning the feed() generator mid-iteration neither loses nor
    duplicates frames (the resume offset tracks delivered frames)."""
    from rsp_chains.io import framing

    frames = [encode_frame(rng.randint(0, 1 << 32, 8, dtype=np.uint32), s)
              for s in range(3)]
    dec = framing.FrameDecoder()
    it = dec.feed(b"".join(frames))
    first = next(it)
    it.close()
    rest = list(dec.feed(b""))
    assert [first.seq] + [f.seq for f in rest] == [0, 1, 2]
