"""TCP chain server: framed IQ in -> CFAR word frames out, config frames."""

import json

import numpy as np
import jax.numpy as jnp

from rsp_chains import (
    ChainConfig, CfarConfig, CfarVariant, FftConfig, RuntimeConfig,
    fft_mag_cfar_chain, packing,
)
from rsp_chains.golden import three_tone_signal
from rsp_chains.io import framing
from rsp_chains.io.server import ChainServer, request_frames


def _server():
    cfg = ChainConfig(fft=FftConfig(max_size=256),
                      cfar=CfarConfig(max_ref_window=16, variant=CfarVariant.CA,
                                      include_cash=False))
    chain = fft_mag_cfar_chain(cfg)
    rt = RuntimeConfig.make(fft_size=256, ref_window_size=8, guard_window_size=2,
                            threshold_scaler=3.5)
    return ChainServer(chain.jit(), rt, frame_len=256, log2_fft_size=8)


def test_served_round_trip():
    iq = three_tone_signal(256, shift_range_factor=12).astype(np.complex64)
    with _server() as srv:
        results = request_frames("127.0.0.1", srv.port, [iq, iq * 0.5, iq])
    assert len(results) == 3
    assert {r.seq for r in results} == {0, 1, 2}
    thr, bins, pk = packing.unpack_cfar_words(results[0].words, 8)
    got = set(np.flatnonzero(pk).tolist())
    assert {32, 64, 128} <= got


def test_served_config_frame_reconfigures():
    iq = three_tone_signal(256, shift_range_factor=12).astype(np.complex64)
    # config frames are register WRITES that merge into the live file: the
    # CFAR fftSize is its own register (the reference writes FFT base+0 and
    # CFAR base+0 separately, RspChainVanillaTester.scala:96,113), so the
    # client shrinks both — an unwritten register keeps its value
    cfg_payload = json.dumps({"fft_size": 128, "cfar_fft_size": 128,
                              "ref_window_size": 8,
                              "guard_window_size": 2}).encode() + b"\0"
    pad = (-len(cfg_payload)) % 4
    words = np.frombuffer(cfg_payload + b"\0" * pad, np.uint32)
    import socket

    with _server() as srv:
        with socket.create_connection(("127.0.0.1", srv.port), timeout=60) as sock:
            sock.settimeout(60)
            sock.sendall(framing.encode_frame(words, seq=0, config=True))
            sock.sendall(framing.encode_iq_frame(iq, seq=1, last=True))
            dec = framing.FrameDecoder()
            got = []
            while not got:
                got.extend(dec.feed(sock.recv(1 << 16)))
    thr, bins, pk = packing.unpack_cfar_words(got[0].words, 8)
    # fft shrunk to 128: bins >= 128 have zero threshold and no peaks
    assert np.all(thr[128:] == 0) and not pk[128:].any()
    assert pk[32] and pk[64]


def test_served_drops_wrong_frame_length():
    iq = three_tone_signal(256, shift_range_factor=12).astype(np.complex64)
    import socket, time

    with _server() as srv:
        with socket.create_connection(("127.0.0.1", srv.port), timeout=60) as sock:
            sock.settimeout(60)
            sock.sendall(framing.encode_iq_frame(np.zeros(100, np.complex64), seq=0))
            sock.sendall(framing.encode_iq_frame(iq, seq=1, last=True))
            dec = framing.FrameDecoder()
            got = []
            t0 = time.time()
            while not got and time.time() - t0 < 60:
                got.extend(dec.feed(sock.recv(1 << 16)))
    assert got[0].seq == 1  # the malformed frame was dropped, the good one served


def test_served_config_frame_merges_not_resets():
    """A config frame naming ONE register must not reset the others to
    make() defaults (a register write channel merges), and a frame violating
    the elaborated maxima is dropped and counted, leaving the file intact."""
    import socket
    import time as _time

    def send_cfg(sock, kw):
        payload = json.dumps(kw).encode() + b"\0"
        pad = (-len(payload)) % 4
        words = np.frombuffer(payload + b"\0" * pad, np.uint32)
        sock.sendall(framing.encode_frame(words, seq=0, config=True))

    with _server() as srv:
        with socket.create_connection(("127.0.0.1", srv.port), timeout=60) as sock:
            sock.settimeout(60)
            send_cfg(sock, {"threshold_scaler": 9.0})   # single-register write
            deadline = _time.time() + 10
            while _time.time() < deadline:
                regs = srv._pipe.runtime.peek()
                if regs["threshold_scaler"] == 9.0:
                    break
                _time.sleep(0.05)
            regs = srv._pipe.runtime.peek()
            assert regs["threshold_scaler"] == 9.0
            # every other register kept its configured (non-default) value
            assert regs["fft_size"] == 256
            assert regs["ref_window_size"] == 8

            # invalid write (require(): window must be a power of two):
            # dropped + counted, registers untouched
            before = dict(regs)
            send_cfg(sock, {"ref_window_size": 3})
            deadline = _time.time() + 10
            while _time.time() < deadline and srv.config_errors == 0:
                _time.sleep(0.05)
            assert srv.config_errors == 1
            assert srv._pipe.runtime.peek() == before


def test_served_run_last_register_drives_frame_flag():
    """The runLast CSR analog (MemForTesting.scala:86-93): a config-frame
    write of mem_run_last=0 clears FLAG_LAST on subsequent reply frames."""
    import socket

    iq = three_tone_signal(256, shift_range_factor=12).astype(np.complex64)
    cfg_payload = json.dumps({"mem_run_last": 0}).encode() + b"\0"
    pad = (-len(cfg_payload)) % 4
    words = np.frombuffer(cfg_payload + b"\0" * pad, np.uint32)

    with _server() as srv:
        results = request_frames("127.0.0.1", srv.port, [iq])
        assert results[0].last            # default: register resets to 1
        with socket.create_connection(("127.0.0.1", srv.port), timeout=60) as sock:
            sock.settimeout(60)
            sock.sendall(framing.encode_frame(words, seq=0, config=True))
            sock.sendall(framing.encode_iq_frame(iq, seq=1, last=True))
            dec = framing.FrameDecoder()
            got = []
            while not got:
                got.extend(dec.feed(sock.recv(1 << 16)))
        assert not got[0].last
        assert srv.config_errors == 0
