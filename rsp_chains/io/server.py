"""TCP serving front-end — the network-age analog of the reference's UART host
link (SURVEY §L1/§2.11): clients stream framed IQ (``io.framing`` format) over a
socket; the server runs the chain per frame and streams back CFAR output words
in the same frame format (bit 0 peak / bin / threshold words,
``RspChainVanillaTester.scala:164-172``).

One worker (the device) serves all connections through a single
``StreamingPipeline``; per-connection sequence numbers route results back.
Config frames (FLAG_CONFIG) carry a JSON RuntimeConfig override — the register
write channel, applied at the next CPI boundary like the reference's
config-before-enable ordering (SURVEY §3.3)."""

from __future__ import annotations

import json
import queue
import socket
import socketserver
import threading


import numpy as np

from ..configs import RuntimeConfig
from . import framing
from .stream import StreamingPipeline


class ChainServer:
    """Serve a jitted chain over TCP.

    Args:
      chain_fn: jitted ``(iq, rt) -> CfarOutput``.
      rt: initial runtime register file.
      frame_len: elaborated frame length (IQ samples per frame).
      log2_fft_size: bin width for output-word packing.
      host/port: bind address (port 0 = ephemeral; see ``.port``).
    """

    def __init__(self, chain_fn, rt: RuntimeConfig, frame_len: int,
                 log2_fft_size: int, host: str = "127.0.0.1", port: int = 0,
                 cfar_cfg=None):
        self._chain = chain_fn
        self._rt = rt
        self._cfar_cfg = cfar_cfg  # elaborated maxima for config-frame validation
        self._frame_len = frame_len
        self._log2n = log2_fft_size
        self._routes = {}
        self._routes_lock = threading.Lock()
        self._next_key = iter(range(1 << 62))
        self.config_errors = 0      # rejected config frames (sticky-error analog)
        self.results_dropped = 0    # results dropped on a stalled client's queue

        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                dec = framing.FrameDecoder()
                sock = self.request
                # per-connection sender: result delivery must never block the
                # pipeline's single drain thread on one stalled client's TCP
                # buffer (which would starve every other connection). A slow
                # client's results are dropped once its bounded queue fills.
                sendq: queue.Queue = queue.Queue(maxsize=64)

                def sender():
                    while True:
                        payload = sendq.get()
                        if payload is None:
                            return
                        try:
                            sock.sendall(payload)
                        except OSError:
                            return  # connection gone; drain-and-drop below

                st = threading.Thread(target=sender, daemon=True)
                st.start()
                try:
                    while True:
                        try:
                            chunk = sock.recv(1 << 16)
                        except OSError:
                            break
                        if not chunk:
                            break
                        for frame in dec.feed(chunk):
                            if frame.config:
                                outer._apply_config(frame)
                                continue
                            iq = frame.iq
                            if iq.size != outer._frame_len:
                                continue  # wrong beat count: drop (width-adapter analog)
                            key = next(outer._next_key)
                            with outer._routes_lock:
                                outer._routes[key] = (sendq, frame.seq,
                                                      frame.channel)
                            outer._pipe.submit(key, iq[None])
                finally:
                    try:
                        sendq.put_nowait(None)
                    except queue.Full:
                        # sender is stalled in sendall on a dead socket; it
                        # exits on the OSError. Daemon thread either way.
                        pass

        self._server = socketserver.ThreadingTCPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._pipe = StreamingPipeline(
            chain_fn, rt, on_result=self._on_result,
            on_error=self._on_error, depth=32,
        )
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)

    # -- plumbing ------------------------------------------------------------

    def _apply_config(self, frame: framing.Frame) -> None:
        try:
            kw = json.loads(bytes(frame.words.view(np.uint8)).split(b"\0")[0])

            # MERGE into the live register file (atomically vs other writers):
            # a config frame is a register WRITE of the named fields only —
            # rebuilding from make() defaults would silently reset every
            # unnamed register (or reject the frame when a default exceeds
            # the elaborated maxima). Validation = the require() analog:
            # out-of-range writes are dropped, not clamped on-device.
            def merge(cur: RuntimeConfig) -> RuntimeConfig:
                return cur.merge_regs(validate_against=self._cfar_cfg, **kw)

            self._rt = self._pipe.update_runtime(merge)
        except Exception:  # noqa: BLE001 — bad config frame: count + ignore
            # no NACK channel in the wire format (the reference's parity error
            # is a sticky status bit) — surface through stats instead
            self.config_errors += 1

    def _pop_route(self, key):
        with self._routes_lock:
            return self._routes.pop(key, None)

    def _on_result(self, key, out, metrics) -> None:
        route = self._pop_route(key)
        if route is None:
            return
        sendq, seq, channel = route
        from .. import packing

        words = np.asarray(packing.pack_cfar_words(
            out.threshold[0], out.peaks[0], self._log2n))
        # the runLast register (MemForTesting.scala:86-93 analog): the live
        # register file drives the emitted frame's last flag
        run_last = bool(int(np.asarray(self._rt.mem_run_last)))
        payload = framing.encode_frame(words, seq, last=run_last,
                                       channel=channel)
        try:
            sendq.put_nowait(payload)   # never block the shared drain thread
        except queue.Full:
            self.results_dropped += 1

    def _on_error(self, key, exc) -> None:
        self._pop_route(key)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ChainServer":
        self._pipe.start()
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._pipe.stop()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    @property
    def stats(self):
        return self._pipe.stats


def request_frames(host: str, port: int, frames, timeout: float = 60.0):
    """Simple blocking client: send framed IQ arrays, collect one result frame
    per request. ``frames``: list of complex arrays."""
    out = []
    with socket.create_connection((host, port), timeout=timeout) as sock:
        sock.settimeout(timeout)
        for i, iq in enumerate(frames):
            sock.sendall(framing.encode_iq_frame(np.asarray(iq), seq=i, last=True))
        dec = framing.FrameDecoder()
        while len(out) < len(frames):
            chunk = sock.recv(1 << 16)
            if not chunk:
                break
            out.extend(dec.feed(chunk))
    return out
