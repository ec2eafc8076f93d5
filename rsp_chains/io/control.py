"""Debug control port — the analog of ``jtag2mm`` (SURVEY §2.7).

The reference declares a JTAG -> AXI4-MM master so a debug probe can issue the
same register reads/writes the host testers issue, *independently of* and
*concurrently with* the normal host link. The analog here: a tiny line-JSON TCP
listener attached to a running ``StreamingPipeline`` that peeks and pokes the
runtime register file between CPIs:

* ``{"peek": true}``                 -> ``{"ok": true, "regs": {...}}``
* ``{"threshold_scaler": 4.0, ...}`` -> validated merge into the live register
  file (``RuntimeConfig.make`` ``require(...)``s, elaborated maxima included),
  applied from the next CPI — the reference's config-at-frame-boundary ordering
  (SURVEY §3.3). Bad writes are rejected without disturbing the stream:
  ``{"ok": false, "error": ...}``.

This is deliberately NOT the data-plane server (``io.server.ChainServer``):
like JTAG vs UART in the reference, it is a second, independent control master.
"""

from __future__ import annotations

import json
import socket
import socketserver
import threading
from typing import Callable, Optional

from ..configs import RuntimeConfig


class ControlServer:
    """Line-JSON register peek/poke listener for a running pipeline.

    Args:
      get_rt: returns the pipeline's current ``RuntimeConfig``.
      set_rt: applies a new ``RuntimeConfig`` (e.g. ``pipeline.reconfigure``).
      cfar_cfg: elaborated ``CfarConfig`` maxima for write validation (the
          hardware would reject out-of-range registers at elaboration; the
          debug master must not be able to smuggle them in at runtime).
      host/port: bind address (port 0 = ephemeral; see ``.port``).
    """

    def __init__(self, get_rt: Callable[[], RuntimeConfig],
                 set_rt: Callable[[RuntimeConfig], None],
                 cfar_cfg=None, host: str = "127.0.0.1", port: int = 0,
                 update_rt: Optional[Callable] = None):
        outer = self
        self._get_rt = get_rt
        self._set_rt = set_rt
        # atomic read-modify-write primitive (StreamingPipeline.update_runtime):
        # the poke's merge must run under the SAME lock the data plane's
        # reconfigure takes, or a concurrent config write landing between the
        # peek and the set would be silently reverted wholesale. The local
        # _poke_lock alone only serializes pokes against each other.
        self._update_rt = update_rt
        self._cfar_cfg = cfar_cfg
        self._poke_lock = threading.Lock()  # serialize read-merge-write pokes

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                for raw in self.rfile:
                    line = raw.strip()
                    if not line:
                        continue
                    try:
                        resp = outer._dispatch(json.loads(line))
                    except Exception as e:  # noqa: BLE001 — malformed request
                        resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                    self.wfile.write((json.dumps(resp) + "\n").encode())
                    self.wfile.flush()

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._srv = Server((host, port), Handler)
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)

    def _dispatch(self, req: dict) -> dict:
        if not isinstance(req, dict):
            raise ValueError("request must be a JSON object")
        if req.get("peek"):
            return {"ok": True, "regs": self._get_rt().peek()}

        def merge(cur: RuntimeConfig) -> RuntimeConfig:
            # scalar register writes only; array state (PLFG profile RAM)
            # is preserved across the merge
            return cur.merge_regs(validate_against=self._cfar_cfg, **req)

        with self._poke_lock:
            if self._update_rt is not None:
                rt = self._update_rt(merge)   # atomic vs data-plane writes
            else:
                rt = merge(self._get_rt())
                self._set_rt(rt)
        return {"ok": True, "regs": rt.peek()}

    @property
    def port(self) -> int:
        return self._srv.server_address[1]

    def start(self) -> "ControlServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def poke(host: str, port: int, overrides: Optional[dict] = None,
         timeout: float = 10.0) -> dict:
    """One-shot debug-master transaction: peek (no overrides) or poke.

    Returns the server's response dict; raises ``RuntimeError`` on a rejected
    write so scripted pokes fail loudly."""
    req = overrides if overrides else {"peek": True}
    with socket.create_connection((host, port), timeout=timeout) as sock:
        sock.sendall((json.dumps(req) + "\n").encode())
        f = sock.makefile("r")
        resp = json.loads(f.readline())
    if not resp.get("ok"):
        raise RuntimeError(f"poke rejected: {resp.get('error')}")
    return resp
