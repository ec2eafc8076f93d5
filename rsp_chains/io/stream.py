"""Streaming/serving harness — the deployment analog of ``RxFftMagCfarTxChain``
(SURVEY §2.11/§3.5): host ingest -> bounded queue -> jitted chain per CPI ->
host drain, with watermark callbacks (the UART FIFO watermark-interrupt analog,
``DSPBlockUART.scala:168-173``) and per-CPI metrics (SURVEY §5.5).

Throughput design: the worker thread overlaps host->device transfer of CPI k+1
with device compute of CPI k (JAX async dispatch provides the double-buffering the
hardware got from elastic stream FIFOs); results are fetched asynchronously so the
device never waits on the host drain."""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np


@dataclass
class CpiMetrics:
    """Per-CPI observability record (samples/s, detections — SURVEY §5.5)."""

    seq: int
    samples: int
    detections: int
    latency_s: float
    samples_per_s: float


@dataclass
class StreamStats:
    frames_in: int = 0
    frames_out: int = 0
    frames_dropped: int = 0
    frames_failed: int = 0
    total_samples: int = 0
    total_time_s: float = 0.0
    # per-phase serving-cost attribution (VERDICT r4 item 3): cumulative
    # seconds spent in each pipeline phase. ``place``/``dispatch`` are
    # issue-side (async work launches there, so they under-report transfer);
    # ``block`` on the drain thread absorbs whatever had not completed —
    # the sum of the phases bounds the serialized serving cost per CPI.
    t_queue_wait: float = 0.0   # worker idle, waiting for submit
    t_place: float = 0.0        # host -> device operand build (device_put)
    t_dispatch: float = 0.0     # jitted chain async dispatch
    t_block: float = 0.0        # drain block_until_ready (residual compute
    #                             + transfer not overlapped by issue)
    t_result: float = 0.0       # metrics + on_result callback

    def __post_init__(self):
        # counters are mutated from the submit caller, the worker, and the
        # drainer concurrently; unlocked += lost updates (ADVICE r1 / VERDICT
        # weak 7)
        self._lock = threading.Lock()

    def bump(self, **deltas):
        with self._lock:
            for k, v in deltas.items():
                setattr(self, k, getattr(self, k) + v)

    def set_time(self, t: float):
        with self._lock:
            self.total_time_s = t

    @property
    def samples_per_s(self) -> float:
        return self.total_samples / self.total_time_s if self.total_time_s else 0.0

    def phase_ms_per_cpi(self) -> dict:
        """Per-CPI phase table in ms (over completed CPIs) — the serving-cost
        attribution the bench's streaming line records."""
        n = max(self.frames_out, 1)
        with self._lock:
            return {k: round(getattr(self, k) / n * 1e3, 2)
                    for k in ("t_queue_wait", "t_place", "t_dispatch",
                              "t_block", "t_result")}

    def phase_totals(self) -> dict:
        """Raw cumulative phase seconds — lets a caller snapshot before a
        measurement window and diff after, excluding warm-up CPIs from the
        per-CPI attribution."""
        with self._lock:
            return {k: getattr(self, k)
                    for k in ("t_queue_wait", "t_place", "t_dispatch",
                              "t_block", "t_result")}


class StreamingPipeline:
    """Continuous multi-CPI execution of a jitted chain.

    Args:
      fn: jitted ``(x, rt) -> CfarOutput`` chain.
      rt: RuntimeConfig applied per CPI (swap with ``reconfigure`` between CPIs —
          config applies at CPI boundaries, mirroring the reference's
          config-before-enable ordering, SURVEY §3.3).
      on_result: callback(seq, output, CpiMetrics) on the drain thread.
      depth: ingest queue depth (the RX FIFO nEntries analog).
      watermark: (low, high) queue depths; ``on_watermark(level)`` fires on
          crossings (the txwm/rxwm interrupt analog).
      drop_on_full: if True, overflow drops newest frame (real-time radar
          semantics); else ``submit`` blocks.
      on_error: callback(seq, exception) for per-CPI failures. The pipeline is
          elastic (SURVEY §5.3): one failed CPI is counted and skipped, the
          stream keeps running — the per-frame restartability the hardware gets
          from its (almost) stateless pipeline.
    """

    def __init__(
        self,
        fn: Callable,
        rt,
        on_result: Optional[Callable[[int, Any, CpiMetrics], None]] = None,
        depth: int = 8,
        watermark: tuple[int, int] = (1, 6),
        on_watermark: Optional[Callable[[str], None]] = None,
        drop_on_full: bool = False,
        on_error: Optional[Callable[[int, Exception], None]] = None,
        detections_every: int = 1,
        block_every: int = 1,
    ):
        self._fn = fn
        self._rt = rt
        # drain sync cadence: 1 = block_until_ready per CPI (exact per-CPI
        # latency + error attribution). K>1 = block only every K-th result
        # and whenever the drain is caught up — sound on a single device
        # stream (executions complete in dispatch order, so the K-th done
        # implies the K-1 before it are done); per-CPI latency then measures
        # drain-pop time and a deferred device error surfaces at the next
        # blocked CPI. A block_until_ready per CPI serializes the host with
        # the device, which caps serving when the per-CPI sync is slow.
        self._block_every = max(block_every, 1)
        self._drained_n = 0
        # detection-count fetch cadence: 1 = per-CPI scalar fetch (exact
        # CpiMetrics.detections). K>1 = accumulate on device and refresh
        # ``detections_total`` every K CPIs; CpiMetrics.detections is ALWAYS
        # -1 in this mode (read the running total from ``detections_total``
        # or ``flush_detections()``). 0 = accumulate, fetch only on
        # ``flush_detections()``. Serving deployments should not pay a
        # device->host round-trip per CPI for a metric (VERDICT r4 item 3). Accumulation
        # runs with or without an on_result consumer.
        self._detections_every = detections_every
        self.detections_total = 0
        self._rt_lock = threading.Lock()
        self._on_result = on_result
        self._on_watermark = on_watermark
        self._on_error = on_error
        self._wm_low, self._wm_high = watermark
        self._drop_on_full = drop_on_full
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._outq: queue.Queue = queue.Queue()
        self.stats = StreamStats()
        self._stop = threading.Event()
        self._worker_done = threading.Event()
        self._wm_level: Optional[str] = None   # edge-trigger state
        self._wm_lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._drainer = threading.Thread(target=self._drain, daemon=True)
        self._started = False

    # -- control plane ------------------------------------------------------

    def start(self):
        if not self._started:
            self._worker.start()
            self._drainer.start()
            self._started = True
        return self

    def reconfigure(self, rt):
        """Swap the runtime register file; applies from the next CPI."""
        with self._rt_lock:
            self._rt = rt

    def update_runtime(self, fn):
        """Atomically transform the register file: ``fn(current) -> new`` runs
        under the same lock ``reconfigure``/``runtime`` take, so a concurrent
        config write cannot interleave between a debug master's read and its
        merged write (which would silently revert it wholesale). Returns the
        new register file."""
        with self._rt_lock:
            self._rt = fn(self._rt)
            return self._rt

    @property
    def runtime(self):
        """The live runtime register file (debug-master read channel)."""
        with self._rt_lock:
            return self._rt

    def stop(self, wait: bool = True):
        self._stop.set()
        if wait and self._started:
            self._worker.join(timeout=30)
            self._drainer.join(timeout=30)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- data plane ---------------------------------------------------------

    def _update_watermark(self):
        """Edge-triggered watermark interrupts: ``on_watermark(level)`` fires
        once per CROSSING into the high/low band (the reference's txwm/rxwm
        interrupts are level comparators feeding edge-latched pending bits,
        ``DSPBlockUART.scala:168-173``) — not once per frame while the queue
        sits at a level, which would be an interrupt storm for any handler
        that treats each call as an event."""
        if self._on_watermark is None:
            return
        q = self._q.qsize()
        level = ("high" if q >= self._wm_high
                 else "low" if q <= self._wm_low else None)
        with self._wm_lock:
            fire = level is not None and level != self._wm_level
            self._wm_level = level
        if fire:
            self._on_watermark(level)

    def submit(self, seq: int, cpi: np.ndarray) -> bool:
        """Enqueue one CPI block. Returns False if dropped (drop_on_full)."""
        try:
            self._q.put((seq, cpi, time.perf_counter()),
                        block=not self._drop_on_full)
        except queue.Full:
            self.stats.bump(frames_dropped=1)
            return False
        self.stats.bump(frames_in=1)
        self._update_watermark()
        return True

    def _run(self):
        import jax

        t_start = None
        try:
            self._run_loop(jax, t_start)
        finally:
            self._worker_done.set()

    def _run_loop(self, jax, t_start):
        while not self._stop.is_set() or not self._q.empty():
            t_w = time.perf_counter()
            try:
                seq, cpi, t_in = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            self.stats.bump(t_queue_wait=time.perf_counter() - t_w)
            self._update_watermark()
            with self._rt_lock:
                rt = self._rt
            try:
                t_p = time.perf_counter()
                x = self._place(jax, cpi)
                t_d = time.perf_counter()
                out = self._fn(x, rt)      # async dispatch
                t_e = time.perf_counter()
                self.stats.bump(t_place=t_d - t_p, t_dispatch=t_e - t_d)
            except Exception as e:         # noqa: BLE001 — elastic: skip the CPI
                self.stats.bump(frames_failed=1)
                if self._on_error:
                    self._on_error(seq, e)
                continue
            self._outq.put((seq, out, t_in, int(np.prod(cpi.shape))))
            if t_start is None:
                t_start = time.perf_counter()
            self.stats.set_time(time.perf_counter() - (t_start or 0))

    def _place(self, jax, cpi):
        """Host CPI -> device operand. Overridden by the pod variant
        (``parallel.multihost.PodStreamingPipeline``) to build globally-sharded
        arrays; the single-process default device-puts locally."""
        if np.iscomplexobj(cpi):
            # complex never touches the device: host-split to a pair
            from ..cplx import as_pair

            return as_pair(np.asarray(cpi))
        return jax.device_put(cpi)  # overlaps with prior CPI's compute

    def checkpoint(self, path, cpi_buffer=None, **extra):
        """Write the pipeline's restartable state — the live register file
        (+ optional CPI corner-turn buffer, + caller extras such as the
        stream cursor) — via ``io.cpi.save_state`` (SURVEY §5.4)."""
        from .cpi import save_state

        save_state(path, self.runtime, cpi=cpi_buffer, **extra)

    def _drain(self):
        import jax

        # terminal only when the WORKER is also done: on stop() the worker may
        # hold a popped frame it has not yet pushed to _outq — an empty _outq
        # alone must not end the drain or that in-flight result is dropped
        while not (self._stop.is_set() and self._worker_done.is_set()
                   and self._outq.empty()):
            try:
                seq, out, t_in, n_samples = self._outq.get(timeout=0.05)
            except queue.Empty:
                continue
            try:
                self._drained_n += 1
                blocked = (self._block_every == 1
                           or self._drained_n % self._block_every == 0)
                if blocked:
                    t_b = time.perf_counter()
                    out = jax.block_until_ready(out)
                    self.stats.bump(t_block=time.perf_counter() - t_b)
                    # single device stream: this completion implies every
                    # earlier dispatch completed — the owed block is paid
                    self._pending_block = None
                else:
                    self._pending_block = out   # completion owed at stop
            except Exception as e:         # noqa: BLE001 — deferred device error
                self.stats.bump(frames_failed=1)
                if self._on_error:
                    self._on_error(seq, e)
                continue
            lat = time.perf_counter() - t_in
            self.stats.bump(frames_out=1, total_samples=n_samples)
            try:
                self._deliver(seq, out, lat, n_samples)
            except Exception as e:  # noqa: BLE001 — a metrics/callback error
                # must never kill the drain thread (the r5 multihost hang:
                # a mixed-device jit raised here and the stream froze)
                if self._on_error:
                    self._on_error(seq, e)
        # block_every > 1 leaves the tail CPIs' completion owed: pay it so
        # stop() means "all submitted work finished on device"
        pend = getattr(self, "_pending_block", None)
        if pend is not None:
            try:
                t_b = time.perf_counter()
                jax.block_until_ready(pend)
                self.stats.bump(t_block=time.perf_counter() - t_b)
            except Exception as e:  # noqa: BLE001 — deferred device error
                self.stats.bump(frames_failed=1)
                if self._on_error:
                    self._on_error(-1, e)
            self._pending_block = None

    def _deliver(self, seq, out, lat, n_samples):
        """Metrics + on_result delivery for one drained CPI (split out of the
        drain loop so its failures are contained per CPI). Detection
        accumulation happens here even with no on_result consumer — a
        callback-less serving deployment still gets ``detections_total`` /
        ``flush_detections()``."""
        t_r = time.perf_counter()
        if hasattr(out, "peaks"):
            # reduce ON DEVICE and fetch one scalar: this is the
            # streaming hot path, and a full-array device->host
            # fetch per CPI would cost the drain its bandwidth. Under
            # jit, not eager: the pod pipeline's outputs are global
            # (not fully addressable) arrays, which eager ops reject —
            # the jitted SPMD reduction is the sanctioned path and
            # yields the GLOBAL detection count on every process.
            # The scalar FETCH is deferred (VERDICT r4 item 3): the
            # count accumulates on device and reaches the host only
            # every ``detections_every``-th CPI; in between,
            # ``CpiMetrics.detections = -1`` ("not fetched yet") and
            # ``detections_total`` carries the running device total.
            import jax as _jax
            import jax.numpy as jnp

            if not hasattr(self, "_det_fn"):
                self._det_fn = _jax.jit(
                    lambda p: jnp.sum(p.astype(jnp.int32)))
                self._det_add = _jax.jit(lambda a, b: a + b)
                # the accumulator must inherit the reduction's OWN
                # sharding: on a pod pipeline ``peaks`` is a global
                # multi-process array and an eagerly-created local
                # zero would make `acc + sum(peaks)` a mixed-device
                # jit that kills the drain thread (r5 full-matrix
                # catch) — so seed it from the first reduction
                self._det_acc = None
                self._det_n = 0
            part = self._det_fn(out.peaks)   # replicated, async
            self._det_acc = (part if self._det_acc is None
                             else self._det_add(self._det_acc, part))
            self._det_n += 1
            k = self._detections_every
            if k == 1:
                # the per-CPI exact count only feeds CpiMetrics — skip its
                # fetch when nobody consumes metrics
                det = int(part) if self._on_result is not None else -1
                self.detections_total = int(self._det_acc)
            elif k > 1 and self._det_n % k == 0:
                det = -1
                self.detections_total = int(self._det_acc)
            else:
                det = -1   # deferred: no host fetch this CPI
        else:
            det = 0
        if self._on_result is None:
            return
        self._on_result(
            seq, out,
            CpiMetrics(seq=seq, samples=n_samples, detections=det,
                       latency_s=lat,
                       samples_per_s=n_samples / max(lat, 1e-9)),
        )
        self.stats.bump(t_result=time.perf_counter() - t_r)

    def flush_detections(self) -> int:
        """Force-fetch the accumulated on-device detection count (one scalar
        to the host); updates and returns ``detections_total``."""
        if getattr(self, "_det_acc", None) is not None:
            self.detections_total = int(self._det_acc)
        return self.detections_total
