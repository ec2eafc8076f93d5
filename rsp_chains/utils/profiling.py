"""Tracing / profiling (SURVEY §5.1).

The reference's observability is Verilator waveform dumps; the analogs here are
``jax.profiler`` traces (every chain stage already runs under a
``jax.named_scope``, so each compiled op carries its stage in its ``op_name``
metadata), a reduction from a trace to device time per stage, and wall-clock
per-stage timing sweeps."""

from __future__ import annotations

import collections
import contextlib
import glob
import os
import re
import time
from typing import Callable, Dict, Iterable


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace of the enclosed block (open with xprof /
    tensorboard). Stage named_scopes appear as trace annotations."""
    import jax

    with jax.profiler.trace(log_dir):
        yield log_dir


# `%name = ... metadata={... op_name="jit(f)/stage/..." ...}` in HLO text
_HLO_INSTR = re.compile(
    r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?metadata=\{[^}]*?op_name="([^"]*)"',
    re.M)


def hlo_op_names(hlo_text: str) -> Dict[str, str]:
    """Instruction name -> ``op_name`` metadata (the ``jax.named_scope`` path)
    for every instruction of a compiled module's HLO text
    (``jax.jit(f).lower(...).compile().as_text()``)."""
    return {m.group(1): m.group(2) for m in _HLO_INSTR.finditer(hlo_text)}


def xplane_file(log_dir: str) -> str:
    """The newest ``.xplane.pb`` that ``jax.profiler.trace(log_dir)`` wrote."""
    files = glob.glob(os.path.join(log_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not files:
        raise FileNotFoundError(f"no .xplane.pb under {log_dir}")
    return max(files, key=os.path.getmtime)


def device_time_by_stage(xplane_path: str, stages: Iterable[str],
                         op_names: Dict[str, str] | None = None,
                         plane_prefix: str = "/device:GPU"):
    """Device time per chain stage and per kernel, and busy time, from a
    profiler trace.

    Takes every event that names an HLO op (its ``hlo_op`` stat) on the planes
    whose name starts with ``plane_prefix``. An event belongs to the first
    component of its scope path that is one of ``stages``. The path is the
    first of these that names a stage: the event's ``name`` stat (where the
    GPU tracer records the ``jax.named_scope`` path), then the ``op_name`` of
    its ``hlo_op``, then that of the kernel's own name (kernels launched from
    a CUDA graph report ``hlo_op`` = ``command_buffer`` but keep their fusion
    name), both looked up in ``op_names`` (``hlo_op_names`` of the compiled
    module). Events in no stage (XLA-inserted copies, fusions whose root
    carries no scope) go to ``"other"``.

    Returns ``(seconds per stage, seconds per kernel name, busy seconds,
    window seconds)``: busy is the union of the event intervals, the window
    spans the first start to the last end (idle share = 1 - busy / window)."""
    from jax.profiler import ProfileData

    stages = set(stages)
    op_names = op_names or {}
    per_stage: Dict[str, float] = collections.defaultdict(float)
    per_kernel: Dict[str, float] = collections.defaultdict(float)
    spans = []
    for plane in ProfileData.from_file(xplane_path).planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                op = stats.get("hlo_op")
                if not op:
                    continue
                paths = (stats.get("name"), op_names.get(str(op)),
                         op_names.get(ev.name))
                stage = next((c for path in paths if path
                              for c in str(path).split("/") if c in stages),
                             "other")
                per_stage[stage] += ev.duration_ns * 1e-9
                per_kernel[ev.name] += ev.duration_ns * 1e-9
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    busy = 0.0
    end = None
    for s, e in sorted(spans):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    window = (max(e for _, e in spans) - min(s for s, _ in spans)
              if spans else 0.0)
    return dict(per_stage), dict(per_kernel), busy * 1e-9, window * 1e-9


def _timeit(fn: Callable, *args, iters: int = 20, warmup: int = 3) -> float:
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        jax.block_until_ready(fn(*args))
    return (time.perf_counter() - t0) / iters


def stage_timings(chain, x, rt, iters: int = 20) -> Dict[str, float]:
    """Wall-clock seconds per cumulative stage prefix of a chain. Each prefix is
    jitted separately; the marginal cost of stage k is t[k] - t[k-1] (fusion
    means stages are not independently timeable — the prefix deltas are the
    honest number)."""
    import jax

    from ..chain import Chain

    out: Dict[str, float] = {}
    for k in range(1, len(chain.stages) + 1):
        prefix = Chain(chain.cfg, chain.stages[:k])
        f = jax.jit(prefix.__call__)
        out[chain.stages[k - 1].name] = _timeit(f, x, rt, iters=iters)
    return out
