"""Multi-host (DCN) execution scaffold (SURVEY §2.15 inter-host row; BASELINE
config 5: continuous multi-CPI streaming on N >= 2 hosts).

The reference's only inter-host story is a UART to a PC; the scaling model
here is the JAX distributed runtime: every host runs the same program,
``jax.distributed.initialize`` wires the cluster over the data-center network
(DCN), and a global mesh is laid out so the fastest-varying axes stay inside a
host's device interconnect while only the CPI/time-block axis crosses hosts
(halo-free by construction — CPIs are independent work units; the CFAR/FIR
halos stay inside each host's ``rng`` axis).

On a single-process environment (CI, one chip) every function degrades to the
local-device mesh, so the same pipeline code runs everywhere.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np

from .mesh import CHANNEL_AXIS, RANGE_AXIS

TIME_AXIS = "cpi"  # CPI/time-block axis — the only axis that crosses DCN


def initialize_cluster(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Join the JAX distributed runtime (no-op for a single process). Returns
    the process index."""
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return jax.process_index()


def make_pod_mesh(
    time_blocks: Optional[int] = None,
    channels: Optional[int] = None,
    range_shards: int = 1,
) -> jax.sharding.Mesh:
    """A 3-D (cpi, ch, rng) mesh over all global devices.

    Layout rule (the scaling-book recipe): the mesh's *innermost* axes map to
    devices that share a host's interconnect, so ``rng`` (halo exchange) and ``ch`` stay
    intra-host; ``cpi`` (independent CPI blocks, no collectives) is the axis
    that spans hosts over DCN. Default: one time block per host."""
    # ORDER the device list by process before reshaping: jax.devices() makes
    # no process-contiguity promise (multi-host slices can interleave hosts in
    # global-id order), and a raw reshape would put devices from different
    # hosts in the same (ch, rng) row — the halo-carrying rng axis would then
    # cross DCN on every CPI, exactly the layout this mesh exists to rule out.
    # Stable sort by (process_index, id) keeps each host's devices contiguous
    # along the leading cpi axis (one or more whole time blocks per host).
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    devs = np.asarray(devs)
    n = devs.size
    if time_blocks is None:
        time_blocks = max(jax.process_count(), 1)
    if channels is None:
        channels = n // (time_blocks * range_shards)
    need = time_blocks * channels * range_shards
    if need != n:
        raise ValueError(
            f"mesh {time_blocks}x{channels}x{range_shards} != {n} devices")
    per_host = n // max(jax.process_count(), 1)
    if per_host % (channels * range_shards) != 0:
        # each [C, R] time block consumes C·R consecutive (same-host) devices;
        # the per-host device count must hold a whole number of blocks or a
        # block would straddle two hosts
        raise ValueError(
            f"layout {time_blocks}x{channels}x{range_shards} cannot keep "
            f"(ch, rng) intra-host with {per_host} devices/host — pick "
            "channels*range_shards dividing the per-host device count")
    grid = devs.reshape(time_blocks, channels, range_shards)
    return jax.sharding.Mesh(grid, (TIME_AXIS, CHANNEL_AXIS, RANGE_AXIS))


def pod_spec(batch_axes: int = 1) -> jax.sharding.PartitionSpec:
    """PartitionSpec for [cpi_blocks, channels, ..., range] arrays."""
    P = jax.sharding.PartitionSpec
    mid = (None,) * (batch_axes - 1)
    return P(TIME_AXIS, CHANNEL_AXIS, *mid, RANGE_AXIS)


class PodStreamingPipeline:
    """Continuous multi-CPI streaming over a pod mesh (BASELINE config 5):
    the multi-host ``io.stream.StreamingPipeline``.

    Every process runs the same SPMD program: each submitted CPI batch
    ([T, C, ..., N] — identical host content on every process, the usual
    replicated-ingest contract) is placed as a globally-sharded ``jax.Array``
    via ``make_array_from_callback`` (a process materializes only its
    addressable shards — the DCN never carries bulk samples), then one jitted
    pod step (``shard_cpi_stream``) processes it; per-CPI detection counts in
    the metrics are GLOBAL (an on-device reduction over the pod array, fetched
    as one scalar). Checkpoint/restore rides the inherited ``checkpoint``
    (register file + stream cursor; every process writes/reads identically, so
    a restarted fleet resumes from the same registers and sequence point).

    SPMD ordering contract: every process must ``submit`` the same sequence —
    the single worker + single drainer threads then issue the collective
    programs in matching order on all processes."""

    def __init__(self, chain_fn, rt, mesh: jax.sharding.Mesh, **kw):
        from ..io.stream import StreamingPipeline

        outer_mesh = mesh

        class _Pod(StreamingPipeline):
            def _place(self, jax_mod, cpi):
                a = np.asarray(cpi)
                spec = pod_spec(batch_axes=a.ndim - 2)
                sh = jax_mod.sharding.NamedSharding(outer_mesh, spec)

                def mk(plane):
                    return jax_mod.make_array_from_callback(
                        plane.shape, sh, lambda idx: plane[idx])

                if np.iscomplexobj(a):
                    from ..cplx import C

                    return C(mk(np.ascontiguousarray(a.real.astype(np.float32))),
                             mk(np.ascontiguousarray(a.imag.astype(np.float32))))
                return mk(a)

        self._pipe = _Pod(shard_cpi_stream(chain_fn, mesh), rt, **kw)

    def __getattr__(self, name):
        if name == "_pipe":
            # _pipe unset (e.g. attribute access before __init__ completes,
            # copy/pickle protocols): a plain AttributeError, not the
            # RecursionError a self._pipe dereference would loop into
            raise AttributeError(name)
        return getattr(self._pipe, name)

    def __enter__(self):
        self._pipe.start()
        return self

    def __exit__(self, *exc):
        self._pipe.stop()


def shard_cpi_stream(pipeline_fn, mesh: jax.sharding.Mesh):
    """Wrap a per-CPI pipeline ``f(x, rt)`` for pod execution: input
    [T, C, P, N] (T CPI blocks x C channels x P pulses x N range) sharded over
    (cpi, ch, -, rng). CPI blocks process independently; the inner pipeline's
    own collectives (range halos) stay within a host."""
    def run(x, rt):
        spec = pod_spec(batch_axes=x.ndim - 2)  # [T, C, ..., N]
        x = jax.lax.with_sharding_constraint(
            x, jax.sharding.NamedSharding(mesh, spec))
        return pipeline_fn(x, rt)

    return jax.jit(run)
