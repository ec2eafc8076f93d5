"""Device-mesh helpers (SURVEY §2.15).

The reference is a single-chip streaming design; its scaling axes map to:

* ``ch``  — channel/beam data parallelism (N chain instances in hardware terms):
  embarrassingly parallel, no collectives.
* ``rng`` — range-axis (fast-time) sequence parallelism: CFAR guard+reference
  windows and overlap-save FIR history cross shard boundaries -> neighbor halo
  exchange (``lax.ppermute``, NCCL between GPUs; SURVEY §5.7).

Meshes are built with ``jax.make_mesh`` so the same code runs on several cards,
on a single card (1x1 mesh), or on the 8-device CPU platform used by CI
(``tests/conftest.py``)."""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np

CHANNEL_AXIS = "ch"
RANGE_AXIS = "rng"


def make_mesh(
    channels: int = 1,
    range_shards: int = 1,
    devices: Optional[Sequence] = None,
) -> jax.sharding.Mesh:
    """A 2-D (ch, rng) mesh over the available devices."""
    devices = list(devices) if devices is not None else jax.devices()
    need = channels * range_shards
    if need > len(devices):
        raise ValueError(f"mesh {channels}x{range_shards} needs {need} devices, "
                         f"have {len(devices)}")
    dev = np.asarray(devices[:need]).reshape(channels, range_shards)
    return jax.sharding.Mesh(dev, (CHANNEL_AXIS, RANGE_AXIS))


def auto_mesh(n_devices: Optional[int] = None) -> jax.sharding.Mesh:
    """Default mesh: put everything on the channel axis unless range sharding is
    requested explicitly (channel parallelism needs no collectives and rides the
    fastest scaling path)."""
    n = n_devices if n_devices is not None else len(jax.devices())
    return make_mesh(channels=n, range_shards=1)


def chain_spec(batch_axes: int = 1) -> jax.sharding.PartitionSpec:
    """PartitionSpec for [channels, ..., range] arrays on a (ch, rng) mesh."""
    P = jax.sharding.PartitionSpec
    middle = (None,) * (batch_axes - 1)
    return P(CHANNEL_AXIS, *middle, RANGE_AXIS)
