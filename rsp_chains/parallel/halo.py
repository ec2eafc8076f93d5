"""Neighbor halo exchange over the range axis (SURVEY §5.7 / §2.15).

The window operators define exactly what crosses shard boundaries when the range
(fast-time) axis is sharded: CFAR needs ``guard + ref`` cells of halo on each side
(elaborated 64+4 cells in the reference config, ``RspChain.scala:134-135``); an
overlap-save FIR needs ``num_taps - 1`` cells of left halo. The mechanism is the
ring-neighbor exchange of sequence parallelism: one ``lax.ppermute`` per direction
between neighboring devices (NCCL on GPUs). Shards at the global frame edges
receive zeros (ppermute's semantics for absent sources), which composes with
``cfar_op``'s ``active_lo``/``active_hi`` masking to reproduce exact
frame-edge behaviour."""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def exchange_halo(x: jnp.ndarray, halo: int, axis_name: str):
    """Return (left_halo, right_halo) for each shard of a shard_mapped array.

    ``x``: local block [..., n_local]. ``left_halo`` is the last ``halo`` samples of
    the left neighbor (zeros on the first shard); ``right_halo`` the first ``halo``
    samples of the right neighbor (zeros on the last shard)."""
    n_shards = lax.axis_size(axis_name)
    if halo > x.shape[-1]:
        # a halo wider than the local shard would need the neighbor's
        # neighbor: x[..., -halo:] silently yields only n_local samples and
        # every downstream fixed-width slice misindexes. Shard wider (fewer
        # range shards) or elaborate smaller windows/filters.
        raise ValueError(
            f"halo {halo} exceeds the local shard width {x.shape[-1]}")
    if halo <= 0 or n_shards == 1:
        z = jnp.zeros(x.shape[:-1] + (max(halo, 0),), x.dtype)
        return z, z
    # send my tail to the right => everyone receives left neighbor's tail
    left = lax.ppermute(
        x[..., -halo:], axis_name,
        perm=[(i, i + 1) for i in range(n_shards - 1)],
    )
    # send my head to the left => everyone receives right neighbor's head
    right = lax.ppermute(
        x[..., :halo], axis_name,
        perm=[(i + 1, i) for i in range(n_shards - 1)],
    )
    return left, right


def extend_with_halo(x: jnp.ndarray, halo: int, axis_name: str) -> jnp.ndarray:
    """Concatenate neighbor halos around the local block:
    [..., halo + n_local + halo]."""
    left, right = exchange_halo(x, halo, axis_name)
    return jnp.concatenate([left, x, right], axis=-1)
