"""Detection-list compaction — a serving addition.

The reference streams one 32-bit ``{threshold|bin|peak}`` word per range cell
(``RspChainVanillaTester.scala:164-172``) because hardware streams are dense. On
an accelerator the device->host link is the scarce resource, so the serving
path can emit a
fixed-size top-K detection list instead: static shapes (XLA-friendly), tiny
egress, sorted by strength. ``max_detections`` is an elaboration choice; the
count is data-dependent and returned alongside.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .cfar import CfarOutput


class DetectionList(NamedTuple):
    """Top-K detections per frame (last axis compacted).

    ``bins``: int32 [..., K] cell indices, -1 past ``count``.
    ``values``: float32 [..., K] magnitude (CUT) of each detection.
    ``thresholds``: float32 [..., K] threshold at each detection.
    ``count``: int32 [...] number of valid detections (clipped at K).
    """

    bins: jnp.ndarray
    values: jnp.ndarray
    thresholds: jnp.ndarray
    count: jnp.ndarray


def compact_detections(
    mag: jnp.ndarray, out: CfarOutput, max_detections: int = 64
) -> DetectionList:
    """Compact a dense CfarOutput into a strength-sorted top-K detection list.

    ``mag``: the magnitude array the CFAR ran on (``out.cut`` when ``send_cut``
    was elaborated). Detections are ranked by magnitude; non-detections rank
    below everything and yield ``bins == -1``."""
    k = max_detections
    score = jnp.where(out.peaks, mag.astype(jnp.float32), -jnp.inf)
    vals, idx = jax.lax.top_k(score, k)
    valid = jnp.isfinite(vals)
    bins = jnp.where(valid, idx, -1).astype(jnp.int32)
    thr = jnp.take_along_axis(out.threshold, jnp.maximum(idx, 0), axis=-1)
    return DetectionList(
        bins=bins,
        values=jnp.where(valid, vals, 0.0),
        thresholds=jnp.where(valid, thr, 0.0),
        count=jnp.sum(out.peaks, axis=-1).astype(jnp.int32).clip(0, k),
    )
