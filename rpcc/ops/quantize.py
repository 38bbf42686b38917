"""Residual quantization and the cluster-ordered stream layout.

The reference C++ (``cpp_modules.cpp:288-424``) buckets quantized residuals
per cluster id (row-major within each cluster), skips id 1 (zero pixels) and
concatenates buckets in id order.  On device that bucket order is one **stable
sort** by cluster id: a single ``lax.sort`` yields the permutation whose
contiguous ranges are the clusters; the bitstream order is that permutation
with the id-1 range skipped — an index shift, not a second sort.

Dequantization (``utils/compress_utils.py:114-132``'s python scatter loop)
inverts the same permutation with one scatter.

Rounding is C ``round()`` (half away from zero), see ops/rounding.py.

NOTE: these are the readable reference-semantics implementations that the
unit tests pin against the C++ bucket-loop behavior; the production encoder/
decoder use the gather-free stream-space formulation in ops/stream.py.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from rpcc.ops.rounding import round_half_away


class ClusterOrder(NamedTuple):
    perm: jnp.ndarray  # (HW,) pixel index sorted by (cluster id, row-major)
    counts: jnp.ndarray  # (num_models,) per-id pixel counts
    starts: jnp.ndarray  # (num_models,) exclusive cumsum of counts
    stream_len: jnp.ndarray  # () HW - counts[1]


def cluster_sort(seg_flat: jnp.ndarray, num_models: int) -> ClusterOrder:
    hw = seg_flat.shape[0]
    iota = jnp.arange(hw, dtype=jnp.int32)
    _, perm = jax.lax.sort((seg_flat.astype(jnp.int32), iota), num_keys=1, is_stable=True)
    counts = jax.ops.segment_sum(
        jnp.ones((hw,), jnp.int32), seg_flat.astype(jnp.int32), num_segments=num_models
    )
    starts = jnp.concatenate([jnp.zeros((1,), jnp.int32), jnp.cumsum(counts)[:-1]])
    stream_len = hw - counts[1]
    return ClusterOrder(perm, counts, starts, stream_len)


def _stream_src(order: ClusterOrder, hw: int) -> jnp.ndarray:
    """Index into ``perm`` for each stream slot, skipping the id-1 range."""
    i = jnp.arange(hw, dtype=jnp.int32)
    return i + jnp.where(i >= order.starts[1], order.counts[1], 0)


def quantize_stream(
    residual_flat: jnp.ndarray,
    order: ClusterOrder,
    step_flat: jnp.ndarray | float,
) -> jnp.ndarray:
    """Quantize + lay out the residual stream.

    ``step_flat`` is a scalar (uniform mode) or per-pixel step (non-uniform:
    ``level_acc[salience[seg]]`` gathered by the caller).  Returns (HW,) int32
    where only the first ``order.stream_len`` entries are meaningful; the tail
    is zero so fixed-shape transfers stay clean.
    """
    hw = residual_flat.shape[0]
    q = round_half_away(residual_flat / step_flat).astype(jnp.int32)
    src = _stream_src(order, hw)
    stream = q[order.perm[jnp.minimum(src, hw - 1)]]
    live = jnp.arange(hw) < order.stream_len
    return jnp.where(live, stream, 0)


def dequantize_stream(
    stream: jnp.ndarray,  # (HW,) int32, tail-padded
    order: ClusterOrder,
    step_flat: jnp.ndarray | float,
) -> jnp.ndarray:
    """Scatter the stream back to per-pixel residuals (id-1 pixels get 0)."""
    hw = stream.shape[0]
    src = _stream_src(order, hw)
    live = jnp.arange(hw) < order.stream_len
    dest = jnp.where(live, order.perm[jnp.minimum(src, hw - 1)], hw)
    resid = jnp.zeros((hw,), jnp.float32).at[dest].set(
        stream.astype(jnp.float32), mode="drop"
    )
    return resid * step_flat
