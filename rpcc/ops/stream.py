"""Stream-space codec math: gather-free cluster-ordered computation.

Instead of gathers/scatters over the flattened pixel grid, this module
reformulates every "bucket by cluster" step around
ONE stable sort that carries all needed per-pixel payloads into *stream
order* (cluster-id-major, row-major within, zero-class last — exactly the
reference bitstream order, ``cpp_modules.cpp:311-319`` with id 1 skipped):

  * cluster boundaries come from ``searchsorted`` on the sorted keys (binary
    search, not a segment_sum scatter);
  * per-cluster sums/means come from one ``cumsum`` + boundary differences;
  * any per-cluster scalar expands to per-slot values with a 102-element
    scatter of telescoping diffs + one ``cumsum`` (piecewise-constant
    expansion), replacing (HW,)-sized table gathers;
  * stream -> pixel inversion is another sort (by the carried pixel index),
    replacing a (HW,) scatter.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp


class StreamOrder(NamedTuple):
    key: jnp.ndarray  # (HW,) sorted stream keys (id, with 1 remapped last)
    perm: jnp.ndarray  # (HW,) pixel index of each stream slot
    seg: jnp.ndarray  # (HW,) cluster id of each stream slot
    starts: jnp.ndarray  # (M,) stream start offset per cluster id
    counts: jnp.ndarray  # (M,) per-cluster pixel counts
    stream_len: jnp.ndarray  # () HW - counts[1]


def _stream_key(seg_flat: jnp.ndarray, num_models: int) -> jnp.ndarray:
    """Cluster id with the zero-pixel class (1) remapped past all ids."""
    return jnp.where(seg_flat == 1, num_models, seg_flat).astype(jnp.int32)


def _cluster_key_values(num_models: int) -> jnp.ndarray:
    """Key value of each cluster id under the stream remap."""
    ids = jnp.arange(num_models, dtype=jnp.int32)
    return jnp.where(ids == 1, num_models, ids)


_IOTA_BITS = 18  # position field width; covers range images up to 2^18 px


def stream_sort(
    seg_flat: jnp.ndarray, payloads: Sequence[jnp.ndarray], num_models: int
) -> Tuple[StreamOrder, Tuple[jnp.ndarray, ...]]:
    """One stable sort into stream order, carrying ``payloads`` along.

    The sort key packs ``(stream_key << 18) | pixel_index`` into one int32:
    position below key makes the single-array sort *inherently* stable, the
    permutation ships inside the key (no iota operand), and the seg id is
    recomputed from the key — two fewer (HW,) operands through the
    comparator network than the naive (key, iota, seg, ...) sort.

    Returns the order plus each payload permuted to stream slots.
    """
    hw = seg_flat.shape[0]
    assert hw < (1 << _IOTA_BITS) and num_models < (1 << (31 - _IOTA_BITS))
    iota = jnp.arange(hw, dtype=jnp.int32)
    key = _stream_key(seg_flat, num_models)
    packed = (key << _IOTA_BITS) | iota
    out = jax.lax.sort((packed,) + tuple(payloads), num_keys=1, is_stable=True)
    packed_s = out[0]
    perm = packed_s & jnp.int32((1 << _IOTA_BITS) - 1)
    key_s = packed_s >> _IOTA_BITS
    seg_s = jnp.where(key_s == num_models, 1, key_s)

    ckeys = _cluster_key_values(num_models)
    starts = jnp.searchsorted(key_s, ckeys, side="left").astype(jnp.int32)
    ends = jnp.searchsorted(key_s, ckeys, side="right").astype(jnp.int32)
    counts = ends - starts
    order = StreamOrder(key_s, perm, seg_s, starts, counts, hw - counts[1])
    return order, tuple(out[1:])


def materialized_cumsum(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """``jnp.cumsum`` whose result is written out before any consumer reads it.

    XLA:GPU otherwise fuses the scan's reduce-window tree into small
    consumers (the M-element gathers at cluster boundaries) and re-evaluates
    the tree for every element they read.  Nested — a per-cluster sum over a
    per-pixel function of an expanded per-cluster value, as the plane fit's
    refit and scan-angle validation are — that is O(HW^2) work on a few
    hundred threads: minutes per batch instead of microseconds.
    """
    return jax.lax.optimization_barrier(jnp.cumsum(x, axis=axis))


# Static stream-visit order of cluster ids: 0, 2, 3, ..., M-1, 1.
def _visit_ids(num_models: int) -> jnp.ndarray:
    import numpy as np

    ids = [0] + list(range(2, num_models)) + [1]
    return jnp.asarray(np.asarray(ids, dtype=np.int32))


def expand_per_cluster(
    values: jnp.ndarray,  # (M,) value per cluster id
    order: StreamOrder,
    hw: int,
) -> jnp.ndarray:
    """Piecewise-constant expansion of per-cluster values to stream slots.

    Telescoping-diff scatter (M writes) + one cumsum — no (HW,) gather.  The
    telescoping runs in the int32 *bitcast* domain: modular integer addition
    is associative, so every slot reconstructs the table value **bit-exactly**
    (a float cumsum would drift by ulps and break the codec's exact-zero
    point-model test, cpp_modules.cpp:271).  Duplicate starts from empty
    clusters telescope correctly because the diffs add.
    """
    vis = _visit_ids(values.shape[0])
    vals_v = jax.lax.bitcast_convert_type(values[vis].astype(jnp.float32), jnp.int32)
    starts_v = order.starts[vis]
    diffs = jnp.concatenate([vals_v[:1], vals_v[1:] - vals_v[:-1]])
    base = jnp.zeros((hw,), jnp.int32).at[starts_v].add(diffs, mode="drop")
    return jax.lax.bitcast_convert_type(materialized_cumsum(base), jnp.float32)


def expand_per_cluster_multi(
    values: jnp.ndarray,  # (C, M) value rows per cluster id
    order: StreamOrder,
    hw: int,
) -> jnp.ndarray:
    """(C, M) -> (C, HW): the C-row variant of expand_per_cluster — same
    bit-exact telescoping-diff scatter, ONE stacked cumsum."""
    C, M = values.shape
    vis = _visit_ids(M)
    vals_v = jax.lax.bitcast_convert_type(
        values[:, vis].astype(jnp.float32), jnp.int32
    )
    starts_v = order.starts[vis]
    diffs = jnp.concatenate([vals_v[:, :1], vals_v[:, 1:] - vals_v[:, :-1]], axis=1)
    base = jnp.zeros((C, hw), jnp.int32).at[:, starts_v].add(diffs, mode="drop")
    return jax.lax.bitcast_convert_type(materialized_cumsum(base), jnp.float32)


def per_cluster_sums(
    values_s: jnp.ndarray,  # (HW,) per-slot values in stream order
    order: StreamOrder,
) -> jnp.ndarray:
    """(M,) per-cluster sums via cumsum + boundary gathers (M-sized)."""
    csum = jnp.concatenate([jnp.zeros((1,), values_s.dtype), materialized_cumsum(values_s)])
    return csum[order.starts + order.counts] - csum[order.starts]


def point_means_stream(ri_s: jnp.ndarray, order: StreamOrder) -> jnp.ndarray:
    """Per-cluster mean range (rows 0 and 1 zeroed), replacing
    ``point_modeling`` (cpp_modules.cpp:471-518) without a segment_sum."""
    sums = per_cluster_sums(ri_s, order)
    cnt = jnp.maximum(order.counts.astype(ri_s.dtype), 1.0)
    mean = jnp.where(order.counts > 0, sums / cnt, 0.0)
    return mean.at[0].set(0.0).at[1].set(0.0)


def predict_stream(
    model_param: jnp.ndarray,  # (M, 4)
    order: StreamOrder,
    rays_s: Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray],  # carried tm planes
    hw: int,
) -> jnp.ndarray:
    """Intra-prediction evaluated directly on stream slots, gather-free:
    a/b/c/d expand piecewise-constant; rays were carried by the sort."""
    a = expand_per_cluster(model_param[:, 0], order, hw)
    b = expand_per_cluster(model_param[:, 1], order, hw)
    c = expand_per_cluster(model_param[:, 2], order, hw)
    d = expand_per_cluster(model_param[:, 3], order, hw)
    tx, ty, tz = rays_s
    is_point = (a + b + c) == 0.0  # exact-zero point-model test (cpp:271)
    denom = a * tx + b * ty + c * tz
    # A ray lying exactly in a through-origin plane gives -0/0 = NaN in the
    # reference C++ too (cpp:275); predict 0 instead so degenerate scenes
    # stay codable (encoder and decoder share this rule).
    safe = jnp.where(denom == 0.0, 1.0, denom)
    plane_pred = jnp.where(denom == 0.0, 0.0, -d / safe)
    return jnp.where(is_point, d, plane_pred)


def rays_from_perm(order: StreamOrder, lidar) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Recompute scan-ray planes analytically from the stream permutation.

    For evenly-distributed LiDARs the ray is pure trigonometry of (row, col)
    (``dataset/transformer.py:41-54``), so carrying three (HW,) ray payloads
    through the stream sort is unnecessary — a few transcendentals per slot
    are cheaper than sorting 12 extra bytes per pixel.  Encoder and decoder
    both use this path, so prediction is bit-identical on both sides (the
    f64-built table differs by float ulps; the residual bound is unaffected).
    """
    W = lidar.width
    H = lidar.height
    row = (order.perm // W).astype(jnp.float32)
    col = (order.perm % W).astype(jnp.float32)
    vfov = lidar.vertical_max - lidar.vertical_min
    alt = jnp.float32(vfov) * row / jnp.float32(H - 1) + jnp.float32(lidar.vertical_min)
    az = jnp.float32(lidar.horizontal_fov) * col / jnp.float32(W)
    cos_alt = jnp.cos(alt)
    return cos_alt * jnp.cos(az), cos_alt * jnp.sin(az), jnp.sin(alt)


def stream_to_pixel(
    values_s: jnp.ndarray, order: StreamOrder
) -> jnp.ndarray:
    """Invert the stream permutation with a sort (cheaper than a scatter)."""
    _, out = jax.lax.sort((order.perm, values_s), num_keys=1, is_stable=True)
    return out


def compact_flagged(
    flags_flat: jnp.ndarray, values_flat: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Stable front-compaction of ``values[flags]`` via one sort.

    Returns (compacted values padded with the tail, count).  Replaces the
    cumsum-position scatter in contour sequence extraction.
    """
    inv = (1 - flags_flat.astype(jnp.int32),)
    _, vals = jax.lax.sort(inv + (values_flat,), num_keys=1, is_stable=True)
    return vals, jnp.sum(flags_flat.astype(jnp.int32))


def compact_flagged_small(
    flags_flat: jnp.ndarray, values_flat: jnp.ndarray, value_bits: int = 12
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """compact_flagged for small non-negative values (< 2^value_bits):
    pack (inv_flag | position | value) into ONE int32 so the sort runs a
    single operand instead of two (stability is positional by construction).
    """
    hw = flags_flat.shape[0]
    assert hw < (1 << _IOTA_BITS) and value_bits + _IOTA_BITS + 1 <= 31
    iota = jnp.arange(hw, dtype=jnp.int32)
    inv = 1 - flags_flat.astype(jnp.int32)
    packed = (
        (inv << (_IOTA_BITS + value_bits))
        | (iota << value_bits)
        | values_flat.astype(jnp.int32)
    )
    pk = jax.lax.sort(packed)
    vals = pk & jnp.int32((1 << value_bits) - 1)
    return vals, jnp.sum(flags_flat.astype(jnp.int32))


def compact_flagged_positions(flags_flat: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Front-packed positions of set flags (single packed-int32 sort)."""
    hw = flags_flat.shape[0]
    assert hw < (1 << _IOTA_BITS)
    iota = jnp.arange(hw, dtype=jnp.int32)
    inv = 1 - flags_flat.astype(jnp.int32)
    pk = jax.lax.sort((inv << _IOTA_BITS) | iota)
    return pk & jnp.int32((1 << _IOTA_BITS) - 1), jnp.sum(flags_flat.astype(jnp.int32))