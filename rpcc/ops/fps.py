"""Farthest point sampling on device.

Replaces the reference's CUDA kernel (``ops/fps/src/sampling_gpu.cu:25-140``)
with a ``lax.fori_loop`` whose per-iteration work is fully vectorized over the
point dimension: maintain the running min-squared-distance vector, take the
argmax, append.  The loop is ``vmap``-able over a frame batch so the 99 sequential
steps amortize across frames.

Semantics matched to the CUDA op:
  * always seeds at index 0 (``sampling_gpu.cu:43-46``);
  * the selection scan uses strict ``>`` so the **lowest** index wins ties —
    ``jnp.argmax`` picks the first occurrence, same winner;
  * distances are squared Euclidean, initial "temp" is +inf (1e10).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def furthest_point_sample_planar(
    xs: jnp.ndarray, ys: jnp.ndarray, zs: jnp.ndarray, num_samples: int
) -> jnp.ndarray:
    """FPS over planar coordinates (three (N,) arrays).

    Planar layout keeps each coordinate a contiguous stream for the per-step
    distance update.
    Points flagged invalid should simply be exact duplicates (e.g. zeros) —
    like the reference GPU path, which FPS-samples the zero-masked full pixel
    grid (``utils/segment_utils.py:139-141``): after any zero point is picked
    once, all other zeros have distance 0 and are never picked again.
    """
    n = xs.shape[0]

    def body(i, state):
        min_d2, idxs, last = state
        dx = xs - xs[last]
        dy = ys - ys[last]
        dz = zs - zs[last]
        d2 = dx * dx + dy * dy + dz * dz
        min_d2 = jnp.minimum(min_d2, d2)
        nxt = jnp.argmax(min_d2).astype(jnp.int32)
        idxs = idxs.at[i].set(nxt)
        return min_d2, idxs, nxt

    idxs0 = jnp.zeros((num_samples,), dtype=jnp.int32)
    min_d2 = jnp.full((n,), 1e10, dtype=jnp.float32)
    _, idxs, _ = jax.lax.fori_loop(1, num_samples, body, (min_d2, idxs0, jnp.int32(0)))
    return idxs


@functools.partial(jax.jit, static_argnames=("num_samples",))
def furthest_point_sample(points: jnp.ndarray, num_samples: int) -> jnp.ndarray:
    """(N, 3) or batched (B, N, 3) wrapper (CUDA-op-compatible semantics,
    ``sampling_gpu.cu:43-68`` / ``ops/fps/fps_utils.py:10-36``): seed index
    0, lowest index wins ties; batched input returns (B, num_samples)."""
    if points.ndim == 3:
        return jax.vmap(
            lambda p: furthest_point_sample_planar(p[:, 0], p[:, 1], p[:, 2], num_samples)
        )(points)
    return furthest_point_sample_planar(
        points[:, 0], points[:, 1], points[:, 2], num_samples
    )


def furthest_point_sample_planar_masked(
    xs: jnp.ndarray,
    ys: jnp.ndarray,
    zs: jnp.ndarray,
    num_valid: jnp.ndarray,
    num_samples: int,
) -> jnp.ndarray:
    """FPS over the first ``num_valid`` entries of planar coordinate arrays.

    The reference CPU path (``utils/segment_utils.py:120-124``) FPS-samples
    the *filtered* (compacted) non-ground point list rather than the
    zero-masked grid; slots past ``num_valid`` hold arbitrary compaction
    leftovers and must never win — their running distance is pinned to -1,
    below any real squared distance.  Seeds at index 0 = the first filtered
    point in row-major order, like the CUDA op on the compacted array.
    """
    n = xs.shape[0]
    valid = jnp.arange(n) < num_valid

    def body(i, state):
        min_d2, idxs, last = state
        dx = xs - xs[last]
        dy = ys - ys[last]
        dz = zs - zs[last]
        d2 = dx * dx + dy * dy + dz * dz
        min_d2 = jnp.where(valid, jnp.minimum(min_d2, d2), -1.0)
        nxt = jnp.argmax(min_d2).astype(jnp.int32)
        idxs = idxs.at[i].set(nxt)
        return min_d2, idxs, nxt

    idxs0 = jnp.zeros((num_samples,), dtype=jnp.int32)
    min_d2 = jnp.where(valid, 1e10, -1.0).astype(jnp.float32)
    _, idxs, _ = jax.lax.fori_loop(1, num_samples, body, (min_d2, idxs0, jnp.int32(0)))
    return idxs
