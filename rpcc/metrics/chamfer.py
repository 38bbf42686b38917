"""Chamfer distance + F1 on device.

Replaces the reference's CUDA ChamferDistancePytorch submodule
(``utils/evaluate_metrics.py:9-45``) with a chunked brute-force nearest
neighbor: for each chunk of A, one (chunk, |B|) squared-distance block via a
matmul (``|a|^2 + |b|^2 - 2 a.b^T`` — the inner product is one matmul),
min-reduced on the fly so the full N^2 matrix never materializes.
"""

from __future__ import annotations

import functools
import time
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

_CHUNK = 2048


@functools.partial(jax.jit, static_argnames=("chunk",))
def _min_d2_and_idx(a: jnp.ndarray, b: jnp.ndarray, chunk: int = _CHUNK):
    """For each row of a: (min squared distance to b, argmin index).

    The |a|^2+|b|^2-2ab expansion selects the neighbor with a fast matmul but
    cancels catastrophically in float32 when points are ~100 units from the
    origin and ~0.01 apart (exactly the LiDAR case), so the *selection* uses
    the expansion and the reported distance is recomputed exactly by direct
    subtraction on the selected pairs.
    """
    n = a.shape[0]
    mean = jnp.mean(b, axis=0)  # center to reduce cancellation in selection
    a = a - mean
    b = b - mean
    b2 = jnp.sum(b * b, axis=-1)

    def body(carry, achunk):
        a2 = jnp.sum(achunk * achunk, axis=-1)
        # precision=HIGHEST: an unpinned f32 matmul may run with bf16 or TF32
        # inputs, whose 3-4 decimal digits are catastrophic at LiDAR coordinate scale (d^2
        # errors of +-17 at |x|~50 select wrong neighbors).
        ab = jnp.dot(achunk, b.T, precision=jax.lax.Precision.HIGHEST)
        d2 = a2[:, None] + b2[None, :] - 2.0 * ab
        return carry, jnp.argmin(d2, axis=-1).astype(jnp.int32)

    pad = (-n) % chunk
    a_pad = jnp.concatenate([a, jnp.zeros((pad, 3), a.dtype)]) if pad else a
    a_chunks = a_pad.reshape(-1, chunk, 3)
    _, idx = jax.lax.scan(body, None, a_chunks)
    idx = idx.reshape(-1)[:n]
    d2_exact = jnp.sum((a[:n] - b[idx]) ** 2, axis=-1)
    return d2_exact, idx


def nn_distances(points1: np.ndarray, points2: np.ndarray):
    """Cross nearest neighbors: (d2_1to2, idx_1to2, d2_2to1, idx_2to1)."""
    a = jnp.asarray(points1, jnp.float32)
    b = jnp.asarray(points2, jnp.float32)
    d1, i1 = _min_d2_and_idx(a, b)
    d2, i2 = _min_d2_and_idx(b, a)
    return np.asarray(d1), np.asarray(i1), np.asarray(d2), np.asarray(i2)


def calc_chamfer_distance(
    points1: np.ndarray, points2: np.ndarray, f1_threshold: float = 0.02, out: bool = True
) -> Dict:
    """Symmetric chamfer distance + F-score (evaluate_metrics.py:9-45)."""
    t = time.time()
    pc1 = points1[np.sum(points1, -1) != 0]
    pc2 = points2[np.sum(points2, -1) != 0]
    d1, i1, d2, i2 = nn_distances(pc1, pc2)

    thr2 = f1_threshold ** 2
    precision = float((d2 < thr2).mean())  # fraction of pc2 near pc1
    recall = float((d1 < thr2).mean())
    f_score = 2 * precision * recall / (precision + recall) if precision + recall > 0 else 0.0
    cd1 = float(np.sqrt(d1).mean())
    cd2 = float(np.sqrt(d2).mean())

    result = {
        "max": max(cd1, cd2),
        "mean": (cd1 + cd2) / 2,
        "sum": cd1 + cd2,
        "cd1": cd1,
        "cd2": cd2,
        "f_score": f_score,
        "precision": precision,
        "recall": recall,
        "chamfer_dist_info": {"dist1": d1, "dist2": d2, "idx1": i1, "idx2": i2},
    }
    if out:
        for key, value in result.items():
            if key != "chamfer_dist_info":
                print(key, value)
        print("time cost: ", time.time() - t)
    return result
