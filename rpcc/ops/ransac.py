"""Seeded, fully vectorized RANSAC plane fitting.

Replaces open3d's ``segment_plane`` (used at ``utils/segment_utils.py:75-82``
for the ground plane with ``threshold=0.1, ransac_n=10, num_iterations=100``
and at ``:207-209`` per cluster with ``ransac_n=4, num_iterations=10``).

The o3d implementation draws hypotheses *sequentially* and is unseeded, which
makes the reference encoder nondeterministic run-to-run (SURVEY.md §5 pitfall
7).  Here all hypotheses are drawn at once from a counter-based PRNG and
evaluated as one batched computation:

  sample (T, n) indices -> gather (T, n, 3) -> weighted-LSQ plane per
  hypothesis (3x3 eigh on the covariance) -> inlier counts via one planar
  (T, M) distance evaluation -> argmax -> final least-squares refit on the
  winning inlier set (o3d also refits on inliers before returning).

Inlier distances are computed against planar x/y/z columns: broadcasting a
(T, M, 3) tensor would tile-pad the 3 to 128 lanes and waste ~42x bandwidth.

Deterministic given the key; statistically equivalent to the reference
(bitwise parity with an unseeded reference is not defined).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def smallest_eigvec_3x3(a: jnp.ndarray) -> jnp.ndarray:
    """Unit eigenvector of the smallest eigenvalue of a symmetric 3x3.

    Closed form (trigonometric eigenvalues + cross-product eigenvector):
    a few dozen elementwise ops instead of ``jnp.linalg.eigh``'s iterative QR
    — ~100x smaller HLO (compile time) and faster at runtime, at f32
    plane-fit accuracy (errors land in the coded residual stream anyway).
    """
    scale = jnp.maximum(jnp.max(jnp.abs(a)), 1e-30)
    a = a / scale
    q = jnp.trace(a) / 3.0
    p1 = a[0, 1] ** 2 + a[0, 2] ** 2 + a[1, 2] ** 2
    b_diag = jnp.diag(a) - q
    p2 = jnp.sum(b_diag**2) + 2.0 * p1
    p = jnp.sqrt(jnp.maximum(p2 / 6.0, 1e-30))
    b = (a - q * jnp.eye(3, dtype=a.dtype)) / p
    detb = (
        b[0, 0] * (b[1, 1] * b[2, 2] - b[1, 2] * b[2, 1])
        - b[0, 1] * (b[1, 0] * b[2, 2] - b[1, 2] * b[2, 0])
        + b[0, 2] * (b[1, 0] * b[2, 1] - b[1, 1] * b[2, 0])
    )
    r = jnp.clip(detb / 2.0, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    lam_min = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)  # smallest

    m = a - lam_min * jnp.eye(3, dtype=a.dtype)
    c01 = jnp.cross(m[0], m[1])
    c02 = jnp.cross(m[0], m[2])
    c12 = jnp.cross(m[1], m[2])
    n01, n02, n12 = (jnp.sum(c01**2), jnp.sum(c02**2), jnp.sum(c12**2))
    best = jnp.argmax(jnp.stack([n01, n02, n12]))
    v = jnp.stack([c01, c02, c12])[best]
    nrm = jnp.sqrt(jnp.maximum(n01, jnp.maximum(n02, n12)))  # = |v|
    # Degenerate (isotropic) covariance: any direction is an eigenvector.
    v = jnp.where(nrm > 1e-20, v / jnp.maximum(nrm, 1e-30), jnp.array([0.0, 0.0, 1.0], a.dtype))
    return v


def fit_plane_weighted(points: jnp.ndarray, weights: jnp.ndarray) -> jnp.ndarray:
    """Least-squares plane for (M, 3) points with (M,) nonneg weights.

    Returns normalized ``[a, b, c, d]`` with ``||(a,b,c)|| = 1`` and
    ``a*x + b*y + c*z + d = 0``; the normal is the smallest-eigenvalue
    eigenvector of the weighted covariance (closed-form 3x3).
    """
    wsum = jnp.maximum(jnp.sum(weights), 1e-12)
    w = weights / wsum
    centroid = jnp.sum(points * w[:, None], axis=0)
    centered = (points - centroid) * jnp.sqrt(w)[:, None]
    # precision=HIGHEST: unpinned bf16/TF32 matmul inputs would perturb the
    # covariance (hence plane normals) at the percent level.
    cov = jnp.dot(
        centered.T, centered, precision=jax.lax.Precision.HIGHEST
    )  # (3, 3)
    normal = smallest_eigvec_3x3(cov)
    norm = jnp.maximum(jnp.linalg.norm(normal), 1e-12)
    normal = normal / norm
    d = -jnp.sum(normal * centroid)  # elementwise: full f32, no bf16 matmul
    return jnp.concatenate([normal, d[None]])


def point_plane_distance(points: jnp.ndarray, plane: jnp.ndarray) -> jnp.ndarray:
    """|a*x + b*y + c*z + d| / ||n|| for (..., 3) points, (..., 4) plane."""
    n = plane[..., :3]
    num = jnp.abs(jnp.sum(points * n, axis=-1) + plane[..., 3])
    return num / jnp.maximum(jnp.linalg.norm(n, axis=-1), 1e-12)


def point_plane_distance_planar(
    xs: jnp.ndarray, ys: jnp.ndarray, zs: jnp.ndarray, plane: jnp.ndarray
) -> jnp.ndarray:
    """|n.p + d|/||n|| over planar coords; plane (..., 4) broadcasts against
    (M,) coords to (..., M) without materializing any (..., M, 3) tensor."""
    a = plane[..., 0:1]
    b = plane[..., 1:2]
    c = plane[..., 2:3]
    d = plane[..., 3:4]
    num = jnp.abs(a * xs + b * ys + c * zs + d)
    nrm = jnp.sqrt(a * a + b * b + c * c)
    return (num / jnp.maximum(nrm, 1e-12)).reshape(*plane.shape[:-1], xs.shape[0])


def ransac_plane(
    points: jnp.ndarray,
    num_valid: jnp.ndarray,
    key: jax.Array,
    threshold: float = 0.1,
    ransac_n: int = 10,
    num_hypotheses: int = 100,
) -> jnp.ndarray:
    """RANSAC plane over the first ``num_valid`` rows of a padded (M, 3) set.

    Rows at index >= num_valid are ignored for sampling, inlier counting and
    the refit.  Returns the normalized (4,) plane.
    """
    M = points.shape[0]
    nv = jnp.maximum(num_valid, 1)

    u = jax.random.uniform(key, (num_hypotheses, ransac_n))
    samp_idx = jnp.minimum((u * nv).astype(jnp.int32), nv - 1)  # (T, n)
    samples = points[samp_idx]  # (T, n, 3) — small

    ones = jnp.ones((ransac_n,), dtype=points.dtype)
    planes = jax.vmap(lambda p: fit_plane_weighted(p, ones))(samples)  # (T, 4)

    xs, ys, zs = points[:, 0], points[:, 1], points[:, 2]
    valid = (jnp.arange(M) < num_valid).astype(points.dtype)  # (M,)
    dists = point_plane_distance_planar(xs, ys, zs, planes)  # (T, M)
    inlier = (dists < threshold).astype(points.dtype) * valid[None, :]
    counts = jnp.sum(inlier, axis=-1)
    best = jnp.argmax(counts)

    # Final least-squares refit on the winning inliers (o3d behavior).
    best_inlier = inlier[best]
    refit = fit_plane_weighted(points, best_inlier)
    # Guard: if the winner somehow has < 3 inliers fall back to the hypothesis.
    return jnp.where(counts[best] >= 3, refit, planes[best])


CANDIDATE_FACTOR = 4  # candidate pool = CANDIDATE_FACTOR * capacity


def compact_random_subset_planar(
    xs: jnp.ndarray,
    ys: jnp.ndarray,
    zs: jnp.ndarray,
    mask: jnp.ndarray,
    key: jax.Array,
    capacity: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Gather a uniformly random masked subset into a small (capacity, 3) set.

    Stands in for the reference's ``np.random.choice(..., 5000,
    replace=False)`` ground-point subsample (``utils/segment_utils.py:
    102-104``).  Instead of argsorting a random priority over the whole grid,
    take a random-phase strided lattice of 4*capacity candidate positions and
    front-pack the masked ones with one small sort.  Strided slices stay
    fully vectorized, with no random-index gathers.  The subset is a random-phase
    systematic sample of the masked points; RANSAC statistics are unaffected
    (the reference draw is unseeded anyway).

    Returns ``(subset (capacity, 3), count)``; rows past ``count`` are
    arbitrary and must be masked by the consumer.
    """
    n = xs.shape[0]
    pool = min(CANDIDATE_FACTOR * capacity, n)
    stride = n // pool  # >= 1
    k_off, k_u = jax.random.split(key)

    if stride > 1:
        off = jax.random.randint(k_off, (), 0, stride, dtype=jnp.int32)

        def pick(a):
            return jnp.roll(a, -off)[::stride][:pool]
    else:

        def pick(a):
            return a[:pool]

    cm = pick(mask)
    u = jax.random.uniform(k_u, (pool,))
    prio = jnp.where(cm, u, 2.0)
    _, cx, cy, cz = jax.lax.sort(
        (prio, pick(xs), pick(ys), pick(zs)), num_keys=1
    )
    subset = jnp.stack([cx[:capacity], cy[:capacity], cz[:capacity]], axis=-1)
    count = jnp.minimum(jnp.sum(cm.astype(jnp.int32)), capacity)
    return subset, count


def compact_random_subset(
    points: jnp.ndarray, mask: jnp.ndarray, key: jax.Array, capacity: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(N, 3) convenience wrapper around the planar implementation."""
    return compact_random_subset_planar(
        points[:, 0], points[:, 1], points[:, 2], mask, key, capacity
    )
