"""Ground + cluster segmentation of a range image.

Batched device re-design of ``PointCloudSegment.segment``
(``utils/segment_utils.py:95-170``):

  * ground plane: z < -1.5 filter, random <=5000 subsample, seeded RANSAC
    (reference ``:101-108`` uses unseeded o3d);
  * FPS cluster centers over the zero-masked non-ground pixel grid — the
    reference's default GPU-path semantics (``:139-141``), which is already
    the fixed-shape formulation a compiled batch wants;
  * per-pixel assignment: argmin over |ground depth residual| and Euclidean
    distances to the K centers (``:127-131``), with the (K, HW) inner product
    computed as a (K, 3) @ (3, HW) contraction;
  * relabel to the codec's id convention: 0=ground, 1=zero pixels,
    2..K+1=clusters (``:168-169``).

All coordinates flow as planar x/y/z (HW,) arrays.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from rpcc.ops.fps import furthest_point_sample_planar
from rpcc.ops.ransac import (
    compact_random_subset_planar,
    point_plane_distance_planar,
    ransac_plane,
)


GROUND_Z_CUT = -1.5  # utils/segment_utils.py:101
GROUND_FIT_CAPACITY = 5000  # :102-104
GROUND_FIT_MIN = 800  # :105-106
GROUND_RANSAC_THRESHOLD = 0.1  # :75
GROUND_RANSAC_N = 10  # :75
GROUND_RANSAC_ITERS = 100  # :75


def segment_index_clean(seg_idx: jnp.ndarray) -> jnp.ndarray:
    """Remove 1-pixel salt from a seg map (``cpp_modules.cpp:226-246``).

    The C++ walks each row left-to-right **in place**: if ``v[w+2] == v[w]``
    and ``v[w+1] != v[w]`` then ``v[w+1] = v[w]`` — where ``v[w]`` may itself
    have just been rewritten.  A ``lax.scan`` carrying the updated previous
    value reproduces the cascade exactly (reads of w+1/w+2 are always
    original values since writes only ever target w+1).
    """
    H, W = seg_idx.shape
    orig = seg_idx

    def row_fix(row):
        def step(prev, w):
            nxt = row[w + 1]
            nxt2 = row[w + 2]
            new_nxt = jnp.where((nxt2 == prev) & (nxt != prev), prev, nxt)
            return new_nxt, new_nxt

        first = row[0]
        _, fixed = jax.lax.scan(step, first, jnp.arange(W - 2))
        return jnp.concatenate([row[:1], fixed, row[W - 1 :]])

    return jax.vmap(row_fix)(orig)


class SegmentResult(NamedTuple):
    seg_idx: jnp.ndarray  # (H, W) int32: 0 ground, 1 zero pixels, 2.. clusters
    ground_model: jnp.ndarray  # (4,) normalized plane
    centers: jnp.ndarray  # (K, 3) FPS cluster centers


def fit_ground_plane_planar(
    xs: jnp.ndarray, ys: jnp.ndarray, zs: jnp.ndarray, key: jax.Array,
    valid: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Seeded RANSAC ground plane from low-z points (fallback: all points).

    ``valid`` masks live pixels when the inputs are a back-projected grid
    cloud: empty range-image pixels sit at the exact origin there, and the
    low-candidate fallback (rare: < 800 points below the z cut) would
    otherwise hand RANSAC tens of thousands of duplicate (0,0,0) points —
    any origin-grazing hypothesis then outvotes the true ground.  (The
    primary low-z mask never admits them: z = 0 > -1.5.)"""
    k_sub, k_ransac = jax.random.split(key)
    low = zs < GROUND_Z_CUT
    if valid is not None:
        low = low & valid
    n_low = jnp.sum(low.astype(jnp.int32))
    # Reference: if fewer than 800 candidates, fit on the full cloud
    # (:105-106) — the full *live* cloud here.
    fallback = jnp.ones_like(low) if valid is None else valid
    mask = jnp.where(n_low < GROUND_FIT_MIN, fallback, low)
    subset, count = compact_random_subset_planar(
        xs, ys, zs, mask, k_sub, GROUND_FIT_CAPACITY
    )
    return ransac_plane(
        subset,
        count,
        k_ransac,
        threshold=GROUND_RANSAC_THRESHOLD,
        ransac_n=GROUND_RANSAC_N,
        num_hypotheses=GROUND_RANSAC_ITERS,
    )


def fit_ground_plane(points_flat: jnp.ndarray, key: jax.Array) -> jnp.ndarray:
    """(N, 3) convenience wrapper."""
    return fit_ground_plane_planar(
        points_flat[:, 0], points_flat[:, 1], points_flat[:, 2], key
    )


def ground_depth_residual(
    range_image: jnp.ndarray, plane: jnp.ndarray, tm_planes: jnp.ndarray
) -> jnp.ndarray:
    """Signed depth residual r - r_plane with r_plane = -d / (n . ray).

    Mirrors ``calc_plane_residual_depth`` (``utils/segment_utils.py:54-72``).
    Shapes: range_image (..., H, W), tm_planes (3, H, W) -> (..., H, W).
    """
    denom = plane[0] * tm_planes[0] + plane[1] * tm_planes[1] + plane[2] * tm_planes[2]
    r_plane = -plane[3] / denom
    return range_image - r_plane


def segment_range_image_dbscan(
    point_planes: jnp.ndarray,  # (3, H, W)
    range_image: jnp.ndarray,  # (H, W)
    tm_planes: jnp.ndarray,  # (3, H, W)
    key: jax.Array,
    eps: float,
    max_clusters: int,
) -> SegmentResult:
    """DBSCAN-mode segmentation (``utils/segment_utils.py:149-164``): ground
    by |depth residual| <= 0.5, clusters from device connected components.

    Final ids: 0 ground, 1 zero pixels, 2 noise, 3.. clusters."""
    from rpcc.ops.dbscan import dbscan_range_image

    H, W = range_image.shape
    xs = point_planes[0].reshape(-1)
    ys = point_planes[1].reshape(-1)
    zs = point_planes[2].reshape(-1)
    ground_model = fit_ground_plane_planar(
        xs, ys, zs, key, valid=range_image.reshape(-1) > 0.0
    )
    g_res = ground_depth_residual(range_image, ground_model, tm_planes)
    nonzero = range_image > 0.0
    active = (jnp.abs(g_res) > 0.5) & nonzero  # :155-156
    seg = dbscan_range_image(point_planes, active, eps, max_clusters)
    seg = jnp.where(nonzero, seg, 1)
    seg = jnp.where(nonzero & ~active, 0, seg)
    centers = jnp.zeros((max_clusters, 3), range_image.dtype)
    return SegmentResult(seg.astype(jnp.int32), ground_model, centers)


def segment_range_image(
    point_planes: jnp.ndarray,  # (3, H, W) planar x/y/z
    range_image: jnp.ndarray,  # (H, W)
    tm_planes: jnp.ndarray,  # (3, H, W)
    key: jax.Array,
    ground_threshold: float,
    cluster_num: int,
    cpu_fps: bool = False,
) -> SegmentResult:
    H, W = range_image.shape
    xs = point_planes[0].reshape(-1)
    ys = point_planes[1].reshape(-1)
    zs = point_planes[2].reshape(-1)
    ri = range_image.reshape(-1)

    ground_model = fit_ground_plane_planar(xs, ys, zs, key, valid=ri > 0.0)

    # Non-ground mask by vertical (point-to-plane) distance (:119-120,137-138).
    vert = point_plane_distance_planar(xs, ys, zs, ground_model)
    if cpu_fps:
        # Reference CPU branch (:120-124): FPS over the row-major *compacted*
        # filtered set — ground pixels leave the candidate pool entirely and
        # the seed is the first filtered pixel, not pixel 0.  (Zero pixels
        # stay: the origin is |d| ~ 1.7 m above the ground plane, and
        # calc_plane_residual_vertical is an absolute distance.)
        from rpcc.ops.fps import furthest_point_sample_planar_masked

        mask = vert > ground_threshold
        inv = (~mask).astype(jnp.int32)
        _, cxs, cys, czs = jax.lax.sort(
            (inv, xs, ys, zs), num_keys=1, is_stable=True
        )
        n_ng = jnp.sum(mask.astype(jnp.int32))
        center_idx = furthest_point_sample_planar_masked(
            cxs, cys, czs, n_ng, cluster_num
        )
        centers = jnp.stack(
            [cxs[center_idx], cys[center_idx], czs[center_idx]], axis=-1
        )  # (K, 3)
    else:
        # GPU-path semantics (:139-141): zero-masked full grid.
        nonground = ((vert > ground_threshold) & (ri > 0.0)).astype(ri.dtype)
        ngx = xs * nonground
        ngy = ys * nonground
        ngz = zs * nonground

        center_idx = furthest_point_sample_planar(ngx, ngy, ngz, cluster_num)
        centers = jnp.stack(
            [ngx[center_idx], ngy[center_idx], ngz[center_idx]], axis=-1
        )  # (K, 3)

    # Distance stack: row 0 = |ground depth residual|, rows 1..K = |p - c|.
    g_res = jnp.abs(
        ground_depth_residual(range_image, ground_model, tm_planes).reshape(-1)
    )
    p2 = xs * xs + ys * ys + zs * zs  # (HW,)
    c2 = jnp.sum(centers * centers, axis=-1)  # (K,)
    pts = jnp.stack([xs, ys, zs], axis=0)  # (3, HW) — cheap planar stack
    # precision=HIGHEST: unpinned bf16/TF32 matmul inputs lose 4-5 of
    # f32's 7 digits — at |x|~50m that is meters of distance error and wrong
    # cluster assignments (bpp regressions vs the CPU backend).
    dots = jnp.dot(
        centers, pts,
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )  # (K, HW)
    d2 = jnp.maximum(p2[None, :] + c2[:, None] - 2.0 * dots, 0.0)
    cdist = jnp.sqrt(d2)

    dist = jnp.concatenate([g_res[None, :], cdist], axis=0)  # (K+1, HW)
    seg = jnp.argmin(dist, axis=0).astype(jnp.int32)  # ties -> lowest id
    seg = jnp.where(seg > 0, seg + 1, seg)  # make room for zero-pixel class 1
    seg = jnp.where(ri == 0.0, 1, seg)
    return SegmentResult(seg.reshape(H, W), ground_model, centers)
