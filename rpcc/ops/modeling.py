"""Per-cluster modeling: point (mean range) and plane (RANSAC) models.

Point modeling replaces the C++ ``segment_utils_cpp.point_modeling``
(``cpp_modules.cpp:471-518``) with one ``segment_sum`` — per-cluster mean
range with ids 0 (ground) and 1 (zero pixels) forced to 0.  Model layout is
the codec's (num_models, 4) table: ``[0, 0, 0, mean_range]`` for point
models, ``[a, b, c, d]`` for planes (``utils/segment_utils.py:177-181``).

Plane modeling replaces the per-cluster python loop + unseeded o3d RANSAC
(``utils/segment_utils.py:187-216``): every cluster is fitted *in parallel*,
and — like the reference, which fits, votes and validates on every cluster
point — ALL of hypothesis voting, the winning plane's **refit** (weighted
covariance from 10 segmented moment sums, centered at the per-cluster mean
so f32 never squares ~50 m coordinates) and the scan-angle validation run
over the cluster's full contiguous stream range.  Random gathers are
confined to the ITERS*N hypothesis points.  The
reference's fallbacks apply: clusters under 30 pixels or planes too oblique
to the scan rays keep the point model (``:203-204,212-216``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from rpcc.ops.ransac import fit_plane_weighted, smallest_eigvec_3x3

MIN_PLANE_POINTS = 30  # utils/segment_utils.py:203
CLUSTER_RANSAC_N = 4  # :208
CLUSTER_RANSAC_ITERS = 10  # :209
CLUSTER_RANSAC_THRESHOLD = 0.1  # o3d default used at :75-82


def point_model_table(means: jnp.ndarray, num_models: int) -> jnp.ndarray:
    """(M,) per-cluster mean ranges -> (M, 4) [0,0,0,mean] model table."""
    zeros3 = jnp.zeros((num_models, 3), means.dtype)
    return jnp.concatenate([zeros3, means[:, None]], axis=-1)


def _select_hypotheses(
    xs: jnp.ndarray,  # (HW,) stream-order x
    ys: jnp.ndarray,
    zs: jnp.ndarray,
    order,  # StreamOrder
    key: jax.Array,
    num_models: int,
) -> jnp.ndarray:
    """Best RANSAC hypothesis per cluster.  Hypothesis points are drawn from
    the cluster's stream range (ITERS*N tiny gathers); votes are counted over
    the WHOLE cluster with segmented sums — like the reference, which votes
    on every cluster point (utils/segment_utils.py:75-82), and ~100x fewer
    gathered elements than a per-cluster pixel sample.  Returns (M, 4)."""
    from rpcc.ops.stream import expand_per_cluster_multi

    hw = xs.shape[0]
    counts = order.counts
    cnt = jnp.maximum(counts, 1)[:, None]
    n_draw = CLUSTER_RANSAC_ITERS * CLUSTER_RANSAC_N
    u = jax.random.uniform(key, (num_models, n_draw))
    offs = jnp.minimum((u * cnt).astype(jnp.int32), cnt - 1)
    sidx = order.starts[:, None] + offs  # (M, ITERS*N) stream positions
    hyp_pts = jnp.stack([xs[sidx], ys[sidx], zs[sidx]], axis=-1).reshape(
        num_models, CLUSTER_RANSAC_ITERS, CLUSTER_RANSAC_N, 3
    )
    ones = jnp.ones((CLUSTER_RANSAC_N,), xs.dtype)
    planes = jax.vmap(jax.vmap(lambda p: fit_plane_weighted(p, ones)))(
        hyp_pts
    )  # (M, ITERS, 4)

    pT = planes.transpose(2, 1, 0).reshape(4 * CLUSTER_RANSAC_ITERS, num_models)
    e = expand_per_cluster_multi(pT, order, hw).reshape(
        4, CLUSTER_RANSAC_ITERS, hw
    )
    ha, hb, hc, hd = e[0], e[1], e[2], e[3]  # (ITERS, hw) each
    hnorm = jnp.sqrt(jnp.maximum(ha * ha + hb * hb + hc * hc, 1e-24))
    dist = jnp.abs(ha * xs[None] + hb * ys[None] + hc * zs[None] + hd) / hnorm
    inl = (dist < CLUSTER_RANSAC_THRESHOLD).astype(xs.dtype)
    votes = per_cluster_sums_multi(inl, order)  # (ITERS, M)
    best = jnp.argmax(votes, axis=0)  # (M,) first max, like np.argmax
    return planes[jnp.arange(num_models), best]


def per_cluster_sums_multi(values_s: jnp.ndarray, order) -> jnp.ndarray:
    """(C, HW) stream-order values -> (C, M) per-cluster sums: one stacked
    cumsum + boundary gathers (the C-row variant of per_cluster_sums)."""
    from rpcc.ops.stream import materialized_cumsum

    C = values_s.shape[0]
    csum = jnp.concatenate(
        [jnp.zeros((C, 1), values_s.dtype), materialized_cumsum(values_s)], axis=-1
    )
    return csum[:, order.starts + order.counts] - csum[:, order.starts]


def plane_models_stream(
    ri_s: jnp.ndarray,  # (HW,) range in stream order
    order,  # StreamOrder
    key: jax.Array,
    num_models: int,
    angle_threshold_deg: float,
    rays_s,  # (tx, ty, tz) stream-order scan rays
) -> jnp.ndarray:
    """Per-cluster RANSAC planes: full-cluster-voted hypothesis, full-cluster
    refit and full-cluster scan-angle validation (utils/segment_utils.py:
    187-216) — everything runs in stream space, gather-free but for the
    ITERS*N hypothesis points."""
    from rpcc.ops.stream import expand_per_cluster, per_cluster_sums, point_means_stream

    hw = ri_s.shape[0]
    counts = order.counts

    # Stream-space coordinates (identical to the pixel cloud: p = r * ray).
    tx, ty, tz = rays_s
    xs = ri_s * tx
    ys = ri_s * ty
    zs = ri_s * tz

    hyp = _select_hypotheses(xs, ys, zs, order, key, num_models)  # (M, 4)

    # Inlier weights of the winning hypothesis over the WHOLE cluster.
    ha = expand_per_cluster(hyp[:, 0], order, hw)
    hb = expand_per_cluster(hyp[:, 1], order, hw)
    hc = expand_per_cluster(hyp[:, 2], order, hw)
    hd = expand_per_cluster(hyp[:, 3], order, hw)
    hnorm = jnp.sqrt(jnp.maximum(ha * ha + hb * hb + hc * hc, 1e-24))
    dist = jnp.abs(ha * xs + hb * ys + hc * zs + hd) / hnorm
    w = (dist < CLUSTER_RANSAC_THRESHOLD).astype(ri_s.dtype)

    # Weighted covariance from segmented moment sums, centered at the
    # per-cluster (unweighted) mean: squaring raw ~50 m coordinates would
    # lose the few-cm cluster extent to f32 cancellation.
    mu_sums = per_cluster_sums_multi(jnp.stack([xs, ys, zs]), order)  # (3, M)
    cntf = jnp.maximum(counts.astype(ri_s.dtype), 1.0)
    mu0 = mu_sums / cntf[None, :]
    m0x = expand_per_cluster(mu0[0], order, hw)
    m0y = expand_per_cluster(mu0[1], order, hw)
    m0z = expand_per_cluster(mu0[2], order, hw)
    dx, dy, dz = xs - m0x, ys - m0y, zs - m0z
    moments = per_cluster_sums_multi(
        jnp.stack(
            [w, w * dx, w * dy, w * dz,
             w * dx * dx, w * dy * dy, w * dz * dz,
             w * dx * dy, w * dx * dz, w * dy * dz]
        ),
        order,
    )  # (10, M)
    wsum = jnp.maximum(moments[0], 1e-12)
    ex, ey, ez = moments[1] / wsum, moments[2] / wsum, moments[3] / wsum
    cxx = moments[4] / wsum - ex * ex
    cyy = moments[5] / wsum - ey * ey
    czz = moments[6] / wsum - ez * ez
    cxy = moments[7] / wsum - ex * ey
    cxz = moments[8] / wsum - ex * ez
    cyz = moments[9] / wsum - ey * ez
    cov = jnp.stack(
        [jnp.stack([cxx, cxy, cxz], -1),
         jnp.stack([cxy, cyy, cyz], -1),
         jnp.stack([cxz, cyz, czz], -1)],
        -2,
    )  # (M, 3, 3)
    normals = jax.vmap(smallest_eigvec_3x3)(cov)  # (M, 3) unit
    centroid = jnp.stack([mu0[0] + ex, mu0[1] + ey, mu0[2] + ez], -1)  # (M, 3)
    dcoef = -jnp.sum(normals * centroid, axis=-1)
    refit = jnp.concatenate([normals, dcoef[:, None]], axis=-1)  # (M, 4)
    planes = jnp.where((moments[0] >= 3.0)[:, None], refit, hyp)

    # Scan-angle validation over every cluster pixel: count violations
    # (max-alpha > threshold  <=>  violation count > 0 — sum-decomposable,
    # so it rides the same cumsum machinery instead of a segmented max).
    fa = expand_per_cluster(planes[:, 0], order, hw)
    fb = expand_per_cluster(planes[:, 1], order, hw)
    fc = expand_per_cluster(planes[:, 2], order, hw)
    fnorm = jnp.sqrt(jnp.maximum(fa * fa + fb * fb + fc * fc, 1e-24))
    cosang = jnp.abs(fa * tx + fb * ty + fc * tz) / fnorm
    alpha = jnp.arccos(jnp.clip(cosang, -1.0, 1.0))
    thr = jnp.pi * (angle_threshold_deg / 180.0)
    viol = per_cluster_sums((alpha > thr).astype(ri_s.dtype), order)
    angle_ok = viol == 0.0

    pmod = point_model_table(point_means_stream(ri_s, order), num_models)
    use_plane = angle_ok & (counts >= MIN_PLANE_POINTS)
    use_plane = use_plane.at[0].set(False).at[1].set(False)
    return jnp.where(use_plane[:, None], planes, pmod)
