"""Unit tests for FPS, RANSAC, rounding, quantization order and contour."""

import numpy as np
import jax
import jax.numpy as jnp

from rpcc.ops.rounding import round_half_away
from rpcc.ops.fps import furthest_point_sample
from rpcc.ops.ransac import (
    compact_random_subset,
    fit_plane_weighted,
    point_plane_distance,
    ransac_plane,
)
from rpcc.ops.quantize import cluster_sort, dequantize_stream, quantize_stream
from rpcc.ops.contour import extract_contour, recover_map


# ---------------------------------------------------------------- rounding
def test_round_half_away_matches_c_round():
    xs = np.array([-2.5, -1.5, -0.5, -0.49, 0.0, 0.49, 0.5, 1.5, 2.5, 3.49])
    expected = np.array([-3, -2, -1, 0, 0, 0, 1, 2, 3, 3], dtype=np.float64)
    np.testing.assert_array_equal(np.asarray(round_half_away(jnp.asarray(xs))), expected)


# ---------------------------------------------------------------- FPS
def numpy_fps(points, m):
    """Direct port of the CUDA loop semantics (sampling_gpu.cu:43-68):
    seed at 0, strict-greater scan so lowest index wins ties."""
    n = points.shape[0]
    temp = np.full(n, 1e10, dtype=np.float32)
    idxs = [0]
    old = 0
    for _ in range(1, m):
        d = np.sum((points - points[old]) ** 2, axis=-1).astype(np.float32)
        temp = np.minimum(temp, d)
        best = -1.0
        besti = 0
        for k in range(n):
            if temp[k] > best:
                best = temp[k]
                besti = k
        idxs.append(besti)
        old = besti
    return np.array(idxs, dtype=np.int32)


def test_fps_matches_cuda_semantics():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-10, 10, (500, 3)).astype(np.float32)
    ours = np.asarray(furthest_point_sample(jnp.asarray(pts), 32))
    ref = numpy_fps(pts, 32)
    np.testing.assert_array_equal(ours, ref)


def test_fps_with_zero_masked_points():
    """Zero-masked points collapse to one candidate (reference GPU path)."""
    rng = np.random.default_rng(1)
    pts = rng.uniform(-10, 10, (200, 3)).astype(np.float32)
    pts[50:150] = 0.0
    idx = np.asarray(furthest_point_sample(jnp.asarray(pts), 16))
    zero_picks = [i for i in idx if (pts[i] == 0).all()]
    assert len(zero_picks) <= 1 + 1  # seed pixel + at most one zero pick


# ---------------------------------------------------------------- RANSAC
def test_fit_plane_weighted_exact():
    # points on z = 2x - y + 3
    rng = np.random.default_rng(2)
    xy = rng.uniform(-5, 5, (100, 2))
    z = 2 * xy[:, 0] - xy[:, 1] + 3
    pts = np.column_stack([xy, z]).astype(np.float32)
    plane = np.asarray(fit_plane_weighted(jnp.asarray(pts), jnp.ones(100)))
    d = np.asarray(point_plane_distance(jnp.asarray(pts), jnp.asarray(plane)))
    # float32 covariance + eigh: ~1e-4 relative on this extent.  Plane-fit
    # error lands in the coded residual stream, so codec correctness is
    # unaffected (only ratio, negligibly).
    assert d.max() < 1e-2
    np.testing.assert_allclose(np.linalg.norm(plane[:3]), 1.0, rtol=1e-5)


def test_ransac_recovers_plane_with_outliers():
    rng = np.random.default_rng(3)
    n_in, n_out = 800, 200
    xy = rng.uniform(-20, 20, (n_in, 2))
    z = 0.05 * xy[:, 0] - 0.02 * xy[:, 1] - 1.7 + rng.normal(0, 0.02, n_in)
    inliers = np.column_stack([xy, z])
    outliers = rng.uniform(-20, 20, (n_out, 3)) + np.array([0, 0, 5.0])
    pts = np.concatenate([inliers, outliers]).astype(np.float32)
    rng.shuffle(pts)
    plane = ransac_plane(
        jnp.asarray(pts), jnp.int32(pts.shape[0]), jax.random.PRNGKey(0),
        threshold=0.1, ransac_n=10, num_hypotheses=100,
    )
    d = np.asarray(point_plane_distance(jnp.asarray(inliers.astype(np.float32)),
                                        jnp.asarray(plane)))
    assert np.mean(d < 0.1) > 0.98


def test_compact_random_subset():
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1, 1, (1000, 3)).astype(np.float32)
    mask = jnp.asarray(pts[:, 2] < 0)
    subset, count = compact_random_subset(jnp.asarray(pts), mask, jax.random.PRNGKey(1), 300)
    count = int(count)
    assert count == min(300, int(np.asarray(mask).sum()))
    # every selected row is a masked input row
    sel = np.asarray(subset)[:count]
    masked_set = {tuple(r) for r in pts[np.asarray(mask)]}
    assert all(tuple(r) in masked_set for r in sel)


# ---------------------------------------------------------------- quantize
def test_cluster_sort_and_stream_roundtrip():
    rng = np.random.default_rng(5)
    hw = 4096
    num_models = 12
    seg = rng.integers(0, num_models, hw).astype(np.int32)
    resid = rng.normal(0, 0.5, hw).astype(np.float32)
    step = 0.04

    order = cluster_sort(jnp.asarray(seg), num_models)
    stream = np.asarray(quantize_stream(jnp.asarray(resid), order, step))

    # Reference bucket layout (cpp_modules.cpp:311-319): id-major, row-major,
    # skipping id 1.
    expected = []
    for m in range(num_models):
        if m == 1:
            continue
        vals = resid[seg == m] / step
        expected.extend(np.trunc(vals + np.where(vals >= 0, 0.5, -0.5)).astype(np.int64))
    expected = np.array(expected, dtype=np.int32)
    n = expected.shape[0]
    assert int(order.stream_len) == n
    np.testing.assert_array_equal(stream[:n], expected)
    assert (stream[n:] == 0).all()

    # dequantize scatters back: error <= step/2 everywhere except id 1 -> 0
    deq = np.asarray(dequantize_stream(jnp.asarray(stream), order, step))
    mask = seg != 1
    assert np.abs(deq[mask] - resid[mask]).max() <= step / 2 + 1e-6
    assert (deq[~mask] == 0).all()


# ---------------------------------------------------------------- contour
def test_contour_reference_example():
    """The documented example from contour_utils.py:181-196."""
    idx = np.array(
        [[1, 1, 1, 1, 2],
         [3, 2, 2, 1, 2],
         [3, 2, 1, 1, 2],
         [3, 3, 2, 2, 2]], dtype=np.int32)
    expected_contour = np.array(
        [[1, 0, 0, 0, 1],
         [1, 1, 0, 1, 1],
         [1, 1, 1, 0, 1],
         [1, 0, 1, 0, 0]], dtype=np.int32)
    expected_seq = np.array([1, 2, 3, 2, 1, 2, 3, 2, 1, 2, 3, 2], dtype=np.int32)

    code = extract_contour(jnp.asarray(idx))
    np.testing.assert_array_equal(np.asarray(code.contour), expected_contour)
    n = int(code.seq_len)
    np.testing.assert_array_equal(np.asarray(code.sequence)[:n], expected_seq)

    rec = recover_map(code.contour, code.sequence)
    np.testing.assert_array_equal(np.asarray(rec), idx)


def test_contour_roundtrip_random():
    rng = np.random.default_rng(6)
    seg = rng.integers(0, 40, (16, 200)).astype(np.int32)
    code = extract_contour(jnp.asarray(seg))
    rec = recover_map(code.contour, code.sequence)
    np.testing.assert_array_equal(np.asarray(rec), seg)


def test_segment_index_clean_matches_inplace_cascade():
    from rpcc.ops.segment import segment_index_clean

    rng = np.random.default_rng(9)
    seg = rng.integers(0, 5, (6, 40)).astype(np.int32)

    # direct port of the in-place C++ loop (cpp_modules.cpp:232-243)
    ref = seg.copy()
    h, w = ref.shape
    for r in range(h):
        for c in range(w - 2):
            cur, nxt, nxt2 = ref[r, c], ref[r, c + 1], ref[r, c + 2]
            if nxt2 == cur and nxt != cur:
                ref[r, c + 1] = cur

    ours = np.asarray(segment_index_clean(jnp.asarray(seg)))
    np.testing.assert_array_equal(ours, ref)


def test_fps_batched_wrapper():
    rng = np.random.default_rng(10)
    pts = rng.uniform(-5, 5, (3, 200, 3)).astype(np.float32)
    out = np.asarray(furthest_point_sample(jnp.asarray(pts), 8))
    assert out.shape == (3, 8)
    for b in range(3):
        np.testing.assert_array_equal(out[b], numpy_fps(pts[b], 8))
