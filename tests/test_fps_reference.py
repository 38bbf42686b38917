"""The lax FPS against a numpy port of the reference's CUDA sampler.

``ops/fps/src/sampling_gpu.cu`` seeds at index 0, keeps a running
min-squared-distance per point (initial 1e10), and appends the point with
the largest running distance; a strict ``>`` scan makes the lowest index win
ties.  Integer coordinates keep every distance exact, so ties are real and
both sides must pick the same indices.
"""

import jax.numpy as jnp
import numpy as np

from rpcc.ops.fps import furthest_point_sample, furthest_point_sample_planar


def fps_reference(points: np.ndarray, n: int) -> np.ndarray:
    pts = np.asarray(points, np.float32)
    temp = np.full(pts.shape[0], 1e10, np.float32)
    out = [0]
    old = 0
    for _ in range(1, n):
        d = pts - pts[old]
        dist = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
        temp = np.minimum(temp, dist)
        best, besti = -1.0, 0
        for k, v in enumerate(temp):  # the kernel's strict-> scan
            if v > best:
                best, besti = v, k
        out.append(besti)
        old = besti
    return np.asarray(out, np.int32)


def _tied_cloud(rng, n):
    """Integer lattice points with many duplicates and symmetric pairs."""
    pts = rng.integers(-6, 7, (n, 3)).astype(np.float32)
    pts[n // 2:] = pts[: n - n // 2]  # exact duplicates at higher indices
    return pts


def test_fps_matches_reference_single_frame_with_ties():
    rng = np.random.default_rng(0)
    pts = _tied_cloud(rng, 300)
    ref = fps_reference(pts, 24)
    got = np.asarray(furthest_point_sample_planar(
        jnp.asarray(pts[:, 0]), jnp.asarray(pts[:, 1]), jnp.asarray(pts[:, 2]), 24))
    np.testing.assert_array_equal(got, ref)
    assert (got < 150).all()  # duplicates past the first copy never win a tie


def test_fps_matches_reference_batched():
    rng = np.random.default_rng(1)
    batch = np.stack([_tied_cloud(rng, 256) for _ in range(3)])
    batch[1, 40:90] = 0.0  # zero-masked pixels, as in the range-image grid
    got = np.asarray(furthest_point_sample(jnp.asarray(batch), 16))
    ref = np.stack([fps_reference(b, 16) for b in batch])
    np.testing.assert_array_equal(got, ref)
