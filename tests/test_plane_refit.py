"""Full-cluster plane modeling fidelity vs a direct numpy port of the
reference loop (utils/segment_utils.py:187-216): RANSAC hypothesis, refit on
ALL cluster inliers, scan-angle validation over ALL cluster pixels.

plane_models_stream is driven directly with a hand-built segmentation so the
cluster size is controlled: >1024 px exercises the full-stream refit beyond
the hypothesis sample."""

import jax
import jax.numpy as jnp
import numpy as np

from rpcc.config import CodecConfig, LidarConfig
from rpcc.models.pipeline import RPCCCodec
from rpcc.ops.modeling import plane_models_stream
from rpcc.ops.projection import build_transform_planes
from rpcc.ops.stream import stream_sort
from tests.test_roundtrip import SMALL

BIG = LidarConfig(
    name="big32",
    horizontal_fov_deg=360.0,
    vertical_angle_max_deg=2.0,
    vertical_angle_min_deg=-24.9,
    height=32,
    width=512,
)
NUM_MODELS = 4  # ground, zero, cluster 2, cluster 3


def lsq_plane(points: np.ndarray) -> np.ndarray:
    centroid = points.mean(0)
    cov = np.cov((points - centroid).T, bias=True)
    w, v = np.linalg.eigh(cov)
    n = v[:, 0]
    return np.concatenate([n, [-n @ centroid]])


def plane_fit_port(points: np.ndarray, rng, iters=10, n=4, thr=0.1) -> np.ndarray:
    """o3d segment_plane semantics: hypothesis vote + full-inlier refit."""
    best, best_cnt = None, -1
    for _ in range(iters):
        idx = rng.choice(len(points), n, replace=False)
        plane = lsq_plane(points[idx])
        dist = np.abs(points @ plane[:3] + plane[3]) / np.linalg.norm(plane[:3])
        cnt = int((dist < thr).sum())
        if cnt > best_cnt:
            best, best_cnt = plane, cnt
    dist = np.abs(points @ best[:3] + best[3]) / np.linalg.norm(best[:3])
    return lsq_plane(points[dist < thr])


def plane_scene(plane: np.ndarray, noise=0.01, seed=0, min_cos=0.0):
    """Range image whose pixels hit a given plane wherever the ray does at
    5..60 m; those pixels form cluster 2, the rest are zero pixels (id 1).
    ``min_cos`` drops grazing rays (|n.ray| below it) so acceptance tests
    stay under the scan-angle threshold."""
    rng = np.random.default_rng(seed)
    tm = np.asarray(build_transform_planes(BIG))  # (3, H, W)
    denom = plane[0] * tm[0] + plane[1] * tm[1] + plane[2] * tm[2]
    with np.errstate(divide="ignore"):
        r = -plane[3] / denom
    hit = (r > 5.0) & (r < 60.0) & (np.abs(denom) > min_cos)
    r = np.where(hit, r + rng.normal(0, noise, r.shape), 0.0).astype(np.float32)
    seg = np.where(hit, 2, 1).astype(np.int32)
    return r, seg, tm


def _fit(ri, seg, tm, angle_threshold=75.0, seed=0):
    H, W = ri.shape
    hw = H * W
    tm_flat = jnp.asarray(tm.reshape(3, hw))
    ri_flat = jnp.asarray(ri.reshape(hw))
    order, carried = stream_sort(
        jnp.asarray(seg.reshape(hw)),
        [ri_flat, tm_flat[0], tm_flat[1], tm_flat[2]],
        NUM_MODELS,
    )
    ri_s, tx, ty, tz = carried
    models = plane_models_stream(
        ri_s, order, jax.random.PRNGKey(seed),
        NUM_MODELS, angle_threshold, (tx, ty, tz),
    )
    return np.asarray(models)


def test_full_cluster_refit_matches_reference_port():
    true_plane = np.array([0.8, 0.1, 0.59, -14.0])
    true_plane[:3] /= np.linalg.norm(true_plane[:3])
    ri, seg, tm = plane_scene(true_plane, min_cos=0.42)  # alpha < 65 deg
    npx = int((seg == 2).sum())
    assert npx > 1024, f"cluster only {npx} px — plane misses the grid"

    models = _fit(ri, seg, tm)
    dev_plane = models[2]
    assert np.abs(dev_plane[:3]).sum() > 0, "cluster not plane-modeled"

    pts = (ri[..., None] * np.transpose(tm, (1, 2, 0)))[seg == 2]
    port = plane_fit_port(pts.astype(np.float64), np.random.default_rng(1))

    cos = abs(float(dev_plane[:3] @ port[:3]) / np.linalg.norm(dev_plane[:3]) / np.linalg.norm(port[:3]))
    angle_deg = np.degrees(np.arccos(min(cos, 1.0)))
    assert angle_deg < 0.5, f"normal off by {angle_deg:.3f} deg from full-cluster port"
    rays = np.transpose(tm, (1, 2, 0))[seg == 2]
    pred_dev = -dev_plane[3] / (rays @ dev_plane[:3])
    pred_port = -port[3] / (rays @ port[:3])
    assert np.abs(pred_dev - pred_port).max() < 0.05


def test_refit_uses_pixels_beyond_the_sample():
    """Plant a bias in pixels the 1024-sample can only partially see: with
    >6000 px, a sample-only refit would recover the hypothesis-sample plane,
    while the full refit must match the all-pixel least-squares fit."""
    true_plane = np.array([0.97, 0.0, 0.24, -12.0])
    true_plane[:3] /= np.linalg.norm(true_plane[:3])
    ri, seg, tm = plane_scene(true_plane, noise=0.03, seed=3, min_cos=0.42)
    npx = int((seg == 2).sum())
    assert npx > 4000
    models = _fit(ri, seg, tm)
    dev_plane = models[2]
    pts = (ri[..., None] * np.transpose(tm, (1, 2, 0)))[seg == 2].astype(np.float64)
    dist = np.abs(pts @ dev_plane[:3] + dev_plane[3]) / np.linalg.norm(dev_plane[:3])
    full = lsq_plane(pts[dist < 0.1])
    cos = abs(float(dev_plane[:3] @ full[:3]) / np.linalg.norm(dev_plane[:3]))
    assert np.degrees(np.arccos(min(cos, 1.0))) < 0.2
    assert abs(-dev_plane[3] - (-full[3])) < 0.05


def test_full_cluster_angle_validation_rejects_oblique():
    """A plane nearly containing the scan rays in part of its extent: alpha
    exceeds the 75-deg threshold somewhere in the cluster, so the whole
    cluster must fall back to the point model."""
    # normal almost perpendicular to the rays that hit it (x-axis rays graze)
    n = np.array([0.17, 0.98, 0.0])
    n /= np.linalg.norm(n)
    plane = np.concatenate([n, [-3.0]])
    ri, seg, tm = plane_scene(plane, noise=0.002, seed=5)
    npx = int((seg == 2).sum())
    assert npx > 100
    models = _fit(ri, seg, tm)
    assert np.abs(models[2][:3]).sum() == 0, "oblique plane not rejected"


def test_plane_mode_roundtrip_bound():
    cfg = CodecConfig(cluster_num=16, modeling_method="plane")
    codec = RPCCCodec(SMALL, cfg)
    from tests.test_roundtrip import synth_scene

    pc = synth_scene(seed=4)
    blob, _, _ = codec.compress(pc)
    _, ri_rec, _ = codec.decompress(blob)
    ri = np.asarray(codec.encode_device(pc).range_image)
    assert np.abs(ri_rec - ri).max() <= cfg.step + 1e-5
