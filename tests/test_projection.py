"""Projection kernel tests: scatter-min semantics, round-trip, binning parity
with a straightforward numpy re-statement of the reference C++ loop
(cpp_modules.cpp:427-467)."""

import math

import numpy as np
import jax.numpy as jnp
import pytest

from rpcc.config import LidarConfig
from rpcc.ops.projection import (
    build_transform_map,
    project_points,
    range_image_to_points,
)

LIDAR_64E = LidarConfig(
    name="Velodyne64E",
    horizontal_fov_deg=360.0,
    vertical_angle_max_deg=2.0,
    vertical_angle_min_deg=-24.9,
    height=64,
    width=2000,
)

SMALL = LidarConfig(
    name="small",
    horizontal_fov_deg=360.0,
    vertical_angle_max_deg=2.0,
    vertical_angle_min_deg=-24.9,
    height=8,
    width=64,
)


def numpy_reference_projection(pc, lidar):
    """Sequential keep-nearest loop, the C++ kernel's semantics."""
    H, W = lidar.height, lidar.width
    ri = np.zeros((H, W), dtype=np.float32)
    for p in pc.astype(np.float32):
        x, y, z = float(p[0]), float(p[1]), float(p[2])
        depth = math.sqrt(x * x + y * y + z * z)
        if depth <= 0:
            continue
        ha = math.atan2(y, x)
        if ha < 0:
            ha += 2 * 3.14159265
        va = math.atan2(z, math.sqrt(x * x + y * y))
        col = int(np.float32(round(np.float32(ha / lidar.horizontal_fov * W)))) % W
        vres = (lidar.vertical_max - lidar.vertical_min) / (H - 1)
        row = round(np.float32((va - lidar.vertical_min) / vres))
        row = min(max(row, 0), H - 1)
        if ri[row, col] == 0 or depth < ri[row, col]:
            ri[row, col] = depth
    return ri


def random_cloud(n, seed=0):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(2.0, 80.0, n)
    az = rng.uniform(0, 2 * np.pi, n)
    el = rng.uniform(LIDAR_64E.vertical_min, LIDAR_64E.vertical_max, n)
    x = depth * np.cos(el) * np.cos(az)
    y = depth * np.cos(el) * np.sin(az)
    z = depth * np.sin(el)
    return np.stack([x, y, z], -1).astype(np.float32)


def test_transform_map_matches_reference_formula():
    tm = build_transform_map(SMALL)
    H, W = SMALL.height, SMALL.width
    vfov = SMALL.vertical_max - SMALL.vertical_min
    for h in [0, 3, H - 1]:
        for w in [0, 17, W - 1]:
            alt = vfov * (h / (H - 1)) + SMALL.vertical_min
            az = SMALL.horizontal_fov * (w / W)
            exp = np.array(
                [math.cos(alt) * math.cos(az), math.cos(alt) * math.sin(az), math.sin(alt)],
                dtype=np.float32,
            )
            np.testing.assert_allclose(tm[h, w], exp, rtol=1e-6)
    # rays are unit norm
    np.testing.assert_allclose(np.linalg.norm(tm, axis=-1), 1.0, atol=1e-6)


def test_projection_matches_numpy_reference():
    pc = random_cloud(5000)
    ours = np.asarray(project_points(jnp.asarray(pc), LIDAR_64E))
    ref = numpy_reference_projection(pc, LIDAR_64E)
    mismatch = np.abs(ours - ref) > 1e-5
    # float32 atan2 boundary bins may differ on a handful of points
    assert mismatch.mean() < 1e-3, f"{mismatch.sum()} mismatched pixels"


def test_projection_keeps_nearest_on_collision():
    # two points in the same pixel: the nearer survives
    base = random_cloud(1)[0]
    far = base * 2.0
    ri = np.asarray(project_points(jnp.asarray(np.stack([far, base])), LIDAR_64E))
    nz = ri[ri > 0]
    assert nz.shape[0] == 1
    np.testing.assert_allclose(nz[0], np.linalg.norm(base), rtol=1e-5)


def test_padding_points_are_ignored():
    pc = random_cloud(100)
    padded = np.concatenate([pc, np.zeros((50, 3), np.float32)])
    a = np.asarray(project_points(jnp.asarray(pc), LIDAR_64E))
    b = np.asarray(project_points(jnp.asarray(padded), LIDAR_64E))
    np.testing.assert_array_equal(a, b)


def test_backprojection_roundtrip_error_bounded():
    """project -> backproject -> project is a fixed point, and the
    backprojected cloud sits within angular-bin distance of the original."""
    pc = random_cloud(20000, seed=1)
    tm = jnp.asarray(build_transform_map(LIDAR_64E))
    ri = project_points(jnp.asarray(pc), LIDAR_64E)
    pts = range_image_to_points(ri, tm)
    ri2 = project_points(np.asarray(pts).reshape(-1, 3), LIDAR_64E)
    # All surviving depths identical (projection of backprojection is stable).
    a, b = np.asarray(ri), np.asarray(ri2)
    both = (a > 0) & (b > 0)
    assert both.sum() > 0.95 * (a > 0).sum()
    np.testing.assert_allclose(a[both], b[both], rtol=1e-5)


UNEVEN = LidarConfig(
    name="uneven32",
    horizontal_fov_deg=360.0,
    vertical_angle_max_deg=10.67,
    vertical_angle_min_deg=-30.67,
    height=8,
    width=512,
    vertical_angles_deg=tuple(float(10.0 - 5.5 * i) for i in range(8)),
)


def test_uneven_channel_projection_rows_by_nearest_angle():
    """Uneven LiDARs bin rows by nearest channel angle (transformer.py:82-83)."""
    import jax.numpy as jnp_

    rng = np.random.default_rng(7)
    n = 3000
    # points exactly on channel angles 2 and 5
    for ch in (2, 5):
        ang = math.radians(UNEVEN.vertical_angles_deg[ch])
        depth = rng.uniform(5, 40, n)
        az = rng.uniform(0, 2 * np.pi, n)
        pc = np.stack(
            [depth * np.cos(ang) * np.cos(az), depth * np.cos(ang) * np.sin(az),
             depth * np.sin(ang)], -1).astype(np.float32)
        v = jnp_.asarray(np.radians(np.asarray(UNEVEN.vertical_angles_deg)), jnp_.float32)
        ri = np.asarray(project_points(jnp_.asarray(pc), UNEVEN, v))
        occupied_rows = np.where((ri > 0).any(axis=1))[0]
        assert occupied_rows.tolist() == [ch]


def test_uneven_roundtrip_through_codec():
    from rpcc.config import CodecConfig
    from rpcc.models.pipeline import RPCCCodec

    rng = np.random.default_rng(8)
    n = 4000
    depth = rng.uniform(3, 50, n)
    az = rng.uniform(0, 2 * np.pi, n)
    el = np.radians(rng.choice(np.asarray(UNEVEN.vertical_angles_deg), n))
    pc = np.stack(
        [depth * np.cos(el) * np.cos(az), depth * np.cos(el) * np.sin(az),
         depth * np.sin(el)], -1).astype(np.float32)
    codec = RPCCCodec(UNEVEN, CodecConfig(cluster_num=8))
    blob, _, _ = codec.compress(pc)
    pc_rec, ri_rec, _ = codec.decompress(blob)
    ri = np.asarray(codec.encode_device(pc).range_image)
    assert np.abs(ri_rec - ri).max() <= codec.cfg.step + 1e-5
