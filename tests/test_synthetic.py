"""Seeded frames: deterministic, distinct, and full-size on the 64E grid."""

import numpy as np

from rpcc.config import LidarConfig
from rpcc.data import __lidar_cfg__
from rpcc.data.synthetic import MAX_RANGE, MIN_RANGE, synthetic_frames
from rpcc.ops.projection import project_points_host


def test_seeded_frames_deterministic_and_full_size():
    lidar = LidarConfig.from_yaml(__lidar_cfg__["Velodyne64E"], name="Velodyne64E")
    a = synthetic_frames(lidar, 3, seed=5)
    b = synthetic_frames(lidar, 3, seed=5)
    assert len(a) == 3
    for x, y in zip(a, b):
        assert x.dtype == np.float32 and x.shape[1] == 3
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], synthetic_frames(lidar, 1, seed=6)[0])
    hw = lidar.height * lidar.width
    for f in a:
        r = np.linalg.norm(f, axis=-1)
        assert 0.9 * hw < f.shape[0] <= hw  # ~120k points of a 128k grid
        assert r.min() > MIN_RANGE - 0.1 and r.max() < MAX_RANGE + 5.0
        occupied = int((project_points_host(f, lidar) > 0).sum())
        assert occupied > 0.9 * hw
    assert a[1].shape != a[2].shape or not np.array_equal(a[1], a[2])
    for x, y in zip(synthetic_frames(lidar, 2, seed=5), a):  # prefix-stable
        np.testing.assert_array_equal(x, y)
