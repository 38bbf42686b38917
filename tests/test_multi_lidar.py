"""Multi-LiDAR geometry roundtrips (BASELINE config 4): Velodyne 32E and
VLP-16 range geometries, real registry configs, synthetic scenes."""

import numpy as np
import pytest

from rpcc.config import CodecConfig, LidarConfig
from rpcc.data import __lidar_cfg__
from rpcc.models.pipeline import RPCCCodec


def scene_for(lidar: LidarConfig, n=6000, seed=0):
    rng = np.random.default_rng(seed)
    ng = n // 2
    az = rng.uniform(0, 2 * np.pi, ng)
    r = rng.uniform(4, 40, ng)
    ground = np.stack([r * np.cos(az), r * np.sin(az), np.full(ng, -1.8)], -1)
    rest = []
    for _ in range((n - ng) // 150):
        c_az = rng.uniform(0, 2 * np.pi)
        c_r = rng.uniform(6, 30)
        center = np.array([c_r * np.cos(c_az), c_r * np.sin(c_az), rng.uniform(-1.0, 2.0)])
        rest.append(center + rng.normal(0, 0.7, (150, 3)))
    pc = np.concatenate([ground] + rest).astype(np.float32)
    el = np.arctan2(pc[:, 2], np.linalg.norm(pc[:, :2], axis=-1))
    return pc[(el > lidar.vertical_min) & (el < lidar.vertical_max)]


def test_kitti_test_unofficial_64e_geometry():
    """The KITTI_test registry entry maps to the unofficial 80-row 64E
    yaml (reference dataset/__init__.py: 'KITTI_test' -> 64E-unofficial);
    the full pipeline must roundtrip on that geometry too."""
    from rpcc.data import __dataset_cfg__

    lidar = LidarConfig.from_yaml(__dataset_cfg__["KITTI_test"], name="KITTI_test")
    assert lidar.height == 80
    cfg = CodecConfig(cluster_num=16)
    codec = RPCCCodec(lidar, cfg)
    pc = scene_for(lidar)
    blob, _, _ = codec.compress(pc)
    pc_rec, ri_rec, _ = codec.decompress(blob)
    ri = np.asarray(codec.encode_device(pc).range_image)
    assert ri.shape == (80, lidar.width)
    assert np.abs(ri_rec - ri).max() <= cfg.step + 1e-5


@pytest.mark.parametrize("name", ["Velodyne32E", "VelodyneVLP16"])
def test_registry_lidar_roundtrip(name):
    lidar = LidarConfig.from_yaml(__lidar_cfg__[name], name=name)
    # full-size geometry (32x2250 / 16x1800), modest cluster count for speed
    cfg = CodecConfig(cluster_num=24)
    codec = RPCCCodec(lidar, cfg)
    pc = scene_for(lidar)
    blob, fields, _ = codec.compress(pc)
    pc_rec, ri_rec, _ = codec.decompress(blob)
    ri = np.asarray(codec.encode_device(pc).range_image)
    assert ri.shape == (lidar.height, lidar.width)
    assert np.abs(ri_rec - ri).max() <= cfg.step + 1e-5
    assert (ri_rec[ri == 0] == 0).all()
    n_pts = (ri > 0).sum()
    assert len(blob) * 8 / n_pts < 96
