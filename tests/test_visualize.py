"""Smoke tests for the headless visualization module (utils/visualize.py,
reference ``utils/visualize_utils.py`` equivalents): every renderer must
produce a non-empty file from real-shaped inputs."""

import os

import numpy as np

from rpcc.utils import visualize as viz


def test_renderers_produce_files(tmp_path):
    rng = np.random.default_rng(0)
    pc1 = rng.uniform(-20, 20, (500, 3)).astype(np.float32)
    pc2 = pc1 + rng.normal(0, 0.05, pc1.shape).astype(np.float32)
    ri = rng.uniform(0, 60, (16, 64)).astype(np.float32)
    seg = rng.integers(0, 8, (16, 64)).astype(np.int32)
    kp = rng.integers(0, 4, (16, 64)).astype(np.int32)

    outputs = [
        viz.compare_point_clouds(pc1, pc2, save_path=str(tmp_path / "cmp.png")),
        viz.visualize_range_image(ri, save_path=str(tmp_path / "ri.png")),
        viz.visualize_seg_map(seg, save_path=str(tmp_path / "seg.png")),
        viz.visualize_key_point_map(kp, ri, save_path=str(tmp_path / "kp.png")),
        viz.visualize_points_vertical_angle_distribution(
            pc1, save_path=str(tmp_path / "vert.png")
        ),
        viz.visualize_error_colored(pc1, pc2, save_path=str(tmp_path / "err.png")),
    ]
    for p in outputs:
        assert os.path.exists(p) and os.path.getsize(p) > 0

    pcd = str(tmp_path / "c.pcd")
    viz.save_point_cloud_to_pcd(pc1, pcd)
    from rpcc.data.pointcloud_io import _read_pcd

    assert np.array_equal(_read_pcd(pcd).astype(np.float32), pc1)
