"""Dataset template: datalist iteration + projection round-trip.

Equivalent of the reference ``DatasetTemplate`` (``dataset/dataset.py:7-108``)
minus open3d: items are ``(point_cloud (H,W,3), range_image (H,W,1),
original_point_cloud (N,3), file_name)`` where the point cloud is the
back-projection of the range image.

The projection itself runs through the jitted device op (ops/projection.py); the
radius-outlier-removal preprocessing option is provided by a numpy
grid-hash neighbor count (the reference shells out to o3d,
``dataset.py:29-35``).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import jax.numpy as jnp

from rpcc.config import LidarConfig
from rpcc.data.pointcloud_io import load_point_cloud, save_point_cloud
from rpcc.ops.projection import (
    build_transform_map,
    project_points,
    range_image_to_points,
)


class PCTransformer:
    """Host-facing wrapper bundling a LidarConfig with its transform map."""

    def __init__(self, lidar_cfg_yaml: Optional[str] = None, channel_distribute_csv: Optional[str] = None,
                 lidar: Optional[LidarConfig] = None):
        if lidar is None:
            lidar = LidarConfig.from_yaml(lidar_cfg_yaml, channel_distribute_csv)
        self.lidar = lidar
        self.H, self.W = lidar.height, lidar.width
        self.transform_map = build_transform_map(lidar)
        self._v_angles = (
            None
            if lidar.even_dist
            else jnp.asarray(np.radians(np.asarray(lidar.vertical_angles_deg)), jnp.float32)
        )

    def point_cloud_to_range_image(self, point_cloud: np.ndarray) -> np.ndarray:
        ri = project_points(
            jnp.asarray(point_cloud[:, :3], jnp.float32), self.lidar, self._v_angles
        )
        return np.asarray(ri)

    def range_image_to_point_cloud(self, range_image: np.ndarray) -> np.ndarray:
        ri = np.asarray(range_image)
        if ri.ndim == 3:
            ri = ri[..., 0]
        return np.asarray(range_image_to_points(jnp.asarray(ri), jnp.asarray(self.transform_map)))


def radius_outlier_removal(pc: np.ndarray, nb_points: int = 3, radius: float = 1.0) -> np.ndarray:
    """Keep points with >= nb_points neighbors within radius (self included,
    o3d ``remove_radius_outlier`` semantics — reference dataset.py:29-35).

    kd-tree formulation: a point has >= k neighbors within r iff its k-th
    nearest neighbor (counting itself) lies within r — one k-NN query with
    tiny k instead of a full ball count (~0.1 s for a 122k-point KITTI
    frame vs minutes for the naive pairwise loop, which survives as the
    test oracle)."""
    pc = np.asarray(pc)
    if pc.shape[0] == 0 or nb_points <= 1:
        return pc
    from scipy.spatial import cKDTree

    tree = cKDTree(pc[:, :3])
    d, _ = tree.query(pc[:, :3], k=nb_points, distance_upper_bound=np.inf)
    return pc[d[:, nb_points - 1] <= radius]


def _radius_outlier_removal_naive(
    pc: np.ndarray, nb_points: int = 3, radius: float = 1.0
) -> np.ndarray:
    """Grid-hash oracle (quadratic within cells) — test reference only."""
    cell = radius
    keys = np.floor(pc[:, :3] / cell).astype(np.int64)
    from collections import defaultdict

    grid = defaultdict(list)
    for i, k in enumerate(map(tuple, keys)):
        grid[k].append(i)
    keep = np.zeros(pc.shape[0], bool)
    r2 = radius * radius
    for i, k in enumerate(map(tuple, keys)):
        cnt = 0
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    for j in grid.get((k[0] + dx, k[1] + dy, k[2] + dz), ()):
                        if np.sum((pc[i, :3] - pc[j, :3]) ** 2) <= r2:
                            cnt += 1
                            if cnt >= nb_points:
                                break
                    if cnt >= nb_points:
                        break
                if cnt >= nb_points:
                    break
            if cnt >= nb_points:
                break
        keep[i] = cnt >= nb_points
    return pc[keep]


class DatasetTemplate:
    def __init__(
        self,
        datalist: Optional[str] = None,
        dataset_cfg: Optional[str] = None,
        channel_distribute_csv: Optional[str] = None,
        use_radius_outlier_removal: bool = False,
    ):
        self.data_list: List[str] = []
        if datalist is not None:
            with open(datalist, "r") as f:
                self.data_list = [line.strip() for line in f if line.strip()]
        if dataset_cfg is not None:
            self.dataset_cfg = dataset_cfg
            self.PCTransformer = PCTransformer(dataset_cfg, channel_distribute_csv)
            self.transform_map = self.PCTransformer.transform_map
        self.use_radius_outlier_removal = use_radius_outlier_removal

    def __len__(self) -> int:
        return len(self.data_list)

    def __getitem__(self, index: int):
        file_name = self.data_list[index]
        original = self.load_data(file_name)
        pc_in = radius_outlier_removal(original) if self.use_radius_outlier_removal else original
        range_image = self.PCTransformer.point_cloud_to_range_image(pc_in)
        range_image = np.expand_dims(range_image, -1)
        point_cloud = self.PCTransformer.range_image_to_point_cloud(range_image)
        return point_cloud, range_image, original, file_name

    def load_data(self, file: str) -> np.ndarray:
        return load_point_cloud(file)

    def load_range_image_points_from_file(self, file: str):
        original = self.load_data(file)
        range_image = self.PCTransformer.point_cloud_to_range_image(original)
        range_image = np.expand_dims(range_image, -1)
        point_cloud = self.PCTransformer.range_image_to_point_cloud(range_image)
        return point_cloud, range_image, original

    def save_point_cloud_to_file(self, file: str, point_cloud: np.ndarray, color=None) -> None:
        save_point_cloud(file, point_cloud.reshape(-1, point_cloud.shape[-1]))


def spot_check_datalist(dataset_cls, datalist: str, lidar_name: str, max_frames: int = 5) -> None:
    """Headless twin of the reference per-dataset ``__main__`` visual
    checks (``dataset/datasets/kitti_dataset.py:35-55`` and siblings):
    iterate the datalist and print the projection round-trip chamfer
    distance per frame (the o3d viewer is replaced by numbers)."""
    from rpcc.data import __lidar_cfg__, __lidar_csv__
    from rpcc.metrics import calc_chamfer_distance

    ds = dataset_cls(
        datalist=datalist,
        dataset_cfg=__lidar_cfg__[lidar_name],
        channel_distribute_csv=__lidar_csv__.get(lidar_name),
    )
    for i in range(min(len(ds), max_frames)):
        point_cloud, _ri, original, file_name = ds[i]
        cd = calc_chamfer_distance(
            point_cloud.reshape(-1, 3), original[:, :3], out=False
        )
        print(
            f"{file_name}: {original.shape[0]} pts -> projection round-trip "
            f"chamfer {cd['mean']:.6f}, F1 {cd['f_score']:.4f}"
        )
