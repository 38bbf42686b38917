"""Dataset + LiDAR registries (mirror of reference ``dataset/__init__.py``)."""

from __future__ import annotations

import os
from typing import Optional

from rpcc.data.dataset import DatasetTemplate, PCTransformer

BASE_DIR = os.path.dirname(os.path.abspath(__file__))
_CFG = lambda name: os.path.join(BASE_DIR, "lidar_cfg", name)  # noqa: E731

__lidar_cfg__ = {
    "VelodyneVLP16": _CFG("Velodyne_VLP_16.yaml"),
    "Velodyne32E": _CFG("Velodyne_HDL_32E.yaml"),
    "Velodyne64E": _CFG("Velodyne_HDL_64E.yaml"),
}

__lidar_csv__ = {
    "VelodyneVLP16": None,
    "Velodyne32E": None,
    "Velodyne64E": None,
}

__dataset_cfg__ = {
    "KITTI": _CFG("Velodyne_HDL_64E.yaml"),
    "KITTI_test": _CFG("Velodyne_HDL_64E_unofficial.yaml"),
    "NCLT": _CFG("Velodyne_HDL_32E.yaml"),
    "Oxford": _CFG("Velodyne_HDL_32E.yaml"),
    "HKUSTCampus": _CFG("Velodyne_VLP_16.yaml"),
}

__dataset_csv__ = {
    "KITTI": None,
    "KITTI_test": None,
    "NCLT": None,
    "Oxford": None,
    "HKUSTCampus": None,
}


def _dataset_classes():
    from rpcc.data.datasets.kitti_dataset import KittiDataset
    from rpcc.data.datasets.nclt_dataset import NcltDataset
    from rpcc.data.datasets.hkust_dataset import HkustCampusDataset
    from rpcc.data.datasets.oxford_dataset import OxfordCampusDataset

    return {
        "KITTI": KittiDataset,
        "KITTI_test": KittiDataset,
        "NCLT": NcltDataset,
        "HKUSTCampus": HkustCampusDataset,
        "Oxford": OxfordCampusDataset,
    }


def build_dataset(
    datalist: Optional[str] = None,
    dataset_name: Optional[str] = None,
    lidar_type: Optional[str] = None,
    use_radius_outlier_removal: bool = False,
) -> DatasetTemplate:
    """Name- or LiDAR-keyed factory (reference ``dataset/__init__.py:52-69``)."""
    if dataset_name is not None:
        cls = _dataset_classes()[dataset_name]
        return cls(
            datalist,
            __dataset_cfg__[dataset_name],
            __dataset_csv__[dataset_name],
            use_radius_outlier_removal,
        )
    if lidar_type is not None:
        return DatasetTemplate(
            datalist,
            __lidar_cfg__[lidar_type],
            __lidar_csv__[lidar_type],
            use_radius_outlier_removal,
        )
    return DatasetTemplate(datalist, dataset_cfg=None, use_radius_outlier_removal=use_radius_outlier_removal)
