"""Oxford campus dataset (HDL-32E) + pcd->bin converter
(reference ``dataset/datasets/oxford_dataset.py``)."""

import glob
import os

import numpy as np

from rpcc.data.dataset import DatasetTemplate
from rpcc.data.pointcloud_io import load_point_cloud


class OxfordCampusDataset(DatasetTemplate):
    def preprocess_pcd_to_bin(self, data_root: str) -> None:
        for d in sorted(glob.glob(os.path.join(data_root, "*"))):
            files = sorted(glob.glob(os.path.join(d, "velodyne_points/right/*.pcd")))
            for i, file in enumerate(files):
                save_path = file.replace("velodyne_points/right", "velodyne_points/right_bin")
                save_path = save_path.replace(save_path.split("/")[-1], "%010d.bin" % i)
                os.makedirs(os.path.dirname(save_path), exist_ok=True)
                pc = load_point_cloud(file)
                pc = np.append(pc, np.zeros((pc.shape[0], 1)), axis=1)
                pc.astype(np.float32).tofile(save_path)


if __name__ == "__main__":
    # Spot-check harness (reference oxford_dataset.py:54-72, headless).
    import argparse

    from rpcc.data.dataset import spot_check_datalist

    p = argparse.ArgumentParser()
    p.add_argument("--datalist", required=True)
    p.add_argument("--lidar", default="Velodyne32E")
    p.add_argument("--max_frames", type=int, default=5)
    a = p.parse_args()
    spot_check_datalist(OxfordCampusDataset, a.datalist, a.lidar, a.max_frames)
