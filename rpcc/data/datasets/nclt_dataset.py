"""NCLT dataset (Velodyne HDL-32E) + utf8 velodyne_sync converter.

Equivalent of reference ``dataset/datasets/nclt_dataset.py:36-63``: NCLT
distributes scans as packed uint16 triples with 5mm scaling and -100m offset.
"""

import glob
import os

import numpy as np

from rpcc.data.dataset import DatasetTemplate

_SCALING = 0.005  # 5 mm
_OFFSET = -100.0


class NcltDataset(DatasetTemplate):
    @staticmethod
    def convert(x_s, y_s, z_s):
        return (
            x_s * _SCALING + _OFFSET,
            y_s * _SCALING + _OFFSET,
            z_s * _SCALING + _OFFSET,
        )

    def load_original_utf8_data(self, file: str) -> np.ndarray:
        """Read one velodyne_sync/[utime].bin: records of <HHHBB (x,y,z,i,l)."""
        raw = np.fromfile(file, dtype=np.uint8)
        raw = raw[: (raw.shape[0] // 8) * 8].reshape(-1, 8)
        xyz = raw[:, :6].copy().view("<u2").astype(np.float64)
        return xyz * _SCALING + _OFFSET

    def preprocess_original_utf8_to_bin_file(self, data_root: str) -> None:
        for d in sorted(glob.glob(os.path.join(data_root, "*_vel"))):
            files = sorted(glob.glob(os.path.join(d, "*/velodyne_sync/*.bin")))
            for i, file in enumerate(files):
                save_path = file.replace("velodyne_sync", "velodyne_sync_bin")
                save_path = save_path.replace(save_path.split("/")[-1], "%010d.bin" % i)
                os.makedirs(os.path.dirname(save_path), exist_ok=True)
                pc = self.load_original_utf8_data(file)
                pc = np.append(pc, np.zeros((pc.shape[0], 1)), axis=1)
                pc.astype(np.float32).tofile(save_path)


if __name__ == "__main__":
    # Spot-check harness (reference nclt_dataset.py:66-89, headless).
    import argparse

    from rpcc.data.dataset import spot_check_datalist

    p = argparse.ArgumentParser()
    p.add_argument("--datalist", required=True)
    p.add_argument("--lidar", default="Velodyne32E")
    p.add_argument("--max_frames", type=int, default=5)
    a = p.parse_args()
    spot_check_datalist(NcltDataset, a.datalist, a.lidar, a.max_frames)
