"""IO parser, converter, and preprocessing tests (ply/pcd/NCLT/txt,
radius outlier removal, sorted_index_encoder)."""

import os

import numpy as np
import pytest

from rpcc.data.dataset import (
    _radius_outlier_removal_naive,
    radius_outlier_removal,
)
from rpcc.data.pointcloud_io import (
    _read_pcd,
    _read_ply,
    _write_pcd,
    _write_ply,
    load_point_cloud,
    load_point_cloud_f32,
    save_point_cloud,
)


@pytest.fixture()
def cloud():
    rng = np.random.default_rng(0)
    return rng.uniform(-50, 50, (257, 3)).astype(np.float32)


# ------------------------------------------------------------------ ply/pcd
def test_ply_binary_roundtrip(tmp_path, cloud):
    p = str(tmp_path / "c.ply")
    _write_ply(p, cloud)
    back = _read_ply(p)
    assert np.array_equal(back.astype(np.float32), cloud)


def test_ply_ascii_read(tmp_path, cloud):
    p = str(tmp_path / "a.ply")
    with open(p, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {cloud.shape[0]}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("end_header\n")
        for row in cloud:
            f.write(f"{row[0]} {row[1]} {row[2]}\n")
    back = _read_ply(p)
    assert np.allclose(back, cloud, atol=1e-4)


def test_pcd_binary_roundtrip(tmp_path, cloud):
    p = str(tmp_path / "c.pcd")
    _write_pcd(p, cloud)
    back = _read_pcd(p)
    assert np.array_equal(back.astype(np.float32), cloud)


def test_pcd_ascii_read(tmp_path, cloud):
    p = str(tmp_path / "a.pcd")
    with open(p, "w") as f:
        f.write("# .PCD v0.7\nVERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\n")
        f.write(f"TYPE F F F\nCOUNT 1 1 1\nWIDTH {cloud.shape[0]}\nHEIGHT 1\n")
        f.write(f"VIEWPOINT 0 0 0 1 0 0 0\nPOINTS {cloud.shape[0]}\nDATA ascii\n")
        for row in cloud:
            f.write(f"{row[0]} {row[1]} {row[2]}\n")
    back = _read_pcd(p)
    assert np.allclose(back, cloud, atol=1e-4)


def test_pcd_extra_fields_and_counts(tmp_path, cloud):
    """Binary pcd with intensity + ring (mixed types/counts) still parses."""
    p = str(tmp_path / "m.pcd")
    n = cloud.shape[0]
    header = (
        "VERSION 0.7\nFIELDS x y z intensity ring\nSIZE 4 4 4 4 2\n"
        f"TYPE F F F F U\nCOUNT 1 1 1 1 1\nWIDTH {n}\nHEIGHT 1\n"
        f"VIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA binary\n"
    )
    rec = np.zeros(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                             ("intensity", "<f4"), ("ring", "<u2")])
    rec["x"], rec["y"], rec["z"] = cloud.T
    rec["intensity"] = 0.5
    rec["ring"] = 7
    with open(p, "wb") as f:
        f.write(header.encode())
        f.write(rec.tobytes())
    back = _read_pcd(p)
    assert np.array_equal(back.astype(np.float32), cloud)


def test_load_save_dispatch(tmp_path, cloud):
    for ext in ("bin", "npy", "ply", "pcd", "txt"):
        p = str(tmp_path / f"c.{ext}")
        save_point_cloud(p, cloud)
        back = load_point_cloud(p)
        assert back.shape[1] == 3
        # save drops sum==0 rows (reference dataset.py:74-75)
        keep = cloud.sum(-1) != 0
        assert np.allclose(back, cloud[keep], atol=1e-4)
        f32 = load_point_cloud_f32(p)
        assert f32.dtype == np.float32
        assert np.allclose(f32[:, :3], back, atol=1e-4)


# ------------------------------------------------------------------ converters
def test_nclt_converter(tmp_path):
    """Packed-uint16 velodyne_sync records decode with 5mm/-100m scaling
    (reference nclt_dataset.py:36-63 semantics)."""
    from rpcc.data.datasets.nclt_dataset import NcltDataset, _OFFSET, _SCALING

    rng = np.random.default_rng(1)
    xyz_u16 = rng.integers(0, 65535, (100, 3)).astype("<u2")
    rec = np.zeros(100, dtype=[("x", "<u2"), ("y", "<u2"), ("z", "<u2"),
                               ("i", "u1"), ("l", "u1")])
    rec["x"], rec["y"], rec["z"] = xyz_u16.T
    root = tmp_path / "nclt_vel" / "2012-01-08" / "velodyne_sync"
    os.makedirs(root)
    (root / "1326030463.bin").write_bytes(rec.tobytes())

    ds = NcltDataset()
    pc = ds.load_original_utf8_data(str(root / "1326030463.bin"))
    expect = xyz_u16.astype(np.float64) * _SCALING + _OFFSET
    assert np.allclose(pc, expect)

    ds.preprocess_original_utf8_to_bin_file(str(tmp_path))
    out = root.parent / "velodyne_sync_bin" / "0000000000.bin"
    assert out.exists()
    back = np.fromfile(out, np.float32).reshape(-1, 4)
    assert np.allclose(back[:, :3], expect, atol=1e-2)
    assert (back[:, 3] == 0).all()


@pytest.mark.parametrize("dataset,subdir,outdir", [
    ("OxfordCampusDataset", "velodyne_points/right", "velodyne_points/right_bin"),
    ("HkustCampusDataset", "velodyne_points/data", "velodyne_points/data_bin"),
])
def test_pcd_converters(tmp_path, cloud, dataset, subdir, outdir):
    import rpcc.data.datasets.hkust_dataset as hk
    import rpcc.data.datasets.oxford_dataset as ox

    cls = getattr(ox, dataset, None) or getattr(hk, dataset)
    d = tmp_path / "seq0" / subdir
    os.makedirs(d)
    _write_pcd(str(d / "scan.pcd"), cloud)
    cls().preprocess_pcd_to_bin(str(tmp_path))
    out = tmp_path / "seq0" / outdir / "0000000000.bin"
    assert out.exists()
    back = np.fromfile(out, np.float32).reshape(-1, 4)
    assert np.allclose(back[:, :3], cloud, atol=1e-5)


def test_kitti_txt_converter(tmp_path, cloud):
    from rpcc.data.datasets.kitti_dataset import KittiDataset

    d = tmp_path / "2011_09_26" / "drive" / "sync" / "velodyne_points" / "data"
    os.makedirs(d)
    with_intensity = np.concatenate([cloud, np.full((cloud.shape[0], 1), 0.25)], -1)
    np.savetxt(str(d / "0000000000.txt"), with_intensity)
    KittiDataset().preprocess_txt_to_bin(str(tmp_path), workers=2)
    out = d.parent / "data_bin" / "0000000000.bin"
    assert out.exists()
    back = np.fromfile(out, np.float32).reshape(-1, 4)
    assert np.allclose(back[:, :3], cloud, atol=1e-4)


# -------------------------------------------------------- outlier removal
def test_radius_outlier_removal_matches_naive():
    rng = np.random.default_rng(2)
    dense = rng.normal(0, 0.5, (300, 3))
    sparse = rng.uniform(20, 40, (20, 3))  # isolated -> removed
    pc = np.concatenate([dense, sparse]).astype(np.float64)
    fast = radius_outlier_removal(pc, nb_points=3, radius=1.0)
    naive = _radius_outlier_removal_naive(pc, nb_points=3, radius=1.0)
    assert np.array_equal(fast, naive)
    assert fast.shape[0] >= dense.shape[0] * 0.9


def test_radius_outlier_removal_speed():
    rng = np.random.default_rng(3)
    pc = rng.uniform(-60, 60, (122_320, 3))
    import time

    t0 = time.perf_counter()
    radius_outlier_removal(pc, nb_points=3, radius=1.0)
    assert time.perf_counter() - t0 < 2.0  # usable at dataset scale


def test_spot_check_datalist(tmp_path, cloud, capsys):
    """The per-dataset __main__ harness prints a round-trip chamfer per
    frame (headless twin of the reference visual spot checks)."""
    from rpcc.data.dataset import DatasetTemplate, spot_check_datalist

    frame = tmp_path / "f.bin"
    np.concatenate([cloud, np.zeros((cloud.shape[0], 1), np.float32)], -1).astype(
        np.float32
    ).tofile(frame)
    dl = tmp_path / "list.txt"
    dl.write_text(str(frame) + "\n")
    spot_check_datalist(DatasetTemplate, str(dl), "VelodyneVLP16", max_frames=1)
    outp = capsys.readouterr().out
    assert "chamfer" in outp and "F1" in outp


# ---------------------------------------------------- sorted_index_encoder
def test_sorted_index_encoder_roundtrip():
    from rpcc.codec.contour2d import (
        extract_contour_double_direction,
        flood_fill_decode,
        sorted_index_encoder,
    )

    idx = np.array(
        [
            [1, 1, 2, 2, 3, 3, 3, 1, 1],
            [1, 1, 2, 2, 2, 3, 3, 1, 1],
            [4, 4, 4, 2, 2, 3, 1, 1, 1],
            [4, 4, 4, 4, 2, 2, 1, 1, 5],
        ],
        np.int32,
    )
    contour, _ = extract_contour_double_direction(idx)
    sorted_map, sorted_seq, orig_seq = sorted_index_encoder(contour, idx)
    # ids renumber 1..n in discovery order; same region partition
    assert sorted_seq.tolist() == list(range(1, len(sorted_seq) + 1))
    assert len(orig_seq) == len(sorted_seq)
    # decoding the sorted sequence reproduces the sorted map exactly
    rec = flood_fill_decode(contour, sorted_seq)
    assert np.array_equal(rec, sorted_map)
    # and every sorted region carries its original id in orig_seq
    for s_id, o_id in zip(sorted_seq, orig_seq):
        region = sorted_map == s_id
        assert region.any() and (idx[region] == o_id).all()
