"""Tests: double-direction contour/flood fill, lz4 container, metrics."""

import numpy as np

from rpcc.codec.contour2d import (
    compress_plane_idx_map,
    extract_contour_double_direction,
    recover_map_double_direction,
)
from rpcc.codec.entropy import BasicCompressor
from rpcc.metrics import calc_chamfer_distance, calc_point_to_point_plane_psnr


def test_double_direction_roundtrip():
    idx = np.array(
        [[1, 1, 1, 1, 2, 1, 3, 4, 4],
         [3, 2, 2, 1, 2, 1, 1, 3, 4],
         [3, 2, 1, 1, 2, 4, 4, 3, 4],
         [3, 3, 2, 2, 2, 1, 4, 4, 4]], dtype=np.int32)
    cm, seq = extract_contour_double_direction(idx)
    rec = recover_map_double_direction(cm, seq)
    np.testing.assert_array_equal(rec, idx)

    packed, seq1 = compress_plane_idx_map(idx, single_line=True)
    assert packed.dtype == np.uint8
    packed2, seq2 = compress_plane_idx_map(idx, single_line=False)
    assert packed2.dtype == np.uint8


def test_entropy_methods_roundtrip_bytes():
    rng = np.random.default_rng(0)
    data = rng.integers(0, 50, (64, 2000)).astype(np.int8)  # the reference's
    # self-test shape (compress_utils.py:313-342)
    for method in ["lz4", "bzip2", "gzip", "deflate"]:
        bc = BasicCompressor(method_name=method)
        blob = bc.compress(data)
        rec = np.frombuffer(bc.decompress(blob), np.int8).reshape(64, 2000)
        np.testing.assert_array_equal(rec, data)


def test_rans_method_roundtrip_int16():
    rng = np.random.default_rng(1)
    # random-walk-ish int16 stream like the residuals
    data = np.cumsum(rng.integers(-4, 5, 30000)).astype(np.int16)
    bc = BasicCompressor(method_name="rans")
    blob = bc.compress(data)
    rec = np.frombuffer(bc.decompress(blob), np.int16)
    np.testing.assert_array_equal(rec, data)
    assert len(blob) < data.nbytes / 2


def test_chamfer_identical_clouds():
    rng = np.random.default_rng(2)
    pc = rng.uniform(-10, 10, (5000, 3)).astype(np.float32)
    r = calc_chamfer_distance(pc, pc.copy(), out=False)
    assert r["mean"] < 1e-4
    assert r["f_score"] > 0.999


def test_chamfer_known_offset():
    rng = np.random.default_rng(3)
    pc = rng.uniform(-10, 10, (2000, 3)).astype(np.float32)
    # spread points so each point's NN is its shifted twin
    pc = pc * np.array([10, 10, 1])
    shifted = pc + np.array([0.01, 0, 0], np.float32)
    r = calc_chamfer_distance(pc, shifted, out=False)
    assert abs(r["mean"] - 0.01) < 2e-3


def test_psnr_identical_is_infinite_energy_ratio():
    rng = np.random.default_rng(4)
    pc = rng.uniform(-10, 10, (3000, 3))
    p2p, p2pl = calc_point_to_point_plane_psnr(pc, pc + 1e-4, out=False)
    assert p2p["psnr_mean"] > 80


def test_self_describing_header_roundtrip():
    from rpcc.codec.bitstream import pack_header, unpack_header

    head_bytes = pack_header(False, 0.03, "FPS", 64, "plane", "rans", "Velodyne32E")
    payload = b"\x12\x34rest-of-stream"
    head, rest = unpack_header(head_bytes + payload)
    assert rest == payload
    assert head == {
        "uniform": False, "accuracy": 0.03, "segment_method": "FPS",
        "cluster_num": 64, "modeling_method": "plane",
        "basic_compressor": "rans", "lidar_name": "Velodyne32E",
    }
    # headerless stream passes through untouched
    head2, rest2 = unpack_header(payload)
    assert head2 is None and rest2 == payload
