"""CLI integration tests: drive the real argparse mains end-to-end."""

import sys

import numpy as np
import pytest

from tests.test_roundtrip import synth_scene


@pytest.fixture()
def frame_bin(tmp_path):
    pc = synth_scene(seed=42)
    path = tmp_path / "frame.bin"
    np.concatenate([pc, np.zeros((pc.shape[0], 1), np.float32)], -1).astype(
        np.float32
    ).tofile(path)
    return str(path)


def run_main(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", argv)
    module.main()


def test_compress_decompress_cli(frame_bin, tmp_path, monkeypatch):
    from rpcc.cli import compress, decompress

    out = str(tmp_path / "f.rpcc")
    rec = str(tmp_path / "rec.bin")
    # VLP16 is the smallest real geometry -> fastest CPU test
    run_main(
        compress,
        ["compress", "--input", frame_bin, "--output", out,
         "--lidar", "VelodyneVLP16", "--cluster_num", "16"],
        monkeypatch,
    )
    run_main(
        decompress,
        ["decompress", "--input", out, "--output", rec,
         "--lidar", "VelodyneVLP16", "--cluster_num", "16"],
        monkeypatch,
    )
    r = np.fromfile(rec, np.float32).reshape(-1, 4)
    assert r.shape[0] > 100
    assert np.isfinite(r).all()

    # host decode backend must reconstruct the same point set (rays differ
    # by float ulps between the in-graph trig and the f64-built table)
    rec_h = str(tmp_path / "rec_host.bin")
    run_main(
        decompress,
        ["decompress", "--input", out, "--output", rec_h,
         "--lidar", "VelodyneVLP16", "--cluster_num", "16",
         "--decode_backend", "host"],
        monkeypatch,
    )
    rh = np.fromfile(rec_h, np.float32).reshape(-1, 4)
    assert rh.shape[0] == r.shape[0]
    assert np.abs(rh[:, :3] - r[:, :3]).max() < 1e-3


def test_self_describing_cli(frame_bin, tmp_path, monkeypatch):
    from rpcc.cli import compress, decompress

    out = str(tmp_path / "sd.rpcc")
    rec = str(tmp_path / "sd.bin")
    run_main(
        compress,
        ["compress", "--input", frame_bin, "--output", out,
         "--lidar", "VelodyneVLP16", "--cluster_num", "16",
         "--accuracy", "0.05", "--basic_compressor", "rans", "--self_describing"],
        monkeypatch,
    )
    # decompress needs NO flags at all
    run_main(decompress, ["decompress", "--input", out, "--output", rec], monkeypatch)
    r = np.fromfile(rec, np.float32).reshape(-1, 4)
    assert r.shape[0] > 100


def test_datalist_cli_roundtrip(frame_bin, tmp_path, monkeypatch):
    from rpcc.cli import compress_datalist, decompress_datalist

    datalist = tmp_path / "list.txt"
    datalist.write_text(frame_bin + "\n")
    out_dir = str(tmp_path / "out")
    run_main(
        compress_datalist,
        ["compress_datalist", "--datalist", str(datalist), "--output_dir", out_dir,
         "--lidar", "VelodyneVLP16", "--cluster_num", "16", "--batch", "2",
         "--workers", "1"],
        monkeypatch,
    )
    import glob

    rpccs = glob.glob(out_dir + "/**/*.rpcc", recursive=True)
    assert len(rpccs) == 1
    rpcc_list = tmp_path / "rpcc.txt"
    rpcc_list.write_text(rpccs[0] + "\n")
    rec_dir = str(tmp_path / "rec")
    run_main(
        decompress_datalist,
        ["decompress_datalist", "--datalist", str(rpcc_list), "--output_dir", rec_dir,
         "--lidar", "VelodyneVLP16", "--cluster_num", "16", "--batch", "2",
         "--workers", "1"],
        monkeypatch,
    )
    bins = glob.glob(rec_dir + "/**/*.bin", recursive=True)
    assert len(bins) == 1

    # host decode backend writes an equivalent point set with no device
    rec_h = str(tmp_path / "rec_host")
    run_main(
        decompress_datalist,
        ["decompress_datalist", "--datalist", str(rpcc_list), "--output_dir", rec_h,
         "--lidar", "VelodyneVLP16", "--cluster_num", "16", "--batch", "2",
         "--workers", "1", "--decode_backend", "host"],
        monkeypatch,
    )
    bins_h = glob.glob(rec_h + "/**/*.bin", recursive=True)
    assert len(bins_h) == 1
    a = np.fromfile(bins[0], np.float32).reshape(-1, 4)
    b = np.fromfile(bins_h[0], np.float32).reshape(-1, 4)
    assert a.shape == b.shape
    assert np.abs(a[:, :3] - b[:, :3]).max() < 1e-3


def test_datalist_eval_reports_chamfer(frame_bin, tmp_path, monkeypatch, capsys):
    """--output --eval prints per-frame depth error (mean+max) + chamfer +
    F1 + p2p/p2plane PSNR and the per-frame host stage timers (reference
    tools/compress_datalist.py:149-200 parity)."""
    from rpcc.cli import compress_datalist

    datalist = tmp_path / "list.txt"
    datalist.write_text(frame_bin + "\n")
    run_main(
        compress_datalist,
        ["compress_datalist", "--datalist", str(datalist),
         "--output_dir", str(tmp_path / "out"), "--lidar", "VelodyneVLP16",
         "--cluster_num", "16", "--batch", "2", "--workers", "1",
         "--output", "--eval"],
        monkeypatch,
    )
    outp = capsys.readouterr().out
    assert "depth error mean" in outp and "max" in outp
    assert "chamfer" in outp and "F1" in outp and "OK" in outp
    assert "p2p_psnr" in outp and "p2plane_psnr" in outp
    assert "Time cost (per frame" in outp and "entropy+download" in outp


def test_csv_lidar_cli_roundtrip(tmp_path, monkeypatch):
    """Uneven-CSV vertical channels (32E) through the full CLI path:
    host projection (nearest-angle rows) -> encode -> decode."""
    from rpcc.cli import compress, decompress
    from tests.test_roundtrip import synth_scene

    pc = synth_scene(seed=11)
    frame = tmp_path / "f32e.bin"
    np.concatenate([pc, np.zeros((pc.shape[0], 1), np.float32)], -1).astype(
        np.float32
    ).tofile(frame)
    out = str(tmp_path / "f32e.rpcc")
    rec = str(tmp_path / "f32e_rec.bin")
    import rpcc.data as _d
    import os

    csv = os.path.join(
        os.path.dirname(_d.__file__), "lidar_cfg",
        "example-Velodyne_HDL_32E_vertical_channel_distribution.csv",
    )
    run_main(
        compress,
        ["compress", "--input", str(frame), "--output", out,
         "--lidar", "Velodyne32E", "--channel_distribute_csv", csv,
         "--cluster_num", "16", "--eval"],
        monkeypatch,
    )
    run_main(
        decompress,
        ["decompress", "--input", out, "--output", rec,
         "--lidar", "Velodyne32E", "--channel_distribute_csv", csv,
         "--cluster_num", "16"],
        monkeypatch,
    )
    r = np.fromfile(rec, np.float32).reshape(-1, 4)
    assert r.shape[0] > 100 and np.isfinite(r).all()


def test_datalist_keep_going_with_bad_file(frame_bin, tmp_path, monkeypatch, capsys):
    from rpcc.cli import compress_datalist

    datalist = tmp_path / "list.txt"
    datalist.write_text(frame_bin + "\n" + str(tmp_path / "missing.bin") + "\n")
    out_dir = str(tmp_path / "out")
    run_main(
        compress_datalist,
        ["compress_datalist", "--datalist", str(datalist), "--output_dir", out_dir,
         "--lidar", "VelodyneVLP16", "--cluster_num", "16", "--batch", "2",
         "--workers", "1", "--keep_going"],
        monkeypatch,
    )
    outp = capsys.readouterr().out
    assert "ERROR loading" in outp
    assert "1 errors" in outp
    import glob

    # the good frame still compressed; the bad one must NOT produce an
    # output file — a dummy .rpcc at the real path would be skipped forever
    # by a --skip_existing resume (silent data loss)
    written = glob.glob(out_dir + "/**/*.rpcc", recursive=True)
    assert len(written) == 1
    assert "missing" not in written[0]


def test_output_path_for_extension_substring_in_dir(tmp_path):
    """Only the trailing extension is replaced (fixes the reference's
    tools/compress_datalist.py:136-141 replace-everywhere bug)."""
    from rpcc.cli.compress_datalist import output_path_for

    out = output_path_for("/data/bin/seq.bin/000001.bin", str(tmp_path), "rpcc")
    assert out == str(tmp_path / "data/bin/seq.bin/000001.rpcc")
    # extensionless input just gains the suffix
    out2 = output_path_for("/data/frames/000002", str(tmp_path), "rpcc")
    assert out2 == str(tmp_path / "data/frames/000002.rpcc")


def test_mirror_path_cannot_escape_output_dir(tmp_path):
    """'..' segments and doubled leading slashes in datalist entries must
    never let the mirrored output path escape --output_dir."""
    import os

    from rpcc.cli.compress_datalist import _mirror_path

    base = str(tmp_path / "out")
    for entry in (
        "//srv/data/frame.bin",        # os.path.join discards base if right side is absolute
        "../../../etc/passwd.bin",
        "/data/../../escape/frame.bin",
        "a/../../b/frame.bin",
    ):
        out = _mirror_path(entry, base, "rpcc")
        assert os.path.abspath(out).startswith(os.path.abspath(base) + os.sep), (
            entry, out
        )


def test_truncated_ply_pcd_headers_raise(tmp_path):
    """A truncated header (no end_header / DATA line) must raise, not spin
    forever at EOF — one bad file would otherwise hang a datalist run."""
    import pytest

    from rpcc.data.pointcloud_io import _read_pcd, _read_ply

    bad_ply = tmp_path / "bad.ply"
    bad_ply.write_bytes(b"ply\nformat binary_little_endian 1.0\nelement vertex 3\n")
    with pytest.raises(ValueError, match="truncated ply"):
        _read_ply(str(bad_ply))
    bad_pcd = tmp_path / "bad.pcd"
    bad_pcd.write_bytes(b"VERSION 0.7\nFIELDS x y z\nPOINTS 3\n")
    with pytest.raises(ValueError, match="truncated pcd"):
        _read_pcd(str(bad_pcd))
