"""Golden determinism tests on the seeded 64E frame (CPU backend).

Locks the encoder's observable behavior: bitstream byte-determinism across
runs, the bpp operating point staying in the expected band, and decode being
an exact inverse.  (Absolute bpp can move when the algorithm legitimately
changes — the band is wide; the determinism checks are strict.)  The frame
is ``synthetic_frames(Velodyne64E, 1, seed=0)[0]``: a ray-cast urban scene on
the sensor's own 64 x 2000 grid, generated in-process.
"""

import hashlib

import numpy as np
import pytest

from rpcc.config import CodecConfig, LidarConfig
from rpcc.data import __lidar_cfg__
from rpcc.models.pipeline import RPCCCodec


@pytest.fixture(scope="module")
def codec_and_frame():
    from rpcc.data.synthetic import synthetic_frames

    lidar = LidarConfig.from_yaml(__lidar_cfg__["Velodyne64E"], name="Velodyne64E")
    # The f32 goldens pin their exact config: the shipped default is the
    # flagship (m8 transfer), which snaps depths to the u16 grid before
    # quantizing — a different (pinned separately below), equally
    # deterministic bitstream.
    cfg = CodecConfig(transfer_precision="f32", device_entropy=False)
    return RPCCCodec(lidar, cfg), synthetic_frames(lidar, 1, seed=0)[0]


# Pinned operating points (uniform/point/FPS, acc 0.02, seed 0) on the
# seeded 64E frame, CPU backend: the default config (rans) and the
# reference-parity entropy coder (bzip2).  BPP pins are ±5% regression
# tripwires; SHAs pin the exact bitstreams.  When the algorithm legitimately
# changes, update with a one-line justification:
#  - The pins were taken on a KITTI example frame until that frame left the
#    repo's inputs; they moved to the seeded frame with no codec change
#    (rans 1.5250 bpp, bzip2 1.3325, flagship 1.5286).
GOLDEN_BPP = 1.5250
GOLDEN_SHA = "f0007961808d73cf45e12d4b8ce86cc89b5dabfa7c3a62a8d63c856c8584ea26"
GOLDEN_BZIP2_BPP = 1.3325
GOLDEN_BZIP2_SHA = "0a86d7903dd264b37b1e83b6ee304a643081b25769bf06fc816c44d6d1eb2c95"
# The DEFAULT config is the flagship (transfer_precision='m8',
# device_entropy=True).  Its bitstream is the u16-snap-grid operating point
# (bit-identical across u16/i8/m8 and across the single-frame/engine/mesh
# paths — test_m8_transfer.py, test_engine.py), pinned on the same frame.
GOLDEN_FLAGSHIP_BPP = 1.5286
GOLDEN_FLAGSHIP_SHA = "2e4aa367e5ad4f51ab4d92a9a8d9928994167b89e070c9d4c6a0554ce3e3d38f"


def test_seeded_frame_operating_point(codec_and_frame):
    codec, pc = codec_and_frame
    blob, fields, _ = codec.compress(pc)
    ri = np.asarray(codec.encode_device(pc).range_image)
    n_pts = int((ri > 0).sum())
    bpp = len(blob) * 8 / n_pts
    assert abs(bpp - GOLDEN_BPP) / GOLDEN_BPP < 0.05, (
        f"bpp {bpp:.4f} drifted >5% from pinned {GOLDEN_BPP}"
    )
    assert hashlib.sha256(blob).hexdigest() == GOLDEN_SHA, (
        "bitstream bytes changed — if intentional, re-pin GOLDEN_SHA/GOLDEN_BPP "
        "with a justification line"
    )

    pc_rec, ri_rec, _ = codec.decompress(blob)
    err = np.abs(ri_rec - ri)
    assert err.max() <= codec.cfg.step + 1e-5
    assert (ri_rec[ri == 0] == 0).all()


def test_seeded_frame_bzip2_operating_point(codec_and_frame):
    _, pc = codec_and_frame
    from rpcc.data import __lidar_cfg__ as _cfgs

    lidar = LidarConfig.from_yaml(_cfgs["Velodyne64E"], name="Velodyne64E")
    codec = RPCCCodec(
        lidar,
        CodecConfig(
            basic_compressor="bzip2", transfer_precision="f32", device_entropy=False
        ),
    )
    blob, _, _ = codec.compress(pc)
    ri = np.asarray(codec.encode_device(pc).range_image)
    bpp = len(blob) * 8 / int((ri > 0).sum())
    assert abs(bpp - GOLDEN_BZIP2_BPP) / GOLDEN_BZIP2_BPP < 0.05
    assert hashlib.sha256(blob).hexdigest() == GOLDEN_BZIP2_SHA


def test_seeded_frame_flagship_default_operating_point(codec_and_frame):
    """The bare CodecConfig() — what a user gets — is the flagship
    (m8 transfer + device entropy) and its bitstream is pinned."""
    _, pc = codec_and_frame
    cfg = CodecConfig()
    assert cfg.transfer_precision == "m8" and cfg.device_entropy, (
        "shipped defaults must be the flagship config"
    )
    lidar = LidarConfig.from_yaml(__lidar_cfg__["Velodyne64E"], name="Velodyne64E")
    codec = RPCCCodec(lidar, cfg)
    blob, _, _ = codec.compress(pc)
    ri = np.asarray(codec.encode_device(pc).range_image)
    n_pts = int((ri > 0).sum())
    bpp = len(blob) * 8 / n_pts
    assert abs(bpp - GOLDEN_FLAGSHIP_BPP) / GOLDEN_FLAGSHIP_BPP < 0.05
    assert hashlib.sha256(blob).hexdigest() == GOLDEN_FLAGSHIP_SHA

    pc_rec, ri_rec, _ = codec.decompress(blob)
    err = np.abs(ri_rec - ri)
    # reduced-transfer bound: quantization step + half the u16 snap grid
    assert err.max() <= codec.cfg.step + codec.cfg.step / 16.0 / 2.0 + 1e-5
    assert (ri_rec[ri == 0] == 0).all()


def test_seeded_frame_bitstream_deterministic(codec_and_frame):
    codec, pc = codec_and_frame
    h = []
    for _ in range(2):
        blob, _, _ = codec.compress(pc)
        h.append(hashlib.sha256(blob).hexdigest())
    assert h[0] == h[1]


def test_seed_changes_bitstream(codec_and_frame):
    codec, pc = codec_and_frame
    out0 = codec.encode_device(pc, seed=0)
    out1 = codec.encode_device(pc, seed=1)
    assert int(out0.stream_len) > 0 and int(out1.stream_len) > 0
    # The seed must actually thread into the RANSAC/FPS PRNG: different
    # seeds on the same frame must yield different quantized streams (a
    # seed that silently stops being wired in would make them identical).
    n0, n1 = int(out0.stream_len), int(out1.stream_len)
    s0 = np.asarray(out0.stream)[:n0]
    s1 = np.asarray(out1.stream)[:n1]
    assert n0 != n1 or not np.array_equal(s0, s1)
