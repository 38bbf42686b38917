"""Property fuzzing: the codec contract must hold for arbitrary clouds.

For random scenes (including adversarial shapes: empty clouds, single
points, all-ground, dense collisions), every mode must (a) roundtrip within
the accuracy bound, (b) decode zero pixels to exactly zero, and (c) produce
byte-identical streams across repeated runs.
"""

import numpy as np
import pytest

from rpcc.config import CodecConfig, LidarConfig
from rpcc.models.pipeline import RPCCCodec

LIDAR = LidarConfig(
    name="fuzz16",
    horizontal_fov_deg=360.0,
    vertical_angle_max_deg=12.0,
    vertical_angle_min_deg=-28.0,
    height=16,
    width=256,
)


def random_cloud(rng, n):
    depth = rng.uniform(1.5, 70.0, n)
    az = rng.uniform(0, 2 * np.pi, n)
    el = rng.uniform(LIDAR.vertical_min, LIDAR.vertical_max, n)
    pc = np.stack(
        [depth * np.cos(el) * np.cos(az), depth * np.cos(el) * np.sin(az),
         depth * np.sin(el)], -1).astype(np.float32)
    # sometimes add a ground sheet
    if rng.random() < 0.7:
        m = n // 2
        az2 = rng.uniform(0, 2 * np.pi, m)
        r2 = rng.uniform(3, 40, m)
        ground = np.stack(
            [r2 * np.cos(az2), r2 * np.sin(az2),
             np.full(m, rng.uniform(-2.2, -1.6))], -1).astype(np.float32)
        pc = np.concatenate([pc, ground])
    return pc


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_roundtrip_uniform(seed):
    rng = np.random.default_rng(seed)
    cfg = CodecConfig(cluster_num=12, accuracy=float(rng.choice([0.01, 0.02, 0.05])))
    codec = RPCCCodec(LIDAR, cfg)
    pc = random_cloud(rng, int(rng.integers(500, 8000)))
    blob1, _, _ = codec.compress(pc)
    blob2, _, _ = codec.compress(pc)
    assert blob1 == blob2, "bitstream must be deterministic"
    pc_rec, ri_rec, _ = codec.decompress(blob1)
    ri = np.asarray(codec.encode_device(pc).range_image)
    assert np.abs(ri_rec - ri).max() <= cfg.step + 1e-5
    assert (ri_rec[ri == 0] == 0).all()


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_roundtrip_modes(seed):
    rng = np.random.default_rng(100 + seed)
    pc = random_cloud(rng, 5000)
    for cfg in [
        CodecConfig(cluster_num=12, modeling_method="plane", basic_compressor="rans"),
        CodecConfig(cluster_num=12, compress_framework="non-uniform"),
        CodecConfig(cluster_num=12, segment_method="DBSCAN"),
    ]:
        codec = RPCCCodec(LIDAR, cfg)
        blob, _, _ = codec.compress(pc)
        pc_rec, ri_rec, _ = codec.decompress(blob)
        ri = np.asarray(codec.encode_device(pc).range_image)
        bound = cfg.step + (0.0 if cfg.uniform else max(cfg.level_delta_acc))
        assert np.abs(ri_rec - ri).max() <= bound + 1e-5, cfg
        assert (ri_rec[ri == 0] == 0).all(), cfg


def test_degenerate_clouds():
    cfg = CodecConfig(cluster_num=8)
    codec = RPCCCodec(LIDAR, cfg)
    # single point
    pc1 = np.array([[10.0, 0.0, -1.0]], np.float32)
    blob, _, _ = codec.compress(pc1)
    pc_rec, ri_rec, _ = codec.decompress(blob)
    ri = np.asarray(codec.encode_device(pc1).range_image)
    assert np.abs(ri_rec - ri).max() <= cfg.step + 1e-5
    # everything in one pixel (massive collisions)
    pc2 = np.tile(np.array([[5.0, 1.0, -1.0]], np.float32), (3000, 1))
    pc2 += np.random.default_rng(0).normal(0, 1e-4, pc2.shape).astype(np.float32)
    blob, _, _ = codec.compress(pc2)
    pc_rec, ri_rec, _ = codec.decompress(blob)
    ri = np.asarray(codec.encode_device(pc2).range_image)
    assert np.abs(ri_rec - ri).max() <= cfg.step + 1e-5
    # flat wall (plane mode exercises plane fits on a perfect plane)
    rng = np.random.default_rng(1)
    y = rng.uniform(-10, 10, 4000)
    z = rng.uniform(-2, 2, 4000)
    wall = np.stack([np.full(4000, 15.0), y, z], -1).astype(np.float32)
    codec_p = RPCCCodec(LIDAR, CodecConfig(cluster_num=8, modeling_method="plane"))
    blob, _, _ = codec_p.compress(wall)
    pc_rec, ri_rec, _ = codec_p.decompress(blob)
    ri = np.asarray(codec_p.encode_device(wall).range_image)
    assert np.abs(ri_rec - ri).max() <= codec_p.cfg.step + 1e-5


def test_host_decoder_survives_mutated_bitstreams():
    """Adversarial .rpcc robustness: bit flips, byte stomps, truncations,
    splices and pure garbage must either decode or raise a clean Python
    exception — never crash the native layer (wire-derived lengths drive
    raw C walks; the guards this pins were added after confirmed heap-OOB
    PoCs)."""
    from rpcc.config import CodecConfig
    from rpcc.models.host_decoder import HostDecoder
    from rpcc.parallel import BatchEngine
    from tests.test_roundtrip import SMALL, synth_scene

    cfg = CodecConfig(cluster_num=16)
    engine = BatchEngine(SMALL, cfg, batch_size=1, workers=2)
    blob = engine.encode_frames([synth_scene(seed=5)], seeds=[0])[0][0]
    hd = HostDecoder(SMALL, cfg)
    rng = np.random.default_rng(7)
    decoded = raised = 0
    for trial in range(300):
        b = bytearray(blob)
        mode = trial % 5
        if mode == 0:
            i = int(rng.integers(0, len(b)))
            b[i] ^= 1 << int(rng.integers(0, 8))
        elif mode == 1:
            i = int(rng.integers(0, len(b)))
            b[i] = int(rng.integers(0, 256))
        elif mode == 2:
            b = b[: int(rng.integers(1, len(b)))]
        elif mode == 3:
            i = int(rng.integers(0, max(1, len(b) - 16)))
            b[i : i + 16] = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
        else:
            b = bytearray(
                rng.integers(0, 256, int(rng.integers(8, 4096)), dtype=np.uint8).tobytes()
            )
        try:
            ris = hd.decode_blobs([bytes(b)])
            assert ris[0].shape == (SMALL.height, SMALL.width)
            decoded += 1
        except Exception:
            raised += 1  # clean failure is fine; a segfault would kill pytest
    assert decoded + raised == 300


def test_engine_decoder_survives_mutated_bitstreams():
    """The DEVICE decode path (engine._prepare_decode -> decoder graph ->
    m8 downlink reconstruction) must also survive adversarial .rpcc input:
    the entropy/container layer raises cleanly, and anything that reaches
    the fixed-shape graph decodes to SOME finite range image (the graph
    itself cannot crash on data).  60 mutations across the same five
    classes as the host fuzz."""
    from rpcc.config import CodecConfig
    from rpcc.parallel import BatchEngine
    from tests.test_roundtrip import SMALL, synth_scene

    cfg = CodecConfig(cluster_num=16)
    engine = BatchEngine(SMALL, cfg, batch_size=1, workers=2)
    blob = engine.encode_frames([synth_scene(seed=5)], seeds=[0])[0][0]
    rng = np.random.default_rng(11)
    decoded = raised = 0
    for trial in range(60):
        b = bytearray(blob)
        mode = trial % 5
        if mode == 0:
            i = int(rng.integers(0, len(b)))
            b[i] ^= 1 << int(rng.integers(0, 8))
        elif mode == 1:
            i = int(rng.integers(0, len(b)))
            b[i] = int(rng.integers(0, 256))
        elif mode == 2:
            b = b[: int(rng.integers(1, len(b)))]
        elif mode == 3:
            i = int(rng.integers(0, max(1, len(b) - 16)))
            b[i : i + 16] = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
        else:
            b = bytearray(
                rng.integers(
                    0, 256, int(rng.integers(8, 4096)), dtype=np.uint8
                ).tobytes()
            )
        try:
            pcs = engine.decode_blobs([bytes(b)])
            assert pcs[0].shape == (SMALL.height, SMALL.width, 3)
            assert np.isfinite(pcs[0]).all()
            decoded += 1
        except Exception:
            raised += 1
    assert decoded + raised == 60
