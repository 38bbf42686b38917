"""End-to-end encode -> bitstream -> decode roundtrip guarantees.

The codec's contract (tools/compress.py:176-181): max reconstruction depth
error <= quantization step (= 2 * configured accuracy) in uniform mode, and
<= step + max(level_delta_acc) in non-uniform mode; zero pixels decode to the
origin and are dropped on save.
"""

import numpy as np
import pytest

from rpcc.config import CodecConfig, LidarConfig
from rpcc.models.pipeline import RPCCCodec

SMALL = LidarConfig(
    name="small64",
    horizontal_fov_deg=360.0,
    vertical_angle_max_deg=2.0,
    vertical_angle_min_deg=-24.9,
    height=16,
    width=256,
)


def synth_scene(n=4000, seed=0):
    """Ground plane + a few clusters, in the lidar's FOV."""
    rng = np.random.default_rng(seed)
    # ground points on z = -1.8 plane
    ng = n // 2
    az = rng.uniform(0, 2 * np.pi, ng)
    r = rng.uniform(4, 40, ng)
    ground = np.stack([r * np.cos(az), r * np.sin(az), np.full(ng, -1.8)], -1)
    # clusters: blobs above ground
    rest = []
    for i in range((n - ng) // 200):
        c_az = rng.uniform(0, 2 * np.pi)
        c_r = rng.uniform(6, 30)
        center = np.array([c_r * np.cos(c_az), c_r * np.sin(c_az), rng.uniform(-1.0, 1.0)])
        rest.append(center + rng.normal(0, 0.8, (200, 3)))
    pc = np.concatenate([ground] + rest).astype(np.float32)
    # keep inside the vertical FOV
    el = np.arctan2(pc[:, 2], np.linalg.norm(pc[:, :2], axis=-1))
    ok = (el > SMALL.vertical_min) & (el < SMALL.vertical_max)
    return pc[ok]


CFG_CASES = [
    CodecConfig(cluster_num=16, basic_compressor="bzip2"),
    CodecConfig(cluster_num=16, basic_compressor="deflate", accuracy=0.05),
    CodecConfig(cluster_num=16, basic_compressor="lz4"),
    CodecConfig(cluster_num=16, basic_compressor="rans"),
    CodecConfig(cluster_num=16, modeling_method="plane"),
    CodecConfig(cluster_num=16, compress_framework="non-uniform"),
    CodecConfig(cluster_num=16, compress_framework="non-uniform", basic_compressor="rans"),
]


@pytest.mark.parametrize("cfg", CFG_CASES, ids=lambda c: f"{c.compress_framework}-{c.modeling_method}-{c.basic_compressor}-{c.accuracy}")
def test_roundtrip_error_bound(cfg):
    codec = RPCCCodec(SMALL, cfg)
    pc = synth_scene()
    blob, fields, _ = codec.compress(pc)
    pc_rec, ri_rec, _ = codec.decompress(blob)

    # reproject original for the ground-truth range image
    ri = codec.encode_device(pc)
    ri = np.asarray(ri.range_image)

    err = np.abs(ri_rec - ri)
    if cfg.uniform:
        bound = cfg.step
    else:
        bound = cfg.step + max(cfg.level_delta_acc)
    assert err.max() <= bound + 1e-5, f"max depth error {err.max()} > {bound}"

    # zero pixels must decode exactly to depth 0
    assert (ri_rec[ri == 0] == 0).all()

    # bitstream is parseable and smaller than raw
    n_pts = (ri > 0).sum()
    bpp = len(blob) * 8 / n_pts
    assert bpp < 96  # raw is 96 bpp


def test_deterministic_encoding():
    cfg = CodecConfig(cluster_num=16)
    codec = RPCCCodec(SMALL, cfg)
    pc = synth_scene(seed=3)
    blob1, _, _ = codec.compress(pc)
    blob2, _, _ = codec.compress(pc)
    assert blob1 == blob2


def test_stream_matches_reference_ordering():
    """Decoded dequantize must consume exactly stream_len residuals
    (the reference asserts this, compress_utils.py:129-131)."""
    cfg = CodecConfig(cluster_num=16)
    codec = RPCCCodec(SMALL, cfg)
    pc = synth_scene(seed=4)
    out = codec.encode_device(pc)
    seg = np.asarray(out.seg_idx)
    stream_len = int(out.stream_len)
    assert stream_len == (seg != 1).sum()
    seq_len = int(out.seq_len)
    fields = codec.fields_from_device(out)
    assert fields["residual_quantized"].shape[0] == stream_len
    assert fields["idx_sequence"].shape[0] == seq_len
    assert fields["plane_param"].shape == (cfg.cluster_num + 2, 4)
