"""Cross-implementation parity: our host path vs a numpy oracle of the
reference's composed pipeline (utils/compress_utils.py:138-229 + the C++
quantize/predict/contour semantics).  See tests/reference_oracle.py.

Guarantees:
 (a) given one fixed segmentation + model table + residual stream, our
     production host path and the oracle produce byte-identical .rpcc
     payloads (contour code, packbits, field dtypes, framing);
 (b) our decoder decodes an oracle-written stream — including the full
     102-row model table the reference encoder writes (pitfall §5.4);
 (c) the oracle decodes our stream (framing, fields, contour, dequantize,
     predict) to the same reconstruction;
 (d) the device quantizer agrees with the C++ bucket-loop oracle everywhere
     except values within float-ulp distance of a .5 rounding boundary
     (XLA may fuse a*b+c into FMA; numpy never does — bitwise-identical f32
     prediction across compilers is not a real invariant, rounding-grid
     agreement is).
"""

import numpy as np
import pytest

from rpcc.codec.bitstream import pack_bitstream
from rpcc.config import CodecConfig, LidarConfig
from rpcc.data import __lidar_cfg__
from rpcc.models.pipeline import RPCCCodec
from tests import reference_oracle as oracle
from tests.reference_oracle import assert_streams_agree
from tests.test_roundtrip import SMALL, synth_scene


@pytest.fixture(scope="module")
def enc_state():
    cfg = CodecConfig(cluster_num=16, basic_compressor="bzip2")
    codec = RPCCCodec(SMALL, cfg)
    pc = synth_scene(seed=3)
    out = codec.encode_device(pc)
    return codec, out


def _oracle_streams(codec, out):
    """Oracle-side residual stream bookkeeping from device seg/model only."""
    seg = np.asarray(out.seg_idx)
    ri = np.asarray(out.range_image)
    mp = np.asarray(out.model_param)
    pred = oracle.intra_predict(seg, mp, codec.transform_map)
    residual = (ri - pred).astype(np.float32)
    res_stream = np.concatenate(
        [residual[seg == m] for m in range(int(seg.max()) + 1) if m != 1]
    )
    return seg, ri, mp, residual, res_stream


def test_oracle_contour_self_inverse():
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 7, (16, 64))
    contour, seq = oracle.extract_contour(idx)
    rec = oracle.recover_map(contour, seq)
    assert np.array_equal(rec, idx)


def test_device_quantizer_matches_cpp_bucket_loop(enc_state):
    codec, out = enc_state
    seg, ri, mp, residual, res_stream = _oracle_streams(codec, out)
    q_oracle = oracle.uniform_quantize(seg, residual, codec.cfg.step)
    q_ours = codec.fields_from_device(out)["residual_quantized"]
    step_stream = np.full(res_stream.shape, np.float32(codec.cfg.step))
    assert_streams_agree(q_ours, q_oracle, res_stream, step_stream)


def test_host_path_byte_identical_to_oracle(enc_state):
    codec, out = enc_state
    seg = np.asarray(out.seg_idx)
    mp = np.asarray(out.model_param)
    fields = codec.fields_from_device(out)
    # same stream on both sides — this pins contour code, packbits, dtypes,
    # per-field entropy coding and framing against the reference functions.
    stream = fields["residual_quantized"].astype(np.int32)
    _, compressed = oracle.compress_point_cloud(
        codec.cfg.basic_compressor, mp, seg, None, stream
    )
    oracle_blob = oracle.pack_bitstream(compressed, uniform=True)
    ours = pack_bitstream(codec.entropy.compress_dict(fields), uniform=True)
    assert ours == oracle_blob


def test_our_decoder_reads_oracle_stream(enc_state):
    codec, out = enc_state
    seg = np.asarray(out.seg_idx)
    mp = np.asarray(out.model_param)
    seg_ids = range(int(seg.max()) + 1)
    _, _, _, residual, _ = _oracle_streams(codec, out)
    stream = oracle.uniform_quantize(seg, residual, codec.cfg.step)
    _, compressed = oracle.compress_point_cloud(
        codec.cfg.basic_compressor, mp, seg, None, stream
    )
    oracle_blob = oracle.pack_bitstream(compressed, uniform=True)

    pc_rec, ri_rec, _ = codec.decompress(oracle_blob)
    ri = np.asarray(out.range_image)
    assert np.abs(ri_rec - ri).max() <= codec.cfg.step + 1e-5
    assert (ri_rec[seg == 1] == 0).all()


def test_oracle_decodes_our_stream(enc_state):
    codec, out = enc_state
    fields = codec.fields_from_device(out)
    blob = pack_bitstream(codec.entropy.compress_dict(fields), uniform=True)

    compressed = oracle.unpack_bitstream(blob, uniform=True)
    # the reference decoder believes model_num = cluster_num + 1 (pitfall 4);
    # our encoder wrote cluster_num + 2 rows — the oracle reads both.
    believed = codec.cfg.cluster_num + 1
    q, idx_map, sal, view, full = oracle.decompress_point_cloud(
        compressed, codec.cfg.basic_compressor, believed, codec.H, codec.W
    )
    assert sal is None
    assert view.shape[0] == believed and full.shape[0] == codec.num_models
    assert np.array_equal(idx_map, np.asarray(out.seg_idx))

    resid = oracle.dequantize_residual(q, idx_map, codec.cfg.step)
    pred = oracle.intra_predict(idx_map, full, codec.transform_map)
    ri_oracle = np.where(idx_map == 1, 0.0, pred + resid).astype(np.float32)
    _, ri_ours, _ = codec.decompress(blob)
    # prediction differs only by compiler FMA/ulp noise; dequantized grid
    # values are exact multiples of step on both sides.
    assert np.abs(ri_oracle - ri_ours).max() < 1e-4
    assert (ri_ours[idx_map == 1] == 0).all()


def test_nonuniform_parity_with_oracle():
    cfg = CodecConfig(cluster_num=16, compress_framework="non-uniform", basic_compressor="bzip2")
    codec = RPCCCodec(SMALL, cfg)
    pc = synth_scene(seed=5)
    out = codec.encode_device(pc)

    seg, ri, mp, residual, res_stream = _oracle_streams(codec, out)
    kp = np.asarray(out.key_point_map)
    level_acc = np.asarray(cfg.level_acc, np.float32)
    q_oracle, salience = oracle.nonuniform_quantize(
        seg, residual, kp, cfg.level_key_point_num, level_acc, cfg.ground_salience_level
    )
    fields = codec.fields_from_device(out)
    assert np.array_equal(fields["salience_level"], salience.astype(np.uint8))
    step_stream = np.concatenate(
        [
            np.full(int((seg == m).sum()), level_acc[salience[m]], np.float32)
            for m in range(int(seg.max()) + 1)
            if m != 1
        ]
    )
    assert_streams_agree(fields["residual_quantized"], q_oracle, res_stream, step_stream)

    # byte-identity of the non-uniform host path (salience-first framing)
    stream = fields["residual_quantized"].astype(np.int32)
    _, compressed = oracle.compress_point_cloud("bzip2", mp, seg, salience, stream)
    oracle_blob = oracle.pack_bitstream(compressed, uniform=False)
    ours = pack_bitstream(codec.entropy.compress_dict(fields), uniform=False)
    assert ours == oracle_blob


def test_full_frame_byte_parity_with_oracle():
    """The seeded full-size 64x2000 frame through both host paths."""
    from rpcc.data.synthetic import synthetic_frames

    lidar = LidarConfig.from_yaml(__lidar_cfg__["Velodyne64E"], name="Velodyne64E")
    codec = RPCCCodec(lidar, CodecConfig(basic_compressor="bzip2"))
    out = codec.encode_device(synthetic_frames(lidar, 1, seed=0)[0])
    seg, ri, mp, residual, res_stream = _oracle_streams(codec, out)
    q_oracle = oracle.uniform_quantize(seg, residual, codec.cfg.step)
    fields = codec.fields_from_device(out)
    step_stream = np.full(res_stream.shape, np.float32(codec.cfg.step))
    assert_streams_agree(fields["residual_quantized"], q_oracle, res_stream, step_stream)

    stream = fields["residual_quantized"].astype(np.int32)
    _, compressed = oracle.compress_point_cloud("bzip2", mp, seg, None, stream)
    oracle_blob = oracle.pack_bitstream(compressed, uniform=True)
    ours = pack_bitstream(codec.entropy.compress_dict(fields), uniform=True)
    assert ours == oracle_blob
