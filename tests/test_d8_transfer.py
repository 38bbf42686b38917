"""i8 row-delta uplink (transfer_precision='i8') parity tests.

The d8 wire code must reconstruct the exact u16 snap grid in-graph, so an
'i8' engine's bitstreams are bit-identical to a 'u16' engine's on the same
clouds/seeds; and the native single-pass projection must emit byte-identical
wire data to the numpy fallback.
"""

import numpy as np

from rpcc.config import CodecConfig
from rpcc.ops.projection import (
    project_points_host_d8,
    project_points_host_u16,
)
from rpcc.parallel import BatchEngine

from tests.test_roundtrip import SMALL, synth_scene


def _d8_fallback(points, lidar, floor):
    """Run the documented numpy fallback path regardless of the native lib."""
    H, W = lidar.height, lidar.width
    hw = H * W
    q, d = project_points_host_u16(points, lidar, floor)
    qi = q.astype(np.int32).reshape(-1)
    diff = np.diff(qi, prepend=np.int32(0))
    col0 = (np.arange(hw) % W) == 0
    exc = col0 | (diff < -128) | (diff > 127)
    d8 = np.where(exc, 0, diff).astype(np.int8)
    pos = np.flatnonzero(exc)
    pd = np.diff(pos, prepend=np.int64(-1)).astype(np.uint16)
    val = qi[pos].astype(np.uint16)
    return d8.reshape(H, W), pd, val, np.float32(d)


def test_native_matches_fallback_bytes():
    pc = synth_scene(seed=3)
    floor = np.float32(CodecConfig().step / 16.0)
    d8_n, pd_n, val_n, delta_n = project_points_host_d8(pc, SMALL, floor)
    d8_f, pd_f, val_f, delta_f = _d8_fallback(pc, SMALL, floor)
    assert delta_n == delta_f
    assert np.array_equal(d8_n, d8_f)
    assert np.array_equal(pd_n, pd_f)
    assert np.array_equal(val_n, val_f)


def test_wire_code_reconstructs_exact_grid():
    pc = synth_scene(seed=5)
    floor = np.float32(CodecConfig().step / 16.0)
    q, delta_u = project_points_host_u16(pc, SMALL, floor)
    d8, pd, val, delta = project_points_host_d8(pc, SMALL, floor)
    assert delta == delta_u
    # host-side inverse of the wire code (mirror of the in-graph math)
    hw = q.size
    C = np.cumsum(d8.reshape(-1).astype(np.int64))
    pos = np.cumsum(pd.astype(np.int64)) - 1
    K = val.astype(np.int64) - C[pos]
    fill = np.zeros(hw, np.int64)
    fill[pos] += np.diff(K, prepend=np.int64(0))
    rec = C + np.cumsum(fill)
    assert np.array_equal(rec, q.reshape(-1).astype(np.int64))


def test_i8_engine_bitstream_identical_to_u16():
    clouds = [synth_scene(seed=s) for s in range(4)]
    cfg16 = CodecConfig(cluster_num=16, transfer_precision="u16")
    cfg8 = CodecConfig(cluster_num=16, transfer_precision="i8")
    e16 = BatchEngine(SMALL, cfg16, batch_size=4, workers=2)
    e8 = BatchEngine(SMALL, cfg8, batch_size=4, workers=2)
    res16 = e16.encode_frames(clouds, seeds=range(4))
    res8 = e8.encode_frames(clouds, seeds=range(4))
    for (b16, _), (b8, _) in zip(res16, res8):
        assert b16 == b8
    # decode roundtrip through the i8 engine's own decoder
    decoded = e8.decode_blobs([b for b, _ in res8])
    out, _ = e16.encode_batch_device(clouds, seeds=range(4))
    ri = np.asarray(out.range_image)
    delta_dec = cfg8.step / 16.0
    for i in range(4):
        rec_ri = np.linalg.norm(decoded[i], axis=-1)
        assert np.abs(rec_ri - ri[i]).max() <= cfg8.step + delta_dec / 2 + 1e-5


def test_i8_engine_device_entropy_combo():
    clouds = [synth_scene(seed=s) for s in range(2)]
    cfg = CodecConfig(cluster_num=16, transfer_precision="i8", device_entropy=True)
    eng = BatchEngine(SMALL, cfg, batch_size=2, workers=2)
    res = eng.encode_frames(clouds, seeds=range(2))
    assert all(len(b) > 0 for b, _ in res)
    dec = eng.decode_blobs([b for b, _ in res])
    assert len(dec) == 2 and all(np.isfinite(d).all() for d in dec)


def test_d8_downlink_matches_u16_downlink_exactly():
    """The default i8 row-delta decode downlink must materialize the exact
    bytes of the raw u16 downlink (models/decoder.py d8_down +
    host_decoder.d8_reconstruct_batch)."""
    clouds = [synth_scene(seed=s) for s in range(4)]
    cfg = CodecConfig(cluster_num=16, transfer_precision="u16")
    # m8_down is the engine default since round 3; request d8 explicitly
    e_d8 = BatchEngine(SMALL, cfg, batch_size=4, workers=2, d8_down=True)
    e_u16 = BatchEngine(SMALL, cfg, batch_size=4, workers=2, d8_down=False)
    assert e_d8._d8_down and not e_u16._d8_down
    blobs = [b for b, _ in e_u16.encode_frames(clouds, seeds=range(4))]
    ris_d8, _ = e_d8._materialize_ris(*e_d8.decode_blobs_device(blobs))
    ris_u16, _ = e_u16._materialize_ris(*e_u16.decode_blobs_device(blobs))
    assert np.array_equal(ris_d8, ris_u16)


def test_d8_downlink_overflow_falls_back_lossless():
    """Frames whose exception count exceeds the fixed CAP must come back
    through the u16 fallback byte-identical, not corrupted."""
    clouds = [synth_scene(seed=s) for s in range(2)]
    cfg = CodecConfig(cluster_num=16, transfer_precision="u16")
    e_tiny = BatchEngine(
        SMALL, cfg, batch_size=2, workers=2, d8_down=True, d8_cap=8
    )
    e_u16 = BatchEngine(SMALL, cfg, batch_size=2, workers=2, d8_down=False)
    blobs = [b for b, _ in e_u16.encode_frames(clouds, seeds=range(2))]
    dec, live = e_tiny.decode_blobs_device(blobs)
    assert (np.asarray(dec.n_exc)[:live] > 8).any()  # overflow really hit
    ris, _ = e_tiny._materialize_ris(dec, live)
    ris_u16, _ = e_u16._materialize_ris(*e_u16.decode_blobs_device(blobs))
    assert np.array_equal(ris, ris_u16)


def test_d8_reconstruct_native_and_numpy_paths(monkeypatch):
    """d8_reconstruct_batch (native single pass and numpy fallback) inverts
    the wire code to the exact q * delta floats."""
    from rpcc.models.host_decoder import d8_reconstruct_batch

    rng = np.random.default_rng(11)
    B, H, W = 3, 8, 64
    hw = H * W
    # smooth-ish grid with injected big jumps (forced exceptions)
    q = np.cumsum(rng.integers(-50, 51, size=(B, hw)), axis=1)
    q = (q - q.min(axis=1, keepdims=True)).astype(np.int64)
    jumps = rng.integers(0, hw, size=(B, 7))
    for i in range(B):
        q[i, jumps[i]] += rng.integers(300, 5000, size=7)
    q = np.minimum(q, 65535).astype(np.uint16)
    delta = rng.uniform(0.001, 0.01, size=B).astype(np.float32)
    cap = hw
    d8 = np.zeros((B, H, W), np.int8)
    pd = np.zeros((B, cap), np.uint16)
    val = np.zeros((B, cap), np.uint16)
    n_exc = np.zeros(B, np.int32)
    col0 = (np.arange(hw) % W) == 0
    for i in range(B):
        qi = q[i].astype(np.int32)
        diff = np.diff(qi, prepend=np.int32(0))
        exc = col0 | (diff < -128) | (diff > 127)
        d8[i] = np.where(exc, 0, diff).astype(np.int8).reshape(H, W)
        pos = np.flatnonzero(exc)
        pd[i, : pos.size] = np.diff(pos, prepend=np.int64(-1)).astype(np.uint16)
        val[i, : pos.size] = q[i][pos]
        n_exc[i] = pos.size
    expected = q.astype(np.float32).reshape(B, H, W) * delta[:, None, None]
    out = d8_reconstruct_batch(d8, pd, val, n_exc, delta)
    assert np.array_equal(out, expected)
    # force the numpy fallback branch and require identical bytes
    import rpcc.codec.lz4block as lz4block

    monkeypatch.setattr(lz4block, "native_lib", lambda: None)
    out_np = d8_reconstruct_batch(d8, pd, val, n_exc, delta)
    assert np.array_equal(out_np, expected)


def test_decode_downlink_clamps_negative_reconstruction():
    """A live pixel with a slightly NEGATIVE reconstructed depth (true depth
    < step/2 plus quantization error) must clamp to q=0 on the u16 decode
    downlink — an unclamped f32->u16 convert of a negative wrapped to a
    near-max-range spike point after host rescaling."""
    from rpcc.models.decoder import make_batch_decoder
    from rpcc.models.encoder import num_model_rows

    cfg = CodecConfig(cluster_num=16, transfer_precision="u16")
    hw = SMALL.height * SMALL.width
    dec_fn = make_batch_decoder(SMALL, cfg)  # raw u16 downlink
    # one run of cluster id 2 over the whole grid, point model d = 0.01,
    # every stream value -1 -> ri = 0.01 - step < 0 everywhere
    contour = np.zeros((1, hw // 8), np.uint8)
    contour[0, 0] = 0x80
    seq = np.zeros((1, 4), np.uint16)
    seq[0, 0] = 2
    stream = np.full((1, hw), -1, np.int16)
    nm = num_model_rows(cfg)
    models = np.zeros((1, nm, 4), np.float32)
    models[0, 2, 3] = 0.01
    out = dec_fn(contour, seq, stream, models, np.float32(cfg.step))
    assert float(np.asarray(out.range_image[0]).max()) < 0  # genuinely negative
    riq = np.asarray(out.range_u16[0])
    assert riq.max() == 0 and riq.min() == 0  # clamped, not wrapped to ~65535


def test_single_frame_codec_matches_engine_content_u16():
    """The single-frame RPCCCodec must quantize the same u16-snapped grid
    as the BatchEngine for reduced transfer configs — previously it
    silently ignored transfer_precision and emitted different bitstream
    content for the identical config + cloud + seed."""
    from rpcc.models.pipeline import RPCCCodec

    # device_entropy=False: the comparison needs the engine's host-visible
    # residual/contour fields (the device-entropy path never downloads them)
    cfg = CodecConfig(cluster_num=16, transfer_precision="u16", device_entropy=False)
    engine = BatchEngine(SMALL, cfg, batch_size=1, workers=2)
    pc = synth_scene(seed=3)
    fields_e = engine.encode_frames([pc], seeds=[0])[0][1]
    codec = RPCCCodec(SMALL, cfg)
    _, fields_c, _ = codec.compress(pc, seed=0)
    assert np.array_equal(
        fields_e["residual_quantized"], fields_c["residual_quantized"]
    )
    assert np.array_equal(fields_e["contour_map"], fields_c["contour_map"])
    assert np.array_equal(
        np.asarray(fields_e["plane_param"], np.float32).reshape(-1, 4),
        np.asarray(fields_c["plane_param"], np.float32).reshape(-1, 4),
    )
