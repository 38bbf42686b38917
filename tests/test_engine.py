"""BatchEngine tests on the virtual 8-device CPU mesh."""

import numpy as np
import jax

from rpcc.config import CodecConfig
from rpcc.parallel import BatchEngine, data_mesh

from tests.test_roundtrip import SMALL, synth_scene


def test_engine_sharded_roundtrip_over_mesh():
    assert jax.device_count() == 8
    mesh = data_mesh(8)
    cfg = CodecConfig(cluster_num=16)
    engine = BatchEngine(SMALL, cfg, batch_size=8, mesh=mesh, workers=2)
    clouds = [synth_scene(seed=s) for s in range(8)]
    results = engine.encode_frames(clouds, seeds=range(8))
    assert len(results) == 8
    blobs = [b for b, _ in results]
    decoded = engine.decode_blobs(blobs)

    out, _ = engine.encode_batch_device(clouds, seeds=range(8))
    ri = np.asarray(out.range_image)
    for i in range(8):
        rec_ri = np.linalg.norm(decoded[i], axis=-1)
        assert np.abs(rec_ri - ri[i]).max() <= cfg.step + 1e-5

    # The flagship production config (u16 transfer + device entropy) must
    # also compile/run over the mesh and roundtrip.
    e16 = BatchEngine(
        SMALL,
        CodecConfig(cluster_num=16, transfer_precision="u16", device_entropy=True),
        batch_size=8, mesh=mesh, workers=2,
    )
    res16 = e16.encode_frames(clouds, seeds=range(8))
    assert len(res16) == 8 and all(len(b) > 0 for b, _ in res16)
    dec16 = e16.decode_blobs([b for b, _ in res16])
    assert len(dec16) == 8


def test_engine_mesh_blobs_byte_identical_to_single_device():
    """THE multi-chip correctness property a CPU run can prove (SURVEY §2.3):
    the same frames encoded on an 8-device mesh produce byte-identical
    .rpcc blobs to a 1-device (meshless) engine run, under the flagship
    default config (m8 transfer + device entropy) — and the native host
    decoder reconstructs both to the same floats."""
    mesh = data_mesh(8)
    cfg = CodecConfig(cluster_num=16)  # shipped flagship defaults
    assert cfg.transfer_precision == "m8" and cfg.device_entropy
    clouds = [synth_scene(seed=s) for s in range(8)]
    e_mesh = BatchEngine(SMALL, cfg, batch_size=8, mesh=mesh, workers=2)
    e_one = BatchEngine(SMALL, cfg, batch_size=8, workers=2)
    blobs_mesh = [b for b, _ in e_mesh.encode_frames(clouds, seeds=range(8))]
    blobs_one = [b for b, _ in e_one.encode_frames(clouds, seeds=range(8))]
    assert blobs_mesh == blobs_one, (
        "mesh-sharded encode must be byte-identical to the single-device run"
    )

    from rpcc.models.host_decoder import HostDecoder

    hd = HostDecoder(SMALL, cfg)
    ris_mesh = hd.decode_blobs(blobs_mesh)
    ris_one = hd.decode_blobs(blobs_one)
    np.testing.assert_array_equal(np.asarray(ris_mesh), np.asarray(ris_one))


def test_engine_sharded_stats_psum():
    """psum metric aggregation over the mesh matches the host-side sums
    and every batched encoder output is batch-sharded (not replicated)."""
    mesh = data_mesh(8)
    cfg = CodecConfig(cluster_num=16)
    engine = BatchEngine(SMALL, cfg, batch_size=8, mesh=mesh, workers=2)
    clouds = [synth_scene(seed=s) for s in range(8)]
    out, live = engine.encode_batch_device(clouds, seeds=range(8))
    for name in ("range_image", "stream", "contour_packed", "sequence",
                 "model_param", "stream_len"):
        arr = getattr(out, name)
        assert not arr.sharding.is_fully_replicated, name
        assert len(arr.sharding.device_set) == 8, name
    blobs = [b for b, _ in engine.finalize_encoded(out, live)]
    report = engine.sharded_stats(out, [len(b) for b in blobs])
    assert report["frames"] == 8
    assert report["points"] == int(np.asarray(out.stream_len).sum())
    assert report["bits"] == sum(len(b) * 8 for b in blobs)
    assert report["bpp"] > 0

    # partial batch: padding slots must not count as frames
    out5, live5 = engine.encode_batch_device(clouds[:5], seeds=range(5))
    blobs5 = [b for b, _ in engine.finalize_encoded(out5, live5)]
    report5 = engine.sharded_stats(out5, [len(b) for b in blobs5])
    assert report5["frames"] == 5


def test_engine_device_entropy_roundtrip_and_rate():
    """device_entropy=True: the residual/contour fields are rANS-coded on
    device; blobs must decode exactly like host-coded ones and the rate must
    match the host coder within a fraction of a percent (identical models,
    live-aware lanes)."""
    cfg_dev = CodecConfig(cluster_num=16, transfer_precision="f32", device_entropy=True)
    cfg_host = CodecConfig(cluster_num=16, transfer_precision="f32", device_entropy=False)
    e_dev = BatchEngine(SMALL, cfg_dev, batch_size=4, workers=2)
    e_host = BatchEngine(SMALL, cfg_host, batch_size=4, workers=2)
    clouds = [synth_scene(seed=s) for s in range(4)]

    res_dev = e_dev.encode_frames(clouds, seeds=range(4))
    res_host = e_host.encode_frames(clouds, seeds=range(4))
    for (bd, _), (bh, _) in zip(res_dev, res_host):
        assert abs(len(bd) - len(bh)) / len(bh) < 0.02, (len(bd), len(bh))

    # decode device-encoded blobs with the ordinary engine decoder
    decoded = e_host.decode_blobs([b for b, _ in res_dev])
    out, _ = e_host.encode_batch_device(clouds, seeds=range(4))
    ri = np.asarray(out.range_image)
    for i in range(4):
        rec_ri = np.linalg.norm(decoded[i], axis=-1)
        assert np.abs(rec_ri - ri[i]).max() <= cfg_host.step + 1e-5


def test_engine_device_entropy_nonuniform_roundtrip():
    """device_entropy under the non-uniform (salience) framework: blobs must
    decode within the per-level bound."""
    cfg = CodecConfig(cluster_num=16, device_entropy=True,
                      compress_framework="non-uniform")
    engine = BatchEngine(SMALL, cfg, batch_size=2, workers=2)
    clouds = [synth_scene(seed=s) for s in range(2)]
    results = engine.encode_frames(clouds, seeds=range(2))
    decoded = engine.decode_blobs([b for b, _ in results])
    out, _ = engine.encode_batch_device(clouds, seeds=range(2))
    ri = np.asarray(out.range_image)
    bound = cfg.step + max(cfg.level_delta_acc) + 1e-5
    for i in range(2):
        rec_ri = np.linalg.norm(decoded[i], axis=-1)
        assert np.abs(rec_ri - ri[i]).max() <= bound


def test_engine_config_combo_matrix():
    """Smoke the knob combinations the dedicated tests don't pair: plane and
    DBSCAN modes under device_entropy + u16 transfer."""
    import pytest

    combos = [
        dict(modeling_method="plane", device_entropy=True, transfer_precision="u16"),
        dict(segment_method="DBSCAN", device_entropy=True),
        dict(modeling_method="plane", transfer_precision="u16"),
    ]
    clouds = [synth_scene(seed=s) for s in range(2)]
    for kw in combos:
        cfg = CodecConfig(cluster_num=16, **kw)
        engine = BatchEngine(SMALL, cfg, batch_size=2, workers=2)
        results = engine.encode_frames(clouds, seeds=range(2))
        decoded = engine.decode_blobs([b for b, _ in results])
        out, _ = engine.encode_batch_device(clouds, seeds=range(2))
        ri = np.asarray(out.range_image)
        for i in range(2):
            rec_ri = np.linalg.norm(decoded[i], axis=-1)
            assert np.abs(rec_ri - ri[i]).max() <= cfg.step + 1e-5, kw


def test_engine_u16_transfer_mode_bounds_and_roundtrip():
    """transfer_precision='u16' halves upload bytes; reconstruction error
    must stay within accuracy + delta/2 of the TRUE (f32) range image, and
    the pipeline/decode paths must work unchanged."""
    cfg16 = CodecConfig(cluster_num=16, transfer_precision="u16")
    # f32 reference engine: ri_true below must be the TRUE (unsnapped) grid
    cfg32 = CodecConfig(cluster_num=16, transfer_precision="f32")
    e16 = BatchEngine(SMALL, cfg16, batch_size=4, workers=2)
    e32 = BatchEngine(SMALL, cfg32, batch_size=4, workers=2)
    clouds = [synth_scene(seed=s) for s in range(4)]

    out16, live = e16.encode_batch_device(clouds, seeds=range(4))
    pts, deltas, _ = e16._stack(clouds)
    assert pts.dtype == np.uint16 and deltas.shape == (4,)
    # never saturates; snap grid within spec
    assert (pts[:live] < 65536).all()
    floor = np.float32(cfg16.step / 16.0)
    assert (deltas[:live] >= floor - 1e-9).all()

    results = e16.encode_frames(clouds, seeds=range(4))
    decoded = e16.decode_blobs([b for b, _ in results])
    ri_true = np.asarray(e32.encode_batch_device(clouds, seeds=range(4))[0].range_image)
    for i in range(4):
        rec_ri = np.linalg.norm(decoded[i], axis=-1)
        # encode-side snap + decode-side snap each contribute <= delta/2
        bound = cfg16.accuracy + float(deltas[i]) + 1e-5
        both = ri_true[i] > 0
        assert np.abs(rec_ri[both] - ri_true[i][both]).max() <= bound


def test_engine_i8_transfer_exceptions_and_fallback():
    """The i8 transfer view of the residual stream must reconstruct the i16
    stream exactly — both through the exception list (few |q|>127) and the
    full-download fallback (exc_count > EXC_CAP on noise-like content)."""
    from rpcc.models.encoder import EXC_CAP

    # f32/host-entropy: this test pokes the i8 residual-stream DOWNLINK view
    # (stage_downloads' stream_dev), which the device-entropy path replaces
    # with in-graph rANS containers.
    cfg = CodecConfig(cluster_num=16, transfer_precision="f32", device_entropy=False)
    engine = BatchEngine(SMALL, cfg, batch_size=2, workers=2)
    rng = np.random.default_rng(7)

    # Noise cloud: residuals are huge everywhere -> thousands of exceptions.
    n = 4000
    noise = np.stack(
        [rng.uniform(-50, 50, n), rng.uniform(-50, 50, n), rng.uniform(-3, 30, n)],
        -1,
    ).astype(np.float32)
    clouds = [synth_scene(seed=1), noise]
    out, live = engine.encode_batch_device(clouds, seeds=[0, 1])
    exc_count = np.asarray(out.exc_count)
    assert exc_count[1] > EXC_CAP  # fallback actually exercised

    # Whatever the path, the framed bitstreams must equal an i16-only build.
    st = engine.stage_downloads(out, live)
    stream16 = np.asarray(out.stream)[:, : np.asarray(st.stream_dev).shape[1]]
    results = engine.finish_staged(st)
    for i, (blob, fields) in enumerate(results):
        np.testing.assert_array_equal(
            fields["residual_quantized"],
            stream16[i, : int(np.asarray(out.stream_len)[i])],
        )

    # Decode side: the noise frame overflows the i8 upload view too, forcing
    # the i16 decoder program — reconstruction must still meet the bound.
    decoded = engine.decode_blobs([blob for blob, _ in results])
    ri = np.asarray(out.range_image)
    for i, rec in enumerate(decoded):
        rec_ri = np.linalg.norm(rec, axis=-1)
        assert np.abs(rec_ri - ri[i]).max() <= cfg.step + 1e-5

    # Exception path (not fallback): verify reconstruction equality directly.
    out2, live2 = engine.encode_batch_device([synth_scene(seed=2)] * 2, seeds=[5, 6])
    exc2 = np.asarray(out2.exc_count)
    assert (exc2 <= EXC_CAP).all()
    st2 = engine.stage_downloads(out2, live2)
    rec = engine.finish_staged(st2)
    full16 = np.asarray(out2.stream)
    for i, (_, fields) in enumerate(rec):
        np.testing.assert_array_equal(
            fields["residual_quantized"],
            full16[i, : int(np.asarray(out2.stream_len)[i])],
        )


def test_ragged_geometry_m8_engine_falls_back_to_d8_downlink():
    """A geometry whose H*W is not a multiple of 8 cannot build the packed
    m8 downlink in-graph (pack_bits_msb packs whole bytes) — the engine
    must auto-select the d8 row-delta downlink and still roundtrip; forcing
    m8_down on an f32 engine must fail at construction."""
    from rpcc.config import LidarConfig

    ragged = LidarConfig(
        name="ragged", horizontal_fov_deg=360.0,
        vertical_angle_max_deg=2.0, vertical_angle_min_deg=-10.0,
        height=12, width=49,  # hw = 588, 588 % 8 == 4
    )
    assert (ragged.height * ragged.width) % 8 != 0
    cfg = CodecConfig(cluster_num=8)  # default m8 transfer
    engine = BatchEngine(ragged, cfg, batch_size=2, workers=2)
    assert engine._downlink == "d8"

    rng = np.random.default_rng(3)
    n = 1500
    depth = rng.uniform(2.0, 40.0, n)
    az = rng.uniform(0, 2 * np.pi, n)
    el = rng.uniform(ragged.vertical_min, ragged.vertical_max, n)
    pc = np.stack(
        [depth * np.cos(el) * np.cos(az), depth * np.cos(el) * np.sin(az),
         depth * np.sin(el)], -1,
    ).astype(np.float32)
    results = engine.encode_frames([pc, pc], seeds=[0, 1])
    decoded = engine.decode_blobs([b for b, _ in results])
    out, _ = engine.encode_batch_device([pc, pc], seeds=[0, 1])
    ri = np.asarray(out.range_image)
    bound = cfg.step + cfg.step / 16.0 / 2.0 + 1e-5
    for i in range(2):
        rec_ri = np.linalg.norm(decoded[i], axis=-1)
        assert np.abs(rec_ri - ri[i]).max() <= bound

    import pytest

    with pytest.raises(ValueError):
        BatchEngine(
            ragged, CodecConfig(cluster_num=8, transfer_precision="f32"),
            batch_size=2, workers=2, m8_down=True,
        )


def test_decode_uplink_u8_and_u16_fallback_agree():
    """The idx_sequence decode uplink rides as u8 when every id fits a byte
    (half the wire bytes); a blob carrying an id >= 256 (corrupt/mismatched
    config input) must keep the u16 view so the out-of-range rule
    (id >= M -> r = 0) stays identical across backends."""
    cfg = CodecConfig(cluster_num=16, basic_compressor="bzip2")
    engine = BatchEngine(SMALL, cfg, batch_size=2, workers=2)
    pcs = [synth_scene(seed=1), synth_scene(seed=2)]
    blobs = [b for b, _ in engine.encode_frames(pcs, seeds=[1, 2])]
    prep = engine._prepare_decode(blobs)
    assert prep[1][1].dtype == np.uint8  # args[1] = the sequence upload
    ris_u8, live = engine._materialize_ris(*engine._dispatch_decode(prep))
    out, _ = engine.encode_batch_device(pcs, seeds=[1, 2])
    ri_enc = np.asarray(out.range_image)
    bound = cfg.step + cfg.step / 16.0 / 2.0 + 1e-5
    for i in range(2):
        assert np.abs(ris_u8[i] - ri_enc[i]).max() <= bound

    # corrupt sequence: one run id >= 256 forces the exact u16 view
    from rpcc.codec.bitstream import pack_bitstream
    from rpcc.models.encoder import num_model_rows

    hw = SMALL.height * SMALL.width
    bits = np.zeros(hw, np.uint8)
    bits[[0, 8]] = 1
    nm = num_model_rows(cfg)
    fields = {
        "residual_quantized": np.zeros(4, np.int16),
        "contour_map": np.packbits(bits),
        "idx_sequence": np.asarray([300, 1], np.uint16),
        "plane_param": np.zeros((nm, 4), np.float32),
    }
    blob_c = pack_bitstream(engine.entropy.compress_dict(fields), uniform=True)
    prep_c = engine._prepare_decode([blob_c, blob_c])
    assert prep_c[1][1].dtype == np.uint16
    ris_c, _ = engine._materialize_ris(*engine._dispatch_decode(prep_c))
    # id 300 >= M and id 1 both decode to r = 0 — the whole frame is empty,
    # exactly like the host decoder's rule
    from rpcc.models.host_decoder import HostDecoder

    hd = HostDecoder(SMALL, cfg)
    ri_host = hd.reconstruct(
        fields["contour_map"], fields["idx_sequence"],
        fields["residual_quantized"], fields["plane_param"],
    )
    assert (ris_c[0] == 0).all()
    np.testing.assert_array_equal(ris_c[0], ri_host)


def test_engine_async_pipeline():
    cfg = CodecConfig(cluster_num=16)
    engine = BatchEngine(SMALL, cfg, batch_size=4, workers=2)
    clouds_a = [synth_scene(seed=s) for s in range(4)]
    clouds_b = [synth_scene(seed=s + 10) for s in range(4)]
    fut_a = engine.encode_batch_async(clouds_a, seeds=range(4))
    fut_b = engine.encode_batch_async(clouds_b, seeds=range(4, 8))
    res_a = engine.finalize_encoded(*fut_a.result())
    res_b = engine.finalize_encoded(*fut_b.result())
    assert len(res_a) == 4 and len(res_b) == 4
    # different frames -> different payloads
    assert res_a[0][0] != res_b[0][0]


def test_engine_encode_pipeline_matches_sync_and_roundtrips():
    """The 3-deep pipeline must yield per-batch results in input order and
    byte-identical to the synchronous path; decode_pipeline must roundtrip."""
    cfg = CodecConfig(cluster_num=16)
    engine = BatchEngine(SMALL, cfg, batch_size=4, workers=2)
    batches = [
        ([synth_scene(seed=3 * k + s) for s in range(4)], range(4 * k, 4 * k + 4))
        for k in range(5)  # > pipeline depth, exercises drain
    ]
    piped = list(engine.encode_pipeline(iter(batches)))
    assert len(piped) == 5
    sync = [engine.encode_frames(c, seeds=s) for c, s in batches]
    for pb, sb in zip(piped, sync):
        assert [b for b, _ in pb] == [b for b, _ in sb]

    blob_batches = [[b for b, _ in pb] for pb in piped]
    decoded = list(engine.decode_pipeline(iter(blob_batches)))
    assert len(decoded) == 5
    bound = cfg.step + 1e-5
    for (clouds, seeds), blobs, recs in zip(batches, blob_batches, decoded):
        # pipeline yields compacted (n, 4) xyz0 save rows — byte-identical
        # to the synchronous device points path ...
        direct = engine.decode_blobs_points(blobs)
        assert len(recs) == len(direct)
        for rec, ref in zip(recs, direct):
            assert rec.shape == ref.shape and rec.shape[1] == 4
            assert np.array_equal(rec, ref)
        # ... and exactly the nonzero rows of the full-cloud decode, whose
        # ranges roundtrip within the quantization error bound
        full = engine.decode_blobs(blobs)
        out, _ = engine.encode_batch_device(clouds, seeds=seeds)
        ri = np.asarray(out.range_image)
        for i, rec in enumerate(recs):
            pts = np.asarray(full[i]).reshape(-1, 3)
            keep = pts.sum(-1) != 0
            assert np.array_equal(rec[:, :3], pts[keep])
            assert np.all(rec[:, 3] == 0)
            rec_ri = np.linalg.norm(np.asarray(full[i]), axis=-1)
            assert np.abs(rec_ri.reshape(ri[i].shape) - ri[i]).max() <= bound


def test_engine_partial_batch():
    cfg = CodecConfig(cluster_num=16)
    engine = BatchEngine(SMALL, cfg, batch_size=4, workers=2)
    clouds = [synth_scene(seed=3)]
    results = engine.encode_frames(clouds)
    assert len(results) == 1
    decoded = engine.decode_blobs([results[0][0]])
    assert len(decoded) == 1


def test_prepare_decode_fused_i8_matches_rebuild_path():
    """The fused native i8 decode uplink (rans.cpp::
    rans_delta_finalize_frames_i8 writing the wire view in place) must be
    byte-identical to the old materialize-i16-then-rescan rebuild, on
    content WITH exceptions (|q| > 127 residuals)."""
    from rpcc.codec import rans_codec

    cfg = CodecConfig(cluster_num=16)
    engine = BatchEngine(SMALL, cfg, batch_size=4, workers=2)
    rng = np.random.default_rng(7)
    clouds = []
    for s in range(4):
        pc = synth_scene(seed=s)
        # spike some ranges so a few residuals overflow i8 (exceptions)
        k = rng.integers(5, 15)
        ix = rng.choice(pc.shape[0], k, replace=False)
        pc[ix] *= rng.uniform(1.5, 3.0, (k, 1)).astype(np.float32)
        clouds.append(pc)
    blobs = [b for b, _ in engine.encode_frames(clouds, seeds=range(4))]

    prep = engine._prepare_decode(blobs)
    _, args, sal, tail, live = prep
    assert args[2].dtype == np.int8 and len(tail) == 2, "fused path not taken"
    orig = rans_codec.peek_delta_ns
    rans_codec.peek_delta_ns = lambda b: None  # force the old rebuild path
    try:
        _, args_o, sal_o, tail_o, _ = engine._prepare_decode(blobs)
    finally:
        rans_codec.peek_delta_ns = orig
    assert args_o[2].dtype == np.int8
    for a, b in zip(args, args_o):
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b)
    for a, b in zip(tail, tail_o):
        assert np.array_equal(a, b)
    assert np.array_equal(sal, sal_o)
    # at least one real exception must have exercised the exception lists
    assert (tail[0] < engine.hw).any(), "test content produced no exceptions"
    # and the decode itself roundtrips
    pts = engine.decode_blobs_points(blobs)
    assert len(pts) == 4 and all(p.shape[1] == 4 for p in pts)


def test_decode_pipeline_single_batch_drain():
    """One batch must flow entirely through the 4-deep pipeline's drain
    (no steady-state yields happen: prepare/dispatch/materialize all pop
    in the drain loops) and still roundtrip within the error bound."""
    cfg = CodecConfig(cluster_num=16)
    engine = BatchEngine(SMALL, cfg, batch_size=4, workers=2)
    clouds = [synth_scene(seed=s) for s in range(4)]
    blobs = [b for b, _ in engine.encode_frames(clouds, seeds=range(4))]
    out, _ = engine.encode_batch_device(clouds, seeds=range(4))
    ri = np.asarray(out.range_image)
    decoded = list(engine.decode_pipeline(iter([blobs])))
    assert len(decoded) == 1
    direct = engine.decode_blobs_points(blobs)
    full = engine.decode_blobs(blobs)
    bound = cfg.step + 1e-5
    for i, rec in enumerate(decoded[0]):
        assert rec.shape == direct[i].shape and rec.shape[1] == 4
        assert np.array_equal(rec, direct[i])
        pts = np.asarray(full[i]).reshape(-1, 3)
        keep = pts.sum(-1) != 0
        assert np.array_equal(rec[:, :3], pts[keep])
        rec_ri = np.linalg.norm(np.asarray(full[i]), axis=-1)
        assert np.abs(rec_ri.reshape(ri[i].shape) - ri[i]).max() <= bound
