"""HostDecoder (native C++ / numpy) parity with the device decoder."""

import numpy as np
import pytest

from rpcc.config import CodecConfig
from rpcc.models.host_decoder import HostDecoder, _decode_frame_np
from rpcc.parallel import BatchEngine

from tests.test_roundtrip import SMALL, synth_scene


# f32 transfer: the 1e-3 host-vs-device agreement below needs the exact f32
# decode downlink (the default m8 downlink re-snaps the reconstruction to a
# u16 grid, adding <= delta/2 — covered by test_m8_down.py instead).
CONFIGS = [
    CodecConfig(cluster_num=16, transfer_precision="f32"),
    CodecConfig(cluster_num=16, transfer_precision="f32", modeling_method="plane"),
    CodecConfig(
        cluster_num=16, transfer_precision="f32", compress_framework="non-uniform"
    ),
]


@pytest.mark.parametrize("cfg", CONFIGS, ids=["point", "plane", "nonuniform"])
def test_host_decode_matches_device(cfg):
    engine = BatchEngine(SMALL, cfg, batch_size=2, workers=2)
    clouds = [synth_scene(seed=s) for s in range(2)]
    results = engine.encode_frames(clouds, seeds=range(2))
    blobs = [b for b, _ in results]
    out, _ = engine.encode_batch_device(clouds, seeds=range(2))
    enc_ri = np.asarray(out.range_image)

    hd = HostDecoder(SMALL, cfg)
    host_ris = hd.decode_blobs(blobs)
    dev_pcs = engine.decode_blobs(blobs)
    bound = cfg.step + (0.0 if cfg.uniform else max(cfg.level_delta_acc))
    for i in range(2):
        # error bound vs the encoder's range image
        assert np.abs(host_ris[i] - enc_ri[i]).max() <= bound + 1e-5
        # agreement with the device decoder (rays differ by float ulps:
        # the device recomputes even-dist rays in-graph, the host uses the
        # f64-built table)
        dev_ri = np.linalg.norm(dev_pcs[i], axis=-1)
        assert np.abs(host_ris[i] - dev_ri).max() < 1e-3


def test_native_matches_numpy_fallback():
    cfg = CodecConfig(cluster_num=16)
    engine = BatchEngine(SMALL, cfg, batch_size=1, workers=2)
    blob = engine.encode_frames([synth_scene(seed=7)], seeds=[0])[0][0]
    hd = HostDecoder(SMALL, cfg)
    fields = hd.entropy_decode_blobs([blob])[0]
    contour = np.frombuffer(fields["contour_map"], np.uint8)
    seq = np.frombuffer(fields["idx_sequence"], np.uint16)
    stream = np.frombuffer(fields["residual_quantized"], np.int16)
    models = np.frombuffer(fields["plane_param"], np.float32).reshape(-1, 4)

    ri_native = hd.reconstruct(contour, seq, stream, models)
    ri_np = _decode_frame_np(
        contour, seq, stream, np.ascontiguousarray(models, np.float32),
        None, None, cfg.step, hd._tm, hd.H, hd.W,
    )
    assert np.array_equal(ri_native, ri_np)


def test_truncated_fields_raise_cleanly():
    """Corrupt/truncated wire fields must raise ValueError, not feed raw C
    pointers out-of-bounds."""
    cfg = CodecConfig(cluster_num=16)
    hd = HostDecoder(SMALL, cfg)
    hw = SMALL.height * SMALL.width
    good_contour = np.zeros(hw // 8, np.uint8)
    seq = np.zeros(4, np.uint16)
    stream = np.zeros(16, np.int16)
    models = np.zeros((4, 4), np.float32)
    with pytest.raises(ValueError, match="contour_map too short"):
        hd.reconstruct(good_contour[:-1], seq, stream, models)
    with pytest.raises(ValueError, match="plane_param"):
        hd.reconstruct(good_contour, seq, stream, np.zeros((0, 4), np.float32))
    cfg_nu = CodecConfig(cluster_num=16, compress_framework="non-uniform")
    hd_nu = HostDecoder(SMALL, cfg_nu)
    with pytest.raises(ValueError, match="salience_level"):
        hd_nu.reconstruct(good_contour, seq, stream, models,
                          salience=np.zeros(2, np.uint8))


def test_decode_blobs_points_zero_drop():
    cfg = CodecConfig(cluster_num=16)
    engine = BatchEngine(SMALL, cfg, batch_size=1, workers=2)
    blob = engine.encode_frames([synth_scene(seed=9)], seeds=[0])[0][0]
    hd = HostDecoder(SMALL, cfg)
    ri = hd.decode_blobs([blob])[0]
    pts = hd.decode_blobs_points([blob])[0]
    # reference drop rule: sum(xyz) != 0 (dataset/dataset.py:74-75)
    full = ri.reshape(-1, 1) * hd._tm.T
    keep = full.sum(-1) != 0
    assert pts.shape == (int(keep.sum()), 4)
    assert np.allclose(pts[:, :3], full[keep], atol=0)
    assert (pts[:, 3] == 0).all()


def test_out_of_range_ids_and_salience_match_native():
    """Seg ids >= M (decoder configured with a smaller cluster_num than the
    encoder) decode to r = 0 and consume no stream slot; salience levels >=
    n_levels clamp to the LAST level (the device decoder's clamped-gather
    rule) — identically on the native kernel and the numpy fallback (the
    .rpcc format is not self-describing, so mismatched-config input is
    exactly where the backends must agree)."""
    cfg = CodecConfig(cluster_num=16)
    hd = HostDecoder(SMALL, cfg)
    H, W, hw = hd.H, hd.W, hd.hw
    M = 4
    models = np.zeros((M, 4), np.float32)
    models[0, 3] = 5.0   # ground: point model, depth 5
    models[2, 3] = 9.0   # cluster 2: point model, depth 9
    models[3, 3] = 2.0
    # runs: [id 2] x 10, [id 99 >= M] x 10, [id 0] x 12, [id 1] rest
    bits = np.zeros(hw, np.uint8)
    bits[[0, 10, 20, 32]] = 1
    contour = np.packbits(bits)
    seq = np.asarray([2, 99, 0, 1], np.uint16)
    # stream covers only the id-0 and id-2 pixels (id-major order: 0 first)
    stream = np.arange(22, dtype=np.int16)

    ri_native = hd.reconstruct(contour, seq, stream, models)
    ri_np = _decode_frame_np(
        contour, seq, stream, np.ascontiguousarray(models, np.float32),
        None, None, cfg.step, hd._tm, H, W,
    )
    assert np.array_equal(ri_native, ri_np)
    flat = ri_native.reshape(-1)
    assert (flat[10:20] == 0).all()          # id 99: out of range -> 0
    # id 0 pixels got the FIRST 12 stream slots (id 99 consumed none)
    assert np.allclose(flat[20:32], 5.0 + np.arange(12) * cfg.step)
    assert np.allclose(flat[:10], 9.0 + np.arange(12, 22) * cfg.step)

    # out-of-range salience level -> clamp to the last level on both backends
    cfg_nu = CodecConfig(cluster_num=16, compress_framework="non-uniform")
    hd_nu = HostDecoder(SMALL, cfg_nu)
    sal = np.zeros(M, np.uint8)
    sal[2] = 200  # >= n_levels
    ri_native = hd_nu.reconstruct(contour, seq, stream, models, salience=sal)
    level_acc = np.asarray(cfg_nu.level_acc, np.float32)
    ri_np = _decode_frame_np(
        contour, seq, stream, np.ascontiguousarray(models, np.float32),
        sal, level_acc, cfg_nu.step, hd_nu._tm, H, W,
    )
    assert np.array_equal(ri_native, ri_np)
    assert np.allclose(
        ri_native.reshape(-1)[:10],
        np.float32(9.0) + np.arange(12, 22, dtype=np.float32) * level_acc[-1],
    )


def test_malformed_exception_lists_native_matches_numpy():
    """Adversarial d8/m8 downlink exception lists (zero pos-deltas, chains
    past the grid) must decode identically on the native kernel and the
    numpy twin, and never write out of bounds (the unguarded walk wrote one
    float past the buffer per zero entry)."""
    from rpcc.codec.lz4block import native_lib
    from rpcc.models.host_decoder import (
        d8_reconstruct_batch,
        m8_reconstruct_batch,
    )

    H, W = 4, 16
    hw = H * W
    rng = np.random.default_rng(3)

    def both_d8(pd, val, n_exc):
        d8 = rng.integers(-5, 6, (1, H, W)).astype(np.int8)
        delta = np.asarray([0.5], np.float32)
        nat = d8_reconstruct_batch(d8, pd, val, n_exc, delta)
        if native_lib() is None:
            return nat, nat
        import rpcc.models.host_decoder as hd_mod
        import rpcc.codec.lz4block as lz

        orig = lz.native_lib
        lz.native_lib = lambda: None
        try:
            np_out = d8_reconstruct_batch(d8, pd, val, n_exc, delta)
        finally:
            lz.native_lib = orig
        return nat, np_out

    cap = 8
    # pd = [hw, 0, 0, ...]: first exception at the LAST pixel, then zero
    # deltas — the PoC that walked past the output buffer
    pd = np.zeros((1, cap), np.uint16)
    pd[0, 0] = hw
    val = np.full((1, cap), 7, np.uint16)
    nat, npo = both_d8(pd, val, np.asarray([cap], np.int32))
    assert np.array_equal(nat, npo)
    # chain running past the grid mid-list
    pd2 = np.full((1, cap), W, np.uint16)
    nat, npo = both_d8(pd2, val, np.asarray([cap], np.int32))
    assert np.array_equal(nat, npo)

    # m8: compact stream of n nonzeros, exceptions with zero deltas
    nz_cap, exc_cap = 16, 8
    maskp = np.zeros((1, hw // 8), np.uint8)
    maskp[0, :2] = 0xFF  # 16 live pixels
    d8c = rng.integers(-5, 6, (1, nz_cap)).astype(np.int8)
    pdm = np.zeros((1, exc_cap), np.uint16)
    pdm[0, 0] = nz_cap  # lands on the last compact slot
    valm = np.full((1, exc_cap), 9, np.uint16)
    args = (maskp, d8c, pdm, valm, np.asarray([nz_cap], np.int32),
            np.asarray([exc_cap], np.int32), np.asarray([0.5], np.float32),
            H, W)
    nat = m8_reconstruct_batch(*args)
    if native_lib() is not None:
        import rpcc.codec.lz4block as lz

        orig = lz.native_lib
        lz.native_lib = lambda: None
        try:
            npo = m8_reconstruct_batch(*args)
        finally:
            lz.native_lib = orig
        assert np.array_equal(nat, npo)
    # empty compact stream + zero pos-delta (wrote nzv[0] on a 0-size vector)
    args0 = (maskp, d8c, pdm, valm, np.asarray([0], np.int32),
             np.asarray([1], np.int32), np.asarray([0.5], np.float32), H, W)
    out0 = m8_reconstruct_batch(*args0)
    assert np.array_equal(out0, np.zeros((1, H, W), np.float32))


def test_engine_points_match_host_backend_f32():
    """Datalist save parity across backends: in f32-transfer mode the device
    engine's compacted (n, 4) save rows (decode.cpp::backproject_compact)
    have the SAME shape (identical drop decisions) as
    HostDecoder.decode_blobs_points, with values within 1e-3 (device vs host
    float evaluation of the shared ray tables differs in final ulps, so
    byte-identity is not guaranteed and not asserted).  decode_pipeline's
    per-frame rows are additionally pinned byte-identical to the
    synchronous decode_blobs_points path."""
    cfg = CodecConfig(cluster_num=16, transfer_precision="f32",
                      device_entropy=False)
    engine = BatchEngine(SMALL, cfg, batch_size=2, workers=2)
    clouds = [synth_scene(seed=s) for s in range(2)]
    blobs = [b for b, _ in engine.encode_frames(clouds, seeds=range(2))]
    hd = HostDecoder(SMALL, cfg)
    host_pts = hd.decode_blobs_points(blobs)
    dev_pts = engine.decode_blobs_points(blobs)
    piped = list(engine.decode_pipeline(iter([blobs])))
    assert len(host_pts) == len(dev_pts) == 2
    assert len(piped) == 1 and len(piped[0]) == 2
    for a, b, p in zip(dev_pts, host_pts, piped[0]):
        assert a.dtype == b.dtype == np.float32
        assert a.shape == b.shape
        # identical drop decisions; values agree to the documented host/
        # device reconstruction agreement (ray-table float ulps)
        assert np.abs(a - b).max() < 1e-3
        assert np.array_equal(p, a)


def test_engine_points4_native_matches_numpy_twin():
    """decode.cpp::backproject_compact == the numpy fallback, bit for bit."""
    from rpcc.codec.lz4block import native_lib

    cfg = CodecConfig(cluster_num=16)
    engine = BatchEngine(SMALL, cfg, batch_size=1, workers=2)
    blob = engine.encode_frames([synth_scene(seed=3)], seeds=[0])[0][0]
    dec, live = engine._dispatch_decode(engine._prepare_decode([blob]))
    ris, live = engine._materialize_ris(dec, live)
    native = engine._points4_from_ris(ris, live)
    lib = native_lib()
    if lib is None or not hasattr(lib, "backproject_compact"):
        pytest.skip("native library unavailable")
    # numpy twin, forced: mirror the fallback branch exactly
    hw = engine.hw
    tmT = engine._tm_planar.T
    for i in range(live):
        pts = ris[i].reshape(-1, 1) * tmT
        keep = pts.sum(-1) != 0
        n = int(keep.sum())
        buf = np.zeros((n, 4), np.float32)
        buf[:, :3] = pts[keep]
        assert np.array_equal(native[i], buf)
