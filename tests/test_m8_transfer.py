"""Masked-compact uplink (transfer_precision='m8') parity tests.

The m8 wire code (packed nonzero-occupancy bit plane + compact i8 deltas
over consecutive nonzero pixels, ops/projection.py::project_points_host_m8)
must reconstruct the exact u16 snap grid in-graph, so an 'm8' engine's
bitstreams are bit-identical to a 'u16' engine's on the same clouds/seeds.
"""

import numpy as np

from rpcc.config import CodecConfig
from rpcc.ops.projection import (
    project_points_host_m8,
    project_points_host_u16,
)
from rpcc.parallel import BatchEngine

from tests.test_roundtrip import SMALL, synth_scene


def _m8_invert(maskp, d8c, pd, val, n, hw):
    """Host mirror of the in-graph ri_m8 inversion (models/encoder.py)."""
    bits = np.unpackbits(maskp)[:hw].astype(np.int64)
    C = np.cumsum(d8c.astype(np.int64))
    if pd.size:
        pos = np.cumsum(pd.astype(np.int64)) - 1
        K = val.astype(np.int64) - C[pos]
        fill = np.zeros(max(n, 1), np.int64)
        fill[pos] += np.diff(K, prepend=np.int64(0))
        nzq = C + np.cumsum(fill)
    else:
        nzq = C
    rank = np.cumsum(bits) - 1
    return np.where(
        bits == 1, nzq[np.clip(rank, 0, max(n - 1, 0))], 0
    )


def test_m8_wire_code_reconstructs_exact_grid():
    pc = synth_scene(seed=5)
    floor = np.float32(CodecConfig().step / 16.0)
    q, delta_u = project_points_host_u16(pc, SMALL, floor)
    maskp, d8c, pd, val, n, delta = project_points_host_m8(pc, SMALL, floor)
    assert delta == delta_u
    assert n == int((q != 0).sum())
    rec = _m8_invert(maskp, d8c, pd, val, n, q.size)
    assert np.array_equal(rec, q.reshape(-1).astype(np.int64))


def test_m8_exception_gaps_fit_u16():
    """Per-row resets bound exception pos-gaps by W in the compact domain."""
    pc = synth_scene(seed=7)
    floor = np.float32(CodecConfig().step / 16.0)
    _, _, pd, _, _, _ = project_points_host_m8(pc, SMALL, floor)
    assert pd.size == 0 or int(pd.max()) <= SMALL.width


def test_m8_empty_frame():
    maskp, d8c, pd, val, n, delta = project_points_host_m8(
        np.zeros((0, 3), np.float32), SMALL, np.float32(0.0025)
    )
    assert n == 0 and d8c.size == 0 and pd.size == 0
    assert not np.unpackbits(maskp).any()


def test_m8_engine_bitstream_identical_to_u16():
    clouds = [synth_scene(seed=s) for s in range(4)]
    cfg16 = CodecConfig(cluster_num=16, transfer_precision="u16")
    cfg_m = CodecConfig(cluster_num=16, transfer_precision="m8")
    e16 = BatchEngine(SMALL, cfg16, batch_size=4, workers=2)
    em = BatchEngine(SMALL, cfg_m, batch_size=4, workers=2)
    res16 = e16.encode_frames(clouds, seeds=range(4))
    resm = em.encode_frames(clouds, seeds=range(4))
    for (b16, _), (bm, _) in zip(res16, resm):
        assert b16 == bm
    # decode roundtrip through the m8 engine's own decoder
    decoded = em.decode_blobs([b for b, _ in resm])
    out, _ = e16.encode_batch_device(clouds, seeds=range(4))
    ri = np.asarray(out.range_image)
    delta_dec = cfg_m.step / 16.0
    for i in range(4):
        rec_ri = np.linalg.norm(decoded[i], axis=-1)
        assert np.abs(rec_ri - ri[i]).max() <= cfg_m.step + delta_dec / 2 + 1e-5


def test_m8_engine_device_entropy_combo():
    clouds = [synth_scene(seed=s) for s in range(2)]
    cfg = CodecConfig(cluster_num=16, transfer_precision="m8", device_entropy=True)
    eng = BatchEngine(SMALL, cfg, batch_size=2, workers=2)
    res = eng.encode_frames(clouds, seeds=range(2))
    assert all(len(b) > 0 for b, _ in res)
    dec = eng.decode_blobs([b for b, _ in res])
    assert len(dec) == 2 and all(np.isfinite(d).all() for d in dec)


def test_m8_native_projection_matches_numpy(monkeypatch):
    """The fused C++ m8 projection (raster.cpp::project_bin_raster_m8) is
    bit-identical to the numpy path on every output."""
    import rpcc.codec.lz4block as lz4block
    from rpcc.codec.lz4block import native_lib

    lib = native_lib()
    if lib is None or not hasattr(lib, "project_bin_raster_m8"):
        import pytest

        pytest.skip("native lib unavailable")
    floor = np.float32(CodecConfig().step / 16.0)
    for seed in range(3):
        pc = synth_scene(seed=seed)
        nat = project_points_host_m8(pc, SMALL, floor)
        monkeypatch.setattr(lz4block, "native_lib", lambda: None)
        ref = project_points_host_m8(pc, SMALL, floor)
        monkeypatch.undo()
        for i, (a, b) in enumerate(zip(nat, ref)):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, i
            assert np.array_equal(a, b), i
