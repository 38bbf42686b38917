"""m8 decode downlink (masked-compact wire code, device-built) parity tests.

The device decoder's ``m8_down`` view is the encode uplink's m8 format
(ops/projection.py::project_points_host_m8) built in-graph: a packed
nonzero-occupancy bit plane + compact i8 deltas over consecutive nonzero
pixels, with (pos-delta, value) exceptions in the compact domain.  The
host inverse (models/host_decoder.py::m8_reconstruct_batch, native
decode.cpp pass + bit-identical numpy fallback) must reproduce exactly
the u16-snap range image the d8/u16 downlinks produce.
"""

import numpy as np
import pytest

from rpcc.config import CodecConfig
from rpcc.models.host_decoder import m8_reconstruct_batch
from rpcc.parallel import BatchEngine

from tests.test_roundtrip import SMALL, synth_scene


@pytest.fixture(scope="module")
def m8_engines():
    cfg = CodecConfig(transfer_precision="m8", device_entropy=False)
    e_m8 = BatchEngine(SMALL, cfg, batch_size=4, workers=2)
    e_d8 = BatchEngine(SMALL, cfg, batch_size=4, workers=2, d8_down=True)
    return e_m8, e_d8


def test_m8_down_is_default_and_exclusive(m8_engines):
    e_m8, e_d8 = m8_engines
    assert e_m8._m8_down and not e_m8._d8_down
    assert e_d8._d8_down and not e_d8._m8_down


def test_m8_down_decode_identical_to_d8_down(m8_engines):
    e_m8, e_d8 = m8_engines
    clouds = [synth_scene(seed=s) for s in range(4)]
    blobs = [b for b, _ in e_m8.encode_frames(clouds, seeds=range(4))]
    r_m8 = e_m8.decode_blobs(blobs)
    r_d8 = e_d8.decode_blobs(blobs)
    assert len(r_m8) == len(r_d8) == 4
    for a, b in zip(r_m8, r_d8):
        assert np.array_equal(a, b)


def test_m8_reconstruct_native_matches_numpy(m8_engines, monkeypatch):
    """The ctypes pass and the numpy fallback are bit-identical."""
    e_m8, _ = m8_engines
    clouds = [synth_scene(seed=s) for s in range(4)]
    blobs = [b for b, _ in e_m8.encode_frames(clouds, seeds=range(4))]
    dec, live = e_m8.decode_blobs_device(blobs)
    args = (
        np.asarray(dec.maskp),
        np.asarray(dec.d8),
        np.asarray(dec.exc_pd),
        np.asarray(dec.exc_val),
        np.asarray(dec.n_nz),
        np.asarray(dec.n_exc),
        np.asarray(dec.delta),
        e_m8.H,
        e_m8.W,
    )
    native = m8_reconstruct_batch(*args)
    import rpcc.codec.lz4block as lz4block

    monkeypatch.setattr(lz4block, "native_lib", lambda: None)
    fallback = m8_reconstruct_batch(*args)
    assert native.dtype == fallback.dtype == np.float32
    assert np.array_equal(native, fallback)


def test_m8_down_wire_matches_u16_grid(m8_engines):
    """The inverted downlink equals range_u16 * delta exactly."""
    e_m8, _ = m8_engines
    clouds = [synth_scene(seed=s) for s in range(2)]
    blobs = [b for b, _ in e_m8.encode_frames(clouds, seeds=range(2))]
    dec, live = e_m8.decode_blobs_device(blobs)
    ris, _ = e_m8._materialize_ris(dec, live)
    riq = np.asarray(dec.range_u16).astype(np.float32)
    want = riq * np.asarray(dec.delta)[:, None, None]
    assert np.array_equal(ris[:live], want[:live])


def test_m8_down_cap_overflow_falls_back_lossless():
    """Frames overflowing either m8 cap download the u16 grid instead."""
    cfg = CodecConfig(transfer_precision="m8", device_entropy=False)
    tiny = BatchEngine(
        SMALL, cfg, batch_size=2, workers=2, m8_down=True, m8_caps=(64, 8)
    )
    clouds = [synth_scene(seed=s) for s in range(2)]
    blobs = [b for b, _ in tiny.encode_frames(clouds, seeds=range(2))]
    dec, live = tiny.decode_blobs_device(blobs)
    assert int(np.asarray(dec.n_nz).max()) > 64  # caps genuinely overflow
    ris, _ = tiny._materialize_ris(dec, live)
    riq = np.asarray(dec.range_u16).astype(np.float32)
    want = riq * np.asarray(dec.delta)[:, None, None]
    assert np.array_equal(ris[:live], want[:live])


def test_m8_down_decode_pipeline(m8_engines):
    """The 4-deep decode pipeline drains correctly in m8_down mode and
    yields the compacted (n, 4) xyz0 save rows (engine.decode_blobs_points
    semantics), matching the full-cloud decode_blobs path after the same
    sum(xyz) != 0 drop rule."""
    e_m8, _ = m8_engines
    clouds = [synth_scene(seed=s) for s in range(4)]
    blobs = [b for b, _ in e_m8.encode_frames(clouds, seeds=range(4))]
    direct = []
    for pc in e_m8.decode_blobs(blobs):
        flat = np.asarray(pc, np.float32).reshape(-1, 3)
        keep = flat.sum(-1) != 0
        rows = np.zeros((int(keep.sum()), 4), np.float32)
        rows[:, :3] = flat[keep]
        direct.append(rows)
    out = []
    for recs in e_m8.decode_pipeline([blobs, blobs]):
        out.append(recs)
    assert len(out) == 2
    for recs in out:
        for a, b in zip(recs, direct):
            assert a.shape == b.shape and a.dtype == np.float32
            assert np.array_equal(a, b)
    pts_direct = e_m8.decode_blobs_points(blobs)
    for a, b in zip(pts_direct, direct):
        assert np.array_equal(a, b)
