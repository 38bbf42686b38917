"""Host projection (production path) vs the device graph and a loop oracle.

The host path (numpy f32 binning + native C++ scatter-min,
ops/projection.py::project_points_host) defines the production bitstream;
the in-graph ``project_points`` stays for pure-device pipelines.  The two
agree except for float ulps: XLA contracts x*x+y*y+z*z with FMA, numpy does
not, so depths differ in the last ulp on a few % of points (and an
occasional arctan2 boundary point flips a bin).
"""

import numpy as np
import jax
import pytest

from rpcc.config import LidarConfig
from rpcc.ops.projection import (
    bin_points_host,
    project_points,
    project_points_host,
    raster_range_image_host,
)

from tests.test_roundtrip import SMALL, synth_scene


def _loop_oracle(depth, idx, H, W):
    """Direct port of the reference keep-nearest loop (cpp_modules.cpp:459)."""
    ri = np.zeros(H * W, np.float32)
    for i in range(depth.shape[0]):
        if depth[i] > 0:
            cur = ri[idx[i]]
            if cur == 0.0 or depth[i] < cur:
                ri[idx[i]] = depth[i]
    return ri.reshape(H, W)


def test_host_raster_matches_loop_oracle_native_and_numpy(monkeypatch):
    pc = synth_scene(seed=0)
    depth, idx = bin_points_host(pc, SMALL)
    want = _loop_oracle(depth, idx, SMALL.height, SMALL.width)
    got_native = raster_range_image_host(depth, idx, SMALL.height, SMALL.width)
    assert (got_native == want).all()
    # numpy fallback (no native library): same bytes, incl. tie handling
    import rpcc.codec.lz4block as lz4block

    monkeypatch.setattr(lz4block, "native_lib", lambda: None)
    got_np = raster_range_image_host(depth, idx, SMALL.height, SMALL.width)
    assert (got_np == want).all()


def test_host_raster_tie_first_point_wins():
    # two points, identical depth, same pixel: the FIRST wins (strict <),
    # and a nearer later point still replaces an earlier farther one.
    depth = np.asarray([5.0, 5.0, 4.0], np.float32)
    idx = np.asarray([7, 7, 9], np.int32)
    ri = raster_range_image_host(depth, idx, 2, 8).reshape(-1)
    assert ri[7] == np.float32(5.0) and ri[9] == np.float32(4.0)


def test_fused_native_projection_bit_identical_to_numpy(monkeypatch):
    """The fused C++ kernel and the numpy fallback must agree on every BIT:
    both evaluate the same deterministic atan2/sqrt sequence (see
    projection.py::_ATAN_COEFFS)."""
    import rpcc.codec.lz4block as lz4block

    if lz4block.native_lib() is None or not hasattr(
        lz4block.native_lib(), "project_bin_raster"
    ):
        pytest.skip("native library unavailable")

    rng = np.random.default_rng(11)
    scenes = [synth_scene(seed=s) for s in range(3)]
    # adversarial: random directions incl. negative x/y, near-axis points
    scenes.append(
        np.stack(
            [rng.uniform(-60, 60, 20000), rng.uniform(-60, 60, 20000),
             rng.uniform(-5, 25, 20000)], -1
        ).astype(np.float32)
    )
    # (N, 4) layout (KITTI .bin has intensity): exercises the stride path
    extra = np.concatenate(
        [scenes[0], np.zeros((scenes[0].shape[0], 1), np.float32)], -1
    )
    scenes.append(extra)

    uneven = LidarConfig(
        name="csvish",
        horizontal_fov_deg=360.0,
        vertical_angle_max_deg=3.0,
        vertical_angle_min_deg=-25.0,
        height=16,
        width=400,
        vertical_angles_deg=tuple(np.linspace(-25.0, 3.0, 16)[::-1]),
    )
    for lidar in (SMALL, uneven):
        for pc in scenes:
            native = project_points_host(pc, lidar)
            monkeypatch.setattr(lz4block, "native_lib", lambda: None)
            fallback = project_points_host(pc, lidar)
            monkeypatch.undo()
            np.testing.assert_array_equal(native, fallback)


def test_u16_projection_native_matches_numpy_and_bounds():
    from rpcc.ops.projection import project_points_host_u16
    import rpcc.codec.lz4block as lz4block

    pc = synth_scene(seed=4)
    floor = np.float32(0.04 / 16.0)
    q_nat, d_nat = project_points_host_u16(pc, SMALL, floor)
    # numpy fallback must produce identical u16 grid + delta
    lib = lz4block.native_lib
    lz4block.native_lib = lambda: None
    try:
        q_np, d_np = project_points_host_u16(pc, SMALL, floor)
    finally:
        lz4block.native_lib = lib
    assert d_nat == d_np
    np.testing.assert_array_equal(q_nat, q_np)
    # reconstruction error <= delta/2 vs the exact projection
    ri = project_points_host(pc, SMALL)
    rec = q_nat.astype(np.float32) * d_nat
    assert np.abs(rec - ri).max() <= d_nat / 2 + 1e-7
    assert ((q_nat > 0) == (ri > 0)).all() or (ri[q_nat == 0] < d_nat).all()


def test_host_vs_device_projection_agrees_mod_ulps():
    pc = synth_scene(seed=3)
    dev = np.asarray(jax.jit(lambda p: project_points(p, SMALL, None))(pc))
    host = project_points_host(pc, SMALL)
    # identical support (a bin flip could move support by one pixel, but
    # synthetic scenes away from bin boundaries should not hit one)
    assert ((dev > 0) == (host > 0)).mean() > 0.9999
    both = (dev > 0) & (host > 0)
    # where both project, depths match to FMA-contraction ulps (or a
    # different same-pixel winner whose depth ties within quantization noise)
    close = np.isclose(dev[both], host[both], rtol=2e-6, atol=0)
    assert close.mean() > 0.999


def test_host_binning_matches_device_binning():
    pc = synth_scene(seed=5)
    import jax.numpy as jnp

    from rpcc.ops.projection import _TWO_PI_REF
    from rpcc.ops.rounding import round_half_away

    H, W = SMALL.height, SMALL.width

    def dev_bins(points):
        x, y, z = points[:, 0], points[:, 1], points[:, 2]
        az = jnp.arctan2(y, x)
        az = jnp.where(az < 0, az + _TWO_PI_REF, az)
        col = round_half_away(az / SMALL.horizontal_fov * W).astype(jnp.int32) % W
        v = jnp.arctan2(z, jnp.sqrt(x * x + y * y))
        vres = (SMALL.vertical_max - SMALL.vertical_min) / (H - 1)
        row = jnp.clip(
            round_half_away((v - SMALL.vertical_min) / vres).astype(jnp.int32), 0, H - 1
        )
        return row * W + col

    dev_idx = np.asarray(jax.jit(dev_bins)(pc))
    _, host_idx = bin_points_host(pc, SMALL)
    assert (dev_idx == host_idx).mean() > 0.9999
