"""Seeded LiDAR frames rendered on a sensor's own scan grid.

The benchmark, the RD sweep, the smoke run on the accelerator and the
driver entry points all draw their input here, from a seed, so no run
depends on a dataset being present.  A frame is one ray per range-image
pixel cast into an urban-like scene — a ground plane, a wavy ring of
building walls, and upright cylinders standing in for poles, trunks and
vehicles — with gaps in the walls that open onto far facades or nothing
(empty pixels), and ~1 cm range noise, so residuals compress like real scans
rather than like white noise.

:func:`frame_variant` perturbs a frame the way a moving sensor's next scan
differs while staying on the scan grid: a yaw rotation, a smooth radial
warp (scene geometry changes), 1 cm range jitter and up to 3% dropout.
Translating a cloud and re-projecting it would punch resampling holes no
real scan has.
"""

from __future__ import annotations

from typing import List

import numpy as np

from rpcc.config import LidarConfig

GROUND_Z = -1.8
MIN_RANGE = 2.0
MAX_RANGE = 80.0


def scene_frame(
    lidar: LidarConfig, seed: int = 0, objects: int = 12, gaps: int = 4
) -> np.ndarray:
    """(N, 3) float32 cloud: the nearest hit of every pixel's ray; rays with
    no hit inside [MIN_RANGE, MAX_RANGE] are dropped."""
    from rpcc.ops.projection import build_transform_map

    rng = np.random.default_rng(seed)
    tm = build_transform_map(lidar).reshape(-1, 3).astype(np.float64)  # unit rays
    tx, ty, tz = tm[:, 0], tm[:, 1], tm[:, 2]
    horiz = np.hypot(tx, ty)
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.where(tz < -1e-4, GROUND_Z / tz, np.inf)
        az = np.arctan2(ty, tx)
        p1, p2 = rng.uniform(0, 2 * np.pi, 2)
        wall = 18 + 8 * np.sin(3 * az + p1) + 3 * np.sin(7 * az + p2)
        for _ in range(gaps):  # far facade (beyond MAX_RANGE: no return)
            mid, half = rng.uniform(-np.pi, np.pi), rng.uniform(0.15, 0.4)
            off = np.abs((az - mid + np.pi) % (2 * np.pi) - np.pi)
            wall = np.where(off < half, rng.uniform(60.0, 120.0), wall)
        r = np.minimum(r, np.where(horiz > 1e-4, wall / horiz, np.inf))
        # Upright cylinders: solve |t * (tx, ty) - c| = rad in the plane and
        # keep the nearer root whose hit height lies on the cylinder.
        for _ in range(objects):
            dist = rng.uniform(4.0, 15.0)
            ang = rng.uniform(-np.pi, np.pi)
            cx, cy = dist * np.cos(ang), dist * np.sin(ang)
            rad = rng.uniform(0.2, 2.0)
            top = GROUND_Z + rng.uniform(1.0, 4.0)
            b = tx * cx + ty * cy
            disc = b * b - horiz * horiz * (cx * cx + cy * cy - rad * rad)
            t = (b - np.sqrt(np.maximum(disc, 0.0))) / np.maximum(horiz * horiz, 1e-12)
            z = t * tz
            hit = (disc > 0) & (t > 0) & (z >= GROUND_Z) & (z <= top)
            r = np.where(hit, np.minimum(r, t), r)
    r = np.where(np.isfinite(r) & (r > MIN_RANGE) & (r < MAX_RANGE), r, 0.0)
    r = r + rng.normal(0, 0.01, r.shape) * (r > 0)
    keep = r > 0
    return (tm[keep] * r[keep, None]).astype(np.float32)


def frame_variant(pc: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """A grid-preserving perturbation of ``pc`` (see module docstring)."""
    pc = np.asarray(pc, np.float64)[:, :3]
    r = np.linalg.norm(pc, axis=-1)
    az = np.arctan2(pc[:, 1], pc[:, 0])
    dirs = pc / np.maximum(r, 1e-9)[:, None]
    yaw = rng.uniform(-np.pi, np.pi)
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    k = rng.integers(1, 4)
    warp = 1.0 + rng.uniform(0.0, 0.08) * np.sin(k * az + rng.uniform(0, 2 * np.pi))
    r2 = np.maximum(r * warp + rng.normal(0, 0.01, r.shape), 0.0)
    keep = rng.random(pc.shape[0]) > rng.uniform(0.0, 0.03)
    return ((dirs * r2[:, None]) @ rot.T)[keep].astype(np.float32)


def synthetic_frames(lidar: LidarConfig, n: int, seed: int = 0) -> List[np.ndarray]:
    """``n`` distinct frames: frame 0 is the clean scene of ``seed``, the
    rest are seeded variants of it.  A shorter list is a prefix of a longer
    one of the same seed."""
    base = scene_frame(lidar, seed)
    rng = np.random.default_rng([seed, 1])
    return [base] + [frame_variant(base, rng) for _ in range(n - 1)]
