"""DBSCAN-mode segmentation: oracle fidelity + roundtrip tests.

The oracle is a textbook euclidean DBSCAN (eps ball over the 3D points,
min_points incl. self, BFS expansion from cores in index order) matching the
reference's o3d ``cluster_dbscan`` semantics (utils/segment_utils.py:149-164).
The device version is window-limited on the pixel grid; fidelity is asserted
as partition agreement on active pixels (>=95% over fuzz scenes) and exact
single-cluster recovery of a long thin wall whose graph diameter far exceeds
any fixed sweep budget (pointer jumping converges in log rounds).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rpcc.config import CodecConfig
from rpcc.models.pipeline import RPCCCodec
from rpcc.ops.dbscan import FIRST_CLUSTER_ID, NOISE_ID, dbscan_range_image

from tests.test_roundtrip import SMALL, synth_scene


def dbscan_oracle(points: np.ndarray, eps: float, min_points: int) -> np.ndarray:
    """Labels (N,): -1 noise, 0.. clusters in discovery order."""
    n = points.shape[0]
    d2 = ((points[:, None, :] - points[None, :, :]) ** 2).sum(-1)
    nbr = d2 < eps * eps  # includes self
    core = nbr.sum(1) >= min_points
    labels = -np.ones(n, np.int64)
    cid = 0
    for i in range(n):
        if not core[i] or labels[i] != -1:
            continue
        stack = [i]
        labels[i] = cid
        while stack:
            j = stack.pop()
            if not core[j]:
                continue
            for k in np.nonzero(nbr[j])[0]:
                if labels[k] == -1:
                    labels[k] = cid
                    stack.append(k)
        cid += 1
    return labels


def partition_agreement(dev_labels: np.ndarray, orc_labels: np.ndarray) -> float:
    """Fraction of pixels whose device label maps to the oracle label under
    the majority correspondence (noise matches noise)."""
    assert dev_labels.shape == orc_labels.shape
    pairs = {}
    for d, o in zip(dev_labels, orc_labels):
        pairs[(d, o)] = pairs.get((d, o), 0) + 1
    # majority mapping device -> oracle
    best = {}
    for (d, o), c in pairs.items():
        if d not in best or c > best[d][1]:
            best[d] = (o, c)
    agree = sum(c for (d, o), c in pairs.items() if best[d][0] == o)
    return agree / dev_labels.size


_jitted_dbscan = jax.jit(
    lambda planes, active, eps: dbscan_range_image(planes, active, eps, 32)
)


def _device_labels(pc_grid: np.ndarray, active: np.ndarray, eps: float):
    planes = np.transpose(pc_grid, (2, 0, 1)).copy()
    return np.asarray(_jitted_dbscan(jnp.asarray(planes), jnp.asarray(active), eps))


def test_dbscan_components_basic():
    """Two well-separated blobs -> two clusters; tiny blob -> noise."""
    H, W = 16, 64
    pc = np.zeros((H, W, 3), np.float32)
    active = np.zeros((H, W), bool)
    for r in range(2, 6):
        for c in range(5, 16):
            pc[r, c] = [10 + 0.01 * r, 0.01 * c, 0]
            active[r, c] = True
    for r in range(9, 13):
        for c in range(30, 41):
            pc[r, c] = [0.01 * r, 20 + 0.01 * c, 0]
            active[r, c] = True
    # tiny blob C (under min_points): 4 px
    for c in range(50, 54):
        pc[14, c] = [5, 5, 3 + 0.01 * c]
        active[14, c] = True

    seg = _device_labels(pc, active, eps=1.5)
    assert set(seg[2:6, 5:16].reshape(-1)) == {3}  # row-major discovery order
    assert set(seg[9:13, 30:41].reshape(-1)) == {4}
    assert set(seg[14, 50:54]) == {2}  # noise
    assert (seg[~active] == 0).all()


def test_dbscan_long_wall_exact():
    """A 2x200-pixel wall: graph diameter ~200 — far beyond any fixed sweep
    budget — must come back as ONE cluster, exactly matching the oracle."""
    H, W = 16, 256
    hspace, vspace = 0.245, 0.3
    pc = np.zeros((H, W, 3), np.float32)
    active = np.zeros((H, W), bool)
    for r in (7, 8):
        for c in range(20, 220):
            pc[r, c] = [hspace * c, 14.0, vspace * r]
            active[r, c] = True
    eps = 1.5
    seg = _device_labels(pc, active, eps)
    dev = seg[active]
    assert (dev >= FIRST_CLUSTER_ID).all(), "wall split or marked noise"
    assert len(set(dev.tolist())) == 1, f"wall split into {len(set(dev.tolist()))} clusters"

    orc = dbscan_oracle(pc[active], eps, 10)
    assert (orc == 0).all(), "oracle itself should see one cluster"


def test_dbscan_fuzz_oracle_agreement():
    """20 random blob scenes: device partition agrees with the euclidean
    DBSCAN oracle on >=95% of active pixels."""
    H, W = 16, 128
    hspace, vspace = 0.245, 0.3
    worst = 1.0
    for t in range(20):
        rng = np.random.default_rng(100 + t)
        pc = np.zeros((H, W, 3), np.float32)
        active = np.zeros((H, W), bool)
        centers = rng.uniform(-30, 30, (rng.integers(2, 6), 3))
        centers[:, 2] = rng.uniform(-1, 2, centers.shape[0])
        for b, ctr in enumerate(centers):
            r0 = int(rng.integers(1, H - 5))
            c0 = int(rng.integers(1, W - 14))
            nr = int(rng.integers(2, 5))
            nc = int(rng.integers(4, 13))
            for r in range(r0, r0 + nr):
                for c in range(c0, c0 + nc):
                    if rng.random() < 0.85:
                        jitter = rng.normal(0, 0.02, 3)
                        pc[r, c] = ctr + [hspace * (c - c0), vspace * (r - r0), 0] + jitter
                        active[r, c] = True
        # isolated noise pixels
        for _ in range(6):
            r, c = int(rng.integers(0, H)), int(rng.integers(0, W))
            if not active[r, c]:
                pc[r, c] = rng.uniform(40, 80, 3)
                active[r, c] = True
        eps = 1.2
        seg = _device_labels(pc, active, eps)
        dev = seg[active]
        dev = np.where(dev == NOISE_ID, -1, dev)
        orc = dbscan_oracle(pc[active], eps, 10)
        score = partition_agreement(dev, orc)
        worst = min(worst, score)
        assert score >= 0.95, f"scene {t}: agreement {score:.3f}"
    print(f"worst-case agreement: {worst:.3f}")


def test_dbscan_roundtrip():
    cfg = CodecConfig(segment_method="DBSCAN", cluster_num=16)
    codec = RPCCCodec(SMALL, cfg)
    pc = synth_scene(seed=7)
    blob, _, _ = codec.compress(pc)
    pc_rec, ri_rec, _ = codec.decompress(blob)
    ri = np.asarray(codec.encode_device(pc).range_image)
    err = np.abs(ri_rec - ri)
    assert err.max() <= cfg.step + 1e-5
    assert (ri_rec[ri == 0] == 0).all()


def test_dispatch_stays_jnp_on_cpu():
    """dbscan_range_image is plain jnp on every backend: a 4x16 block of
    eps-connected pixels is one cluster with the first cluster id, and every
    inactive pixel stays 0."""
    H, W = 8, 32
    pc = np.zeros((H, W, 3), np.float32)
    active = np.zeros((H, W), bool)
    for r in range(2, 6):
        for c in range(4, 20):
            pc[r, c] = [0.2 * c, 10.0, 0.3 * r]
            active[r, c] = True
    planes = jnp.asarray(np.transpose(pc, (2, 0, 1)).copy())
    seg = np.asarray(dbscan_range_image(planes, jnp.asarray(active), 1.5, 8))
    np.testing.assert_array_equal(seg[active], FIRST_CLUSTER_ID)
    np.testing.assert_array_equal(seg[~active], 0)
