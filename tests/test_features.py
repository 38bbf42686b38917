"""Feature extractor vs a direct numpy port of the reference C++ loop
(cpp_modules.cpp:28-121), including its inert mark_as_picked suppression."""

import numpy as np
import jax.numpy as jnp

from rpcc.ops.features import (
    extract_features_with_segment,
    salience_levels,
)

NEAR, GAP = 0.2, 0.3


def numpy_reference_features(ri, valid, region, segments, sharp, less_sharp, flat):
    """Behavioral port of extract_features_with_segment (cpp:28-121)."""
    h, w = ri.shape
    flat_ri = ri.reshape(-1)
    feat_map = np.zeros((h, w), np.float32)
    kp = np.zeros((h, w), np.int32)
    picked = np.zeros((h, w), np.int32)

    def mark(h_i, w_i):
        r = flat_ri[h_i * w + w_i]
        ok = True
        for i in range(-region, region + 1):
            j = min(max(h_i * w + w_i + i, 0), h * w - 1)  # clamp like ours
            dif = r - flat_ri[j]
            if abs(dif) < NEAR:
                picked[h_i, w_i] = 1
            if dif > GAP:
                ok = False
        return ok

    for h_i in range(h):
        vr = [float(ri[h_i, w_i]) for w_i in range(w) if valid[h_i, w_i]]
        vi = [w_i for w_i in range(w) if valid[h_i, w_i]]
        L = len(vi)
        if L < segments + region * 2 + 1:
            continue
        entries = []  # (feat, entry_index)
        for s in range(region, L - region):
            acc = 0.0
            for k in range(-region, region + 1):
                acc += vr[s + k] - vr[s]
            f = np.float32(acc * acc / (2 * region) / vr[s])
            feat_map[h_i, vi[s]] = f
            entries.append([f, s])
        nfeat = len(entries)
        for j in range(segments):
            sp = (nfeat // segments) * j
            ep = (nfeat // segments) * (j + 1)
            sector = sorted(entries[sp:ep], key=lambda e: (e[0], e[1]))
            # sharp: iterate desc
            cnt = 0
            stop = len(sector)
            for i in range(len(sector) - 1, -1, -1):
                idx = sector[i][1]
                sector[i][0] = 0.0
                if picked[h_i, vi[idx]] == 0 and mark(h_i, vi[idx]):
                    cnt += 1
                    if cnt < sharp:
                        kp[h_i, vi[idx]] = 3
                    elif cnt < less_sharp:
                        kp[h_i, vi[idx]] = 2
                    else:
                        stop = i
                        break
            # flat: re-sort asc, skip zeroed
            sector = sorted(sector, key=lambda e: (e[0], e[1]))
            cnt = 0
            for i in range(len(sector)):
                if sector[i][0] == 0:
                    continue
                idx = sector[i][1]
                sector[i][0] = 0.0
                if picked[h_i, vi[idx]] == 0 and mark(h_i, vi[idx]):
                    cnt += 1
                    if cnt < flat:
                        kp[h_i, vi[idx]] = 1
                    else:
                        break
    return feat_map, kp


def make_scene(seed=0, h=8, w=160):
    rng = np.random.default_rng(seed)
    # smooth-ish depth with structure: walls + bumps + holes
    base = 10 + 3 * np.sin(np.linspace(0, 8, w))[None, :] + rng.normal(0, 0.05, (h, w))
    ri = base.astype(np.float32)
    seg = rng.integers(2, 6, (h, w)).astype(np.int32)
    # carve ground rows and holes
    seg[:2] = 0
    holes = rng.random((h, w)) < 0.08
    ri[holes] = 0.0
    seg[holes] = 1
    # a few sharp discontinuities
    ri[:, 60:80] += 4.0
    return ri, seg


def test_features_match_reference_port():
    ri, seg = make_scene()
    valid = (seg != 0) & (seg != 1)
    ref_feat, ref_kp = numpy_reference_features(ri, valid, 3, 8, 4, 8, 6)
    feat, kp = extract_features_with_segment(jnp.asarray(ri), jnp.asarray(seg))
    feat, kp = np.asarray(feat), np.asarray(kp)

    np.testing.assert_allclose(feat, ref_feat, rtol=2e-3, atol=1e-5)
    # Labels must agree except where float tie-order flips ranking at the
    # sector boundary; require near-exact agreement.
    agree = (kp == ref_kp).mean()
    assert agree > 0.999, f"kp agreement {agree}"
    assert (ref_kp > 0).sum() > 20  # scene actually produced keypoints


def test_features_several_seeds():
    for seed in range(1, 4):
        ri, seg = make_scene(seed)
        valid = (seg != 0) & (seg != 1)
        _, ref_kp = numpy_reference_features(ri, valid, 3, 8, 4, 8, 6)
        _, kp = extract_features_with_segment(jnp.asarray(ri), jnp.asarray(seg))
        assert (np.asarray(kp) == ref_kp).mean() > 0.995


def test_salience_levels():
    hw = 1000
    rng = np.random.default_rng(1)
    seg = rng.integers(0, 6, hw).astype(np.int32)
    kp = np.zeros(hw, np.int32)
    # cluster 2: >=30 kp; cluster 3: 5 kp; cluster 4: 0 kp; cluster 5: tiny
    kp[np.where(seg == 2)[0][:40]] = 3
    kp[np.where(seg == 3)[0][:5]] = 2
    seg[np.where(seg == 5)[0][20:]] = 4  # shrink cluster 5 under 30 px
    counts = np.bincount(seg, minlength=6)
    lvl = np.asarray(
        salience_levels(
            jnp.asarray(kp), jnp.asarray(seg), jnp.asarray(counts), 6,
            level_kp_num=(30, 10, 3, 0), ground_level=2,
        )
    )
    assert lvl[0] == 2  # ground fixed
    assert lvl[1] == 3  # zero class -> last
    assert lvl[2] == 0  # 40 kp >= 30
    assert lvl[3] == 2  # 5 kp >= 3
    assert lvl[4] == 3  # 0 kp -> last threshold 0 -> level 3
    assert lvl[5] == 3  # tiny cluster -> last
