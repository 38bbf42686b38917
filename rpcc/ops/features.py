"""LOAM-style feature extraction + salience levels (non-uniform mode).

Replaces ``feature_extractor_cpp.extract_features[_with_segment]``
(``cpp_modules.cpp:28-223``): per row, compact the valid pixels, compute the
curvature ``(sum_{|k|<=r}(v[s+k]-v[s]))^2 / (2r * v[s])``, then per sector
pick top-curvature "sharp" points and bottom-curvature "flat" points subject
to an occlusion (gap) check.

The reference's selection loop is sequential with stateful bookkeeping, but
its observable behavior reduces to rank tests (verified against a direct port
in the tests):

  * ``mark_as_picked`` is an inert no-op for selection — it always marks the
    candidate itself (the ``i = 0`` neighbor difference is 0 < 0.2,
    ``cpp_modules.cpp:16-20``), never its neighbors, and each pixel is visited
    at most once per phase — so only its *return value* (the gap check:
    reject if the candidate is > 0.3 farther than any neighbor within +-r
    original columns, read off the **raw flat range buffer**, wrapping across
    row ends, ``:17,21-22``) affects the output.
  * sharp phase: in (curvature desc, entry desc) order, gap-passing entries
    ranked 1..sharp_num-1 get label 3, sharp_num..less_sharp_num-1 get label
    2; the loop breaks on the less_sharp_num-th passing entry, so entries
    beyond it are never *visited* (``:81-95``).
  * flat phase: among never-visited entries with nonzero curvature, in
    (curvature asc, entry asc) order, gap-passing entries ranked
    1..flat_num-1 get label 1 (``:97-112``).

On device both phases become one global 3-key ``lax.sort`` over (row x sector)
groups plus segmented cumsums.  No (HW,)-sized gathers or scatters survive:
neighbor reads are static clamped shifts, row compaction carries every
needed plane through its sort, per-group cumsum bases expand by telescoping
diffs over the contiguous sorted groups, and the few thousand key-point
labels scatter through a capped compaction.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

NEAR_THRESHOLD = 0.2  # cpp_modules.cpp:11 (inert, see module docstring)
GAP_THRESHOLD = 0.3  # cpp_modules.cpp:11


def _shift_clamp_axis1(x: jnp.ndarray, i: int) -> jnp.ndarray:
    """x[:, clip(j+i, 0, W-1)] as static slices (no gather)."""
    if i == 0:
        return x
    if i > 0:
        tail = jnp.repeat(x[:, -1:], i, axis=1)
        return jnp.concatenate([x[:, i:], tail], axis=1)
    head = jnp.repeat(x[:, :1], -i, axis=1)
    return jnp.concatenate([head, x[:, :i]], axis=1)


def _shift_clamp_flat(x: jnp.ndarray, i: int) -> jnp.ndarray:
    """x[clip(j+i, 0, n-1)] as static slices."""
    if i == 0:
        return x
    if i > 0:
        return jnp.concatenate([x[i:], jnp.repeat(x[-1:], i)])
    return jnp.concatenate([jnp.repeat(x[:1], -i), x[:i]])


def _row_compact(values, cols_payload, valid):
    """Per-row stable compaction of valid pixels — one row-wise sort
    (valid-first, column order preserved) carrying an extra payload.

    Returns (compacted values, compacted payload, original column per slot,
    per-row valid count)."""
    H, W = values.shape
    col_iota = jnp.broadcast_to(jnp.arange(W, dtype=jnp.int32), (H, W))
    key = jnp.where(valid, col_iota, W + col_iota)  # invalid pushed back, stable
    _, comp, pay, cols = jax.lax.sort(
        (key, values, cols_payload, col_iota), dimension=1, num_keys=1, is_stable=True
    )
    counts = jnp.sum(valid.astype(jnp.int32), axis=1)
    comp = jnp.where(col_iota < counts[:, None], comp, 0)
    return comp, pay, cols, counts


def _gap_ok(range_image: jnp.ndarray, feature_region: int) -> jnp.ndarray:
    """Occlusion check per pixel on the raw flat buffer (cpp:16-22).

    The C++ reads ``ri[h*W + w + i]`` without bounds checks — neighbors wrap
    across row ends into adjacent rows; we clamp at the image boundary (the
    only place the C++ behavior is undefined).  Static shifts, no gather.
    """
    H, W = range_image.shape
    flat = range_image.reshape(-1)
    ok = jnp.ones(flat.shape, bool)
    for i in range(-feature_region, feature_region + 1):
        nbr = _shift_clamp_flat(flat, i)
        ok = ok & ((flat - nbr) <= GAP_THRESHOLD)
    return ok.reshape(H, W)


def _expand_at_starts(vals: jnp.ndarray, starts: jnp.ndarray, n: int) -> jnp.ndarray:
    """Piecewise-constant int expansion over contiguous sorted groups:
    telescoping-diff scatter (len(vals) writes) + cumsum."""
    diffs = jnp.concatenate([vals[:1], vals[1:] - vals[:-1]])
    base = jnp.zeros((n,), vals.dtype).at[starts].add(diffs, mode="drop")
    return jnp.cumsum(base)


def _extract(
    range_image: jnp.ndarray,
    valid: jnp.ndarray,
    feature_region: int,
    segments: int,
    sharp_num: int,
    less_sharp_num: int,
    flat_num: int,
    want_feature_map: bool = True,
) -> Tuple[Optional[jnp.ndarray], jnp.ndarray]:
    H, W = range_image.shape
    hw = H * W
    r = feature_region

    gap = _gap_ok(range_image, r)
    vri, vgap, vcol, counts = _row_compact(
        range_image, gap.astype(jnp.int32), valid
    )  # all (H, W) in slot space, + (H,)
    row_ok = counts >= segments + 2 * r + 1  # cpp:59-60

    # Curvature over compacted slots via prefix sums: win(s) = sum v[s-r..s+r].
    pad = jnp.zeros((H, r), vri.dtype)
    vpad = jnp.concatenate([pad, vri, pad], axis=1)
    csum = jnp.cumsum(vpad, axis=1)
    zero = jnp.zeros((H, 1), vri.dtype)
    csum = jnp.concatenate([zero, csum], axis=1)
    win = csum[:, 2 * r + 1 :] - csum[:, : W]  # (H, W): win[s] over v[s-r..s+r]

    safe_v = jnp.where(vri != 0, vri, 1.0)
    diff = win - (2 * r + 1) * vri
    feat = diff * diff / (2.0 * r) / safe_v  # (H, W) indexed by slot s

    # Entries: t = s - r for s in [r, L-r).  n = L - 2r entries per row.
    n = jnp.maximum(counts - 2 * r, 0)  # (H,)
    sector_w = n // segments  # cpp:76-77 floor(n/segments)
    t = jnp.broadcast_to(jnp.arange(W, dtype=jnp.int32), (H, W))  # entry id
    entry_valid = (t < sector_w[:, None] * segments) & (sector_w[:, None] > 0) & row_ok[:, None]
    # Entries past the last full sector exist but belong to no sector
    # (cpp:76-77 floor arithmetic) — they still emit curvature (cpp:71).
    entry_exists = (t < n[:, None]) & row_ok[:, None]
    sec = jnp.where(entry_valid, t // jnp.maximum(sector_w, 1)[:, None], segments)

    # Entry views of slot-space planes: slot s = t + r -> static shift by +r.
    efeat = _shift_clamp_axis1(feat, r)
    ecol = _shift_clamp_axis1(vcol, r)  # original column of the entry
    epass = (_shift_clamp_axis1(vgap, r) > 0) & entry_valid

    pix_grid = jnp.arange(H, dtype=jnp.int32)[:, None] * W + ecol

    feat_flat = None
    if want_feature_map:
        # Feature map at original pixels (feat_ptr[h*W + valid_idx[s]], cpp:71).
        feat_flat = jnp.zeros((hw,), jnp.float32)
        feat_flat = feat_flat.at[
            jnp.where(entry_exists, pix_grid, hw).reshape(-1)
        ].set(efeat.reshape(-1), mode="drop")

    # Group = row * segments + sector (invalid entries -> trailing group).
    grp = jnp.where(
        entry_valid,
        jnp.arange(H, dtype=jnp.int32)[:, None] * segments + sec,
        H * segments,
    )
    num_groups = H * segments + 1

    # One global sort: group asc, curvature desc, entry desc  (the C++ sorts
    # (feat, s_i) ascending and iterates backwards, cpp:80-83).
    g = grp.reshape(-1)
    f = efeat.reshape(-1)
    tt = t.reshape(-1)
    p = epass.reshape(-1)
    pix = pix_grid.reshape(-1)
    ev = entry_valid.reshape(-1)
    g_s, _, _, f_s, p_s, pix_s, ev_s = jax.lax.sort(
        (g, -f, -tt, f, p.astype(jnp.int32), pix, ev.astype(jnp.int32)), num_keys=3
    )
    p_s = p_s.astype(bool)
    ev_s = ev_s.astype(bool)

    # Group starts via searchsorted on the sorted keys (no segment_sum).
    gids = jnp.arange(num_groups, dtype=jnp.int32)
    grp_start = jnp.searchsorted(g_s, gids, side="left").astype(jnp.int32)

    # Segmented cumsum of passing entries in sharp (desc) order; the per-slot
    # group base expands by telescoping diffs (groups are contiguous).
    pass_i = p_s.astype(jnp.int32)
    csum_p = jnp.cumsum(pass_i)
    base_g = jnp.where(grp_start > 0, csum_p[jnp.maximum(grp_start - 1, 0)], 0)
    cum_in_grp = csum_p - _expand_at_starts(base_g, grp_start, hw)

    label3 = p_s & (cum_in_grp <= sharp_num - 1)
    label2 = p_s & (cum_in_grp >= sharp_num) & (cum_in_grp <= less_sharp_num - 1)
    visited = (cum_in_grp - pass_i) < less_sharp_num  # processed before break

    # Flat phase operates in reversed (asc) order on unvisited nonzero-feat
    # entries; compute ascending ranks from descending cumsums.
    cand = (~visited) & (f_s != 0) & ev_s
    fc = (cand & p_s).astype(jnp.int32)
    csum_f = jnp.cumsum(fc)
    base_f = jnp.where(grp_start > 0, csum_f[jnp.maximum(grp_start - 1, 0)], 0)
    cum_f = csum_f - _expand_at_starts(base_f, grp_start, hw)
    end_f = jnp.concatenate([grp_start[1:], jnp.full((1,), hw, jnp.int32)])
    total_per_group = (
        jnp.where(end_f > 0, csum_f[jnp.maximum(end_f - 1, 0)], 0) - base_f
    )
    total_f = _expand_at_starts(total_per_group, grp_start, hw)
    asc_rank = total_f - cum_f + fc  # 1-based among flat candidates, asc order
    label1 = cand & p_s & (asc_rank <= flat_num - 1)

    # Scatter the (few thousand) labels through a capped compaction: at most
    # (sharp-1)+(less_sharp-sharp)+(flat-1) labels per sector.
    kp_val = jnp.where(label3, 3, jnp.where(label2, 2, jnp.where(label1, 1, 0)))
    cap = H * segments * (less_sharp_num - 1 + flat_num - 1)
    cap = min(cap, hw)
    flags = (kp_val > 0) & ev_s
    _, pix_c, val_c = jax.lax.sort(
        ((~flags).astype(jnp.int32), pix_s, kp_val), num_keys=1, is_stable=True
    )
    n_lab = jnp.sum(flags.astype(jnp.int32))
    dest = jnp.where(jnp.arange(cap) < n_lab, pix_c[:cap], hw)
    kp_flat = jnp.zeros((hw,), jnp.int32).at[dest].set(val_c[:cap], mode="drop")

    feat_map = None if feat_flat is None else feat_flat.reshape(H, W)
    return feat_map, kp_flat.reshape(H, W)


def extract_features(
    range_image: jnp.ndarray,
    feature_region: int = 3,
    segments: int = 8,
    sharp_num: int = 4,
    less_sharp_num: int = 8,
    flat_num: int = 6,
    want_feature_map: bool = True,
) -> Tuple[Optional[jnp.ndarray], jnp.ndarray]:
    """Whole-image variant (valid = nonzero pixels), cpp:125-223."""
    return _extract(
        range_image, range_image != 0, feature_region, segments, sharp_num,
        less_sharp_num, flat_num, want_feature_map,
    )


def extract_features_with_segment(
    range_image: jnp.ndarray,
    seg_idx: jnp.ndarray,
    feature_region: int = 3,
    segments: int = 8,
    sharp_num: int = 4,
    less_sharp_num: int = 8,
    flat_num: int = 6,
    want_feature_map: bool = True,
) -> Tuple[Optional[jnp.ndarray], jnp.ndarray]:
    """Post-segmentation variant (valid = non-ground, non-zero), cpp:28-121."""
    valid = (seg_idx != 0) & (seg_idx != 1)
    return _extract(
        range_image, valid, feature_region, segments, sharp_num,
        less_sharp_num, flat_num, want_feature_map,
    )


def salience_levels_from_counts(
    kp_cnt: jnp.ndarray,  # (num_models,) per-cluster key-point counts
    counts: jnp.ndarray,  # (num_models,) per-cluster pixel counts
    level_kp_num: Tuple[int, ...],
    ground_level: int,
) -> jnp.ndarray:
    """Per-cluster salience level (cpp_modules.cpp:388-404).

    ground -> ground_level; zero class and clusters under 30 pixels -> last
    level; else the first level whose key-point threshold is met (the last
    threshold is 0, so one always matches).
    """
    num_levels = len(level_kp_num)
    thresholds = jnp.asarray(level_kp_num, dtype=jnp.int32)  # (L,)
    meets = kp_cnt[:, None] >= thresholds[None, :]  # (C, L)
    first = jnp.argmax(meets, axis=1).astype(jnp.int32)  # first True, or 0 like C++ init
    lvl = jnp.where(counts < 30, num_levels - 1, first)
    lvl = lvl.at[0].set(ground_level)
    lvl = lvl.at[1].set(num_levels - 1)
    return lvl


def salience_levels(
    kp_flat: jnp.ndarray,  # (HW,) key-point labels
    seg_flat: jnp.ndarray,  # (HW,) cluster ids
    counts: jnp.ndarray,  # (num_models,) per-cluster pixel counts
    num_models: int,
    level_kp_num: Tuple[int, ...],
    ground_level: int,
) -> jnp.ndarray:
    """Pixel-space convenience wrapper around
    :func:`salience_levels_from_counts` (uses a segment_sum; the encoder's
    stream path computes the counts with a cumsum instead)."""
    kp_cnt = jax.ops.segment_sum(
        (kp_flat > 0).astype(jnp.int32), seg_flat.astype(jnp.int32), num_segments=num_models
    )
    return salience_levels_from_counts(kp_cnt, counts, level_kp_num, ground_level)
