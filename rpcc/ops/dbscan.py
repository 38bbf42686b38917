"""Euclidean DBSCAN of non-ground pixels — on device.

The reference's DBSCAN mode (``utils/segment_utils.py:149-164``) runs o3d's
euclidean DBSCAN (eps, min_points=10) over the non-ground points (|ground
depth residual| > 0.5) and labels: 0=ground, 1=zero pixels, 2=noise,
3..=clusters (after the +2 shift at ``:161`` and the +1 relabel at ``:168``).

Device formulation: on a *range image* the eps-neighbor graph is local — any
eps-ball neighbor of a pixel falls within a small pixel window (LiDAR angular
spacing) — so DBSCAN becomes three data-parallel stages:

1. **core rule**: count active neighbors within eps in the window; a pixel is
   core iff ``count + 1 >= min_points`` (the point itself counts, like o3d);
2. **connected components over core pixels**: iterative min-label hooking
   with **row/column segmented-min scans** (labels flood whole horizontally/
   vertically linked runs in ONE ``associative_scan`` sweep — the killer
   case is a 2000-px wall, which pure neighbor hooking crosses 3 px per
   sweep) plus pointer jumping, inside a convergence-checked
   ``lax.while_loop``; real scenes converge in a handful of sweeps;
3. **border attachment**: a non-core active pixel joins the min-labeled core
   neighbor within eps; remaining active pixels are noise.

Cluster ids are assigned by ascending root pixel index = row-major discovery
order.  The pixel window bounds the eps graph (nearby points can have
eps-neighbors many pixels away); encoder/decoder always agree since both use
the produced seg map — fidelity vs the point-set oracle is property-tested in
tests/test_dbscan.py.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

MIN_POINTS = 10  # utils/segment_utils.py:152
NOISE_ID = 2  # final id of DBSCAN noise
FIRST_CLUSTER_ID = 3  # final id of the first cluster
WINDOW = 3  # pixel window for eps-connectivity


def _neighbor_shifts(window: int) -> Tuple[Tuple[int, int], ...]:
    out = []
    for dr in range(-window, window + 1):
        for dc in range(-window, window + 1):
            if (dr, dc) != (0, 0):
                out.append((dr, dc))
    return tuple(out)


def _shift(arr: jnp.ndarray, dr: int, dc: int, fill):
    """Value of the (r+dr, c+dc) neighbor at each pixel: column-circular (the
    image wraps in azimuth), row-clamped with ``fill``."""
    H = arr.shape[0]
    out = jnp.roll(arr, (-dr, -dc), axis=(0, 1))
    if dr > 0:
        out = out.at[H - dr :, :].set(fill)
    elif dr < 0:
        out = out.at[: -dr, :].set(fill)
    return out


def dbscan_range_image(
    point_planes: jnp.ndarray,  # (3, H, W) planar x/y/z
    active: jnp.ndarray,  # (H, W) bool: non-ground, non-zero pixels
    eps: float,
    max_clusters: int,
    min_points: int = MIN_POINTS,
    window: int = WINDOW,
) -> jnp.ndarray:
    """Cluster ids for active pixels: NOISE_ID or FIRST_CLUSTER_ID + k
    (k < max_clusters, ordered by row-major discovery); inactive pixels 0.

    Components beyond ``max_clusters`` (rare: o3d typically finds far fewer
    than the model-table budget) collapse to noise.
    """
    H, W = active.shape
    hw = H * W
    eps2 = eps * eps

    shifts = _neighbor_shifts(window)
    px, py, pz = point_planes[0], point_planes[1], point_planes[2]
    # Per-shift eps-connectivity between active pixels.
    conns = []
    for dr, dc in shifts:
        nb_act = _shift(active, dr, dc, False)
        dx = px - _shift(px, dr, dc, jnp.inf)
        dy = py - _shift(py, dr, dc, 0.0)
        dz = pz - _shift(pz, dr, dc, 0.0)
        d2 = dx * dx + dy * dy + dz * dz
        conns.append(active & nb_act & (d2 < eps2))
    conn = jnp.stack(conns)  # (S, H, W)

    # Core rule: |eps-neighborhood| (incl. the point itself) >= min_points.
    ncount = jnp.sum(conn.astype(jnp.int32), axis=0)
    core = active & (ncount + 1 >= min_points)

    # Connected components over core-core edges.
    iota = jnp.arange(hw, dtype=jnp.int32).reshape(H, W)
    labels = jnp.where(core, iota, hw)
    core_edge = jnp.stack(
        [conn[i] & core & _shift(core, dr, dc, False) for i, (dr, dc) in enumerate(shifts)]
    )

    def hook(lab):
        best = lab
        for i, (dr, dc) in enumerate(shifts):
            nb = _shift(lab, dr, dc, hw)
            best = jnp.where(core_edge[i], jnp.minimum(best, nb), best)
        return best

    def shortcut(lab):
        flat = lab.reshape(-1)
        jumped = flat[jnp.minimum(flat, hw - 1)]
        return jnp.where(flat < hw, jumped, hw).reshape(H, W)

    # Run links for the segmented scans: adjacent-pixel core edges.
    i01 = shifts.index((0, 1))
    i10 = shifts.index((1, 0))
    lp_col = jnp.concatenate(
        [jnp.zeros((H, 1), bool), core_edge[i01][:, :-1]], axis=1
    )  # pixel (r,c) linked to (r,c-1)
    lp_row = jnp.concatenate(
        [jnp.zeros((1, W), bool), core_edge[i10][:-1, :]], axis=0
    )  # pixel (r,c) linked to (r-1,c)

    def _run_min(lab, linked_prev):
        """Min label over maximal linked runs along axis 1 (segmented
        forward+backward associative min scans — one sweep floods a whole
        run, however long)."""

        def comb(a, b):
            va, sa = a
            vb, sb = b
            return jnp.where(sb, vb, jnp.minimum(va, vb)), sa | sb

        start = ~linked_prev
        fwd, _ = jax.lax.associative_scan(comb, (lab, start), axis=1)
        lab_f = jnp.flip(lab, 1)
        lp_f = jnp.flip(linked_prev, 1)
        start_b = ~jnp.concatenate([jnp.zeros_like(lp_f[:, :1]), lp_f[:, :-1]], 1)
        bwd, _ = jax.lax.associative_scan(comb, (lab_f, start_b), axis=1)
        return jnp.minimum(fwd, jnp.flip(bwd, 1))

    def cond(state):
        return state[1]

    def body(state):
        lab, _ = state
        new = hook(lab)
        new = _run_min(new, lp_col)  # flood along rows
        new = _run_min(new.T, lp_row.T).T  # flood along columns
        new = shortcut(shortcut(new))
        return new, jnp.any(new != lab)

    labels, _ = jax.lax.while_loop(cond, body, (labels, jnp.asarray(True)))

    # Border attachment: min-labeled core neighbor within eps.
    border = jnp.full((H, W), hw, jnp.int32)
    for i, (dr, dc) in enumerate(shifts):
        nb_lab = _shift(labels, dr, dc, hw)
        nb_core = _shift(core, dr, dc, False)
        border = jnp.where(conn[i] & nb_core, jnp.minimum(border, nb_lab), border)
    labels = jnp.where(core, labels, jnp.where(active, border, hw))
    return _compact_labels(labels, active, max_clusters)


def _compact_labels(
    labels: jnp.ndarray,  # (H, W) root-pixel-index labels, hw = unlabeled
    active: jnp.ndarray,
    max_clusters: int,
) -> jnp.ndarray:
    """Discovery-order compaction: roots ascending == row-major first pixel.

    A converged min-label forest labels each root with its own index, so
    roots are found elementwise (no scatter); the only remaining gather is
    the per-pixel rank lookup."""
    H, W = active.shape
    hw = H * W
    flat = labels.reshape(-1)
    iota = jnp.arange(hw, dtype=flat.dtype)
    is_root = (flat == iota) & (flat < hw)
    rank = jnp.cumsum(is_root.astype(jnp.int32)) - 1  # rank of each root id
    r = rank[jnp.minimum(flat, hw - 1)]
    cluster_id = jnp.where(
        (flat < hw) & (r < max_clusters),
        FIRST_CLUSTER_ID + r,
        jnp.where(active.reshape(-1), NOISE_ID, 0),
    )
    return cluster_id.reshape(H, W).astype(jnp.int32)
