"""Lossless contour coding of the segmentation map — on device.

The reference encodes the seg map as a 1-bit-per-pixel "new run starts here"
mask plus the run values (``contour_utils_cpp.extract_contour``,
``cpp_modules.cpp:521-558``): contour=1 at column 0 of every row and wherever
the id differs from the left neighbor; the id value is emitted at each
contour=1 position in row-major order.

Device formulation: the contour mask is a shifted compare; the run-value
sequence is a stable-sort compaction (front-pack flagged pixels, no
position scatter); and the decoder's run-length fill
(``cpp_modules.cpp:561-593``) scatters only the ~seq_len run *deltas* and
integrates with one cumsum — never a (HW,)-sized gather or scatter.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from rpcc.ops.stream import compact_flagged_positions, compact_flagged_small


class ContourCode(NamedTuple):
    contour: jnp.ndarray  # (H, W) int32 {0, 1}
    sequence: jnp.ndarray  # (HW,) int32, first ``seq_len`` entries valid
    seq_len: jnp.ndarray  # () int32


def extract_contour(seg: jnp.ndarray) -> ContourCode:
    H, W = seg.shape
    left = jnp.concatenate([jnp.full((H, 1), -1, seg.dtype), seg[:, :-1]], axis=1)
    contour = (seg != left).astype(jnp.int32)
    contour = contour.at[:, 0].set(1)  # row starts are always contour points
    cflat = contour.reshape(-1)
    sflat = seg.reshape(-1).astype(jnp.int32)
    sequence, seq_len = compact_flagged_small(cflat, sflat)  # seg ids < 2^12
    hw = cflat.shape[0]
    live = jnp.arange(hw) < seq_len
    return ContourCode(contour, jnp.where(live, sequence, 0), seq_len)


def pack_bits_msb(bits: jnp.ndarray) -> jnp.ndarray:
    """np.packbits(axis=None) equivalent on device: (...,) {0,1} -> (ceil(N/8),) u8.

    One (ceil(N/8), 8) @ (8,) contraction instead of a 2MB/frame download of
    raw bit bytes.  A ragged tail (N % 8 != 0 — geometries whose H*W is not
    a byte multiple) is zero-padded exactly like np.packbits, so the packed
    bytes stay byte-identical to the host encoder's.
    """
    flat = bits.reshape(-1).astype(jnp.int32)
    n = flat.shape[0]
    if n % 8:
        flat = jnp.concatenate([flat, jnp.zeros(((-n) % 8,), jnp.int32)])
    weights = jnp.asarray([128, 64, 32, 16, 8, 4, 2, 1], jnp.int32)
    return jnp.sum(flat.reshape(-1, 8) * weights, axis=-1).astype(jnp.uint8)


def unpack_bits_msb(packed: jnp.ndarray, n_bits: int) -> jnp.ndarray:
    """Inverse of :func:`pack_bits_msb` -> (n_bits,) int32 {0,1}."""
    shifts = jnp.asarray([7, 6, 5, 4, 3, 2, 1, 0], jnp.int32)
    bits = (packed.astype(jnp.int32)[:, None] >> shifts) & 1
    return bits.reshape(-1)[:n_bits]


def recover_map(contour: jnp.ndarray, sequence: jnp.ndarray) -> jnp.ndarray:
    """Invert :func:`extract_contour`.  ``sequence`` may be tail-padded.

    Scatter the per-run value deltas at the run-start pixels, then cumsum:
    only ~seq_len elements are scattered and the fill is one parallel scan.
    """
    H, W = contour.shape
    hw = H * W
    cflat = contour.reshape(-1).astype(jnp.int32)
    iota = jnp.arange(hw, dtype=jnp.int32)
    # ``pos`` is a full permutation: run-start pixels first (ascending), then
    # the remaining pixels (ascending) — so placing the run deltas back at
    # their pixels is a sort by ``pos``, not a scatter.
    pos, n = compact_flagged_positions(cflat)
    seq = sequence.astype(jnp.int32)
    diffs = jnp.concatenate([seq[:1], seq[1:] - seq[:-1]])
    if diffs.shape[0] < hw:  # bucketed upload: tail runs cannot exist
        diffs = jnp.concatenate(
            [diffs, jnp.zeros((hw - diffs.shape[0],), jnp.int32)]
        )
    diffs = jnp.where(iota < n, diffs, 0)
    _, base = jax.lax.sort((pos, diffs), num_keys=1, is_stable=True)
    return jnp.cumsum(base).reshape(H, W)
