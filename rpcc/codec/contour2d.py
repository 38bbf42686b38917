"""Two-direction contour coding + flood-fill index (de)coder.

Parity port of the reference's dormant alternative seg-map codec
(``utils/contour_utils.py:8-175``): a (H, W, 2) right/bottom contour map plus
a flood-fill visit order that emits one index per connected region.  The
reference keeps it for experiments and visualization
(``compress_plane_idx_map(single_line=False)``); the production path is the
single-direction coder in ops/contour.py.  Host-side numpy: the flood fill is
inherently sequential and never on the hot path.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def extract_contour_double_direction(idx_map: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(H, W) ids -> ((H, W, 2) right/bottom contour, flood-fill idx sequence)."""
    row, col = idx_map.shape
    contour_map = np.ones((row, col, 2))
    row_dif = np.append(idx_map[1:, :] - idx_map[:-1, :], np.ones((1, col)), 0)
    bottom = np.ones((row, col))
    bottom[row_dif == 0] = 0
    col_dif = np.append(idx_map[:, 1:] - idx_map[:, :-1], np.ones((row, 1)), 1)
    right = np.ones((row, col))
    right[col_dif == 0] = 0
    contour_map[:, :, 0] = right
    contour_map[:, :, 1] = bottom
    seq = flood_fill_encode(contour_map, idx_map)
    return contour_map, seq


def recover_map_double_direction(contour_map: np.ndarray, idx_sequence: np.ndarray) -> np.ndarray:
    return flood_fill_decode(contour_map, idx_sequence)


def _neighbors(r: int, c: int, rows: int, cols: int, contour_map: np.ndarray, visited):
    """4-neighborhood moves not blocked by a contour edge (contour_utils.py:42-53)."""
    out = []
    if r > 0 and not visited[r - 1, c] and contour_map[r - 1, c, 1] == 0:
        out.append((r - 1, c))
    if c > 0 and not visited[r, c - 1] and contour_map[r, c - 1, 0] == 0:
        out.append((r, c - 1))
    if r < rows - 1 and not visited[r + 1, c] and contour_map[r, c, 1] == 0:
        out.append((r + 1, c))
    if c < cols - 1 and not visited[r, c + 1] and contour_map[r, c, 0] == 0:
        out.append((r, c + 1))
    return out


def flood_fill_encode(contour_map: np.ndarray, idx_map: np.ndarray) -> np.ndarray:
    rows, cols = idx_map.shape
    visited = np.zeros((rows, cols), bool)
    seq: List[int] = []
    for r in range(rows):
        for c in range(cols):
            if visited[r, c]:
                continue
            seq.append(int(idx_map[r, c]))
            stack = [(r, c)]
            while stack:
                cr, cc = stack.pop()
                visited[cr, cc] = True
                stack.extend(_neighbors(cr, cc, rows, cols, contour_map, visited))
    return np.asarray(seq)


def sorted_index_encoder(
    contour_map: np.ndarray, idx_map: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Visit-order id-remapping flood fill (``contour_utils.py:16-57``).

    Walks regions in row-major discovery order and renumbers each one
    1, 2, ... ("to make sure each block has different plane id"), so two
    disconnected regions sharing a cluster id become distinct.  Returns
    ``(sorted_idx_map, sorted_sequence, original_sequence)`` — decoding
    ``sorted_sequence`` with :func:`flood_fill_decode` reproduces
    ``sorted_idx_map`` exactly.
    """
    rows, cols = idx_map.shape
    visited = np.zeros((rows, cols), bool)
    sorted_map = np.array(idx_map, np.int32, copy=True)
    orig_seq: List[int] = []
    sorted_seq: List[int] = []
    n = 1
    for r in range(rows):
        for c in range(cols):
            if visited[r, c]:
                continue
            orig_seq.append(int(idx_map[r, c]))
            sorted_seq.append(n)
            stack = [(r, c)]
            while stack:
                cr, cc = stack.pop()
                visited[cr, cc] = True
                sorted_map[cr, cc] = n
                stack.extend(_neighbors(cr, cc, rows, cols, contour_map, visited))
            n += 1
    return sorted_map, np.asarray(sorted_seq), np.asarray(orig_seq)


def flood_fill_decode(contour_map: np.ndarray, idx_sequence: np.ndarray) -> np.ndarray:
    rows, cols = contour_map.shape[:2]
    visited = np.zeros((rows, cols), bool)
    idx_map = np.zeros((rows, cols), np.int32)
    k = 0
    for r in range(rows):
        for c in range(cols):
            if visited[r, c]:
                continue
            val = int(idx_sequence[k])
            stack = [(r, c)]
            while stack:
                cr, cc = stack.pop()
                visited[cr, cc] = True
                idx_map[cr, cc] = val
                stack.extend(_neighbors(cr, cc, rows, cols, contour_map, visited))
            k += 1
    return idx_map


def compress_plane_idx_map(plane_idx: np.ndarray, single_line: bool = True):
    """Reference ``compress_plane_idx_map`` (compress_utils.py:217-229)."""
    if single_line:
        import jax.numpy as jnp

        from rpcc.ops.contour import extract_contour

        code = extract_contour(jnp.asarray(plane_idx.astype(np.int32)))
        contour = np.asarray(code.contour).astype(bool)
        seq = np.asarray(code.sequence)[: int(code.seq_len)]
    else:
        contour, seq = extract_contour_double_direction(plane_idx)
        contour = contour.astype(bool)
    return np.packbits(contour, axis=None), seq
