"""The i8-delta + exception wire code, shared by every reduced-transfer path.

One format, four users: the encode uplink ships it host->device (d8 over the
full grid, m8 over the masked-compact nonzero stream) and the decode
downlink ships it device->host (same two layouts, built in-graph).  The
format: first-differences of a u16 snap grid as i8; positions where the
delta stream resets (row starts / first live pixel of a row) or the diff
leaves i8 range become (position-delta u16, grid-value u16) exceptions.

``invert_delta_exceptions`` is the graph-side decoder of the code (encode
uplink), ``build_delta_exception_wire`` the graph-side encoder (decode
downlink); both are pure cumsum/scatter formulations — no sorts, no random
gathers.  Host-side counterparts:
``ops/projection.py::project_points_host_{d8,m8}`` (encoders) and
``codec/native/decode.cpp::{d8,m8}_reconstruct_batch`` (decoders).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp


def invert_delta_exceptions(
    deltas_i32: jnp.ndarray,  # (N,) i32 first-differences (0 at exceptions)
    exc_pd: jnp.ndarray,  # (cap,) u16 exception position deltas
    exc_val: jnp.ndarray,  # (cap,) u16 exception grid values
    n_exc: jnp.ndarray,  # () i32 live exception count
) -> jnp.ndarray:
    """-> (N,) i32 reconstructed grid values, exact integer math.

    ``C = cumsum(deltas)``; at each exception ``e`` the true value is
    ``exc_val[e]``, so a correction ``K_e = exc_val[e] - C[pos_e]`` holds
    from ``e`` to the next exception — scatter the K telescoping diffs and
    cumsum (reset exceptions at every row start stop the flat cumsum from
    leaking across rows)."""
    n = deltas_i32.shape[0]
    C = jnp.cumsum(deltas_i32)
    cap = exc_pd.shape[0]
    live_e = jnp.arange(cap) < n_exc
    pos = jnp.cumsum(exc_pd.astype(jnp.int32)) - 1
    pos = jnp.where(live_e, pos, n)
    Cp = jnp.concatenate([C, jnp.zeros((1,), jnp.int32)])
    K = jnp.where(live_e, exc_val.astype(jnp.int32) - Cp[pos], 0)
    Kd = jnp.concatenate([K[:1], K[1:] - K[:-1]])
    return C + jnp.cumsum(jnp.zeros((n,), jnp.int32).at[pos].add(Kd, mode="drop"))


def build_delta_exception_wire(
    q: jnp.ndarray,  # (N,) i32 grid values
    reset_mask: jnp.ndarray,  # (N,) bool forced exceptions (row starts)
    cap: int,  # exception capacity (slots past n_exc hold junk)
    live_mask: Optional[jnp.ndarray] = None,  # (N,) bool: gate exceptions
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """-> (d8 (N,) i8, pd (cap,) u16, val (cap,) u16, n_exc () i32).

    Compaction is one cumsum + two sorted scatters; positions are visited
    in order so the exception list comes out position-sorted for free.
    ``pd[e] = pos[e] - pos[e-1]`` with ``pos[-1] = -1`` (the host encoders'
    convention)."""
    n = q.shape[0]
    diff = q - jnp.concatenate([jnp.zeros((1,), jnp.int32), q[:-1]])
    exc = reset_mask | (diff < -128) | (diff > 127)
    if live_mask is not None:
        exc = exc & live_mask
    d8 = jnp.where(exc, 0, diff).astype(jnp.int8)
    n_exc = exc.sum().astype(jnp.int32)
    slot = jnp.where(exc, jnp.cumsum(exc) - 1, cap)
    pos = jnp.full((cap,), -1, jnp.int32).at[slot].set(
        jnp.arange(n, dtype=jnp.int32), mode="drop"
    )
    val = jnp.zeros((cap,), jnp.uint16).at[slot].set(
        q.astype(jnp.uint16), mode="drop"
    )
    pd = (
        pos - jnp.concatenate([jnp.full((1,), -1, jnp.int32), pos[:-1]])
    ).astype(jnp.uint16)
    return d8, pd, val, n_exc
