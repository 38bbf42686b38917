"""Cross-chip aggregation of throughput/rate metrics (SURVEY §2.3).

The codec itself has zero cross-frame communication — frames shard over
the 1-D mesh and never talk.  The ONE place collectives belong is
reporting: global frames/points/bits across the mesh ride one ``psum``
instead of gathering per-chip arrays to the host (reference analogue: the
datalist tools' printed BPP/ratio summaries, tools/compress_datalist.py:
163-199, computed per-process there).
"""

from __future__ import annotations

from functools import partial

import numpy as np


def make_stats_aggregator(mesh):
    """-> jitted ``agg(n_points (B,), bits (B,)) -> (3,) i32``:
    [global frames, global points, global bits], summed over the 'data'
    axis with one psum (inputs batch-sharded over the mesh).  i32 lanes
    bound ONE call at ~2^31 points/bits — aggregate per batch, not over
    accumulated totals."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    # int32 lanes (jax default; x64 stays off): bounds one aggregation call
    # at ~2^31 points / bits — far beyond any single batch.
    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("data"), P("data")),
        out_specs=P(),
    )
    def agg(n_points, bits):
        # live frames = slots with a nonempty payload (batch padding frames
        # carry bits == 0; a real frame's framing alone is > 0 bytes)
        frames = jax.lax.psum(jnp.sum((bits > 0).astype(jnp.int32)), "data")
        tp = jax.lax.psum(jnp.sum(n_points.astype(jnp.int32)), "data")
        tb = jax.lax.psum(jnp.sum(bits.astype(jnp.int32)), "data")
        return jnp.stack([frames, tp, tb])

    b = NamedSharding(mesh, P("data"))
    return jax.jit(agg, in_shardings=(b, b))


def batch_report(totals: np.ndarray) -> dict:
    """(3,) [frames, points, bits] -> report dict (bpp, ratio)."""
    frames, points, bits = (int(x) for x in np.asarray(totals))
    points = max(points, 1)
    return {
        "frames": frames,
        "points": points,
        "bits": bits,
        "bpp": bits / points,
        "ratio": (points * 96) / max(bits, 1),
    }
