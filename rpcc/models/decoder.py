"""The device-side decoder graph — exactly inverts the encoder.

From the entropy-decoded arrays (contour bits, run values, residual stream,
model table, salience) back to the reconstructed range image, as one jitted
program: recover the seg map with a parallel run-length fill, rebuild the
cluster-sorted permutation (deterministic given the seg map), scatter the
residual stream, intra-predict, add.

Back-projection to the (H, W, 3) cloud happens on host (one broadcast
multiply with the transform map): returning a trailing-dim-3 array from the
device would tile-pad 3 -> 128 lanes and inflate the download ~42x.

Mirrors ``tools/decompress.py:87-112``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from rpcc.config import CodecConfig, LidarConfig
from rpcc.ops.contour import recover_map, unpack_bits_msb
from rpcc.ops.projection import build_transform_planes
from rpcc.ops.stream import (
    expand_per_cluster,
    predict_stream,
    rays_from_perm,
    stream_sort,
    stream_to_pixel,
)


class DecoderOutput(NamedTuple):
    range_image: jnp.ndarray  # (H, W) f32
    seg_idx: jnp.ndarray  # (H, W) i32
    # u16 transfer view (cfg.transfer_precision='u16' only, else None):
    # range_image snapped to a per-frame grid so the dominant decode
    # download halves; the host rescales by delta.  Adds <= delta/2 error
    # (delta = max(step/16, depth_max/65535)), mirroring the encode-side
    # transfer contract.
    range_u16: Optional[jnp.ndarray] = None  # (H, W) u16
    delta: Optional[jnp.ndarray] = None  # () f32
    # i8 row-delta downlink view (d8_down=True only): first-differences of
    # the flattened u16 snap grid as i8 plus a position-sorted exception
    # list (col-0 of every row and any |diff| > 127), the exact wire code
    # of the encode uplink (ops/projection.py::project_points_host_d8) run
    # in reverse — the DEVICE builds it, the HOST inverts with one fused
    # native pass.  ~31% fewer downlink bytes than the raw u16 grid,
    # byte-identical reconstruction.  ``range_u16`` stays in the outputs
    # (not downloaded) as the lossless per-frame fallback when a frame
    # overflows ``d8_cap`` exceptions.
    d8: Optional[jnp.ndarray] = None  # (H, W) i8 — or (NZ_CAP,) compact in m8
    exc_pd: Optional[jnp.ndarray] = None  # (CAP,) u16 position deltas
    exc_val: Optional[jnp.ndarray] = None  # (CAP,) u16 grid values
    n_exc: Optional[jnp.ndarray] = None  # () i32 live exception count
    # m8 downlink view (m8_down=True only): the encode uplink's
    # masked-compact wire code (ops/projection.py::project_points_host_m8)
    # built device-side — packed nonzero-occupancy bit plane + i8
    # first-differences over *consecutive nonzero* pixels only.  The
    # zero<->depth transitions leave both the delta plane and the
    # exception list, so the downlink drops ~26% vs the d8 view on KITTI
    # (~173 -> ~128 KB/frame).  ``d8`` holds the (NZ_CAP,) compact deltas.
    maskp: Optional[jnp.ndarray] = None  # (ceil(hw/8),) u8
    n_nz: Optional[jnp.ndarray] = None  # () i32 live nonzero count


# Decode-downlink exception capacity: the decoded 64E KITTI grid measures
# ~6.9k exceptions clean / ~12.0k under 1 mm jitter (same stats as the
# encode uplink, whose buckets are 8192/12288).  One fixed program at 12288
# covers both; overflow falls back to the per-frame u16 grid download.
D8_DOWN_CAP = 12288
# m8 downlink capacities (64E KITTI measured: ~92.6k nonzero pixels of
# 128k, ~3.5k exceptions — per-row resets plus |diff|>127 in the compact
# domain).  Overflow of either cap falls back to the u16 grid download.
M8_DOWN_NZ_CAP = 98304
M8_DOWN_EXC_CAP = 6144


def build_decode_fn(
    lidar: LidarConfig,
    cfg: CodecConfig,
    d8_down: bool = False,
    d8_cap: Optional[int] = None,
    m8_down: bool = False,
    m8_caps: Optional[tuple] = None,
):
    """Build the raw ``decode(contour (H,W) u8, sequence (HW,) i32, stream
    (HW,) i32, model_param (M,4) f32, step, salience (M,) i32|unused) ->
    DecoderOutput`` (vmap/shard-composable).

    ``sequence`` and ``stream`` are tail-padded to HW on host (padding values
    are ignored: runs beyond seq_len are never indexed, stream tail maps to
    the zero-pixel class).
    """
    from rpcc.models.encoder import num_model_rows

    H, W = lidar.height, lidar.width
    hw = H * W
    # cap >= hw can never overflow (every pixel an exception at worst), so
    # small grids always take the lossless d8 path with zero waste.
    d8_cap = min(D8_DOWN_CAP, hw) if d8_cap is None else int(d8_cap)
    nz_cap, m8_exc_cap = (
        (min(M8_DOWN_NZ_CAP, hw), min(M8_DOWN_EXC_CAP, hw))
        if m8_caps is None
        else (int(m8_caps[0]), int(m8_caps[1]))
    )
    tm_planes_flat = jnp.asarray(build_transform_planes(lidar)).reshape(3, hw)
    num_models = num_model_rows(cfg)

    def decode(
        contour_packed: jnp.ndarray,  # (HW/8,) u8 packbits
        sequence: jnp.ndarray,
        stream: jnp.ndarray,
        model_param: jnp.ndarray,
        step: jnp.ndarray,
        salience: Optional[jnp.ndarray] = None,
        exc_pos: Optional[jnp.ndarray] = None,  # (CAP,) i32, pad = hw
        exc_val: Optional[jnp.ndarray] = None,  # (CAP,) i16
    ) -> DecoderOutput:
        """``step``: scalar uniform step, or per-level table ((L,)) in
        non-uniform mode — traced so accuracy changes never recompile.

        ``sequence``/``stream`` may be shorter than HW (the engine uploads
        bucketed live prefixes — the padded (B, HW) arrays are ~17 MB/batch
        for ~1 MB of runs); the tail is
        reconstructed in-graph.  ``stream`` may also arrive as the i8
        transfer view with an exception list (mirror of the encoder's
        downlink compression): widen + scatter the few |q|>127 values.

        Stream-space mirror of the encoder: the same stable sort rebuilds
        the bitstream permutation + carried rays; prediction and
        dequantization run gather-free; one placement sort returns to pixel
        order.  The stream tail (zero-pixel class, q padded 0, model row 1
        all-zero) reconstructs exact depth-0 pixels.
        """
        if stream.dtype == jnp.int8:
            s32 = stream.astype(jnp.int32)
            if s32.shape[0] < hw:
                s32 = jnp.concatenate(
                    [s32, jnp.zeros((hw - s32.shape[0],), jnp.int32)]
                )
            if exc_pos is not None:
                s32 = s32.at[exc_pos].set(
                    exc_val.astype(jnp.int32), mode="drop"
                )
            stream = s32
        elif stream.shape[0] < hw:
            stream = jnp.concatenate(
                [
                    stream.astype(jnp.int32),
                    jnp.zeros((hw - stream.shape[0],), jnp.int32),
                ]
            )
        contour = unpack_bits_msb(contour_packed, hw).reshape(H, W)
        seg = recover_map(contour, sequence.astype(jnp.int32))
        seg_flat = seg.reshape(-1)
        if lidar.even_dist:
            order, _ = stream_sort(seg_flat, [], num_models)
            rays_s = rays_from_perm(order, lidar)
        else:
            order, rays_s = stream_sort(
                seg_flat,
                [tm_planes_flat[0], tm_planes_flat[1], tm_planes_flat[2]],
                num_models,
            )
        pred_s = predict_stream(model_param, order, rays_s, hw)
        if cfg.uniform:
            step_s = step
        else:
            step_s = expand_per_cluster(step[salience.astype(jnp.int32)], order, hw)
        ri_s = pred_s + stream.astype(jnp.float32) * step_s
        ri = stream_to_pixel(ri_s, order).reshape(seg.shape)
        if cfg.transfer_precision in ("u16", "i8", "m8"):  # i8/m8 are uplink-only;
            # the reduced decode downlink rides the same u16 snap grid
            step_max = step if cfg.uniform else jnp.max(step)
            delta = jnp.maximum(step_max / 16.0, jnp.max(ri) / 65535.0)
            # clip BOTH ends: a live pixel with true depth < step/2 can
            # reconstruct to a slightly negative ri (|err| <= step/2), and
            # an unclamped f32->u16 convert of a negative is implementation-
            # defined — it wrapped to ~65529, a near-max-range spike point
            # on the host after rescaling.
            riq = jnp.clip(jnp.rint(ri / delta), 0.0, 65535.0).astype(jnp.uint16)
            if not (d8_down or m8_down):
                return DecoderOutput(ri, seg, riq, delta.astype(jnp.float32))
            # Row-delta i8 wire code of the q grid (the encode uplink's
            # project_points_host_d8 format, built device-side): flat
            # first-differences; col-0 of every row and any |diff| > 127
            # become (pos-delta u16, value u16) exceptions.  Compaction is
            # one cumsum + two sorted scatters (no sorts, no gathers);
            # positions are visited in order so the
            # exception list comes out position-sorted for free.
            from rpcc.ops.wire import build_delta_exception_wire

            qf = riq.astype(jnp.int32).reshape(hw)
            if m8_down:
                # Masked-compact wire code (the encode uplink's m8 format,
                # project_points_host_m8) built in-graph: occupancy bit
                # plane + i8 diffs over consecutive nonzero pixels; resets
                # (first live pixel of each row) and |diff| > 127 become
                # exceptions in the compact domain (ops/wire.py).  Row
                # resets bound exception pos-gaps by W so the u16
                # pos-deltas never overflow.
                live = qf != 0
                from rpcc.ops.contour import pack_bits_msb

                maskp = pack_bits_msb(live)
                n_nz = live.sum().astype(jnp.int32)
                nzrank = jnp.cumsum(live) - 1
                slot = jnp.where(live, nzrank, nz_cap)
                cq = jnp.zeros((nz_cap,), jnp.int32).at[slot].set(
                    qf, mode="drop"
                )
                m2 = live.reshape(H, W)
                reset2 = m2 & (jnp.cumsum(m2, axis=1) == 1)
                creset = jnp.zeros((nz_cap,), jnp.bool_).at[slot].set(
                    reset2.reshape(hw), mode="drop"
                )
                d8c, pd, val, n_exc = build_delta_exception_wire(
                    cq, creset, m8_exc_cap,
                    live_mask=jnp.arange(nz_cap, dtype=jnp.int32) < n_nz,
                )
                return DecoderOutput(
                    ri, seg, riq, delta.astype(jnp.float32),
                    d8c, pd, val, n_exc, maskp, n_nz,
                )
            col0 = (jnp.arange(hw) % W) == 0
            d8, pd, val, n_exc = build_delta_exception_wire(qf, col0, d8_cap)
            return DecoderOutput(
                ri, seg, riq, delta.astype(jnp.float32),
                d8.reshape(H, W), pd, val, n_exc,
            )
        return DecoderOutput(ri, seg)

    return decode


def make_decoder(lidar: LidarConfig, cfg: CodecConfig):
    """Jitted single-frame decoder."""
    return jax.jit(build_decode_fn(lidar, cfg))


def make_batch_decoder(
    lidar: LidarConfig,
    cfg: CodecConfig,
    mesh=None,
    i8_stream: bool = False,
    d8_down: bool = False,
    d8_cap: Optional[int] = None,
    m8_down: bool = False,
    m8_caps: Optional[tuple] = None,
):
    """Jitted batched decoder; batch dim sharded over mesh axis 'data'.

    With ``i8_stream=True`` the stream argument is the (B, m) i8 transfer
    view and two (B, CAP) exception arrays follow (after salience in
    non-uniform mode).  With ``d8_down=True`` the output additionally
    carries the i8 row-delta downlink view of the u16 snap grid; with
    ``m8_down=True`` the masked-compact (m8) downlink view instead."""
    base = build_decode_fn(
        lidar, cfg, d8_down=d8_down, d8_cap=d8_cap,
        m8_down=m8_down, m8_caps=m8_caps,
    )
    if cfg.uniform:
        if i8_stream:
            fn = jax.vmap(
                lambda c, q, s, m, step, ep, ev: base(
                    c, q, s, m, step, None, ep, ev
                ),
                in_axes=(0, 0, 0, 0, None, 0, 0),
            )
        else:
            fn = jax.vmap(
                lambda c, q, s, m, step: base(c, q, s, m, step),
                in_axes=(0, 0, 0, 0, None),
            )
    else:
        if i8_stream:
            fn = jax.vmap(base, in_axes=(0, 0, 0, 0, None, 0, 0, 0))
        else:
            fn = jax.vmap(
                lambda c, q, s, m, step, sal: base(c, q, s, m, step, sal),
                in_axes=(0, 0, 0, 0, None, 0),
            )
    if mesh is None:
        return jax.jit(fn)
    from jax.sharding import NamedSharding, PartitionSpec as P

    b = NamedSharding(mesh, P("data"))
    r = NamedSharding(mesh, P())
    n_batched_tail = (0 if cfg.uniform else 1) + (2 if i8_stream else 0)
    in_sh = (b, b, b, b, r) + (b,) * n_batched_tail
    return jax.jit(fn, in_shardings=in_sh, out_shardings=b)
