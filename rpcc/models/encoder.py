"""The device-side encoder graph.

One jit-compiled, fixed-shape program from a padded point cloud to every
device-computable codec artifact: range image, segmentation, model table,
cluster-ordered quantized residual stream, contour code (and salience levels
in non-uniform mode).  This fuses the reference's per-frame chain of python/
C++/CUDA calls (``tools/compress.py:93-131``) into a single XLA computation;
only the byte-level entropy stage stays on host.

Hot-loop design (see ops/stream.py): after segmentation, ONE stable sort
carries the range, scan rays (and key-point labels) into bitstream order;
modeling, prediction, quantization and salience then run gather-free in
stream space — per-cluster scalars expand by telescoping-diff cumsums instead of
gathers/scatters over the pixel grid.

The graph is ``vmap``-able over a frame batch and shardable over a device
mesh (see :mod:`rpcc.parallel`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from rpcc.config import CodecConfig, LidarConfig
from rpcc.ops.contour import extract_contour, pack_bits_msb
from rpcc.ops.features import extract_features_with_segment, salience_levels_from_counts
from rpcc.ops.modeling import plane_models_stream, point_model_table
from rpcc.ops.projection import build_transform_planes, project_points
from rpcc.ops.rounding import round_half_away
from rpcc.ops.segment import segment_range_image, segment_range_image_dbscan
from rpcc.ops.stream import (
    expand_per_cluster,
    per_cluster_sums,
    point_means_stream,
    predict_stream,
    rays_from_perm,
    stream_sort,
)


def num_model_rows(cfg: CodecConfig) -> int:
    """Model-table rows: FPS = ground + zero-class + K clusters; DBSCAN adds
    the noise class (ids 0,1,2=noise,3..K+2)."""
    rows = cfg.cluster_num + (3 if cfg.segment_method == "DBSCAN" else 2)
    # Seg ids ride a 12-bit field in the packed contour-sequence sort
    # (ops/stream.py::compact_flagged_small); beyond it they would silently
    # corrupt the idx_sequence bitstream.
    if rows >= (1 << 12):
        raise ValueError(
            f"cluster_num={cfg.cluster_num} needs {rows} model ids, over the "
            f"codec's 4095-id limit"
        )
    return rows


class EncoderOutput(NamedTuple):
    range_image: jnp.ndarray  # (H, W) f32
    seg_idx: jnp.ndarray  # (H, W) i32
    model_param: jnp.ndarray  # (M, 4) f32; row 0 = ground plane
    stream: jnp.ndarray  # (HW,) i16 quantized residuals, tail-padded
    stream_len: jnp.ndarray  # () i32
    contour_packed: jnp.ndarray  # (HW/8,) u8, np.packbits-compatible (MSB first)
    sequence: jnp.ndarray  # (HW,) u16 run values, tail-padded
    seq_len: jnp.ndarray  # () i32
    salience: Optional[jnp.ndarray]  # (M,) u8 or None (uniform)
    key_point_map: Optional[jnp.ndarray]  # (H, W) i32 or None
    # Transfer-compressed residual stream: |q| <= 127 for ~99.98% of real
    # residuals, so the host downloads the i8 view plus a tiny exception
    # list instead of the i16 stream — half the bytes on the link.  The
    # i16 ``stream`` above stays materialized for the rare exc_count > EXC_CAP fallback; jax arrays
    # only transfer when read.
    stream_i8: jnp.ndarray  # (HW,) i8; -128 marks an exception slot
    exc_pos: jnp.ndarray  # (EXC_CAP,) i32 stream positions, |q|-descending
    exc_val: jnp.ndarray  # (EXC_CAP,) i16 true values
    exc_count: jnp.ndarray  # () i32 number of live exceptions
    # On-device entropy coding (cfg.device_entropy, 'rans' only): container
    # pieces of the residual 'C' and contour 'N' fields — the engine
    # downloads ~30 KB/frame of compressed words instead of the transfer
    # views and skips the host entropy encode (ops/rans_device.py).
    de_res_words: Optional[jnp.ndarray] = None  # (L*T,) u16
    de_res_nw: Optional[jnp.ndarray] = None  # () i32
    de_res_counts: Optional[jnp.ndarray] = None  # (L,) i32
    de_res_states: Optional[jnp.ndarray] = None  # (L,) u32
    de_res_freqs: Optional[jnp.ndarray] = None  # (C, A) u16
    de_res_escapes: Optional[jnp.ndarray] = None  # (ESC_CAP_DEV,) u32
    de_res_nesc: Optional[jnp.ndarray] = None  # () i32
    de_res_q0: Optional[jnp.ndarray] = None  # () i32
    de_cnt_words: Optional[jnp.ndarray] = None  # (H*Tc,) u16
    de_cnt_nw: Optional[jnp.ndarray] = None  # () i32
    de_cnt_counts: Optional[jnp.ndarray] = None  # (H,) i32
    de_cnt_states: Optional[jnp.ndarray] = None  # (H,) u32
    de_cnt_freqs: Optional[jnp.ndarray] = None  # (4, 2) u16


# Per-frame capacity of the transfer-exception list (observed ~18 on KITTI;
# the engine falls back to the full i16 download past this, losslessly).
EXC_CAP = 256


def build_encode_fn(
    lidar: LidarConfig,
    cfg: CodecConfig,
    from_ri: bool = False,
    ri_u16: bool = False,
    ri_d8: bool = False,
    ri_m8: bool = False,
):
    """Build the raw (traceable) single-frame encode function.

    ``encode(points (N,3) f32, seed u32, step) -> EncoderOutput`` — pure, so
    it composes with ``jax.vmap`` (frame batches) and ``shard_map``/``jit``
    shardings (device meshes).  Static configuration (shapes, mode,
    thresholds) is closed over; ``seed`` drives the deterministic
    RANSAC/subsample PRNG; ``step`` is traced so changing ``--accuracy``
    never recompiles.

    With ``from_ri=True`` the first argument is the (H, W) f32 range image
    instead of the raw cloud — the production pipelines project on the host
    (``ops.projection.project_points_host``, mirroring the reference's host
    C++ projection) and upload 3x fewer bytes; the in-graph projection stays
    for pure-device use.

    With ``ri_u16=True`` (implies from_ri) the signature becomes
    ``encode(ri_u16 (H, W) u16, seed, step, delta ())``: the host pre-snaps
    depths to a per-frame ``delta`` grid and the device rescales
    ``ri = ri_u16 * delta`` — half the upload bytes for <= delta/2 extra
    reconstruction error (cfg.transfer_precision).

    With ``ri_d8=True`` the signature becomes ``encode(d8 (H, W) i8, seed,
    step, delta (), exc_pd (m,) u16, exc_val (m,) u16, n_exc ())``: the
    host ships first-differences of the u16 snap grid plus a compact
    exception list (ops/projection.py::project_points_host_d8) and the
    graph reconstructs the exact q grid with two cumsums + one small
    scatter — ~30% fewer uplink bytes than raw u16, bit-identical
    bitstreams (cfg.transfer_precision='i8').

    With ``ri_m8=True`` the signature becomes ``encode(maskp (ceil(hw/8),)
    u8, seed, step, delta (), exc_pd (m,) u16, exc_val (m,) u16, n_exc (),
    d8c (M,) i8, n_nz ())``: the host ships a packed nonzero-occupancy
    bit plane plus compact first-differences over consecutive nonzero
    pixels (ops/projection.py::project_points_host_m8).  Zero pixels never
    ride the wire and the zero<->depth delta tails vanish from the
    exception list, ~27% fewer uplink bytes than 'i8' mode.  The graph
    runs the same two-cumsum inversion in the compact domain, then one
    rank-indexed gather expands through the mask — still bit-identical to
    u16-transfer bitstreams (cfg.transfer_precision='m8').
    """
    tm_planes = jnp.asarray(build_transform_planes(lidar))  # (3, H, W) planar
    H, W = lidar.height, lidar.width
    hw = H * W
    tm_planes_flat = tm_planes.reshape(3, hw)
    num_models = num_model_rows(cfg)
    v_angles = (
        None
        if lidar.even_dist
        else jnp.asarray(
            [a * jnp.pi / 180.0 for a in lidar.vertical_angles_deg], dtype=jnp.float32
        )
    )

    def encode(
        points: jnp.ndarray,
        seed: jnp.ndarray,
        step: jnp.ndarray,
        delta: Optional[jnp.ndarray] = None,
        exc_pd: Optional[jnp.ndarray] = None,
        exc_val: Optional[jnp.ndarray] = None,
        n_exc: Optional[jnp.ndarray] = None,
        d8c: Optional[jnp.ndarray] = None,
        n_nz: Optional[jnp.ndarray] = None,
    ) -> EncoderOutput:
        key = jax.random.PRNGKey(seed)
        k_seg, k_model = jax.random.split(key)

        if ri_m8:
            # Masked-compact inversion: the shared cumsum + scatter
            # inversion (ops/wire.py) runs over the compact nonzero stream
            # (length M bucket), then one monotonic gather expands it
            # through the occupancy mask.
            from rpcc.ops.wire import invert_delta_exceptions

            M = d8c.shape[0]
            live = jnp.arange(M) < n_nz
            nzq = invert_delta_exceptions(
                jnp.where(live, d8c.astype(jnp.int32), 0),
                exc_pd, exc_val, n_exc,
            )
            # Unpack the MSB-first bit plane (np.packbits convention) and
            # expand the compact values back to grid positions with ONE
            # u16 row-gather per mask byte instead of one gather per grid
            # cell: gather an 8-wide row of the staggered (M, 8) value table
            # at each byte's exclusive base rank and select in-register
            # with a one-hot sum, bit-identical to the per-cell rank-gather
            # (its speed on the GPU is not measured).
            bitsb = (
                (points[:, None] >> jnp.arange(7, -1, -1, dtype=jnp.uint8)) & 1
            ).astype(jnp.int32)  # (n_bytes, 8); padded tail bits are 0
            pc = bitsb.sum(1)
            base = jnp.cumsum(pc) - pc           # exclusive rank at byte start
            off = jnp.cumsum(bitsb, 1) - bitsb   # in-byte exclusive prefix
            padded = jnp.concatenate(
                [nzq.astype(jnp.uint16), jnp.zeros((7,), jnp.uint16)]
            )
            rows = jnp.stack([padded[k:k + M] for k in range(8)], 1)  # (M, 8)
            g = rows[jnp.clip(base, 0, M - 1)].astype(jnp.int32)
            qg = jnp.zeros_like(bitsb)
            for k in range(8):
                qg = qg + jnp.where(off == k, g[:, k][:, None], 0)
            qv = jnp.where(bitsb == 1, qg, 0).reshape(-1)[:hw]
            ri = (qv.astype(jnp.float32) * delta).reshape(H, W)
        elif ri_d8:
            # Invert the host's row-delta i8 code exactly (ops/wire.py;
            # col-0 exceptions reset every row, so the flat cumsum never
            # leaks across rows).
            from rpcc.ops.wire import invert_delta_exceptions

            qv = invert_delta_exceptions(
                points.astype(jnp.int32).reshape(hw), exc_pd, exc_val, n_exc
            )
            ri = (qv.astype(jnp.float32) * delta).reshape(H, W)
        elif ri_u16:
            ri = points.astype(jnp.float32) * delta  # (H, W), host-snapped
        elif from_ri:
            ri = points  # (H, W) f32, projected on host
        else:
            ri = project_points(points, lidar, v_angles)  # (H, W)
        pc_planes = ri[None, :, :] * tm_planes  # (3, H, W) planar cloud

        if cfg.segment_method == "DBSCAN":
            seg, ground_model, _ = segment_range_image_dbscan(
                pc_planes, ri, tm_planes, k_seg, cfg.dbscan_eps, cfg.cluster_num
            )
        else:
            seg, ground_model, _ = segment_range_image(
                pc_planes, ri, tm_planes, k_seg, cfg.ground_threshold,
                cfg.cluster_num, cpu_fps=cfg.cpu_fps,
            )
        seg_flat = seg.reshape(-1)
        ri_flat = ri.reshape(-1)

        kp_map = None
        # Even-dist rays are recomputed analytically after the sort; uneven
        # (CSV) lidars carry the ray planes as sort payloads.
        payloads = [ri_flat]
        if not lidar.even_dist:
            payloads += [tm_planes_flat[0], tm_planes_flat[1], tm_planes_flat[2]]
        if not cfg.uniform:
            _, kp_map = extract_features_with_segment(
                ri,
                seg,
                feature_region=cfg.feature_region,
                segments=cfg.segments,
                sharp_num=cfg.sharp_num,
                less_sharp_num=cfg.less_sharp_num,
                flat_num=cfg.flat_num,
                want_feature_map=False,  # only key points feed salience
            )
            payloads.append((kp_map.reshape(-1) > 0).astype(jnp.float32))

        order, carried = stream_sort(seg_flat, payloads, num_models)
        ri_s = carried[0]
        if lidar.even_dist:
            rays_s = rays_from_perm(order, lidar)
            kp_carry = carried[1] if not cfg.uniform else None
        else:
            rays_s = (carried[1], carried[2], carried[3])
            kp_carry = carried[4] if not cfg.uniform else None

        if cfg.modeling_method == "point":
            models = point_model_table(point_means_stream(ri_s, order), num_models)
        else:
            models = plane_models_stream(
                ri_s,
                order,
                k_model,
                num_models,
                cfg.plane_angle_threshold,
                rays_s,
            )
        model_param = models.at[0].set(ground_model)

        pred_s = predict_stream(model_param, order, rays_s, hw)
        resid_s = ri_s - pred_s

        salience = None
        if cfg.uniform:
            step_s = step
        else:
            kp_cnt = per_cluster_sums(kp_carry, order).astype(jnp.int32)
            sal = salience_levels_from_counts(
                kp_cnt,
                order.counts,
                level_kp_num=cfg.level_key_point_num,
                ground_level=cfg.ground_salience_level,
            )
            step_s = expand_per_cluster(step[sal], order, hw)
            salience = sal.astype(jnp.uint8)

        q = round_half_away(resid_s / step_s).astype(jnp.int32)
        live = jnp.arange(hw) < order.stream_len
        q = jnp.where(live, q, 0)

        # Transfer compression of the residual stream: i8 body + top_k
        # exception list (one partial sort over |q|, no scatters).  With
        # device entropy the stream is never downloaded raw — skip the pass.
        # out_exc_*: the DOWNLINK exception view of the residual stream —
        # distinct names from the exc_pd/exc_val UPLINK parameters consumed
        # by the ri_d8/ri_m8 branches above, so a later read cannot silently
        # pick up the wrong list.
        dev_entropy = cfg.device_entropy and cfg.basic_compressor == "rans"
        q16 = q.astype(jnp.int16)
        if dev_entropy:
            out_exc_count = out_exc_pos = out_exc_val = q8 = None
        else:
            absq = jnp.abs(q)
            is_exc = absq > 127
            out_exc_count = is_exc.sum().astype(jnp.int32)
            _, out_exc_pos = jax.lax.top_k(absq, EXC_CAP)  # exceptions sort first
            out_exc_val = q16[out_exc_pos]
            q8 = jnp.where(is_exc, -128, q).astype(jnp.int8)

        code = extract_contour(seg)

        de = {}
        if cfg.device_entropy and cfg.basic_compressor == "rans":
            from rpcc.ops.rans_device import (
                encode_contour_field_device,
                encode_residual_field_device,
            )

            (rw, rnw, rcnt, rst, rfq, resc, rnesc, rq0) = (
                encode_residual_field_device(q, order.stream_len)
            )
            (cw, cnw, ccnt, cst, cfq) = encode_contour_field_device(code.contour)
            de = dict(
                de_res_words=rw,
                de_res_nw=rnw,
                de_res_counts=rcnt,
                de_res_states=rst,
                de_res_freqs=rfq.astype(jnp.uint16),
                de_res_escapes=resc,
                de_res_nesc=rnesc,
                de_res_q0=rq0,
                de_cnt_words=cw,
                de_cnt_nw=cnw,
                de_cnt_counts=ccnt,
                de_cnt_states=cst,
                de_cnt_freqs=cfq.astype(jnp.uint16),
            )

        return EncoderOutput(
            range_image=ri,
            seg_idx=seg,
            model_param=model_param,
            stream=q16,  # reference casts int16 (compress_utils.py:142)
            stream_len=order.stream_len,
            contour_packed=pack_bits_msb(code.contour),
            sequence=code.sequence.astype(jnp.uint16),  # reference casts uint16 (:160)
            seq_len=code.seq_len,
            salience=salience,
            key_point_map=kp_map,
            stream_i8=q8,
            exc_pos=None if out_exc_pos is None else out_exc_pos.astype(jnp.int32),
            exc_val=out_exc_val,
            exc_count=out_exc_count,
            **de,
        )

    return encode


def make_encoder(lidar: LidarConfig, cfg: CodecConfig, from_ri: bool = False):
    """Jitted single-frame encoder."""
    return jax.jit(build_encode_fn(lidar, cfg, from_ri=from_ri))


def make_batch_encoder(
    lidar: LidarConfig,
    cfg: CodecConfig,
    mesh=None,
    from_ri: bool = False,
    ri_u16: bool = False,
    ri_d8: bool = False,
    ri_m8: bool = False,
):
    """Jitted batched encoder over (B, N, 3) points (or (B, H, W) range
    images with ``from_ri=True``; (B, H, W) u16 plus a (B,) delta with
    ``ri_u16=True``; (B, H, W) i8 plus (B,) delta, (B, m) u16 exception
    pos-deltas/values and (B,) counts with ``ri_d8=True``; (B, ceil(hw/8))
    u8 packed masks plus (B,) delta, (B, m) u16 exceptions, (B,) exc
    counts, (B, M) i8 compact deltas and (B,) nonzero counts with
    ``ri_m8=True``) and (B,) seeds.

    With a ``mesh`` (1-D, axis 'data'), inputs/outputs are sharded over the
    batch dimension — frame-level data parallelism across devices, the
    equivalent of the reference's ThreadPoolExecutor over frames
    (tools/compress_datalist.py:202-206).
    """
    if ri_m8:
        in_axes = (0, 0, None, 0, 0, 0, 0, 0, 0)
    elif ri_d8:
        in_axes = (0, 0, None, 0, 0, 0, 0)
    elif ri_u16:
        in_axes = (0, 0, None, 0)
    else:
        in_axes = (0, 0, None)
    fn = jax.vmap(
        build_encode_fn(
            lidar, cfg, from_ri=from_ri, ri_u16=ri_u16, ri_d8=ri_d8, ri_m8=ri_m8
        ),
        in_axes=in_axes,
    )
    if mesh is None:
        return jax.jit(fn)
    from jax.sharding import NamedSharding, PartitionSpec as P

    batch_sharding = NamedSharding(mesh, P("data"))
    replicated = NamedSharding(mesh, P())
    in_shardings = tuple(
        replicated if ax is None else batch_sharding for ax in in_axes
    )
    return jax.jit(
        fn,
        in_shardings=in_shardings,
        out_shardings=batch_sharding,
    )
