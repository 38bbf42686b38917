"""Smoke run of the codec's main path on the GPU.

Drives the flagship configuration (Velodyne 64E, 64 x 2000 range image,
~125k points per frame, batch 64, m8 transfer + in-graph rANS) through the
four CLIs in-process, every user-selectable mode once through
``BatchEngine``, the numpy reference oracle (``tests/reference_oracle.py``),
a CPU-backend comparison and a repeat-encode determinism check, and prints
compile times, throughput, peak device memory, the cost of the sequential
device walks and the top device ops of one warm batch.  The last line of
standard output is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Usage:
    python chip_smoke.py            # one GPU: every phase
    python chip_smoke.py --gpus 4   # only the 4-GPU mesh path, vs 1 GPU

Every phase raises on a failed check, so the script exits non-zero before
printing the JSON line.  Without a GPU it exits 2 and prints no result.
Frames are generated from ``--seed`` into ``build/smoke`` (removed at the
end); a short JSON summary goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
LIDAR = "Velodyne64E"
BATCH = 64
FLAGSHIP_FRAMES = 3 * BATCH
CPU_FRAMES = 8  # frames encoded on both backends (phase 5)
TOP_OPS = 15
SUMMARY: dict = {}
_T0 = time.perf_counter()


def log(msg: str = "") -> None:
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


class CompileLog:
    """Compile events reported by jax.monitoring, split by phase."""

    KEYS = ("/jax/core/compile/jaxpr_trace_duration",
            "/jax/core/compile/jaxpr_to_mlir_module_duration",
            "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax

        self.events = []
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event in self.KEYS:
            self.events.append((event, duration))

    def mark(self) -> int:
        return len(self.events)

    def report(self, since: int) -> str:
        ev = self.events[since:]
        backend = [d for e, d in ev if e == self.KEYS[2]]
        total = sum(d for _, d in ev)
        return (f"{len(backend)} backend compiles, {total:.1f} s compiling "
                f"(largest {max(backend, default=0.0):.1f} s)")


# ------------------------------------------------------------------ helpers
def load_lidar(name: str, csv: str | None = None):
    from rpcc.config import LidarConfig
    from rpcc.data import __lidar_cfg__

    return LidarConfig.from_yaml(__lidar_cfg__[name], csv, name=name)


def reference_range_image(pts: np.ndarray, lidar, cfg) -> np.ndarray:
    """The (H, W) range image the encoder sees: host projection, snapped to
    the u16 grid in the reduced transfer modes."""
    from rpcc.ops.projection import project_points_host, project_points_host_u16

    if cfg.transfer_precision == "f32":
        return project_points_host(pts[:, :3], lidar)
    q, d = project_points_host_u16(pts[:, :3], lidar, np.float32(cfg.step / 16.0))
    return q.astype(np.float32) * d


def error_bound(cfg, backend: str) -> float:
    """Max |decoded - encoded range| the CPU tests assert for this mode:
    the quantization step (plus the widest non-uniform level), plus half the
    u16 snap grid when the device decoder reconstructs a reduced-mode grid."""
    b = cfg.step + (0.0 if cfg.uniform else max(cfg.level_delta_acc))
    if backend == "device" and cfg.transfer_precision != "f32":
        b += cfg.step / 16.0 / 2.0
    return b + 1e-5


def check_range_images(name, ris_rec, ris_ref, bound) -> float:
    worst = 0.0
    for i, (rec, ref) in enumerate(zip(ris_rec, ris_ref)):
        err = float(np.abs(np.asarray(rec) - ref).max())
        check(err <= bound, f"{name} frame {i}: max depth error {err} > {bound}")
        worst = max(worst, err)
    return worst


def check_bin_outputs(name, paths, ris_ref, lidar, bound):
    """Decoded .bin files -> per-frame ranges, checked against the encoder's
    range images.  Rows are the nonzero pixels in row-major order; the
    occupancy is recovered by re-projecting the points onto the grid."""
    from rpcc.ops.projection import project_points_host

    ranges = []
    worst = 0.0
    for i, (p, ref) in enumerate(zip(paths, ris_ref)):
        rec = np.fromfile(p, np.float32).reshape(-1, 4)
        occ = project_points_host(rec[:, :3], lidar) > 0
        check(np.array_equal(occ, ref > 0),
              f"{name} frame {i}: decoded occupancy differs from the input")
        r = np.linalg.norm(rec[:, :3].astype(np.float64), axis=-1)
        err = float(np.abs(r - ref[ref > 0]).max())
        check(err <= bound, f"{name} frame {i}: max depth error {err} > {bound}")
        worst = max(worst, err)
        ranges.append(r)
    return ranges, worst


def bpp_of(blobs, ris) -> float:
    bits = sum(len(b) * 8 for b in blobs)
    return bits / sum(int((r > 0).sum()) for r in ris)


def timed(fn, reps: int = 3) -> float:
    """Warm seconds per call of ``fn`` (which blocks on its result)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


# ------------------------------------------------------------------ phase 2
def phase_native() -> None:
    from rpcc.codec import lz4block, rans_native

    t0 = time.perf_counter()
    path = lz4block.build_library()  # raises on a failed build
    log(f"native library: {path} (built or found in {time.perf_counter() - t0:.1f} s)")
    check(rans_native.available(), "native rANS library did not load")
    lib = lz4block.native_lib()
    for sym in ("project_bin_raster_m8", "host_decode_frame", "m8_reconstruct_batch",
                "backproject_compact", "rans_decode_ctx_batch",
                "rans_delta_finalize_frames_i8"):
        check(hasattr(lib, sym), f"native library lacks {sym}")
    log("phase 2 native library: OK")


# ------------------------------------------------------------------ phase 3
def phase_cli(work, frames, lidar, cfg, comp):
    """The flagship through the four CLIs; returns the encoder range images."""
    from rpcc.cli import compress, compress_datalist, decompress, decompress_datalist
    from rpcc.cli.compress_datalist import output_path_for

    fdir = os.path.join(work, "frames")
    os.makedirs(fdir)
    names = []
    for i, pc in enumerate(frames):
        p = os.path.join(fdir, f"{i:06d}.bin")
        np.concatenate([pc, np.zeros((pc.shape[0], 1), np.float32)], 1).tofile(p)
        names.append(p)
    lst = os.path.join(work, "frames.txt")
    with open(lst, "w") as f:
        f.write("\n".join(names) + "\n")
    ris_ref = [reference_range_image(pc, lidar, cfg) for pc in frames]

    mark = comp.mark()
    enc_dir = os.path.join(work, "enc")
    t0 = time.perf_counter()
    compress_datalist.main(["--datalist", lst, "--output_dir", enc_dir,
                            "--lidar", LIDAR, "--batch", str(BATCH), "--workers", "8"])
    t_enc = time.perf_counter() - t0
    log(f"compress_datalist: {len(frames)} frames in {t_enc:.2f} s incl. compile "
        f"({comp.report(mark)})")
    rpccs = [output_path_for(n, enc_dir, "rpcc") for n in names]
    blobs = []
    for p in rpccs:
        with open(p, "rb") as f:
            blobs.append(f.read())
    SUMMARY["cli_bpp"] = bpp_of(blobs, ris_ref)
    rlst = os.path.join(work, "rpcc.txt")
    with open(rlst, "w") as f:
        f.write("\n".join(rpccs) + "\n")

    ranges = {}
    for backend in ("host", "device"):
        mark = comp.mark()
        out_dir = os.path.join(work, "rec_" + backend)
        t0 = time.perf_counter()
        decompress_datalist.main(["--datalist", rlst, "--output_dir", out_dir,
                                  "--lidar", LIDAR, "--batch", str(BATCH),
                                  "--workers", "8", "--decode_backend", backend])
        dt = time.perf_counter() - t0
        bins = [output_path_for(p, out_dir, "bin") for p in rpccs]
        ranges[backend], worst = check_bin_outputs(
            f"decompress_datalist --decode_backend {backend}", bins, ris_ref,
            lidar, error_bound(cfg, backend))
        log(f"decompress_datalist --decode_backend {backend}: {len(bins)} frames in "
            f"{dt:.2f} s incl. compile ({comp.report(mark)}); max depth error "
            f"{worst:.6f} <= {error_bound(cfg, backend):.6f}")
    # The device decode reconstructs the m8 snap grid (<= step/32 from the
    # host decoder's exact ranges) and evaluates the plane prediction in
    # XLA instead of C++ (~1e-3 f32 agreement) — the snap + f32 bound.
    snap_bound = cfg.step / 16.0 / 2.0 + 1e-3
    diff = max(float(np.abs(h - d).max()) for h, d in zip(ranges["host"], ranges["device"]))
    check(diff <= snap_bound, f"host vs device decode differ by {diff} > {snap_bound}")
    log(f"host vs device decode: max |dr| {diff:.6f} <= {snap_bound:.6f}")

    mark = comp.mark()
    one = os.path.join(work, "one.rpcc")
    compress.main(["--input", names[0], "--output", one, "--lidar", LIDAR, "--eval"])
    decompress.main(["--input", one, "--output", os.path.join(work, "one_rec.bin"),
                     "--lidar", LIDAR, "--eval", "--original_point_cloud", names[0]])
    log(f"compress/decompress --eval on one frame: OK ({comp.report(mark)})")
    log("phase 3 flagship CLIs: OK")
    return ris_ref, blobs


# ------------------------------------------------------------------ phase 4
def mode_matrix(frames64):
    from rpcc.config import CodecConfig

    csv = os.path.join(REPO, "rpcc", "data", "lidar_cfg",
                       "example-Velodyne_HDL_32E_vertical_channel_distribution.csv")
    rows = [
        ("plane", LIDAR, None, CodecConfig(modeling_method="plane")),
        ("non-uniform", LIDAR, None, CodecConfig(compress_framework="non-uniform")),
        ("DBSCAN", LIDAR, None, CodecConfig(segment_method="DBSCAN")),
        ("Velodyne32E-csv", "Velodyne32E", csv, CodecConfig()),
        ("VelodyneVLP16", "VelodyneVLP16", None, CodecConfig()),
    ]
    for tp in ("f32", "u16", "i8"):
        for de in (True, False):
            rows.append((f"{tp}{'+device_entropy' if de else ''}", LIDAR, None,
                         CodecConfig(transfer_precision=tp, device_entropy=de)))
    return rows


def phase_modes(frames64, comp):
    from rpcc.data.synthetic import synthetic_frames
    from rpcc.models.host_decoder import HostDecoder
    from rpcc.parallel import BatchEngine

    other = {}
    for name, lname, csv, cfg in mode_matrix(frames64):
        lidar = load_lidar(lname, csv)
        if lname == LIDAR:
            frames = frames64
        else:
            frames = other.setdefault(lname, synthetic_frames(lidar, BATCH, seed=1))
        mark = comp.mark()
        t0 = time.perf_counter()
        engine = BatchEngine(lidar, cfg, batch_size=BATCH, workers=8)
        blobs = [b for b, _ in engine.encode_frames(frames, seeds=range(BATCH))]
        dt = time.perf_counter() - t0
        ris_ref = [reference_range_image(pc, lidar, cfg) for pc in frames]
        bound = error_bound(cfg, "host")
        worst = check_range_images(name, HostDecoder(lidar, cfg).decode_blobs(blobs),
                                   ris_ref, bound)
        bpp = bpp_of(blobs, ris_ref)
        SUMMARY.setdefault("modes", {})[name] = {"bpp": bpp, "max_err": worst}
        log(f"mode {name}: {BATCH} frames encode+host decode OK, bpp {bpp:.4f}, "
            f"max depth error {worst:.6f} <= {bound:.6f}; first batch {dt:.1f} s "
            f"({comp.report(mark)})")
    log("phase 4 modes: OK")


# ------------------------------------------------------------------ phase 5
def phase_oracle(out, gpu_blobs, frames, lidar, cfg):
    import importlib.util

    import jax

    # By file path: another installed package may also be named ``tests``.
    spec = importlib.util.spec_from_file_location(
        "reference_oracle", os.path.join(REPO, "tests", "reference_oracle.py"))
    oracle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oracle)

    from rpcc.codec.bitstream import pack_bitstream
    from rpcc.codec.entropy import BasicCompressor
    from rpcc.ops.projection import build_transform_map
    from rpcc.parallel import BatchEngine

    tm = build_transform_map(lidar)
    hw = lidar.height * lidar.width
    seg = np.asarray(out.seg_idx[0])
    ri = np.asarray(out.range_image[0])
    mp = np.asarray(out.model_param[0])
    n = int(out.stream_len[0])
    q_gpu = np.asarray(out.stream[0])[:n].astype(np.int64)

    pred = oracle.intra_predict(seg, mp, tm)
    residual = (ri - pred).astype(np.float32)
    q_oracle = oracle.uniform_quantize(seg, residual, cfg.step)
    res_stream = np.concatenate(
        [residual[seg == m] for m in range(int(seg.max()) + 1) if m != 1])
    oracle.assert_streams_agree(q_gpu, q_oracle, res_stream,
                         np.full(res_stream.shape, np.float32(cfg.step)))
    flips = int((q_gpu != np.asarray(q_oracle, np.int64)).sum())
    log(f"oracle: quantized residuals agree ({n} symbols, {flips} .5-boundary flips)")

    contour, seq = oracle.extract_contour(seg)
    contour_gpu = np.unpackbits(np.asarray(out.contour_packed[0]))[:hw].reshape(seg.shape)
    seq_gpu = np.asarray(out.sequence[0])[: int(out.seq_len[0])]
    check(np.array_equal(contour_gpu, contour.astype(np.uint8)), "contour differs from oracle")
    check(np.array_equal(seq_gpu.astype(np.int64), np.asarray(seq, np.int64)),
          "index sequence differs from oracle")
    check(np.packbits(contour.astype(bool), axis=None).tobytes()
          == np.asarray(out.contour_packed[0]).tobytes(), "packed contour bytes differ")
    log("oracle: contour and index sequence byte-identical")

    # The oracle reads the reference's byte coders only, so the GPU frame's
    # fields are framed with bzip2 for it (the rans containers are this
    # codec's own extension).
    fields = {
        "residual_quantized": q_gpu.astype(np.int16),
        "contour_map": np.asarray(out.contour_packed[0]),
        "idx_sequence": seq_gpu.astype(np.uint16),
        "plane_param": mp.astype(np.float32),
    }
    blob = pack_bitstream(BasicCompressor(method_name="bzip2").compress_dict(fields))
    comp = oracle.unpack_bitstream(blob)
    q, idx_map, _, _, full = oracle.decompress_point_cloud(
        comp, "bzip2", cfg.cluster_num + 1, lidar.height, lidar.width)
    ri_oracle = np.where(
        idx_map == 1, 0.0,
        oracle.intra_predict(idx_map, full, tm) + oracle.dequantize_residual(q, idx_map, cfg.step),
    ).astype(np.float32)
    err = float(np.abs(ri_oracle - ri).max())
    bound = error_bound(cfg, "host")
    check(err <= bound, f"oracle decode of the GPU bitstream: error {err} > {bound}")
    log(f"oracle: decode of the GPU bitstream within bound ({err:.6f} <= {bound:.6f})")

    # Same frames, same seeds, on the CPU backend in this process.
    gpu_blobs = gpu_blobs[:CPU_FRAMES]
    with jax.default_device(jax.devices("cpu")[0]):
        cpu_engine = BatchEngine(lidar, cfg, batch_size=CPU_FRAMES, workers=8)
        out_c, live = cpu_engine.encode_batch_device(frames[:CPU_FRAMES], seeds=range(CPU_FRAMES))
        cpu_blobs = [b for b, _ in cpu_engine.finalize_encoded(out_c, live)]
        seg_c = np.asarray(out_c.seg_idx)
    ris = np.asarray(out.range_image[:CPU_FRAMES])
    bpp_g, bpp_c = bpp_of(gpu_blobs, ris), bpp_of(cpu_blobs, ris)
    rel = abs(bpp_g - bpp_c) / bpp_c
    seg_diff = int((np.asarray(out.seg_idx[:CPU_FRAMES]) != seg_c).sum())
    same = sum(a == b for a, b in zip(gpu_blobs, cpu_blobs))
    SUMMARY["cpu_vs_gpu"] = {"bpp_gpu": bpp_g, "bpp_cpu": bpp_c, "rel": rel,
                             "seg_pixels_differ": seg_diff, "identical_blobs": same}
    log(f"GPU vs CPU backend, {CPU_FRAMES} frames: bpp {bpp_g:.5f} vs {bpp_c:.5f} "
        f"(|d| {100 * rel:.3f}%), {seg_diff} of {CPU_FRAMES * hw} segment ids differ, "
        f"{same}/{CPU_FRAMES} blobs byte-identical (not required: f32 sums and FMA "
        f"contraction differ across backends)")
    check(rel <= 0.01, f"GPU vs CPU bpp differ by {100 * rel:.3f}% > 1%")
    log("phase 5 reference oracle: OK")


# ------------------------------------------------------------------ phase 7
def phase_walks(out, lidar, cfg):
    """Device time of the sequential walks at the flagship's shapes."""
    import jax
    import jax.numpy as jnp

    from rpcc.ops.dbscan import dbscan_range_image
    from rpcc.ops.fps import furthest_point_sample_planar
    from rpcc.ops.projection import build_transform_planes
    from rpcc.ops.rans_device import encode_contour_field_device, encode_residual_field_device
    from rpcc.ops.segment import segment_index_clean

    ri = jnp.asarray(out.range_image)
    planes = ri[:, None] * jnp.asarray(build_transform_planes(lidar))[None]
    seg = jnp.asarray(out.seg_idx)
    q = jnp.asarray(out.stream).astype(jnp.int32)
    slen = jnp.asarray(out.stream_len)
    bits = jnp.unpackbits(jnp.asarray(out.contour_packed), axis=-1)
    bits = bits[:, : lidar.height * lidar.width].reshape(ri.shape).astype(jnp.int32)
    flat = planes.reshape(BATCH, 3, -1)
    walks = {
        "in-graph rANS residual field (renorm lax.scan)": (
            jax.jit(jax.vmap(encode_residual_field_device)), (q, slen)),
        "in-graph rANS contour field (wavefront lax.scan)": (
            jax.jit(jax.vmap(encode_contour_field_device)), (bits,)),
        "FPS fori_loop (cluster_num samples)": (
            jax.jit(jax.vmap(lambda p: furthest_point_sample_planar(
                p[0], p[1], p[2], cfg.cluster_num))), (flat,)),
        "DBSCAN while_loop": (
            jax.jit(jax.vmap(lambda p, a: dbscan_range_image(
                p, a, cfg.dbscan_eps, cfg.cluster_num))), (planes, ri > 0)),
        "segmentation row-fix lax.scan (segment_index_clean)": (
            jax.jit(jax.vmap(segment_index_clean)), (seg,)),
    }
    res = {}
    for name, (fn, args) in walks.items():
        s = timed(lambda: jax.block_until_ready(fn(*args)))
        res[name] = s * 1e3
        log(f"walk {name}: {s * 1e3:.3f} ms per {BATCH}-frame batch "
            f"({s * 1e3 / BATCH:.4f} ms/frame)")
    return res


def phase_trace(engine, frames, card):
    import jax

    from rpcc.utils.profiling import summarize_trace

    tdir = os.path.join(REPO, "build", "smoke_trace")
    shutil.rmtree(tdir, ignore_errors=True)
    prepared = engine._prepare_batch(frames[:BATCH], range(BATCH))
    jax.block_until_ready(engine._dispatch_prepared(prepared)[0])
    jax.profiler.start_trace(tdir)
    jax.block_until_ready(engine._dispatch_prepared(prepared)[0])
    jax.profiler.stop_trace()
    rows = summarize_trace(tdir, TOP_OPS)
    check(bool(rows), "the profiler trace holds no device events")
    total = sum(ms for ms, _, _ in summarize_trace(tdir, 10**6))
    log(f"top {TOP_OPS} device ops of one warm flagship encode batch "
        f"({total:.3f} ms device time in all, {card}):")
    for ms, name, n in rows:
        log(f"    {ms:9.3f} ms  {100 * ms / total:5.1f}%  {n:6d}x  {name[:90]}")
    SUMMARY["trace_device_ms"] = total
    SUMMARY["trace_top"] = [[round(ms, 4), name, n] for ms, name, n in rows]
    shutil.rmtree(tdir, ignore_errors=True)


def phase_metrics(engine, frames, blobs, lidar, cfg, card):
    import jax

    from rpcc.models.host_decoder import HostDecoder

    batches = [(frames[s:s + BATCH], list(range(s, s + BATCH)))
               for s in range(0, len(frames), BATCH)]
    list(engine.encode_pipeline(batches[:1]))  # warm
    t0 = time.perf_counter()
    n = sum(len(r) for r in engine.encode_pipeline(batches))
    enc = n / (time.perf_counter() - t0)
    hd = HostDecoder(lidar, cfg)
    t0 = time.perf_counter()
    pts = hd.decode_blobs_points(blobs)
    host = len(pts) / (time.perf_counter() - t0)
    blob_batches = [blobs[s:s + BATCH] for s in range(0, len(blobs), BATCH)]
    list(engine.decode_pipeline(blob_batches[:1]))  # warm
    t0 = time.perf_counter()
    n = sum(len(r) for r in engine.decode_pipeline(blob_batches))
    dev = n / (time.perf_counter() - t0)
    dev_only = BATCH / timed(lambda: jax.block_until_ready(
        engine._dispatch_prepared(engine._prepare_batch(frames[:BATCH], range(BATCH)))[0]))
    SUMMARY["fps"] = {"encode_pipeline": enc, "decode_host": host,
                      "decode_device_pipeline": dev, "encode_device_call": dev_only}
    log(f"flagship frames/s on {card}: encode pipeline {enc:.1f}, decode host "
        f"{host:.1f}, decode device pipeline {dev:.1f} (warm, in-process, no file IO; "
        f"{len(frames)} frames); one encode batch incl. host projection + upload "
        f"{dev_only:.1f}")


# --------------------------------------------------------------- --gpus 4
def phase_mesh(n_gpus: int, card: str) -> None:
    import jax

    from rpcc.config import CodecConfig
    from rpcc.data.synthetic import synthetic_frames
    from rpcc.parallel import BatchEngine, data_mesh

    lidar = load_lidar(LIDAR)
    cfg = CodecConfig()
    n_frames = 13  # ragged: the engine rounds the batch up to 16
    frames = synthetic_frames(lidar, n_frames, seed=2)
    mesh = data_mesh(n_gpus)
    check(mesh.axis_names == ("data",), f"mesh axes {mesh.axis_names}")
    eng = BatchEngine(lidar, cfg, batch_size=n_frames, mesh=mesh, workers=8)
    check(eng.batch_size % n_gpus == 0 and eng.batch_size >= n_frames,
          f"mesh batch {eng.batch_size}")
    out, live = eng.encode_batch_device(frames, seeds=range(n_frames))
    for name in ("range_image", "stream", "contour_packed", "sequence", "model_param",
                 "stream_len", "de_res_words", "de_cnt_words"):
        arr = getattr(out, name)
        check(not arr.sharding.is_fully_replicated, f"{name} is replicated")
        check(len(arr.sharding.device_set) == n_gpus, f"{name} not on all {n_gpus} GPUs")
        shards = {s.device for s in arr.addressable_shards}
        check(len(shards) == n_gpus, f"{name} lands on {len(shards)} device(s)")
    blobs = [b for b, _ in eng.finalize_encoded(out, live)]
    check(len(blobs) == n_frames, f"{len(blobs)} blobs for {n_frames} frames")

    # The 1-GPU engine runs the per-card batch: XLA:GPU compiles another
    # batch size to kernels that may sum f32 in another order (a 13-frame
    # batch on one H100 gave other bytes), so only equal per-card shapes
    # promise equal bitstreams.
    per_card = eng.batch_size // n_gpus
    one = BatchEngine(lidar, cfg, batch_size=per_card, workers=8)
    starts = range(0, n_frames, per_card)
    blobs_one = [b for s in starts for b, _ in one.encode_frames(
        frames[s:s + per_card], seeds=range(s, min(s + per_card, n_frames)))]
    check(blobs == blobs_one, "mesh blobs differ from the 1-GPU encode")
    log(f"mesh encode: {n_frames} frames over {n_gpus} GPUs (batch {eng.batch_size}) "
        f"byte-identical to 1 GPU at the per-card batch {per_card}")

    dec = eng.decode_blobs(blobs)
    dec_one = [d for s in starts for d in one.decode_blobs(blobs[s:s + per_card])]
    for i in range(n_frames):
        check(np.array_equal(np.asarray(dec[i]), np.asarray(dec_one[i])),
              f"mesh decode differs from the 1-GPU decode on frame {i}")
    log("mesh decode: equal to the 1-GPU decode")

    rep = eng.sharded_stats(out, [len(b) for b in blobs])
    pts = int(np.asarray(out.stream_len)[:n_frames].sum())
    bits = sum(len(b) * 8 for b in blobs)
    check((rep["frames"], rep["points"], rep["bits"]) == (n_frames, pts, bits),
          f"psum stats {rep} != host sums ({n_frames}, {pts}, {bits})")
    log(f"psum stats equal the host sums: {n_frames} frames, {pts} points, {bits} bits, "
        f"bpp {rep['bpp']:.4f} ({card}, {n_gpus} GPUs)")
    SUMMARY["mesh"] = {"gpus": n_gpus, "frames": n_frames, "bpp": rep["bpp"]}


# ----------------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gpus", type=int, choices=(1, 4), default=1,
                    help="4: run only the 4-GPU mesh path and its 1-GPU comparison")
    ap.add_argument("--seed", type=int, default=0, help="seed of the generated frames")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    sys.path.insert(0, REPO)
    from rpcc.runtime import card_label, require_gpus, setup_compile_cache

    devs = require_gpus(args.gpus)  # phase 1: GPUs or exit 2, never the CPU
    import jax

    card = card_label()
    print(card, flush=True)  # as nvidia-smi --query-gpu=name,power.limit prints it
    log(f"card: {card}")
    log(f"devices: {len(jax.devices())} x {devs[0].device_kind}; using {args.gpus}")
    log(f"compile cache: {setup_compile_cache()}")
    comp = CompileLog()

    if args.gpus > 1:
        phase_mesh(args.gpus, card)
    else:
        from rpcc.config import CodecConfig
        from rpcc.data.synthetic import synthetic_frames
        from rpcc.parallel import BatchEngine

        phase_native()
        lidar = load_lidar(LIDAR)
        cfg = CodecConfig()  # the flagship: m8 uplink + in-graph rANS
        t0 = time.perf_counter()
        frames = synthetic_frames(lidar, FLAGSHIP_FRAMES, seed=args.seed)
        log(f"{len(frames)} seeded {LIDAR} frames, {min(len(f) for f in frames)}-"
            f"{max(len(f) for f in frames)} points each ({time.perf_counter() - t0:.1f} s)")
        work = os.path.join(REPO, "build", "smoke")
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        try:
            ris_ref, cli_blobs = phase_cli(work, frames, lidar, cfg, comp)
        finally:
            shutil.rmtree(work, ignore_errors=True)

        mark = comp.mark()
        engine = BatchEngine(lidar, cfg, batch_size=BATCH, workers=8)
        out, live = engine.encode_batch_device(frames[:BATCH], seeds=range(BATCH))
        blobs = [b for b, _ in engine.finalize_encoded(out, live)]
        log(f"flagship engine first batch ({comp.report(mark)})")
        # phase 6: reproducible bitstreams under --seed
        again = [b for b, _ in engine.encode_frames(frames[:BATCH], seeds=range(BATCH))]
        check(again == blobs, "repeat encode of the same batch is not byte-identical")
        check(cli_blobs[:BATCH] == blobs,
              "the compress_datalist blobs differ from the engine's for the same seeds")
        log("phase 6 determinism: repeat encode byte-identical, and equal to the CLI's blobs")

        phase_modes(frames[:BATCH], comp)
        phase_oracle(out, blobs, frames, lidar, cfg)
        stats = jax.devices()[0].memory_stats() or {}
        peak = stats.get("peak_bytes_in_use", 0)
        log(f"peak_bytes_in_use after the mode matrix: {peak / 2**30:.3f} GiB ({card})")
        phase_metrics(engine, frames, cli_blobs, lidar, cfg, card)
        SUMMARY["walk_ms_per_batch"] = phase_walks(out, lidar, cfg)
        phase_trace(engine, frames, card)
        stats = jax.devices()[0].memory_stats() or {}
        SUMMARY["peak_bytes_in_use"] = stats.get("peak_bytes_in_use", 0)
        log(f"peak_bytes_in_use: {SUMMARY['peak_bytes_in_use'] / 2**30:.3f} GiB ({card})")

    SUMMARY.update(card=card, gpus=args.gpus, seconds=time.perf_counter() - t_start)
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    name = "chip_smoke.json" if args.gpus == 1 else f"chip_smoke_{args.gpus}gpu.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(SUMMARY, f, indent=1, default=float)
    log(f"chip_smoke passed in {SUMMARY['seconds']:.1f} s on {card}")
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {"platform": d.platform, "kind": d.device_kind,
                                             "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
