"""Batch compression over a datalist (reference ``tools/compress_datalist.py``).

Frames are loaded by IO threads, encoded in device batches (sharded over the
mesh when more than one chip is attached), entropy-coded on a host pool, and
written mirroring the input paths under --output_dir with the .rpcc suffix.
Device batch i+1 is dispatched before batch i's host work (double buffering).
"""

from __future__ import annotations

import argparse
import concurrent.futures as futures
import os
import time

import numpy as np

from rpcc.cli.common import add_codec_args, config_from_args, lidar_from_args, print_args


def output_path_for(file_name: str, output_dir: str, suffix: str) -> str:
    """Mirror the input path under output_dir with the given suffix.

    The reference (tools/compress_datalist.py:136-141) does
    ``out.replace(out.split(".")[-1], suffix)`` which corrupts every other
    occurrence of the extension substring (e.g. a directory named ``bin/``).
    We deliberately fix that: only the trailing extension is replaced.
    """
    out = _mirror_path(file_name, output_dir, suffix)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    return out


def _mirror_path(file_name: str, output_dir: str, suffix: str) -> str:
    # Normalize and strip every leading slash and any '..' segments so a
    # datalist entry like '//srv/data/a.bin' or '../x/a.bin' can never make
    # the mirrored output escape --output_dir (os.path.join discards
    # output_dir entirely when the right side is absolute).
    file_name = os.path.normpath(file_name.strip()).lstrip(os.sep)
    parts = [p for p in file_name.split(os.sep) if p not in ("..", "")]
    out = os.path.join(output_dir, *parts) if parts else output_dir
    root, _ = os.path.splitext(out)
    return root + "." + suffix


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    add_codec_args(parser, datalist=True)
    args = parser.parse_args(argv)
    print_args(args)

    cfg = config_from_args(args)
    lidar = lidar_from_args(args)

    import jax

    from rpcc.data import build_dataset
    from rpcc.data.pointcloud_io import load_point_cloud_f32
    from rpcc.parallel import BatchEngine, data_mesh, prefetch_loaded_batches

    dataset = build_dataset(datalist=args.datalist, lidar_type=args.lidar)
    mesh = data_mesh() if len(jax.devices()) > 1 else None
    engine = BatchEngine(lidar, cfg, batch_size=args.batch, mesh=mesh, workers=args.workers)

    file_list = dataset.data_list
    if args.skip_existing:
        before = len(file_list)
        file_list = [
            f for f in file_list
            if not os.path.exists(_existing_path(f, args.output_dir, "rpcc"))
        ]
        print(f"--skip_existing: {before - len(file_list)} done, {len(file_list)} to go")
    n = len(file_list)
    io_pool = futures.ThreadPoolExecutor(args.workers)

    failed_loads: set = set()  # global indices whose load failed (keep_going)

    def load(idx: int):
        try:
            return load_point_cloud_f32(file_list[idx])
        except Exception as e:  # failure isolation (--keep_going)
            if not args.keep_going:
                raise
            failed_loads.add(idx)
            print(f"ERROR loading {file_list[idx]}: {e}")
            # Placeholder keeps the batch shape; its output is NEVER
            # written — a dummy .rpcc at the real path would be skipped
            # forever by a --skip_existing resume (silent data loss).
            return np.zeros((1, 3), np.float32)

    t0 = time.time()
    done = 0
    errors = 0
    if args.output or args.eval:
        # Diagnostic path: per-batch reports need the device range image.
        pending = None  # (future -> (device handle, live), names, failed, load_s)
        for start in range(0, n, args.batch):
            names = file_list[start : start + args.batch]
            t_l = time.time()
            clouds = list(io_pool.map(load, range(start, min(start + args.batch, n))))
            load_s = time.time() - t_l
            # loads for this batch are complete here, so the snapshot is exact
            batch_failed = {i - start for i in failed_loads
                            if start <= i < start + len(clouds)}
            seeds = [cfg.seed + start + i for i in range(len(clouds))]
            fut = engine.encode_batch_async(clouds, seeds)
            if pending is not None:
                out, live = pending[0].result()
                d, e = _drain((out, live, *pending[1:]), engine, args)
                done += d
                errors += e
            pending = (fut, names, batch_failed, load_s)
        if pending is not None:
            out, live = pending[0].result()
            d, e = _drain((out, live, *pending[1:]), engine, args)
            done += d
            errors += e
    else:
        # Throughput path: 3-deep pipeline (upload k / download k-1 /
        # entropy+write k-2 all overlap) fed by a background prefetcher so
        # disk reads never stall a pipeline pull.
        gen = prefetch_loaded_batches(
            file_list, args.batch, load, seed_base=cfg.seed, workers=args.workers
        )
        name_batches = [file_list[s : s + args.batch] for s in range(0, n, args.batch)]
        for bi, (names, results) in enumerate(zip(name_batches, engine.encode_pipeline(gen))):
            for j, ((blob, _fields), name) in enumerate(zip(results, names)):
                if bi * args.batch + j in failed_loads:
                    errors += 1  # load already logged; no output written
                    continue
                try:
                    path = output_path_for(name, args.output_dir, "rpcc")
                    with open(path, "wb") as f:
                        f.write(blob)
                    done += 1
                except Exception as e:
                    if not args.keep_going:
                        raise
                    errors += 1
                    print(f"ERROR writing output for {name}: {e}")

    dt = time.time() - t0
    print(f"\nCompressed {done} frames in {dt:.2f}s ({done / dt:.2f} frames/s)"
          + (f", {errors} errors" if errors else ""))


def _existing_path(file_name: str, output_dir: str, suffix: str) -> str:
    return _mirror_path(file_name, output_dir, suffix)


def _drain(pending, engine, args):
    """-> (written, errors) for one finished batch."""
    import numpy as np

    out, live, names, batch_failed, load_s = pending
    errors = 0
    written = 0
    t_f = time.time()
    results = engine.finalize_encoded(out, live)
    entropy_s = time.time() - t_f
    t_w = time.time()
    blobs = []
    kept = []  # batch indices whose write succeeded, aligned with blobs
    for i, ((blob, fields), name) in enumerate(zip(results, names)):
        if i in batch_failed:
            errors += 1  # load failed (already logged); placeholder frame
            continue
        try:
            path = output_path_for(name, args.output_dir, "rpcc")
            with open(path, "wb") as f:
                f.write(blob)
            blobs.append(blob)
            kept.append(i)
            written += 1
            if args.output:
                ri = np.asarray(out.range_image[i])
                n_pts = max(int((ri > 0).sum()), 1)
                print(
                    f"binary bitstream save in {path}  "
                    f"BPP: {len(blob) * 8 / n_pts:.4f}  "
                    f"ratio: {(n_pts * 96) / (len(blob) * 8):.2f}"
                )
        except Exception as e:
            if not args.keep_going:
                raise
            errors += 1
            print(f"ERROR writing output for {name}: {e}")

    if args.output and live:
        # Per-frame host-stage wall clock (reference tools/
        # compress_datalist.py:149-158 prints per-stage timers; our
        # segment/model/predict/quantize stages are ONE fused XLA graph, so
        # the meaningful host stages of the batch path are reported
        # instead — device-graph stage timing comes from --profile on the
        # single-frame CLI).
        write_s = time.time() - t_w
        per = 1000.0 / live
        print(
            f"Time cost (per frame, batch of {live}): "
            f"load {load_s * per:.2f} ms | "
            f"entropy+download {entropy_s * per:.2f} ms | "
            f"write {write_s * per:.2f} ms"
        )

    if args.eval and blobs:
        # Per-frame reconstruction quality (reference --output --eval path,
        # tools/compress_datalist.py:163-200): decode the batch we just
        # wrote and report depth error (mean+max) + chamfer distance + F1 +
        # point-to-point / point-to-plane PSNR per frame, matching the
        # reference's per-frame eval report field for field.
        from rpcc.metrics import (
            calc_chamfer_distance,
            calc_point_to_point_plane_psnr,
        )
        from rpcc.ops.projection import build_transform_map

        tm = build_transform_map(engine.lidar)
        ris = np.asarray(out.range_image)
        decoded = engine.decode_blobs(blobs)
        bound = engine.cfg.step + (
            0.0 if engine.cfg.uniform else max(engine.cfg.level_delta_acc)
        )
        if engine.cfg.transfer_precision in ("u16", "i8", "m8"):
            bound += engine.cfg.step / 16.0 / 2.0  # decode-side snap floor
        # `decoded` aligns with `blobs` = the frames whose write succeeded
        # (`kept` batch indices) — a --keep_going write failure must not
        # shift every later frame's report onto the wrong name/range image.
        for dec, i in zip(decoded, kept):
            rec_ri = np.linalg.norm(dec, axis=-1)
            dif = np.abs(rec_ri - ris[i])
            err = float(dif.max())
            status = "OK" if err <= bound + 1e-5 else "RECONSTRUCTION ERROR"
            orig_pc = ris[i][..., None] * tm
            cd = calc_chamfer_distance(
                orig_pc.reshape(-1, 3), dec.reshape(-1, 3), out=False
            )
            p2p, p2pl = calc_point_to_point_plane_psnr(
                orig_pc.reshape(-1, 3), dec.reshape(-1, 3), out=False
            )
            print(
                f"eval {names[i]}: depth error mean {float(dif.mean()):.6f} "
                f"max {err:.5f} (bound {bound:.5f}) "
                f"chamfer {cd['mean']:.6f} F1 {cd['f_score']:.4f} "
                f"p2p_psnr {p2p['psnr_mean']:.2f} "
                f"p2plane_psnr {p2pl['psnr_mean']:.2f} {status}"
            )
    return written, errors


if __name__ == "__main__":
    main()
