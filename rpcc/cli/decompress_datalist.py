"""Batch decompression over a datalist of .rpcc files
(reference ``tools/decompress_datalist.py``): reads each bitstream, decodes in
device batches, writes reconstructed clouds as .bin (zeroed intensity)
mirroring input paths under --output_dir."""

from __future__ import annotations

import argparse
import concurrent.futures as futures
import time

import numpy as np

from rpcc.cli.common import add_codec_args, config_from_args, lidar_from_args, print_args
from rpcc.cli.compress_datalist import output_path_for

def _read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _write_batch_async(io_pool, names, write_one, keep_going: bool):
    """Submit one decoded batch's writes on the IO pool, with per-frame
    failure isolation (a single failed save — disk full, bad mirrored path
    — must not kill a --keep_going run, and must not be counted as done).

    Returns ``drain() -> number written``; the caller drains the PREVIOUS
    batch after dispatching the next, so batch k's .bin writes (mostly
    writeback wall stalls, little CPU) overlap batch k+1's decode."""
    def safe(i: int):
        try:
            write_one(i)
            return None
        except Exception as e:  # noqa: BLE001 — isolate, report, re-raise in drain
            return (names[i], e)

    futs = [io_pool.submit(safe, i) for i in range(len(names))]

    def drain() -> int:
        fails = [r for r in (f.result() for f in futs) if r is not None]
        for name, err in fails:
            print(f"ERROR writing output for {name}: {err}")
        if fails and not keep_going:
            raise fails[0][1]
        return len(names) - len(fails)

    return drain


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    add_codec_args(parser, datalist=True)
    parser.add_argument(
        "--decode_backend", choices=("device", "host"), default="host",
        help="host (default): fused native C++ reconstruction, no device "
        "traffic; device: the jitted decode graph on the accelerator "
        "(scales over the mesh)",
    )
    args = parser.parse_args(argv)
    print_args(args)

    cfg = config_from_args(args)
    lidar = lidar_from_args(args)

    import os

    with open(args.datalist) as f:
        file_list = [line.strip() for line in f if line.strip()]
    for fp in file_list:
        assert fp.split(".")[-1] == "rpcc", f"expected .rpcc input, got {fp}"
    if args.skip_existing:
        from rpcc.cli.compress_datalist import _existing_path

        before = len(file_list)
        file_list = [
            f for f in file_list
            if not os.path.exists(_existing_path(f, args.output_dir, "bin"))
        ]
        print(f"--skip_existing: {before - len(file_list)} done, {len(file_list)} to go")

    io_pool = futures.ThreadPoolExecutor(args.workers)
    t0 = time.time()
    done = 0
    if args.decode_backend == "host":
        done = _host_decode_datalist(args, cfg, lidar, file_list, io_pool)
        dt = time.time() - t0
        print(f"\nDecompressed {done} frames in {dt:.2f}s ({done / dt:.2f} frames/s)")
        return

    import jax

    from rpcc.parallel import BatchEngine, data_mesh

    mesh = data_mesh() if len(jax.devices()) > 1 else None
    engine = BatchEngine(lidar, cfg, batch_size=args.batch, mesh=mesh, workers=args.workers)

    # Both device paths write the engine's compacted (n, 4) xyz0 rows
    # straight to .bin — same save semantics as the host backend (the
    # zero-pixel drop rule lives in decode.cpp::backproject_compact / its
    # numpy twin, matching data.pointcloud_io.save_point_cloud's sum != 0
    # reference rule); byte-identical to the host files in f32-transfer
    # mode, within the u16 snap bound in reduced modes.
    pending = None
    if args.keep_going:
        # Failure-isolation path: per-batch decode so one corrupt bitstream
        # only skips its own batch.
        for start in range(0, len(file_list), args.batch):
            names = file_list[start : start + args.batch]
            try:
                blobs = [_read_bytes(fp) for fp in names]
                pcs = engine.decode_blobs_points(blobs)
            except Exception as e:
                print(f"ERROR decoding batch at {names[0]}: {e}")
                continue

            def write(i: int, names=names, pcs=pcs) -> None:
                path = output_path_for(names[i], args.output_dir, "bin")
                np.ascontiguousarray(pcs[i], "<f4").tofile(path)

            if pending is not None:
                done += pending()
            pending = _write_batch_async(io_pool, names, write, args.keep_going)
    else:
        # Throughput path: pipelined decode with one write batch in flight
        # — batch k's entropy decode + upload overlaps batch k-1's
        # range-image download and batch k-2's .bin writes.
        name_batches = [
            file_list[s : s + args.batch]
            for s in range(0, len(file_list), args.batch)
        ]

        def gen():
            for names in name_batches:
                yield [_read_bytes(fp) for fp in names]

        for names, pcs in zip(name_batches, engine.decode_pipeline(gen())):
            def write(i: int, names=names, pcs=pcs) -> None:
                path = output_path_for(names[i], args.output_dir, "bin")
                np.ascontiguousarray(pcs[i], "<f4").tofile(path)

            if pending is not None:
                done += pending()
            pending = _write_batch_async(io_pool, names, write, args.keep_going)

    if pending is not None:
        done += pending()
    dt = time.time() - t0
    print(f"\nDecompressed {done} frames in {dt:.2f}s ({done / dt:.2f} frames/s)")


def _host_decode_datalist(args, cfg, lidar, file_list, io_pool) -> int:
    """Device-free datalist decode: batched native entropy decode + fused
    C++ reconstruction, compacted (n, 4) rows written straight to .bin."""
    import numpy as np

    from rpcc.models.host_decoder import HostDecoder

    hd = HostDecoder(lidar, cfg)
    done = 0
    pending = None
    for start in range(0, len(file_list), args.batch):
        names = file_list[start : start + args.batch]
        try:
            blobs = list(io_pool.map(_read_bytes, names))
            pts = hd.decode_blobs_points(blobs)
        except Exception as e:
            if not args.keep_going:
                raise
            print(f"ERROR decoding batch at {names[0]}: {e}")
            continue

        def write(i: int, names=names, pts=pts) -> None:
            path = output_path_for(names[i], args.output_dir, "bin")
            np.ascontiguousarray(pts[i], "<f4").tofile(path)

        # One write batch in flight: the .bin writes are writeback wall
        # stalls, not CPU — overlapping them with the next batch's decode
        # is the single biggest lever on the host datalist decode rate.
        if pending is not None:
            done += pending()
        pending = _write_batch_async(io_pool, names, write, args.keep_going)
    if pending is not None:
        done += pending()
    return done


if __name__ == "__main__":
    main()
