"""Single-frame decompression CLI (reference ``tools/decompress.py``).

Usage:
    python -m rpcc.cli.decompress --input frame.rpcc --output rec.bin \
        --lidar Velodyne64E [--eval --original_point_cloud frame.bin]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from rpcc.cli.common import add_codec_args, config_from_args, lidar_from_args, print_args
from rpcc.data.pointcloud_io import load_point_cloud, save_point_cloud


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    add_codec_args(parser)
    parser.add_argument("--original_point_cloud", default=None)
    parser.add_argument(
        "--decode_backend", choices=("device", "host"), default="host",
        help="host (default): fused native C++ reconstruction, no device "
        "traffic; device: the jitted decode graph on the accelerator "
        "(scales over the mesh)",
    )
    args = parser.parse_args(argv)
    print_args(args)

    cfg = config_from_args(args)

    with open(args.input, "rb") as f:
        blob = f.read()

    # Self-described streams configure the decoder themselves.
    from rpcc.codec.bitstream import unpack_header

    head, blob = unpack_header(blob)
    if head is not None:
        print("self-describing bitstream:", head)
        cfg = cfg.replace(
            compress_framework="uniform" if head["uniform"] else "non-uniform",
            accuracy=head["accuracy"],
            segment_method=head["segment_method"],
            cluster_num=head["cluster_num"],
            modeling_method=head["modeling_method"],
            basic_compressor=head["basic_compressor"],
        )
        if args.lidar is None:
            args.lidar = head["lidar_name"]
    lidar = lidar_from_args(args)

    codec = None
    if args.decode_backend == "host":
        import time

        from rpcc.models.host_decoder import HostDecoder
        from rpcc.ops.projection import build_transform_map

        hd = HostDecoder(lidar, cfg)
        t0 = time.time()
        fields = hd.entropy_decode_blobs([blob])[0]
        t1 = time.time()
        ri_rec = hd.decode_fields(fields)
        t2 = time.time()
        pc_rec = ri_rec[..., None] * build_transform_map(lidar)
        times = {"entropy": t1 - t0, "device_decode": t2 - t1}
    else:
        from rpcc.models.pipeline import RPCCCodec

        codec = RPCCCodec(lidar, cfg)
        pc_rec, ri_rec, times = codec.decompress(blob)
    save_point_cloud(args.output, pc_rec.reshape(-1, 3))

    print("\nDecompression finished.")
    print(args.output.split(".")[-1], "file save in ", args.output)
    print("    Entropy decode: ", times["entropy"])
    print("    Device decode: ", times["device_decode"])

    if args.eval:
        assert args.original_point_cloud is not None, (
            "If want to evaluate the reconstruction quality, must set the "
            "original point cloud file path first."
        )
        print("\nStart evaluation...")
        original = load_point_cloud(args.original_point_cloud)
        if codec is None:
            from rpcc.models.pipeline import RPCCCodec

            codec = RPCCCodec(lidar, cfg)
        out = codec.encode_device(original)
        ri = np.asarray(out.range_image)
        n_points = int((ri > 0).sum())

        range_dif = np.abs(ri_rec - ri)
        max_depth_error = float(range_dif.max())
        mean_depth_error = float(range_dif.mean())
        bound = cfg.step + (0.0 if cfg.uniform else max(cfg.level_delta_acc))
        if max_depth_error > bound + 1e-5:
            print("Does the the uniform or non-uniform compression framework "
                  "matches the compress processing?")
            raise AssertionError(
                f"Reconstruction error {max_depth_error} exceeds bound {bound}"
            )

        from rpcc.metrics import calc_chamfer_distance, calc_point_to_point_plane_psnr

        pc_grid = ri[..., None] * codec.transform_map
        cd = calc_chamfer_distance(pc_grid.reshape(-1, 3), pc_rec.reshape(-1, 3), out=False)
        p2p, p2pl = calc_point_to_point_plane_psnr(
            pc_grid.reshape(-1, 3), pc_rec.reshape(-1, 3), out=False
        )

        compressed_bit_size = os.path.getsize(args.input) * 8
        print("\nCompared with ", args.original_point_cloud)
        print("    BPP: ", compressed_bit_size / n_points)
        print("    Compression Ratio: ", (n_points * 32 * 3) / compressed_bit_size)
        print("    Depth Error (mean): ", mean_depth_error)
        print("    Depth Error (max): ", max_depth_error)
        print("    Chamfer Distance (mean): ", cd["mean"])
        print("    F1 score (threshold=0.02): ", cd["f_score"])
        print("    Point-to-Point PSNR (r=59.7): ", p2p["psnr_mean"])
        print("    Point-to-Plane PSNR (r=59.7): ", p2pl["psnr_mean"])


if __name__ == "__main__":
    main()
