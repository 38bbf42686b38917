"""Shared CLI plumbing: the reference's exact flag surface
(``tools/compress.py:18-41``) mapped onto CodecConfig overrides."""

from __future__ import annotations

import argparse

from rpcc.config import CodecConfig, DEFAULT_CODEC_YAML, LidarConfig, load_codec_config
from rpcc.data import __lidar_cfg__, __lidar_csv__


def add_codec_args(parser: argparse.ArgumentParser, datalist: bool = False) -> None:
    if datalist:
        parser.add_argument("--datalist", help="txt file listing input frames.")
        parser.add_argument("--output_dir", help="output directory mirroring input paths.")
        parser.add_argument("--workers", type=int, default=4, help="IO/entropy worker threads.")
        parser.add_argument("--batch", type=int, default=8, help="frames per device batch.")
        parser.add_argument("--output", action="store_true", help="verbose per-frame reports.")
        parser.add_argument(
            "--skip_existing", action="store_true",
            help="resume: skip frames whose output file already exists.",
        )
        parser.add_argument(
            "--keep_going", action="store_true",
            help="failure isolation: log per-frame errors and continue.",
        )
    else:
        parser.add_argument("--input", help="single frame input for static compression.")
        parser.add_argument("--output", help="output bitstream.")
    parser.add_argument(
        "--transfer_precision", choices=("f32", "u16", "i8", "m8"), default=None,
        help="host<->device wire code for the range image (default m8 — the "
        "benched flagship; 'f32' uploads exact depths, no snap grid).",
    )
    parser.add_argument(
        "--device_entropy", action=argparse.BooleanOptionalAction, default=None,
        help="rANS-code residual/contour ON device (rans coder only; "
        "default on — --no-device_entropy disables).",
    )
    parser.add_argument("--lidar", help="lidar type of this point cloud collection.")
    parser.add_argument(
        "--channel_distribute_csv", default=None,
        help="per-channel vertical-angle CSV for uneven LiDARs (overrides "
        "the registry default; reference dataset/transformer.py:13-22)",
    )
    parser.add_argument("--compressor_yaml", default=DEFAULT_CODEC_YAML)
    parser.add_argument("--basic_compressor", type=str, default=None, help="for manual setting.")
    parser.add_argument("--accuracy", type=float, default=None, help="for manual setting.")
    parser.add_argument("--segment_method", type=str, default=None, help="for manual setting.")
    parser.add_argument("--cluster_num", type=int, default=None, help="for manual setting.")
    parser.add_argument("--DBSCAN_eps", type=float, default=None, help="for manual setting.")
    parser.add_argument("--model_method", type=str, default=None, help="for manual setting.")
    parser.add_argument("--angle_threshold", type=float, default=None, help="for manual setting.")
    parser.add_argument("--nonuniform", action="store_true", help="for manual setting.")
    parser.add_argument("--eval", action="store_true", help="evaluate the reconstruction quality.")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU backend instead of the accelerator.")
    parser.add_argument("--seed", type=int, default=0, help="deterministic RANSAC seed.")


def use_cpu_backend() -> None:
    """Pin JAX to the CPU backend; raises if an accelerator is already in use
    (the platform list cannot change once a backend has initialized)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    platform = jax.devices()[0].platform
    if platform != "cpu":
        raise RuntimeError(
            f"--cpu did not take effect: JAX already runs on {platform!r}"
        )


def print_args(args: argparse.Namespace) -> None:
    print("Input arguments:")
    for key, val in vars(args).items():
        print("{:16} {}".format(key, val))


def config_from_args(args: argparse.Namespace) -> CodecConfig:
    if args.cpu:
        use_cpu_backend()
    cfg = load_codec_config(
        args.compressor_yaml,
        basic_compressor=args.basic_compressor,
        accuracy=args.accuracy,
        segment_method=args.segment_method,
        cluster_num=args.cluster_num,
        dbscan_eps=args.DBSCAN_eps,
        modeling_method=args.model_method,
        plane_angle_threshold=args.angle_threshold,
        seed=args.seed,
    )
    if args.nonuniform:
        cfg = cfg.replace(compress_framework="non-uniform")
    if args.cpu:
        # Reference parity: --cpu also switches FPS to the filtered-set
        # semantics of the CPU branch (utils/segment_utils.py:120-124).
        cfg = cfg.replace(cpu_fps=True)
    if getattr(args, "transfer_precision", None):
        cfg = cfg.replace(transfer_precision=args.transfer_precision)
    if getattr(args, "device_entropy", None) is not None:
        cfg = cfg.replace(device_entropy=bool(args.device_entropy))
    return cfg


def lidar_from_args(args: argparse.Namespace) -> LidarConfig:
    assert args.lidar in __lidar_cfg__, (
        f"unknown --lidar {args.lidar}; choose from {sorted(__lidar_cfg__)}"
    )
    csv = getattr(args, "channel_distribute_csv", None) or __lidar_csv__[args.lidar]
    return LidarConfig.from_yaml(
        __lidar_cfg__[args.lidar], csv, name=args.lidar
    )
