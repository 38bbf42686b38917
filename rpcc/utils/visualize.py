"""Visualization helpers (reference ``utils/visualize_utils.py`` parity).

The reference opens interactive open3d viewers; on a headless host we
render matplotlib figures to files instead (same information: point clouds
colored by error, range/contour/key-point maps, vertical-angle histograms)
and write .pcd/.ply via rpcc.data.pointcloud_io for external viewers.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from rpcc.data.pointcloud_io import save_point_cloud


def save_point_cloud_to_pcd(point_cloud: np.ndarray, file: str) -> None:
    save_point_cloud(file, point_cloud.reshape(-1, point_cloud.shape[-1]))


def _scatter3(ax, pc, c, s=0.1, cmap=None, label=None):
    return ax.scatter(pc[:, 0], pc[:, 1], pc[:, 2], c=c, s=s, cmap=cmap, label=label)


def compare_point_clouds(
    pc1: np.ndarray,
    pc2: np.ndarray,
    vis_all: bool = True,
    save: bool = False,
    vis: bool = False,
    save_path: str = "compare.png",
) -> Optional[str]:
    """Side-by-side + overlay rendering of two clouds (error-colored)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    a = pc1.reshape(-1, 3)
    b = pc2.reshape(-1, 3)
    a = a[np.sum(a, -1) != 0]
    b = b[np.sum(b, -1) != 0]
    fig = plt.figure(figsize=(15, 5))
    ax1 = fig.add_subplot(131, projection="3d")
    _scatter3(ax1, a, "tab:blue")
    ax1.set_title(f"cloud 1 ({a.shape[0]} pts)")
    ax2 = fig.add_subplot(132, projection="3d")
    _scatter3(ax2, b, "tab:orange")
    ax2.set_title(f"cloud 2 ({b.shape[0]} pts)")
    ax3 = fig.add_subplot(133, projection="3d")
    _scatter3(ax3, a, "tab:blue")
    _scatter3(ax3, b, "tab:orange")
    ax3.set_title("overlay")
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return save_path


def visualize_range_image(range_image: np.ndarray, save_path: str = "range.png") -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ri = np.asarray(range_image)
    if ri.ndim == 3:
        ri = ri[..., 0]
    fig, ax = plt.subplots(figsize=(16, 3))
    im = ax.imshow(ri, aspect="auto", cmap="turbo")
    fig.colorbar(im, ax=ax, label="depth (m)")
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return save_path


def visualize_key_point_map(
    range_image: np.ndarray, key_point_map: np.ndarray, save_path: str = "keypoints.png"
) -> str:
    """Range image with key points overlaid by label (3 sharp / 2 / 1 flat)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ri = np.asarray(range_image)
    if ri.ndim == 3:
        ri = ri[..., 0]
    kp = np.asarray(key_point_map)
    if kp.ndim == 3:
        kp = kp[..., 0]
    fig, ax = plt.subplots(figsize=(16, 3))
    ax.imshow(ri, aspect="auto", cmap="gray")
    colors = {3: "red", 2: "orange", 1: "lime"}
    for label, c in colors.items():
        ys, xs = np.where(kp == label)
        ax.scatter(xs, ys, s=2, c=c, label=f"kp={label}")
    ax.legend(markerscale=4)
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return save_path


def visualize_seg_map(seg_idx: np.ndarray, save_path: str = "segmap.png") -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(16, 3))
    im = ax.imshow(np.asarray(seg_idx), aspect="auto", cmap="tab20", interpolation="nearest")
    fig.colorbar(im, ax=ax, label="cluster id")
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return save_path


def visualize_points_vertical_angle_distribution(
    points: np.ndarray, bins: int = 256, save_path: str = "vangles.png"
) -> str:
    """Histogram of per-point elevation angles (LiDAR channel discovery)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pc = points.reshape(-1, points.shape[-1])[:, :3]
    pc = pc[np.sum(pc, -1) != 0]
    el = np.degrees(np.arctan2(pc[:, 2], np.linalg.norm(pc[:, :2], axis=-1)))
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.hist(el, bins=bins)
    ax.set_xlabel("vertical angle (deg)")
    ax.set_ylabel("points")
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return save_path


def visualize_error_colored(
    pc_orig: np.ndarray, pc_rec: np.ndarray, save_path: str = "error.png"
) -> str:
    """Reconstruction colored by nearest-neighbor error to the original."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from rpcc.metrics.chamfer import nn_distances

    a = pc_orig.reshape(-1, 3)
    b = pc_rec.reshape(-1, 3)
    a = a[np.sum(a, -1) != 0]
    b = b[np.sum(b, -1) != 0]
    d2, _, _, _ = nn_distances(b, a)
    err = np.sqrt(d2)
    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(111, projection="3d")
    sc = _scatter3(ax, b, err, cmap="turbo")
    fig.colorbar(sc, ax=ax, label="NN error (m)")
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return save_path
