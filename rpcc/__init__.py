"""rpcc — a JAX/XLA range-image LiDAR point-cloud compression framework.

Re-designed from scratch with the capabilities of R-PCC (StevenWang30/R-PCC,
ICRA 2022, arXiv 2109.07717): spherical projection to range images,
ground-RANSAC + FPS/DBSCAN segmentation, point/plane cluster modeling,
intra-prediction, uniform / salience-driven non-uniform residual quantization,
contour-coded segmentation maps and pluggable entropy coding — but organized
as batched, fixed-shape, jit-compiled JAX programs over ``(B, H, W)`` range
maps sharded across a device mesh, instead of per-frame Python/C++/CUDA calls.

Layers (bottom-up):
  * :mod:`rpcc.ops`      — pure-JAX geometry + codec kernels.
  * :mod:`rpcc.models`   — the device encoder/decoder graphs.
  * :mod:`rpcc.codec`    — host bitstream framing + entropy coders.
  * :mod:`rpcc.parallel` — mesh/shard_map batch data-parallelism.
  * :mod:`rpcc.data`     — dataset registry, LiDAR geometry, file IO.
  * :mod:`rpcc.metrics`  — chamfer/F1/PSNR evaluation.
  * :mod:`rpcc.cli`      — compress/decompress (single frame + datalist).
"""

from rpcc.version import __version__

__all__ = ["__version__"]
