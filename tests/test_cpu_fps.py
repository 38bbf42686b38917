"""Reference --cpu branch FPS semantics: filtered-set sampling
(utils/segment_utils.py:120-124) vs a direct numpy port."""

import jax
import jax.numpy as jnp
import numpy as np

from rpcc.config import CodecConfig
from rpcc.models.pipeline import RPCCCodec, pad_points
from rpcc.ops.projection import build_transform_planes, project_points
from rpcc.ops.segment import segment_range_image
from tests.test_roundtrip import SMALL, synth_scene


def numpy_fps(pts: np.ndarray, k: int) -> np.ndarray:
    """CUDA-op semantics: seed 0, strict-greater scan (lowest index ties)."""
    n = pts.shape[0]
    idx = np.zeros(k, np.int64)
    min_d2 = np.full(n, 1e10, np.float32)
    last = 0
    for i in range(1, k):
        d2 = ((pts - pts[last]) ** 2).sum(-1).astype(np.float32)
        min_d2 = np.minimum(min_d2, d2)
        last = int(np.argmax(min_d2))
        idx[i] = last
    return idx


def test_cpu_fps_matches_reference_port():
    K = 8
    pc = synth_scene(seed=11)
    lidar = SMALL
    tm = jnp.asarray(build_transform_planes(lidar))
    ri = project_points(jnp.asarray(pad_points(pc)), lidar, None)
    pc_planes = ri[None, :, :] * tm

    res = segment_range_image(
        pc_planes, ri, tm, jax.random.PRNGKey(0), 0.5, K, cpu_fps=True
    )
    centers_dev = np.asarray(res.centers)

    # numpy port of the CPU branch, driven by the same ground plane
    g = np.asarray(res.ground_model)
    grid = np.transpose(np.asarray(pc_planes), (1, 2, 0)).reshape(-1, 3)
    vert = np.abs(grid @ g[:3] + g[3]) / np.linalg.norm(g[:3])
    pc_left = grid[vert > 0.5]  # row-major filtered set (zero px included)
    centers_port = pc_left[numpy_fps(pc_left.astype(np.float32), K)]

    assert np.allclose(centers_dev, centers_port, atol=1e-5), (
        f"centers differ:\n{centers_dev}\nvs port\n{centers_port}"
    )


def test_cpu_fps_roundtrip():
    cfg_cpu = CodecConfig(cluster_num=16, cpu_fps=True)
    pc = synth_scene(seed=12)
    codec_cpu = RPCCCodec(SMALL, cfg_cpu)
    blob, _, _ = codec_cpu.compress(pc)
    _, ri_rec, _ = codec_cpu.decompress(blob)
    ri = np.asarray(codec_cpu.encode_device(pc).range_image)
    assert np.abs(ri_rec - ri).max() <= cfg_cpu.step + 1e-5
