"""Function-level API parity with the reference ``utils/compress_utils.py``.

``compress_point_cloud`` / ``decompress_point_cloud`` /
``save_compressed_bitstream`` / ``read_compressed_bitstream`` with the same
signatures and field conventions (``compress_utils.py:138-214``), built on
the codec's device outputs.  The ``full=True`` debug mode additionally
carries the raw point cloud / range image / per-class residual streams in
the compressed dict (like the reference, these extra fields are *not*
written by ``save_compressed_bitstream``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from rpcc.codec.bitstream import (  # noqa: F401  (re-export)
    read_compressed_bitstream,
    save_compressed_bitstream,
)
from rpcc.codec.entropy import BasicCompressor
from rpcc.ops.contour import extract_contour


def compress_point_cloud(
    basic_compressor: BasicCompressor,
    plane_param: np.ndarray,
    cluster_idx: np.ndarray,
    salience_level: Optional[np.ndarray],
    nonzero_residual_quantized: np.ndarray,
    ground_residual_quantized: Optional[np.ndarray] = None,
    cluster_residual_quantized: Optional[np.ndarray] = None,
    point_cloud: Optional[np.ndarray] = None,
    range_image: Optional[np.ndarray] = None,
    full: bool = False,
) -> Tuple[Dict[str, np.ndarray], Dict[str, bytes]]:
    import jax.numpy as jnp

    original_data: Dict[str, np.ndarray] = {}
    original_data["residual_quantized"] = np.asarray(nonzero_residual_quantized).astype(np.int16)

    if full:
        if point_cloud is not None:
            original_data["point_cloud"] = np.asarray(point_cloud).astype(np.float32)
        if range_image is not None:
            original_data["range_image"] = np.asarray(range_image).astype(np.float32)
        if ground_residual_quantized is not None:
            original_data["ground_residual"] = np.asarray(ground_residual_quantized).astype(np.int16)
        if cluster_residual_quantized is not None:
            original_data["cluster_residual"] = np.asarray(cluster_residual_quantized).astype(np.int16)

    if salience_level is not None:
        original_data["salience_level"] = np.asarray(salience_level).astype(np.uint8)

    code = extract_contour(jnp.asarray(np.asarray(cluster_idx).astype(np.int32)))
    contour = np.asarray(code.contour).astype(bool)
    seq = np.asarray(code.sequence)[: int(code.seq_len)]
    original_data["contour_map"] = np.packbits(contour, axis=None).astype(np.uint8)
    original_data["idx_sequence"] = seq.astype(np.uint16)
    original_data["plane_param"] = np.asarray(plane_param).astype(np.float32)

    compressed_data = basic_compressor.compress_dict(original_data)
    return original_data, compressed_data


def decompress_point_cloud(
    compressed_data: Dict[str, bytes],
    basic_compressor: BasicCompressor,
    model_num: int,
    H: int,
    W: int,
):
    """Entropy-decode + recover the seg map.  Unlike the reference (which
    shapes the model table as (model_num, 4) over a larger buffer — SURVEY §5
    pitfall 4), the true model count comes from the field length."""
    import jax.numpy as jnp

    from rpcc.ops.contour import recover_map

    decompressed = basic_compressor.decompress_dict(compressed_data)
    plane_param = np.frombuffer(decompressed["plane_param"], np.float32).reshape(-1, 4)
    contour = np.unpackbits(np.frombuffer(decompressed["contour_map"], np.uint8))
    contour = contour[: H * W].reshape(H, W)
    idx_sequence = np.frombuffer(decompressed["idx_sequence"], np.uint16)
    seq_pad = np.zeros((H * W,), np.int32)
    seq_pad[: idx_sequence.shape[0]] = idx_sequence
    idx_map = np.asarray(
        recover_map(jnp.asarray(contour.astype(np.int32)), jnp.asarray(seq_pad))
    )
    salience_level = None
    if "salience_level" in decompressed:
        salience_level = np.frombuffer(decompressed["salience_level"], np.uint8)
    residual_quantized = np.frombuffer(decompressed["residual_quantized"], np.int16)
    return residual_quantized, idx_map, salience_level, plane_param
