"""Pure-numpy oracle of the reference R-PCC host path, for parity tests.

An independent, deliberately-naive port of the reference's composed host
pipeline so this codec can be byte-checked against reference semantics
without torch/o3d/CUDA:

- ``extract_contour`` / ``recover_map``: the python versions the reference
  keeps commented next to its C++ (``utils/contour_utils.py:197-227``),
  which match ``cpp_modules.cpp:521-593``.
- ``uniform_quantize`` / ``nonuniform_quantize``: the C++ bucket loops
  (``cpp_modules.cpp:288-424``) — cluster-id-major, row-major within, id 1
  skipped, C ``round()`` (half away from zero), salience-level rules.
- ``dequantize_residual``: the python scatter loop
  (``utils/compress_utils.py:114-132``).
- ``intra_predict``: the per-pixel model lookup (``cpp_modules.cpp:248-285``),
  including the read-past-the-view accident of SURVEY §5 pitfall 4 (the full
  model buffer is used, whatever ``model_num`` the caller believes).
- ``compress_point_cloud`` / ``decompress_point_cloud`` /
  ``pack_bitstream`` / ``unpack_bitstream`` /
  ``save_compressed_bitstream`` / ``read_compressed_bitstream``:
  field dict construction, per-field byte coding and the 4-byte ``'i'``
  length-prefixed .rpcc framing (``utils/compress_utils.py:138-214``).

Everything here favors clarity/faithfulness over speed; it exists only to
stand in for reference-produced bitstreams in tests.
"""

from __future__ import annotations

import bz2
import gzip
import struct
import zlib

import numpy as np


def c_round(x: np.ndarray) -> np.ndarray:
    """C ``round()``: half away from zero (numpy rint is half-to-even)."""
    x = np.asarray(x)
    return np.sign(x) * np.floor(np.abs(x) + 0.5)


# --------------------------------------------------------------- contour

def extract_contour(idx_map: np.ndarray):
    """contour=1 at col 0 and wherever id != left neighbor; sequence is the
    id at each contour=1 position, row-major (utils/contour_utils.py:197-203)."""
    idx_map = np.asarray(idx_map)
    contour = np.zeros(idx_map.shape, np.int32)
    contour[:, 0] = 1
    contour[:, 1:] = (idx_map[:, 1:] != idx_map[:, :-1]).astype(np.int32)
    idx_sequence = idx_map[contour == 1]
    return contour, idx_sequence


def recover_map(contour_map: np.ndarray, idx_sequence: np.ndarray) -> np.ndarray:
    """The reference's run-length pointer fill (utils/contour_utils.py:210-227)."""
    cm_flat = np.asarray(contour_map).reshape(-1)
    idx_map = np.zeros(cm_flat.shape[0], np.int64)
    pointer = 0
    for value in np.asarray(idx_sequence):
        if pointer >= cm_flat.shape[0]:
            break
        idx_map[pointer] = value
        pointer += 1
        while pointer < cm_flat.shape[0] and cm_flat[pointer] == 0:
            idx_map[pointer] = value
            pointer += 1
    return idx_map.reshape(contour_map.shape)


# --------------------------------------------------------------- quantize

def uniform_quantize(seg_idx: np.ndarray, residual: np.ndarray, acc: float) -> np.ndarray:
    """cpp_modules.cpp:288-334: per-cluster buckets in id order, skip id 1."""
    seg_idx = np.asarray(seg_idx)
    res = np.asarray(residual).reshape(seg_idx.shape).astype(np.float32)
    out = []
    for m in range(int(seg_idx.max()) + 1):
        if m == 1:
            continue
        vals = res[seg_idx == m]  # np.where order == row-major C++ scan order
        out.append(c_round(vals / np.float32(acc)).astype(np.int32))
    return np.concatenate(out) if out else np.zeros((0,), np.int32)


def nonuniform_quantize(
    seg_idx: np.ndarray,
    residual: np.ndarray,
    key_point_map: np.ndarray,
    level_kp_num,
    level_acc,
    ground_level: int,
):
    """cpp_modules.cpp:337-424: salience level per cluster, per-level acc."""
    seg_idx = np.asarray(seg_idx)
    res = np.asarray(residual).reshape(seg_idx.shape).astype(np.float32)
    kp = np.asarray(key_point_map).reshape(seg_idx.shape)
    level_kp_num = np.asarray(level_kp_num)
    level_acc = np.asarray(level_acc, np.float32)
    level_num = level_acc.shape[0]
    cluster_num = int(seg_idx.max()) + 1

    salience = np.zeros(cluster_num, np.int32)
    for i in range(cluster_num):
        if i == 0:
            salience[i] = ground_level
        elif i == 1:
            salience[i] = level_num - 1
        else:
            mask = seg_idx == i
            p_num = int(mask.sum())
            kp_num = int((kp[mask] > 0).sum())
            if p_num < 30:
                salience[i] = level_num - 1
            else:
                for l in range(level_num):
                    if kp_num >= level_kp_num[l]:
                        salience[i] = l
                        break

    out = []
    for m in range(cluster_num):
        if m == 1:
            continue
        vals = res[seg_idx == m]
        out.append(c_round(vals / level_acc[salience[m]]).astype(np.int32))
    stream = np.concatenate(out) if out else np.zeros((0,), np.int32)
    return stream, salience


def dequantize_residual(quantized_residual, seg_idx, acc, salience_level=None):
    """utils/compress_utils.py:114-132 (uniform: ``acc`` scalar; non-uniform:
    ``acc`` is the per-level table and ``salience_level`` selects)."""
    seg_idx = np.asarray(seg_idx)
    residual = np.zeros_like(seg_idx, dtype=np.float32)
    start = 0
    q = np.asarray(quantized_residual)
    for m in range(int(seg_idx.max()) + 1):
        if m == 1:
            continue
        idx = np.where(seg_idx == m)
        cur_acc = acc if salience_level is None else acc[salience_level[m]]
        n = idx[0].shape[0]
        residual[idx] = q[start : start + n] * np.float32(cur_acc)
        start += n
    assert start == q.shape[0], "residual stream length mismatch"
    return residual


# --------------------------------------------------------------- predict

def intra_predict(seg_idx: np.ndarray, model_param: np.ndarray, transform_map: np.ndarray) -> np.ndarray:
    """cpp_modules.cpp:248-285 in f32: point model (a+b+c==0) => constant d;
    plane => -d / (a*A + b*B + c*C).  ``model_param`` is the FULL table the
    encoder wrote — the reference decoder's (model_num, 4) prefix view reads
    past its extent into this same buffer (SURVEY §5 pitfall 4)."""
    seg_idx = np.asarray(seg_idx)
    mp = np.asarray(model_param, np.float32).reshape(-1, 4)
    tm = np.asarray(transform_map, np.float32)
    p = mp[seg_idx]  # (H, W, 4)
    dot = (
        p[..., 0] * tm[..., 0] + p[..., 1] * tm[..., 1] + p[..., 2] * tm[..., 2]
    ).astype(np.float32)
    is_point = (p[..., 0] + p[..., 1] + p[..., 2]) == 0
    with np.errstate(divide="ignore", invalid="ignore"):
        plane = (-p[..., 3] / dot).astype(np.float32)
    return np.where(is_point, p[..., 3], plane).astype(np.float32)


# --------------------------------------------------------------- entropy

def byte_compress(method: str, arr) -> bytes:
    buf = arr.tobytes() if isinstance(arr, np.ndarray) else bytes(arr)
    if method == "bzip2":
        return bz2.compress(buf)
    if method in ("gzip", "deflate"):
        return gzip.compress(buf)
    if method == "lz4":
        # reference uses pip lz4 0.7.0 dumps(); our codec writes the same
        # wire format — tests route lz4 through the repo codec instead.
        raise NotImplementedError("oracle lz4 handled via rpcc codec")
    raise ValueError(method)


def byte_decompress(method: str, blob: bytes) -> bytes:
    if method == "bzip2":
        return bz2.decompress(blob)
    if method in ("gzip", "deflate"):
        return zlib.decompress(blob, 31)
    raise ValueError(method)


# --------------------------------------------------------------- host path

def compress_point_cloud(
    method: str,
    plane_param: np.ndarray,
    cluster_idx: np.ndarray,
    salience_level,
    nonzero_residual_quantized: np.ndarray,
):
    """utils/compress_utils.py:138-164 (full=False path)."""
    original = {}
    original["residual_quantized"] = np.asarray(nonzero_residual_quantized).astype(np.int16)
    if salience_level is not None:
        original["salience_level"] = np.asarray(salience_level).astype(np.uint8)
    contour_map, idx_sequence = extract_contour(cluster_idx)
    original["contour_map"] = np.packbits(contour_map.astype(bool), axis=None)
    original["idx_sequence"] = idx_sequence.astype(np.uint16)
    original["plane_param"] = np.asarray(plane_param).astype(np.float32)
    compressed = {k: byte_compress(method, v) for k, v in original.items()}
    return original, compressed


def pack_bitstream(compressed: dict, uniform: bool = True) -> bytes:
    """utils/compress_utils.py:167-179 framing, as bytes."""
    parts = []
    if not uniform:
        parts += [struct.pack("i", len(compressed["salience_level"])), compressed["salience_level"]]
    for name in ("contour_map", "idx_sequence", "plane_param", "residual_quantized"):
        parts += [struct.pack("i", len(compressed[name])), compressed[name]]
    return b"".join(parts)


def save_compressed_bitstream(file: str, compressed: dict, uniform: bool = True) -> None:
    with open(file, "wb") as f:
        f.write(pack_bitstream(compressed, uniform))


def unpack_bitstream(buf: bytes, uniform: bool = True) -> dict:
    """utils/compress_utils.py:182-196."""
    out = {}
    off = 0
    names = ("contour_map", "idx_sequence", "plane_param", "residual_quantized")
    if not uniform:
        names = ("salience_level",) + names
    for name in names:
        (length,) = struct.unpack_from("i", buf, off)
        off += 4
        out[name] = buf[off : off + length]
        off += length
    return out


def read_compressed_bitstream(file: str, uniform: bool = True) -> dict:
    with open(file, "rb") as f:
        return unpack_bitstream(f.read(), uniform)


def decompress_point_cloud(compressed: dict, method: str, model_num: int, H: int, W: int):
    """utils/compress_utils.py:199-214.  ``model_num`` is what the reference
    decoder *believes* (cluster_num+1 — one short, pitfall 4); the returned
    ``plane_param_full`` is the whole buffer its C++ actually reads from."""
    dec = {k: byte_decompress(method, v) for k, v in compressed.items()}
    plane_param_full = np.frombuffer(dec["plane_param"], np.float32).reshape(-1, 4)
    plane_param_view = plane_param_full[:model_num]
    contour = np.unpackbits(np.frombuffer(dec["contour_map"], np.uint8))
    contour = contour[: H * W].reshape(H, W)
    idx_sequence = np.frombuffer(dec["idx_sequence"], np.uint16)
    idx_map = recover_map(contour, idx_sequence)
    salience = None
    if "salience_level" in dec:
        salience = np.frombuffer(dec["salience_level"], np.uint8)
    residual_quantized = np.frombuffer(dec["residual_quantized"], np.int16)
    return residual_quantized, idx_map, salience, plane_param_view, plane_param_full


def assert_streams_agree(q_ours, q_oracle, residual_stream, step_stream, tol=1e-3):
    """Quantized streams must be equal except off-by-one flips at slots whose
    residual/step sits within ``tol`` of a .5 boundary (FMA/ulp artifacts)."""
    q_ours = np.asarray(q_ours, np.int64)
    q_oracle = np.asarray(q_oracle, np.int64)
    assert q_ours.shape == q_oracle.shape
    diff = np.nonzero(q_ours != q_oracle)[0]
    if diff.size == 0:
        return
    assert np.abs(q_ours - q_oracle)[diff].max() <= 1
    frac = residual_stream[diff] / step_stream[diff]
    dist = np.abs(np.abs(frac - np.trunc(frac)) - 0.5)
    assert dist.max() < tol, f"non-boundary quantizer disagreement at {diff[dist >= tol][:5]}"
    assert diff.size <= max(2, int(0.005 * q_ours.size)), "too many boundary flips"
