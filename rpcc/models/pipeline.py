"""Host orchestration: device encode/decode <-> entropy coding <-> .rpcc.

This is the single-frame engine behind the CLIs (the batched/sharded engine
lives in rpcc/parallel).  Replaces the body of ``tools/compress.py:44-156``
and ``tools/decompress.py:45-115``.

Host<->device contract: point clouds are zero-padded to a shape bucket
(multiples of ``PAD_QUANTUM``) so jit caches stay small; every device output
is fixed-shape with an explicit length, trimmed here before entropy coding.

Bitstream fields (byte-compatible with the reference, compress_utils.py:138-
164): residual stream int16 LE, salience uint8, contour packbits-uint8, index
sequence uint16, model table float32.  One conscious fix (SURVEY.md §5 pitfall
4): the decoder derives the model count from the field length instead of
assuming cluster_num+1.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import jax
import numpy as np

from rpcc.codec.bitstream import pack_bitstream, unpack_bitstream
from rpcc.codec.entropy import BasicCompressor
from rpcc.config import CodecConfig, LidarConfig
from rpcc.models.decoder import make_decoder
from rpcc.models.encoder import make_encoder
from rpcc.runtime import setup_compile_cache

PAD_QUANTUM = 16384


def pad_points(points: np.ndarray, quantum: int = PAD_QUANTUM) -> np.ndarray:
    """Zero-pad an (N, >=3) cloud to the next bucket; zeros never project."""
    pc = np.asarray(points, dtype=np.float32)[:, :3]
    n = pc.shape[0]
    target = max(quantum, ((n + quantum - 1) // quantum) * quantum)
    if target == n:
        return pc
    out = np.zeros((target, 3), dtype=np.float32)
    out[:n] = pc
    return out


class RPCCCodec:
    """A configured encoder/decoder pair for one LiDAR geometry."""

    def __init__(self, lidar: LidarConfig, cfg: CodecConfig):
        setup_compile_cache()
        self.lidar = lidar
        self.cfg = cfg
        from rpcc.models.encoder import num_model_rows

        self.H, self.W = lidar.height, lidar.width
        self.hw = self.H * self.W
        self.num_models = num_model_rows(cfg)
        from rpcc.ops.projection import build_transform_map

        self.transform_map = build_transform_map(lidar)  # (H, W, 3) np.float32
        # Production encode takes the host-projected range image (numpy
        # binning + native scatter-min): 3x smaller uploads, no device
        # compaction sorts, backend-independent bitstreams.
        # device_entropy is a batch-engine downlink optimization: the
        # single-frame path entropy-codes on host, so building the in-graph
        # rANS here would force its outputs (+30% device time) and then
        # discard them — drop the flag for this encoder only.
        enc_cfg = cfg.replace(device_entropy=False) if cfg.device_entropy else cfg
        self._encode = make_encoder(lidar, enc_cfg, from_ri=True)
        self._decode = make_decoder(lidar, cfg)
        self.entropy = BasicCompressor(
            method_name=cfg.basic_compressor, contour_shape=(self.H, self.W)
        )

    @property
    def _step_arg(self) -> np.ndarray:
        if self.cfg.uniform:
            return np.float32(self.cfg.step)
        return np.asarray(self.cfg.level_acc, dtype=np.float32)

    # ------------------------------------------------------------- encode
    def encode_device(self, points: np.ndarray, seed: Optional[int] = None):
        """Host-project, then run the device graph; returns the EncoderOutput.

        In the reduced transfer modes ('u16'/'i8'/'m8') the batch engine
        quantizes the u16-snapped grid; apply the same snap here so the
        single-frame path emits the same bitstream bytes as the engine for
        the same config + cloud + seed (i8/m8 reconstruct the exact u16
        grid, so one snap covers all three)."""
        pts = np.asarray(points, np.float32)[:, :3]
        if self.cfg.transfer_precision != "f32":
            from rpcc.ops.projection import project_points_host_u16

            q, d = project_points_host_u16(
                pts, self.lidar, np.float32(self.cfg.step / 16.0)
            )
            ri = q.astype(np.float32) * d
        else:
            from rpcc.ops.projection import project_points_host

            ri = project_points_host(pts, self.lidar)
        seed = self.cfg.seed if seed is None else seed
        return self._encode(ri, np.uint32(seed), self._step_arg)

    def fields_from_device(self, out) -> Dict[str, np.ndarray]:
        """Trim fixed-shape device outputs into bitstream field arrays."""
        stream_len = int(out.stream_len)
        seq_len = int(out.seq_len)
        stream = np.asarray(out.stream[:stream_len])  # int16 already
        fields = {
            "residual_quantized": stream.astype(np.int16),
            "contour_map": np.asarray(out.contour_packed),  # packed on device
            "idx_sequence": np.asarray(out.sequence[:seq_len]),  # uint16 already
            "plane_param": np.asarray(out.model_param).astype(np.float32),
        }
        if out.salience is not None:
            fields["salience_level"] = np.asarray(out.salience).astype(np.uint8)
        return fields

    def compress(
        self, points: np.ndarray, seed: Optional[int] = None
    ) -> Tuple[bytes, Dict[str, np.ndarray], Dict[str, float]]:
        """points -> (.rpcc payload bytes, raw fields, stage timings)."""
        t0 = time.perf_counter()
        out = self.encode_device(points, seed)
        out = jax.block_until_ready(out)
        t1 = time.perf_counter()
        fields = self.fields_from_device(out)
        t2 = time.perf_counter()
        compressed = self.entropy.compress_dict(fields)
        t3 = time.perf_counter()
        blob = pack_bitstream(compressed, uniform=self.cfg.uniform)
        t4 = time.perf_counter()
        times = {
            "device_encode": t1 - t0,
            "gather_fields": t2 - t1,
            "entropy": t3 - t2,
            "framing": t4 - t3,
        }
        return blob, fields, times

    # ------------------------------------------------------------- decode
    def fields_to_device(self, fields: Dict[str, bytes]):
        """Entropy-decoded field bytes -> padded device input arrays."""
        hw = self.hw
        contour = np.frombuffer(fields["contour_map"], np.uint8)  # device unpacks
        seq = np.frombuffer(fields["idx_sequence"], np.uint16).astype(np.int32)
        seq_pad = np.zeros((hw,), np.int32)
        seq_pad[: seq.shape[0]] = seq
        stream = np.frombuffer(fields["residual_quantized"], np.int16).astype(np.int32)
        stream_pad = np.zeros((hw,), np.int32)
        stream_pad[: stream.shape[0]] = stream
        # True model count from the field length (pitfall-4 fix).
        model_param = np.frombuffer(fields["plane_param"], np.float32).reshape(-1, 4)
        salience = None
        if "salience_level" in fields:
            salience = np.frombuffer(fields["salience_level"], np.uint8).astype(np.int32)
        return contour, seq_pad, stream_pad, model_param, salience

    def decompress(self, blob: bytes) -> Tuple[np.ndarray, np.ndarray, Dict[str, float]]:
        """.rpcc payload -> ((H,W,3) cloud, (H,W) range image, timings)."""
        t0 = time.perf_counter()
        compressed = unpack_bitstream(blob, uniform=self.cfg.uniform)
        fields = self.entropy.decompress_dict(compressed)
        t1 = time.perf_counter()
        contour, seq, stream, model_param, salience = self.fields_to_device(fields)
        if salience is None:
            dec = self._decode(contour, seq, stream, model_param, self._step_arg)
        else:
            dec = self._decode(contour, seq, stream, model_param, self._step_arg, salience)
        dec = jax.block_until_ready(dec)
        # Download the range image only (3x fewer bytes than the cloud);
        # back-project on host.
        ri = np.asarray(dec.range_image)
        pc = ri[..., None] * self.transform_map
        t2 = time.perf_counter()
        times = {"entropy": t1 - t0, "device_decode": t2 - t1}
        return pc, ri, times
