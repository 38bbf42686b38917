"""Native host decoder: .rpcc bitstream -> range image / points, no device.

The device decode path uploads ~150 KB/frame of entropy-decoded arrays and
downloads a ~256 KB/frame range image, while the reconstruction itself
(run-length seg fill, cluster-ordered dequantize, intra-predict —
``tools/decompress.py:87-112``) is one pass of branch-free float math.  This module runs that math on the host: the
fused C++ kernel (codec/native/decode.cpp) when available, with a
bit-identical vectorized numpy fallback.

The device decoder (models/decoder.py) remains the scaling path — frames
shard over the mesh with zero cross-frame communication; this is the
latency/throughput path for single-host datalist decode.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from rpcc.codec.bitstream import unpack_bitstream
from rpcc.codec.entropy import BasicCompressor
from rpcc.config import CodecConfig, LidarConfig
from rpcc.ops.projection import build_transform_planes


def _decode_frame_np(
    contour_packed: np.ndarray,
    seq: np.ndarray,
    stream: np.ndarray,
    models: np.ndarray,
    salience: Optional[np.ndarray],
    level_acc: Optional[np.ndarray],
    step: float,
    tm: np.ndarray,  # (3, HW) f32
    H: int,
    W: int,
) -> np.ndarray:
    """Vectorized numpy twin of ``host_decode_frame`` (bit-identical)."""
    hw = H * W
    M = models.shape[0]
    bits = np.unpackbits(contour_packed)[:hw]
    run_idx = np.cumsum(bits) - 1
    seq = np.asarray(seq, np.int64)
    if seq.shape[0]:
        seg = seq[np.minimum(run_idx, seq.shape[0] - 1)].astype(np.int32)
        # A well-formed contour sets bit 0, but a corrupt one may not:
        # run_idx = -1 would wrap to seq[-1] here while the native kernel
        # keeps id 0 (cur starts at 0) until the first set bit — pin the
        # native rule so both backends decode corrupt planes identically.
        seg = np.where(run_idx < 0, np.int32(0), seg)
    else:
        seg = np.zeros(hw, np.int32)
    # stream slot per pixel: stable sort by (remapped id, pixel) — id 1 last
    key = np.where(seg == 1, M, seg)
    perm = np.argsort(key, kind="stable")
    q_pad = np.zeros(hw, np.float32)
    n_s = min(stream.shape[0], hw)
    q_pad[:n_s] = stream[:n_s].astype(np.float32)
    q_pix = np.empty(hw, np.float32)
    q_pix[perm] = q_pad
    mrows = models[np.clip(seg, 0, M - 1)]
    a, b, c, d = mrows[:, 0], mrows[:, 1], mrows[:, 2], mrows[:, 3]
    denom = a * tm[0] + b * tm[1] + c * tm[2]
    with np.errstate(divide="ignore", invalid="ignore"):
        plane_pred = np.where(denom == 0.0, np.float32(0.0), -d / np.where(denom == 0.0, 1.0, denom))
    pred = np.where(a + b + c == 0.0, d, plane_pred).astype(np.float32)
    if salience is not None and level_acc is not None:
        # Out-of-range salience levels clamp to the LAST level — the same
        # rule as the device decoder's clamped gather (step[salience]) and
        # the native kernel, so corrupt salience decodes identically on
        # every backend.
        lv = salience[np.clip(seg, 0, M - 1)].astype(np.int64)
        st = level_acc[np.minimum(lv, level_acc.shape[0] - 1)]
    else:
        st = np.float32(step)
    ri = pred + q_pix * st
    # id 1 (zero pixels) and out-of-range ids >= M decode to r = 0, matching
    # the native kernel's `id != 1 && id >= 0 && id < M` guard — a decoder
    # configured with a smaller cluster_num than the encoder must produce
    # the same output from either backend.
    return np.where((seg == 1) | (seg >= M), np.float32(0.0), ri).reshape(H, W)


def d8_reconstruct_batch(
    d8: np.ndarray,  # (B, H, W) i8
    pd: np.ndarray,  # (B, CAP) u16 exception position deltas
    val: np.ndarray,  # (B, CAP) u16 exception grid values
    n_exc: np.ndarray,  # (B,) i32
    delta: np.ndarray,  # (B,) f32 per-frame snap grid
) -> np.ndarray:
    """Invert the device decoder's i8 row-delta downlink -> (B, H, W) f32.

    The wire code is the encode uplink's (project_points_host_d8): flat
    first-differences of the u16 snap grid as i8, with a position-sorted
    (pos-delta u16, value u16) exception list.  Output is byte-identical to
    ``range_u16.astype(f32) * delta`` (q <= 65535 is exact in f32, one
    multiply — same order as the u16 downlink path).  Fused native single
    pass when available; frames with ``n_exc > CAP`` are reconstructed from
    the truncated list here and must be overwritten by the caller's u16
    fallback.
    """
    from rpcc.codec.lz4block import native_lib

    B, H, W = d8.shape
    hw = H * W
    cap = pd.shape[1]
    out = np.empty((B, H, W), np.float32)
    lib = native_lib()
    if lib is not None and hasattr(lib, "d8_reconstruct_batch"):
        import ctypes as ct

        d8c = np.ascontiguousarray(d8)
        pdc = np.ascontiguousarray(pd)
        valc = np.ascontiguousarray(val)
        nc = np.ascontiguousarray(n_exc, np.int32)
        dc = np.ascontiguousarray(delta, np.float32)
        lib.d8_reconstruct_batch(
            d8c.ctypes.data_as(ct.c_void_p),
            pdc.ctypes.data_as(ct.c_void_p),
            valc.ctypes.data_as(ct.c_void_p),
            nc.ctypes.data_as(ct.c_void_p),
            dc.ctypes.data_as(ct.c_void_p),
            ct.c_int64(B),
            ct.c_int64(hw),
            ct.c_int64(cap),
            out.ctypes.data_as(ct.c_void_p),
        )
        return out
    for i in range(B):
        d32 = d8[i].astype(np.int32).reshape(hw)
        C = np.cumsum(d32, dtype=np.int32)
        n = min(int(n_exc[i]), cap)
        if n > 0:
            pdv = pd[i, :n].astype(np.int64)
            pos = np.cumsum(pdv) - 1
            # Malformed lists truncate at the first non-increasing or
            # out-of-grid position, exactly like the native kernel's
            # `epd == 0 || next >= hw` break — both backends must decode
            # the same (possibly corrupt) wire bytes identically.
            bad = (pdv == 0) | (pos >= hw)
            if bad.any():
                n = int(np.argmax(bad))
                pos = pos[:n]
            if n > 0:
                K = val[i, :n].astype(np.int32) - C[pos]
                corr = np.zeros(hw, np.int32)
                corr[pos] = np.diff(K, prepend=np.int32(0))
                q = C + np.cumsum(corr, dtype=np.int32)
            else:
                q = C
        else:
            q = C
        out[i] = (q.astype(np.float32) * np.float32(delta[i])).reshape(H, W)
    return out


def m8_reconstruct_batch(
    maskp: np.ndarray,  # (B, hw/8) u8 packed nonzero-occupancy bits
    d8c: np.ndarray,  # (B, NZ_CAP) i8 compact deltas
    pd: np.ndarray,  # (B, EXC_CAP) u16 exception pos-deltas (compact domain)
    val: np.ndarray,  # (B, EXC_CAP) u16 exception grid values
    n_nz: np.ndarray,  # (B,) i32 live nonzero counts
    n_exc: np.ndarray,  # (B,) i32
    delta: np.ndarray,  # (B,) f32 per-frame snap grid
    H: int,
    W: int,
) -> np.ndarray:
    """Invert the device decoder's m8 masked-compact downlink -> (B,H,W) f32.

    The wire code is the encode uplink's m8 format
    (ops/projection.py::project_points_host_m8) built device-side
    (models/decoder.py m8_down branch): occupancy bit plane + i8 diffs over
    consecutive nonzero pixels, exceptions in the compact domain.  Output is
    byte-identical to ``range_u16.astype(f32) * delta``.  Frames with
    ``n_nz`` or ``n_exc`` over their caps are truncated here and must be
    overwritten by the caller's u16 fallback.
    """
    from rpcc.codec.lz4block import native_lib

    B = maskp.shape[0]
    hw = H * W
    nz_cap = d8c.shape[1]
    exc_cap = pd.shape[1]
    out = np.empty((B, H, W), np.float32)
    lib = native_lib()
    # hw % 8 gate mirrors the encode side (project_points_host_m8): the
    # native expansion walks whole mask bytes and would leave the last
    # hw % 8 floats of the np.empty output unwritten.
    if lib is not None and hasattr(lib, "m8_reconstruct_batch") and hw % 8 == 0:
        import ctypes as ct

        mc = np.ascontiguousarray(maskp)
        dc8 = np.ascontiguousarray(d8c)
        pdc = np.ascontiguousarray(pd)
        valc = np.ascontiguousarray(val)
        nzc = np.ascontiguousarray(n_nz, np.int32)
        nec = np.ascontiguousarray(n_exc, np.int32)
        dlc = np.ascontiguousarray(delta, np.float32)
        lib.m8_reconstruct_batch(
            mc.ctypes.data_as(ct.c_void_p),
            dc8.ctypes.data_as(ct.c_void_p),
            pdc.ctypes.data_as(ct.c_void_p),
            valc.ctypes.data_as(ct.c_void_p),
            nzc.ctypes.data_as(ct.c_void_p),
            nec.ctypes.data_as(ct.c_void_p),
            dlc.ctypes.data_as(ct.c_void_p),
            ct.c_int64(B),
            ct.c_int64(hw),
            ct.c_int64(nz_cap),
            ct.c_int64(exc_cap),
            out.ctypes.data_as(ct.c_void_p),
        )
        return out
    for i in range(B):
        n = min(int(n_nz[i]), nz_cap)
        ne = min(int(n_exc[i]), exc_cap)
        C = np.cumsum(d8c[i, :n].astype(np.int32), dtype=np.int32)
        if ne > 0 and n > 0:
            pdv = pd[i, :ne].astype(np.int64)
            pos = np.cumsum(pdv) - 1
            # Truncate at the first non-increasing or out-of-stream
            # position (native `epd == 0 || next >= n` break) — the old
            # `pos[pos < n]` filter also misaligned the values against the
            # surviving positions.
            bad = (pdv == 0) | (pos >= n)
            ne = int(np.argmax(bad)) if bad.any() else ne
            pos = pos[:ne]
            if ne > 0:
                K = val[i, :ne].astype(np.int32) - C[pos]
                corr = np.zeros(n, np.int32)
                corr[pos] = np.diff(K, prepend=np.int32(0))
                nzq = C + np.cumsum(corr, dtype=np.int32)
            else:
                nzq = C
        else:
            nzq = C
        bits = np.unpackbits(maskp[i])[:hw]
        rank = np.cumsum(bits) - 1
        # rank >= n only on cap overflow (caller overwrites via u16
        # fallback); emit 0 there to stay bit-identical to the native pass.
        q = np.where(
            (bits == 1) & (rank < n),
            nzq[np.clip(rank, 0, max(n - 1, 0))] if n > 0 else np.int32(0),
            0,
        )
        out[i] = (q.astype(np.float32) * np.float32(delta[i])).reshape(H, W)
    return out


class HostDecoder:
    """Decode .rpcc payloads entirely on the host.

    ``decode_fields`` inverts the entropy-decoded field dict to the (H, W)
    range image; ``decode_blobs``/``decode_blobs_points`` take raw payloads
    and batch the entropy stage through the native rANS decoder.
    """

    def __init__(self, lidar: LidarConfig, cfg: CodecConfig):
        self.lidar = lidar
        self.cfg = cfg
        self.H, self.W = lidar.height, lidar.width
        self.hw = self.H * self.W
        self._tm = np.ascontiguousarray(
            build_transform_planes(lidar).reshape(3, self.hw), np.float32
        )
        self.entropy = BasicCompressor(
            method_name=cfg.basic_compressor, contour_shape=(self.H, self.W)
        )
        self._level_acc = (
            None if cfg.uniform else np.asarray(cfg.level_acc, np.float32)
        )

    # ------------------------------------------------------------- reconstruct
    @staticmethod
    def _field_arrays(fields: Dict[str, bytes]):
        """Entropy-decoded field bytes -> (contour, seq, stream, models,
        salience|None) array views — the one place the field dtypes and the
        salience presence rule live."""
        contour = np.frombuffer(fields["contour_map"], np.uint8)
        seq = np.frombuffer(fields["idx_sequence"], np.uint16)
        stream = np.frombuffer(fields["residual_quantized"], np.int16)
        models = np.frombuffer(fields["plane_param"], np.float32).reshape(-1, 4)
        sal = (
            np.frombuffer(fields["salience_level"], np.uint8)
            if "salience_level" in fields
            else None
        )
        return contour, seq, stream, models, sal

    def decode_fields(self, fields: Dict[str, bytes]) -> np.ndarray:
        return self.reconstruct(*self._field_arrays(fields))

    def reconstruct(
        self,
        contour_packed: np.ndarray,
        seq: np.ndarray,
        stream: np.ndarray,
        models: np.ndarray,
        salience: Optional[np.ndarray] = None,
        xyz_out: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """-> (H, W) f32 range image; if ``xyz_out`` is a preallocated
        (HW, 4) f32 array, also fills it with the compacted xyz0 rows and
        stashes the row count on ``self.last_point_count``."""
        from rpcc.codec.lz4block import native_lib

        models = np.ascontiguousarray(models, np.float32)
        # Wire-derived fields feed raw C pointers below: validate lengths so
        # a truncated/corrupt .rpcc raises instead of reading out of bounds.
        if contour_packed.size < (self.hw + 7) // 8:  # kernel reads ceil(hw/8)
            raise ValueError(
                f"contour_map too short: {contour_packed.size} bytes for a "
                f"{self.H}x{self.W} grid"
            )
        if models.ndim != 2 or models.shape[1] != 4 or models.shape[0] == 0:
            raise ValueError(f"plane_param must be (M, 4), got {models.shape}")
        if salience is not None and len(salience) < models.shape[0]:
            raise ValueError(
                f"salience_level has {len(salience)} entries for "
                f"{models.shape[0]} model rows"
            )
        lib = native_lib()
        if lib is not None and hasattr(lib, "host_decode_frame"):
            import ctypes as ct

            contour_packed = np.ascontiguousarray(contour_packed, np.uint8)
            seq = np.ascontiguousarray(seq, np.uint16)
            stream = np.ascontiguousarray(stream, np.int16)
            sal_arr = (
                None
                if salience is None
                else np.ascontiguousarray(salience, np.uint8)
            )
            ri = np.empty(self.hw, np.float32)
            la = self._level_acc
            n = lib.host_decode_frame(
                contour_packed.ctypes.data_as(ct.c_void_p),
                seq.ctypes.data_as(ct.c_void_p),
                ct.c_int64(seq.shape[0]),
                stream.ctypes.data_as(ct.c_void_p),
                ct.c_int64(stream.shape[0]),
                models.ctypes.data_as(ct.c_void_p),
                ct.c_int32(models.shape[0]),
                None if sal_arr is None else sal_arr.ctypes.data_as(ct.c_void_p),
                None if la is None else la.ctypes.data_as(ct.c_void_p),
                ct.c_int32(0 if la is None else la.shape[0]),
                ct.c_float(np.float32(self.cfg.step)),
                self._tm.ctypes.data_as(ct.c_void_p),
                ct.c_int32(self.H),
                ct.c_int32(self.W),
                ri.ctypes.data_as(ct.c_void_p),
                None if xyz_out is None else xyz_out.ctypes.data_as(ct.c_void_p),
            )
            self.last_point_count = int(n)
            return ri.reshape(self.H, self.W)

        ri = _decode_frame_np(
            np.asarray(contour_packed, np.uint8),
            np.asarray(seq, np.uint16),
            np.asarray(stream, np.int16),
            models,
            None if salience is None else np.asarray(salience, np.uint8),
            self._level_acc,
            self.cfg.step,
            self._tm,
            self.H,
            self.W,
        )
        if xyz_out is not None:
            pts = ri.reshape(-1, 1) * self._tm.T  # (HW, 3)
            keep = pts.sum(-1) != 0
            n = int(keep.sum())
            xyz_out[:n, :3] = pts[keep]
            xyz_out[:n, 3] = 0.0
            self.last_point_count = n
        return ri

    # ------------------------------------------------------------- entropy
    def entropy_decode_blobs(self, blobs: Sequence[bytes]) -> List[Dict[str, bytes]]:
        """Entropy-decode a batch of payloads (batched native rANS for the
        big fields, mirroring BatchEngine.decode_blobs_device)."""
        packed = [unpack_bitstream(b, uniform=self.cfg.uniform) for b in blobs]
        resid = None
        contour = None
        if self.cfg.basic_compressor == "rans":
            from rpcc.codec import rans_codec

            resid, contour = rans_codec.batch_decode_big_fields(packed)
        out = []
        for i, p in enumerate(packed):
            fields = {}
            for k, v in p.items():
                if k == "residual_quantized" and resid is not None:
                    fields[k] = resid[i]
                elif k == "contour_map" and contour is not None:
                    fields[k] = contour[i]
                else:
                    fields[k] = self.entropy.decompress(v)
            out.append(fields)
        return out

    def decode_blobs(self, blobs: Sequence[bytes]) -> List[np.ndarray]:
        """-> list of (H, W) f32 range images."""
        return [self.decode_fields(f) for f in self.entropy_decode_blobs(blobs)]

    def decode_blobs_points(self, blobs: Sequence[bytes]) -> List[np.ndarray]:
        """-> list of compacted (n, 4) f32 xyz0 arrays (zero rows dropped,
        reference save semantics) — ready for .bin output."""
        out = []
        buf = np.empty((self.hw, 4), np.float32)
        for fields in self.entropy_decode_blobs(blobs):
            self.reconstruct(*self._field_arrays(fields), xyz_out=buf)
            out.append(buf[: self.last_point_count].copy())
        return out
