"""Batched throughput engine: device frame batches + host entropy pool.

The dataset-scale path (``compress_datalist`` / ``decompress_datalist``):
frames are host-projected into fixed-shape (B, H, W) range-image batches
(f32, or u16+delta in u16 transfer mode), encoded by one sharded XLA
program, and the byte-level stages run on host threads overlapped with the
next device batch via JAX's async dispatch.  With ``cfg.device_entropy``
the big fields come back as finished rANS containers instead.

Three pipeline stages on three threads keep the host<->device link
saturated (``encode_pipeline``):

  1. ``encode_batch_device``  (uploader thread) stack + upload + dispatch;
     queue async host copies of every fixed-size output.
  2. ``stage_downloads``      (downloader thread) wait for the device, then
     bucket + queue the async live-prefix copies.
  3. ``finish_staged``        (caller thread) materialize, entropy-code,
     frame.
"""

from __future__ import annotations

import concurrent.futures as futures
import threading
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rpcc.codec.bitstream import pack_bitstream, unpack_bitstream
from rpcc.codec.entropy import BasicCompressor
from rpcc.config import CodecConfig, LidarConfig
from rpcc.models.decoder import make_batch_decoder
from rpcc.models.encoder import EXC_CAP, make_batch_encoder
from rpcc.runtime import setup_compile_cache


def _bucket(n: int, cap: int, quantum: int = 8192) -> int:
    """Round a live length up to a transfer bucket (bounded slice variants)."""
    return min(cap, max(quantum, -(-n // quantum) * quantum))


def _timed_stage(fn, stats: dict, key: str, count: bool = False):
    """Accumulate a pipeline stage's wall + thread-CPU seconds into stats."""
    import time

    def wrapped(*a):
        t0 = time.perf_counter()
        c0 = time.thread_time()
        r = fn(*a)
        stats[key + "_s"] = stats.get(key + "_s", 0.0) + time.perf_counter() - t0
        stats[key + "_cpu_s"] = (
            stats.get(key + "_cpu_s", 0.0) + time.thread_time() - c0
        )
        if count:
            stats["batches"] = stats.get("batches", 0) + 1
        return r

    return wrapped


def _copy_async(*arrays) -> None:
    """Queue device->host copies without blocking (jax.Array only)."""
    for a in arrays:
        if a is not None and hasattr(a, "copy_to_host_async"):
            a.copy_to_host_async()


class _Staged(NamedTuple):
    live: int
    stream_len: "np.ndarray"
    seq_len: "np.ndarray"
    stream_dev: object  # (B, m_stream) i8 transfer view, async copy queued
    seq_dev: object  # (B, m_seq) u8 when ids < 256 (default), else u16
    contour_dev: object  # (B, HW/8) u8
    models_dev: object  # (B, M*4) f32 — flat downlink, host reshapes
    salience_dev: object  # (B, M) u8 or None
    exc_pos_dev: object  # (B, EXC_CAP) i32
    exc_val_dev: object  # (B, EXC_CAP) i16
    exc_count: "np.ndarray"  # (B,) i32, already materialized
    stream16_dev: object  # (B, HW) i16 — only read on exc_count > EXC_CAP
    de: object = None  # device-entropy staged pieces (dict) or None


class BatchEngine:
    def __init__(
        self,
        lidar: LidarConfig,
        cfg: CodecConfig,
        batch_size: int = 8,
        mesh=None,
        workers: int = 4,
        d8_down: Optional[bool] = None,
        d8_cap: Optional[int] = None,
        m8_down: Optional[bool] = None,
        m8_caps: Optional[tuple] = None,
    ):
        setup_compile_cache()
        self.lidar = lidar
        self.cfg = cfg
        if mesh is not None:
            n_dev = int(mesh.devices.size)
            batch_size = -(-batch_size // n_dev) * n_dev  # shardable batch
        self.batch_size = batch_size
        self.mesh = mesh
        self.H, self.W = lidar.height, lidar.width
        self.hw = self.H * self.W
        # Production encode is from_ri: frames are projected on the host
        # (fused native C++ bin+raster) and the (B, H, W)
        # range image is uploaded — 3x fewer bytes than raw clouds and no
        # device compaction sorts.  transfer_precision='u16' halves the
        # upload again (per-frame grid snap, <= delta/2 extra error);
        # 'i8' ships row-deltas of the u16 grid + a compact exception list
        # (~30% fewer bytes again, bit-identical bitstream).
        self._u16 = cfg.transfer_precision == "u16"
        self._d8 = cfg.transfer_precision == "i8"
        # 'm8' drops the zero pixels from the wire entirely: packed 1-bit
        # occupancy plane + compact nonzero deltas (~27% fewer bytes than
        # 'i8' — the zero<->depth delta tails leave the exception list).
        self._m8 = cfg.transfer_precision == "m8"
        # Decode DOWNLINK mode — ONE value: 'f32' raw range image, 'u16'
        # snap grid, 'd8' i8 row-delta + exception view of the grid (~31%
        # fewer bytes), 'm8' masked-compact wire code (~26% fewer again on
        # KITTI; the default whenever the uplink rides a reduced mode).
        # The d8_down/m8_down constructor knobs keep their r3 semantics for
        # A/B work: m8_down=True/False forces/blocks the m8 view,
        # d8_down=True forces the row-delta view, d8_down=False (with
        # m8_down unset/False) keeps the raw u16 grid.
        reduced = cfg.transfer_precision in ("u16", "i8", "m8")
        if not reduced and (m8_down or d8_down):
            # The f32 decoder graph never emits the m8/d8 downlink fields —
            # a forced reduced downlink would crash at first decode
            # (np.asarray(None)) instead of failing here at construction.
            raise ValueError(
                "m8_down/d8_down require transfer_precision in "
                "('u16', 'i8', 'm8'); the f32 decoder has no reduced downlink"
            )
        # The m8 downlink's NATIVE host inverter (m8_reconstruct_batch) and
        # the native m8 projection both walk whole mask bytes and gate on
        # hw % 8 == 0 (falling back to slower numpy twins) — ragged
        # geometries take the d8 row-delta downlink instead, which has no
        # such cliff.  (pack_bits_msb itself zero-pads ragged tails.)
        m8_ok = (self.hw % 8) == 0
        m8_sel = (
            (reduced and m8_ok and d8_down is None)
            if m8_down is None
            else bool(m8_down)
        )
        d8_sel = (reduced and not m8_sel) if d8_down is None else bool(d8_down)
        if m8_sel:
            self._downlink = "m8"
        elif d8_sel:
            self._downlink = "d8"
        elif reduced:
            self._downlink = "u16"
        else:
            self._downlink = "f32"
        self._m8_down = self._downlink == "m8"
        self._d8_down = self._downlink == "d8"
        self._u16_down = self._downlink in ("u16", "d8", "m8")
        # Device entropy: the encoder graph also emits the rANS containers
        # for the residual/contour fields (cfg.device_entropy, rans only).
        self._dev_entropy = bool(cfg.device_entropy) and cfg.basic_compressor == "rans"
        self._encode_b = make_batch_encoder(
            lidar, cfg, mesh, from_ri=True, ri_u16=self._u16, ri_d8=self._d8,
            ri_m8=self._m8,
        )
        # Two decoder programs: the i8+exception uplink (default) and the
        # full-i16 fallback, which only triggers when a frame overflows
        # EXC_CAP on the decode uplink.  The fallback compiles lazily — a
        # full-graph compile stalls the first degenerate frame that shows
        # up mid-production (cached after).
        # Call prewarm_fallback_decoder() during setup to pay it up front.
        self._decode_b = make_batch_decoder(
            lidar, cfg, mesh, d8_down=self._d8_down, d8_cap=d8_cap,
            m8_down=self._m8_down, m8_caps=m8_caps,
        )
        self._decode_b_i8 = make_batch_decoder(
            lidar, cfg, mesh, i8_stream=True, d8_down=self._d8_down,
            d8_cap=d8_cap, m8_down=self._m8_down, m8_caps=m8_caps,
        )
        self.entropy = BasicCompressor(
            method_name=cfg.basic_compressor, contour_shape=(self.H, self.W)
        )
        self._pool = futures.ThreadPoolExecutor(workers)
        # Per-site pool-worker thread-CPU accounting: pool workers are not
        # pipeline stage threads, so their CPU is invisible to the stats
        # hooks' thread_time deltas (most of it the native projection
        # running here).
        self._pool_cpu: Dict[str, float] = {}
        self._pool_cpu_lock = threading.Lock()
        # Dedicated uploader: stacking + host->device transfer is mostly IO
        # wait, so it overlaps the entropy stage.
        self._uploader = futures.ThreadPoolExecutor(1)
        # Dedicated downloader: stage_downloads blocks on the device finishing
        # a batch, then queues the big async copies — on its own thread those
        # copies stream over the wire WHILE the main thread entropy-codes the
        # previous batch (queueing them on the main thread after
        # finish_staged serializes the download wait).
        self._downloader = futures.ThreadPoolExecutor(1)
        # Dedicated stacker: host projection/stacking for batch k+1 runs
        # while the uploader's wire transfer for batch k is in flight (the
        # native projection releases the GIL, so both make progress).
        self._stacker = futures.ThreadPoolExecutor(1)
        # Download the (B, M, 4) model table as flat (B, M*4); bytes are
        # row-major so the host reshape is free and byte-identical.
        self._flatten_models = jax.jit(lambda a: a.reshape(a.shape[0], -1))
        # idx_sequence wire code: run ids are < num_models, so whenever the
        # model table fits a byte the sequence rides the wire as u8 — half
        # the bytes of the u16 field in BOTH directions (the seq downlink
        # was the single largest encode-downlink item, 32.8 KB/frame vs the
        # ~13 KB live payload on KITTI).  The cast runs on device (tiny
        # standalone jit — the big encoder/decoder programs stay cached);
        # hosts restore exact u16 (values < 256 are lossless).  The decode
        # uplink additionally requires every id in the (untrusted) blob to
        # be < 256 — corrupt ids >= 256 keep the u16 path so out-of-range
        # semantics stay identical across backends.
        from rpcc.models.encoder import num_model_rows

        self._seq_u8_ok = num_model_rows(cfg) <= 256
        self._cast_u8 = jax.jit(lambda a: a.astype(jnp.uint8))
        self._cast_u16 = jax.jit(lambda a: a.astype(jnp.uint16))

    @property
    def _step_arg(self) -> np.ndarray:
        if self.cfg.uniform:
            return np.float32(self.cfg.step)
        return np.asarray(self.cfg.level_acc, dtype=np.float32)

    def _pool_map(self, key: str, fn, n: int) -> list:
        """``self._pool.map(fn, range(n))`` with the workers' thread-CPU
        seconds accumulated under ``key`` (read via :meth:`pool_cpu_snapshot`;
        ~2 us/task of clock overhead on per-frame tasks)."""
        import time

        def timed(i):
            c0 = time.thread_time()
            r = fn(i)
            dt = time.thread_time() - c0
            with self._pool_cpu_lock:
                self._pool_cpu[key] = self._pool_cpu.get(key, 0.0) + dt
            return r

        return list(self._pool.map(timed, range(n)))

    def pool_cpu_snapshot(self) -> Dict[str, float]:
        """Cumulative pool-worker thread-CPU seconds per call site."""
        with self._pool_cpu_lock:
            return dict(self._pool_cpu)

    # ---------------------------------------------------------------- encode
    def _stack(self, clouds: Sequence[np.ndarray]):
        """Host-project each frame (thread pool) and stack (B, H, W) images.

        Returns ``(images, deltas, live)``; deltas is None in f32 mode, the
        (B,) per-frame snap grid in u16 mode (delta_i = max(step/16,
        depth_max_i / 65535) — never saturates, error <= delta/2).
        """
        from rpcc.ops.projection import project_points_host

        if not self._u16:
            out = np.zeros((self.batch_size, self.H, self.W), np.float32)

            def one(i: int) -> None:
                out[i] = project_points_host(
                    np.asarray(clouds[i], np.float32)[:, :3], self.lidar
                )

            self._pool_map("project", one, len(clouds))
            return out, None, len(clouds)

        from rpcc.ops.projection import project_points_host_u16

        out = np.zeros((self.batch_size, self.H, self.W), np.uint16)
        deltas = np.full((self.batch_size,), np.float32(1.0), np.float32)
        floor = np.float32(self.cfg.step / 16.0)

        def one16(i: int) -> None:
            out[i], deltas[i] = project_points_host_u16(clouds[i], self.lidar, floor)

        self._pool_map("project", one16, len(clouds))
        return out, deltas, len(clouds)

    def _stack_d8(self, clouds: Sequence[np.ndarray]):
        """i8-transfer host projection: returns ``(d8 (B,H,W) i8, deltas
        (B,), exc_pd (B,m) u16, exc_val (B,m) u16, n_exc (B,), live)``.

        ``m`` is the bucketed max exception count (quantum 2048, so the
        jitted program set stays small and cached)."""
        from rpcc.ops.projection import project_points_host_d8

        B = self.batch_size
        d8 = np.zeros((B, self.H, self.W), np.int8)
        deltas = np.full((B,), np.float32(1.0), np.float32)
        floor = np.float32(self.cfg.step / 16.0)
        pds: List[Optional[np.ndarray]] = [None] * B
        vals: List[Optional[np.ndarray]] = [None] * B

        def one(i: int) -> None:
            d8[i], pds[i], vals[i], deltas[i] = project_points_host_d8(
                clouds[i], self.lidar, floor
            )

        live = len(clouds)
        self._pool_map("project", one, live)
        m = _bucket(
            max((p.shape[0] for p in pds[:live] if p is not None), default=1),
            self.hw,
            quantum=2048,
        )
        exc_pd = np.zeros((B, m), np.uint16)
        exc_val = np.zeros((B, m), np.uint16)
        n_exc = np.zeros((B,), np.int32)
        for i in range(live):
            k = pds[i].shape[0]
            exc_pd[i, :k] = pds[i]
            exc_val[i, :k] = vals[i]
            n_exc[i] = k
        return d8, deltas, exc_pd, exc_val, n_exc, live

    def _stack_m8(self, clouds: Sequence[np.ndarray]):
        """Masked-compact transfer projection: returns ``(maskp (B, ceil(hw/8))
        u8, deltas (B,), exc_pd (B, m) u16, exc_val (B, m) u16, n_exc (B,),
        d8c (B, M) i8, n_nz (B,), live)``.

        ``m``/``M`` are bucketed max counts (quantum 2048 / 16384) so the
        jitted program set stays small and cached."""
        from rpcc.ops.projection import project_points_host_m8

        B = self.batch_size
        nb = -(-self.hw // 8)
        maskp = np.zeros((B, nb), np.uint8)
        deltas = np.full((B,), np.float32(1.0), np.float32)
        floor = np.float32(self.cfg.step / 16.0)
        planes: List[Optional[np.ndarray]] = [None] * B
        pds: List[Optional[np.ndarray]] = [None] * B
        vals: List[Optional[np.ndarray]] = [None] * B

        def one(i: int) -> None:
            maskp[i], planes[i], pds[i], vals[i], _, deltas[i] = (
                project_points_host_m8(clouds[i], self.lidar, floor)
            )

        live = len(clouds)
        self._pool_map("project", one, live)
        M = _bucket(
            max((p.shape[0] for p in planes[:live] if p is not None), default=1),
            self.hw,
            quantum=16384,
        )
        m = _bucket(
            max((p.shape[0] for p in pds[:live] if p is not None), default=1),
            self.hw,
            quantum=2048,
        )
        d8c = np.zeros((B, M), np.int8)
        exc_pd = np.zeros((B, m), np.uint16)
        exc_val = np.zeros((B, m), np.uint16)
        n_exc = np.zeros((B,), np.int32)
        n_nz = np.zeros((B,), np.int32)
        for i in range(live):
            n = planes[i].shape[0]
            d8c[i, :n] = planes[i]
            n_nz[i] = n
            k = pds[i].shape[0]
            exc_pd[i, :k] = pds[i]
            exc_val[i, :k] = vals[i]
            n_exc[i] = k
        return maskp, deltas, exc_pd, exc_val, n_exc, d8c, n_nz, live

    def _prepare_batch(self, clouds: Sequence[np.ndarray], seeds: Optional[Sequence[int]] = None):
        """Pipeline stage 0 (CPU-bound): host-project + stack one batch.

        Split from :meth:`_dispatch_prepared` so the pipeline's stacker
        thread can project batch k+1 while the uploader thread's wire
        transfer for batch k is in flight — when both lived on the uploader
        thread the projection serialized ahead of the upload, capping e2e
        at 1/(project + upload) instead of 1/upload per batch.
        """
        assert len(clouds) <= self.batch_size
        if self._m8:
            pts, deltas, exc_pd, exc_val, n_exc, d8c, n_nz, live = self._stack_m8(clouds)
            tail = (deltas, exc_pd, exc_val, n_exc, d8c, n_nz)
        elif self._d8:
            pts, deltas, exc_pd, exc_val, n_exc, live = self._stack_d8(clouds)
            tail = (deltas, exc_pd, exc_val, n_exc)
        elif self._u16:
            pts, deltas, live = self._stack(clouds)
            tail = (deltas,)
        else:
            pts, _, live = self._stack(clouds)
            tail = ()
        if seeds is None:
            seeds = [self.cfg.seed] * self.batch_size
        seeds = np.asarray(
            list(seeds) + [self.cfg.seed] * (self.batch_size - len(seeds)), np.uint32
        )
        return pts, seeds, tail, live

    def _dispatch_prepared(self, prepared):
        """Pipeline stage 1 (wire-bound): upload + dispatch a prepared batch;
        queues the fixed-size output copies without blocking on the device."""
        pts, seeds, tail, live = prepared
        out = self._encode_b(pts, seeds, self._step_arg, *tail)
        # model_param rides the wire flat (see stage_downloads), not here.
        if self._dev_entropy:
            _copy_async(out.stream_len, out.seq_len,
                        out.salience, out.de_res_nw, out.de_res_counts,
                        out.de_res_states, out.de_res_freqs,
                        out.de_res_escapes, out.de_res_nesc, out.de_res_q0,
                        out.de_cnt_nw, out.de_cnt_counts, out.de_cnt_states,
                        out.de_cnt_freqs, out.exc_count)
        else:
            _copy_async(out.stream_len, out.seq_len, out.contour_packed,
                        out.salience,
                        out.exc_pos, out.exc_val, out.exc_count)
        return out, live

    def encode_batch_device(self, clouds: Sequence[np.ndarray], seeds: Optional[Sequence[int]] = None):
        """Stack + dispatch one device batch (async); returns
        (EncoderOutput, live_count)."""
        return self._dispatch_prepared(self._prepare_batch(clouds, seeds))

    def stage_downloads(self, out, live: int) -> _Staged:
        """Pipeline stage 2: bucket the live prefixes, queue their copies.

        Blocks only on the (B,)-length arrays (ready as soon as the device
        finishes the batch); the big slices stream back asynchronously while
        the caller finishes earlier batches.
        """
        stream_len = np.asarray(out.stream_len)
        seq_len = np.asarray(out.seq_len)
        # Download only the live prefixes (bucketed so the slice programs
        # stay cached): the padded sequence alone is 8MB/batch for ~12KB of
        # runs.
        m_seq = _bucket(int(seq_len.max()) if seq_len.size else 1, self.hw)
        seq_dev = out.sequence[:, :m_seq]
        if self._seq_u8_ok:
            seq_dev = self._cast_u8(seq_dev)  # ids < 256: halve the downlink
        models_dev = self._flatten_models(out.model_param)  # flat downlink
        if self._dev_entropy:
            # Device entropy: download compressed word prefixes instead of
            # the residual transfer view / contour plane (~30 KB/frame).
            res_nw = np.asarray(out.de_res_nw)
            cnt_nw = np.asarray(out.de_cnt_nw)
            m_rw = _bucket(int(res_nw.max()) if res_nw.size else 1,
                           out.de_res_words.shape[1], quantum=2048)
            m_cw = _bucket(int(cnt_nw.max()) if cnt_nw.size else 1,
                           out.de_cnt_words.shape[1], quantum=2048)
            rw_dev = out.de_res_words[:, :m_rw]
            cw_dev = out.de_cnt_words[:, :m_cw]
            _copy_async(seq_dev, rw_dev, cw_dev, models_dev)
            de = dict(
                res_nw=res_nw, cnt_nw=cnt_nw, rw_dev=rw_dev, cw_dev=cw_dev,
                res_counts=out.de_res_counts, res_states=out.de_res_states,
                res_freqs=out.de_res_freqs, res_escapes=out.de_res_escapes,
                res_nesc=np.asarray(out.de_res_nesc),
                res_q0=np.asarray(out.de_res_q0),
                cnt_counts=out.de_cnt_counts, cnt_states=out.de_cnt_states,
                cnt_freqs=out.de_cnt_freqs,
            )
            return _Staged(live, stream_len, seq_len, None, seq_dev,
                           None, models_dev, out.salience,
                           None, None, None,
                           out.stream, de)
        m_stream = _bucket(int(stream_len.max()) if stream_len.size else 1, self.hw)
        stream_dev = out.stream_i8[:, :m_stream]
        _copy_async(stream_dev, seq_dev, models_dev)
        return _Staged(live, stream_len, seq_len, stream_dev, seq_dev,
                       out.contour_packed, models_dev, out.salience,
                       out.exc_pos, out.exc_val, np.asarray(out.exc_count),
                       out.stream)

    def finalize_encoded(self, out, live: int) -> List[Tuple[bytes, Dict[str, np.ndarray]]]:
        """Trim per-frame fields + entropy-code them on the thread pool."""
        return self.finish_staged(self.stage_downloads(out, live))

    def finish_staged(self, st: _Staged) -> List[Tuple[bytes, Dict[str, np.ndarray]]]:
        """Pipeline stage 3: materialize host copies, entropy-code, frame."""
        if st.de is not None:
            return self._finish_device_entropy(st)
        live, stream_len, seq_len = st.live, st.stream_len, st.seq_len
        if (st.exc_count[:live] > EXC_CAP).any():
            # Degenerate content (>EXC_CAP residuals beyond |127| in one
            # frame): lossless fallback to the full i16 download.
            stream = np.asarray(st.stream16_dev)
        else:
            # Reconstruct the exact i16 stream from the i8 transfer view +
            # exception list (half the device->host bytes).
            stream = np.asarray(st.stream_dev).astype(np.int16)
            exc_pos = np.asarray(st.exc_pos_dev)
            exc_val = np.asarray(st.exc_val_dev)
            m = stream.shape[1]
            for i in range(live):
                n = int(st.exc_count[i])
                if n:
                    p = exc_pos[i, :n]
                    keep = p < m
                    stream[i, p[keep]] = exc_val[i, :n][keep]
        seq = np.asarray(st.seq_dev)
        if seq.dtype == np.uint8:  # u8 wire code -> exact u16 field
            seq = seq.astype(np.uint16)
        contour_packed = np.asarray(st.contour_dev)
        models = np.asarray(st.models_dev)
        models = models.reshape(models.shape[0], -1, 4)  # flat wire -> (B, M, 4)
        salience = None if st.salience_dev is None else np.asarray(st.salience_dev)

        # With the device rANS coder, the dominant fields (residual stream,
        # contour bit plane) for the whole batch are entropy-coded in one
        # device call each; the small remaining fields go to the host pool.
        resid_blobs = None
        contour_blobs = None
        seq_blobs = None
        if self.cfg.basic_compressor == "rans":
            from rpcc.codec import rans_codec

            resid_blobs = rans_codec.compress_delta_batch(
                [stream[i, : stream_len[i]].astype(np.int16) for i in range(live)]
            )
            contour_blobs = rans_codec.compress_contour_batch(
                [contour_packed[i] for i in range(live)], self.H, self.W
            )
            seq_blobs = [
                rans_codec.compress_seq_u16(seq[i, : seq_len[i]]) for i in range(live)
            ]

        def one(i: int) -> Tuple[bytes, Dict[str, np.ndarray]]:
            fields = {
                "residual_quantized": stream[i, : stream_len[i]].astype(np.int16),
                "contour_map": contour_packed[i],
                "idx_sequence": seq[i, : seq_len[i]],
                "plane_param": models[i].astype(np.float32),
            }
            if salience is not None:
                fields["salience_level"] = salience[i].astype(np.uint8)
            if resid_blobs is None:
                compressed = self.entropy.compress_dict(fields)
            else:
                batched = ("residual_quantized", "contour_map", "idx_sequence")
                compressed = self.entropy.compress_dict(
                    {k: v for k, v in fields.items() if k not in batched}
                )
                compressed["residual_quantized"] = resid_blobs[i]
                compressed["contour_map"] = contour_blobs[i]
                compressed["idx_sequence"] = seq_blobs[i]
            return pack_bitstream(compressed, uniform=self.cfg.uniform), fields

        return self._pool_map("entropy", one, live)

    def _finish_device_entropy(self, st: _Staged) -> List[Tuple[bytes, Dict[str, np.ndarray]]]:
        """Assemble containers from device-encoded pieces (cfg.device_entropy):
        no residual/contour downloads, no host entropy encode.  The fields
        dict carries only the host-visible fields (models, idx_sequence,
        salience)."""
        from rpcc.codec import rans_codec
        from rpcc.ops.rans_device import (
            ESC_CAP_DEV,
            RESID_LANES,
            contour_T,
            resid_T,
        )

        live, stream_len, seq_len = st.live, st.stream_len, st.seq_len
        de = st.de
        seq = np.asarray(st.seq_dev)
        if seq.dtype == np.uint8:  # u8 wire code -> exact u16 field
            seq = seq.astype(np.uint16)
        models = np.asarray(st.models_dev)
        models = models.reshape(models.shape[0], -1, 4)  # flat wire -> (B, M, 4)
        salience = None if st.salience_dev is None else np.asarray(st.salience_dev)
        rw = np.asarray(de["rw_dev"])
        cw = np.asarray(de["cw_dev"])
        res_counts = np.asarray(de["res_counts"])
        res_states = np.asarray(de["res_states"])
        res_freqs = np.asarray(de["res_freqs"])
        res_escapes = np.asarray(de["res_escapes"])
        cnt_counts = np.asarray(de["cnt_counts"])
        cnt_states = np.asarray(de["cnt_states"])
        cnt_freqs = np.asarray(de["cnt_freqs"])
        L = RESID_LANES
        T_res = resid_T(self.hw)
        T_cnt = contour_T(self.H, self.W)

        def one(i: int) -> Tuple[bytes, Dict[str, np.ndarray]]:
            n = int(stream_len[i])
            n_esc = int(de["res_nesc"][i])
            if n_esc > ESC_CAP_DEV:
                # escape overflow: host-code this frame from the i16 stream
                q16 = np.asarray(st.stream16_dev[i])[:n].astype(np.int16)
                resid_blob = rans_codec.compress_delta_batch([q16])[0]
            else:
                resid_blob = rans_codec.build_ctx_container(
                    L, T_res, n, int(de["res_q0"][i]),
                    res_escapes[i, :n_esc], res_freqs[i].astype(np.int64),
                    res_states[i], res_counts[i].astype(np.uint16),
                    rw[i, : int(de["res_nw"][i])], np.int16,
                )
                if n <= rans_codec.BZD_TRY_MAX_SYMBOLS:
                    # Small frames: bzip2-over-delta often wins — keep the
                    # host adaptive pick (downloads <=64 KB; production-size
                    # frames never take this branch).
                    q16 = np.asarray(st.stream16_dev[i])[:n].astype(np.int16)
                    host_blob = rans_codec.compress_delta_batch([q16])[0]
                    resid_blob = min(resid_blob, host_blob, key=len)
            cnt_blob = rans_codec.build_bits_container(
                T_cnt, self.H, self.W, cnt_freqs[i], cnt_states[i],
                cnt_counts[i].astype(np.uint16), cw[i, : int(de["cnt_nw"][i])],
            )
            fields = {
                "idx_sequence": seq[i, : seq_len[i]],
                "plane_param": models[i].astype(np.float32),
            }
            if salience is not None:
                fields["salience_level"] = salience[i].astype(np.uint8)
            compressed = self.entropy.compress_dict(
                {k: v for k, v in fields.items() if k != "idx_sequence"}
            )
            compressed["residual_quantized"] = resid_blob
            compressed["contour_map"] = cnt_blob
            compressed["idx_sequence"] = rans_codec.compress_seq_u16(
                seq[i, : seq_len[i]]
            )
            return pack_bitstream(compressed, uniform=self.cfg.uniform), fields

        return self._pool_map("entropy", one, live)

    def sharded_stats(self, out, blob_sizes: Sequence[int]) -> Dict[str, float]:
        """Global frames/points/bits/bpp across the mesh via ONE psum
        (SURVEY §2.3's only collective use — metric aggregation; the codec
        itself has no cross-frame communication).  ``out`` is a sharded
        EncoderOutput batch; ``blob_sizes`` the per-frame payload bytes."""
        if self.mesh is None:
            raise ValueError("sharded_stats needs a mesh-backed engine")
        from jax.sharding import NamedSharding, PartitionSpec as P

        from rpcc.parallel.aggregate import batch_report, make_stats_aggregator

        if not hasattr(self, "_agg"):
            self._agg = make_stats_aggregator(self.mesh)
        bits = np.zeros((self.batch_size,), np.int32)
        bits[: len(blob_sizes)] = np.asarray(blob_sizes, np.int64) * 8
        bits_dev = jax.device_put(bits, NamedSharding(self.mesh, P("data")))
        # stream_len = live (nonzero) pixels per frame = point count
        totals = self._agg(out.stream_len, bits_dev)
        return batch_report(np.asarray(totals))

    def encode_batch_async(self, clouds: Sequence[np.ndarray], seeds=None):
        """Stack + upload + dispatch on the uploader thread; returns a
        future resolving to (EncoderOutput, live_count)."""
        return self._uploader.submit(self.encode_batch_device, clouds, seeds)

    def _run_pipeline(self, inputs, prepare, dispatch, stage, finish, stats=None):
        """4-deep, 4-thread pipeline scaffold shared by encode and decode.

        Yields one finished result per input, in order.  Stage threads:
        stacker runs ``prepare`` on input k (CPU-bound), uploader runs
        ``dispatch`` on k-1 (wire-bound host->device), downloader runs
        ``stage`` on k-2 (device wait + async device->host copies), the
        caller runs ``finish`` on k-3 while k-2's copies stream.
        Separating prepare from dispatch matters when host cores are
        scarce: the two used to serialize on the uploader thread, capping
        throughput below the link's ceiling.

        ``stats`` (optional dict) accumulates per-stage cost across the run:
        ``<stage>_s`` wall seconds (includes wire/device waits — dispatch
        wall ~= uplink wire time) and ``<stage>_cpu_s`` thread-CPU seconds
        (what the stage actually burns of the host), plus
        ``batches``.  Each stage runs on its own dedicated thread, so
        ``time.thread_time()`` deltas attribute CPU exactly.
        """
        from collections import deque

        pool0 = None
        if stats is not None:
            prepare = _timed_stage(prepare, stats, "prepare")
            dispatch = _timed_stage(dispatch, stats, "dispatch")
            stage = _timed_stage(stage, stats, "stage")
            finish = _timed_stage(finish, stats, "finish", count=True)
            pool0 = self.pool_cpu_snapshot()

        try:
            prepared: deque = deque()
            dispatched: deque = deque()
            staged: deque = deque()
            for item in inputs:
                prepared.append(self._stacker.submit(prepare, item))
                if len(prepared) >= 2:
                    fut = prepared.popleft()
                    dispatched.append(
                        self._uploader.submit(lambda f=fut: dispatch(f.result()))
                    )
                if len(dispatched) >= 2:
                    fut = dispatched.popleft()
                    staged.append(
                        self._downloader.submit(lambda f=fut: stage(f.result()))
                    )
                if len(staged) >= 2:
                    yield finish(staged.popleft().result())
            # Drain: at most one batch sits in each upstream stage.
            while prepared:
                fut = prepared.popleft()
                dispatched.append(
                    self._uploader.submit(lambda f=fut: dispatch(f.result()))
                )
            while dispatched:
                fut = dispatched.popleft()
                staged.append(
                    self._downloader.submit(lambda f=fut: stage(f.result()))
                )
            while staged:
                yield finish(staged.popleft().result())
        finally:
            if pool0 is not None:
                # Pool-worker thread-CPU per call site over this run: the
                # per-stage fields above see only their own pipeline thread,
                # but projection + per-frame entropy framing run on the
                # shared pool (the r4 datalist evidence left that CPU
                # unattributed).
                for k, v in self.pool_cpu_snapshot().items():
                    d = v - pool0.get(k, 0.0)
                    if d > 0.0:
                        stats[f"pool_{k}_cpu_s"] = (
                            stats.get(f"pool_{k}_cpu_s", 0.0) + d
                        )

    def encode_pipeline(self, batches, stats=None):
        """4-deep, 4-thread pipelined encode over an iterable of (clouds,
        seeds): stacker host-projects batch k, uploader transfers +
        dispatches k-1, downloader queues k-2's async prefix copies, the
        caller entropy-codes k-3.  Yields one result list per batch.
        ``stats`` (optional dict) accumulates per-stage wall/CPU seconds —
        see :meth:`_run_pipeline`."""
        return self._run_pipeline(
            batches,
            lambda cs: self._prepare_batch(*cs),
            self._dispatch_prepared,
            lambda ol: self.stage_downloads(*ol),
            self.finish_staged,
            stats=stats,
        )

    def encode_frames(self, clouds: Sequence[np.ndarray], seeds=None):
        """Convenience: one synchronous batch -> list of .rpcc payloads."""
        out, live = self.encode_batch_device(clouds, seeds)
        return self.finalize_encoded(out, live)

    # ---------------------------------------------------------------- decode
    def _prepare_decode(self, blobs: Sequence[bytes]):
        """Decode pipeline stage 0 (CPU-bound): entropy-decode + stack one
        batch of .rpcc payloads into the decoder's upload arrays.

        Split from :meth:`_dispatch_decode` for the same reason as the
        encode side's :meth:`_prepare_batch`: the batch entropy decode used
        to serialize ahead of the decode uplink on the uploader thread."""
        assert len(blobs) <= self.batch_size
        b = self.batch_size
        hw = self.hw
        from rpcc.models.encoder import num_model_rows

        nm = num_model_rows(self.cfg)
        # ceil(hw/8): the encoder packs whole bytes (pack_bits_msb)
        contour = np.zeros((b, (hw + 7) // 8), np.uint8)  # device unpacks
        models = np.zeros((b, nm, 4), np.float32)
        sal = np.zeros((b, nm), np.uint8)
        seqs: List[Optional[np.ndarray]] = [None] * b
        streams: List[Optional[np.ndarray]] = [None] * b

        packed = [unpack_bitstream(b, uniform=self.cfg.uniform) for b in blobs]
        resid_bytes = None
        contour_bytes = None
        fused = None  # (stream8, exc_pos, exc_val) — i8 uplink built in-place
        if self.cfg.basic_compressor == "rans":
            from rpcc.codec import rans_codec

            # Fused i8 path: the native finalize writes the i8+exception
            # decode-uplink view DIRECTLY, skipping the (B, HW) i16
            # materialization + three rescan passes.
            rblobs = [p["residual_quantized"] for p in packed]
            ns = rans_codec.peek_delta_ns(rblobs)
            if ns is not None and max(ns, default=1) <= hw:
                m_f = _bucket(max(ns + [1]), hw)
                stream8 = np.zeros((b, m_f), np.int8)
                exc_pos = np.full((b, EXC_CAP), hw, np.int32)
                exc_val = np.zeros((b, EXC_CAP), np.int16)
                n_exc = rans_codec.decompress_delta_batch_i8(
                    rblobs, stream8, exc_pos, exc_val
                )
                if n_exc is not None and (n_exc <= EXC_CAP).all():
                    fused = (stream8, exc_pos, exc_val)
            if fused is None:
                resid_bytes, contour_bytes = rans_codec.batch_decode_big_fields(
                    packed
                )
            else:
                # residuals already landed in the fused i8 view; the contour
                # side rides the SAME shared gate as the general path.
                contour_bytes = rans_codec.batch_decode_contours(packed)

        def one(i: int):
            skip = set()
            if resid_bytes is not None or fused is not None:
                skip.add("residual_quantized")
            if contour_bytes is not None:
                skip.add("contour_map")
            fields = {
                k: self.entropy.decompress(v)
                for k, v in packed[i].items()
                if k not in skip
            }
            if resid_bytes is not None:
                fields["residual_quantized"] = resid_bytes[i]
            if contour_bytes is not None:
                fields["contour_map"] = contour_bytes[i]
            contour[i] = np.frombuffer(fields["contour_map"], np.uint8)
            seqs[i] = np.frombuffer(fields["idx_sequence"], np.uint16)
            if fused is None:
                streams[i] = np.frombuffer(fields["residual_quantized"], np.int16)
            m = np.frombuffer(fields["plane_param"], np.float32).reshape(-1, 4)
            models[i, : m.shape[0]] = m
            if "salience_level" in fields:
                sal[i] = np.frombuffer(fields["salience_level"], np.uint8).astype(np.int32)

        self._pool_map("entropy_decode", one, len(blobs))
        # Bucketed uploads: the padded (B, HW) seq/stream arrays are ~17 MB
        # for ~1 MB of live data.  The decoder pads
        # in-graph; the residual stream additionally rides the i8+exception
        # transfer view when every frame fits (mirror of the encode downlink).
        m_seq = _bucket(max((s.shape[0] for s in seqs if s is not None), default=1), hw)
        # u8 sequence uplink (half the bytes) whenever the model table fits
        # a byte AND every id in this (untrusted) batch is < 256 — corrupt
        # ids >= 256 keep the u16 view so the out-of-range decode rule
        # (ids >= M -> r = 0) stays identical across backends.
        seq_u8 = self._seq_u8_ok and all(
            s.size == 0 or int(s.max()) < 256 for s in seqs if s is not None
        )
        seq = np.zeros((b, m_seq), np.uint8 if seq_u8 else np.uint16)
        for i, s in enumerate(seqs):
            if s is not None:
                seq[i, : s.shape[0]] = s
        if fused is not None:
            # i8 uplink view was written in place by the native finalize —
            # no i16 materialization, no rescan.
            stream8, exc_pos, exc_val = fused
            return (
                self._decode_b_i8,
                (contour, seq, stream8, models, self._step_arg),
                sal,
                (exc_pos, exc_val),
                len(blobs),
            )
        # Rebuild the i8+exception transfer view vectorized across the
        # batch (the per-frame loop here was a measurable host cost).
        m_stream = _bucket(
            max((q.shape[0] for q in streams if q is not None), default=1), hw
        )
        stream16 = np.zeros((b, m_stream), np.int16)
        for i, q in enumerate(streams):
            if q is not None:
                stream16[i, : q.shape[0]] = q
        # no int32 temp: a (B, m_stream) cast+abs walked ~32 MB per batch;
        # the two comparisons work on the int16 directly
        # (and are immune to the int16 abs(-32768) pitfall the cast dodged)
        mask = (stream16 > 127) | (stream16 < -127)
        n_exc_per = mask.sum(axis=1)
        if (n_exc_per <= EXC_CAP).all():
            stream8 = np.where(mask, np.int16(-128), stream16).astype(np.int8)
            exc_pos = np.full((b, EXC_CAP), hw, np.int32)
            exc_val = np.zeros((b, EXC_CAP), np.int16)
            rows, cols = np.nonzero(mask)  # row-major: sorted by row
            if rows.size:
                slot = np.arange(rows.size) - np.searchsorted(rows, rows)
                exc_pos[rows, slot] = cols
                exc_val[rows, slot] = stream16[rows, cols]
            dec_fn = self._decode_b_i8
            args = (contour, seq, stream8, models, self._step_arg)
            tail = (exc_pos, exc_val)
        else:
            dec_fn = self._decode_b
            args = (contour, seq, stream16, models, self._step_arg)
            tail = ()
        return dec_fn, args, sal, tail, len(blobs)

    def _dispatch_decode(self, prepared):
        """Decode pipeline stage 1 (wire-bound): upload + dispatch a
        prepared decode batch; queues the downlink copies."""
        dec_fn, args, sal, tail, live = prepared
        if args[1].dtype == np.uint8:
            # u8 sequence uplink: ship half the bytes, widen on device (the
            # decoder program itself always sees u16 — one cached trace).
            # On a mesh the upload goes straight to the batch sharding the
            # decoder expects (an unsharded device_put would land on device
            # 0 and pay a second hop when the sharded decoder reshards it);
            # the cast jit follows the input's sharding.
            if self.mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as P

                dev = jax.device_put(args[1], NamedSharding(self.mesh, P("data")))
            else:
                dev = jax.device_put(args[1])
            args = (args[0], self._cast_u16(dev), *args[2:])
        if self.cfg.uniform:
            dec = dec_fn(*args, *tail)
        else:
            dec = dec_fn(*args, sal, *tail)
        if self._m8_down:
            _copy_async(dec.maskp, dec.d8, dec.exc_pd, dec.exc_val,
                        dec.n_exc, dec.n_nz, dec.delta)
        elif self._d8_down:
            _copy_async(dec.d8, dec.exc_pd, dec.exc_val, dec.n_exc, dec.delta)
        elif self._u16_down:
            _copy_async(dec.range_u16, dec.delta)
        else:
            _copy_async(dec.range_image)
        return dec, live

    def decode_blobs_device(self, blobs: Sequence[bytes]):
        """Entropy-decode + stack + dispatch one device decode batch."""
        return self._dispatch_decode(self._prepare_decode(blobs))

    def _materialize_ris(self, dec, live: int):
        """Block on the decode downloads -> ((B, H, W) f32 ranges, live).

        Downloads the (B, H, W) range image, NOT the (B, H, W, 3) cloud (3x
        the bytes); back-projection is one host multiply.
        In u16 transfer mode the u16 snap view halves it again; the default
        d8 view (i8 row-deltas + exceptions) takes ~31% more off that."""
        if self._m8_down:
            from rpcc.models.host_decoder import m8_reconstruct_batch

            n_exc = np.asarray(dec.n_exc)
            n_nz = np.asarray(dec.n_nz)
            d8c = np.asarray(dec.d8)
            pd = np.asarray(dec.exc_pd)
            ris = m8_reconstruct_batch(
                np.asarray(dec.maskp), d8c, pd,
                np.asarray(dec.exc_val), n_nz, n_exc,
                np.asarray(dec.delta), self.H, self.W,
            )
            over = np.flatnonzero(
                (n_nz[:live] > d8c.shape[1]) | (n_exc[:live] > pd.shape[1])
            )
            if over.size:
                # Rare lossless fallback: a frame overflowing either cap
                # downloads its raw u16 grid rows instead.
                riq = np.asarray(dec.range_u16)
                d = np.asarray(dec.delta)
                for i in over:
                    ris[i] = riq[i].astype(np.float32) * d[i]
            return ris, live
        if self._d8_down:
            from rpcc.models.host_decoder import d8_reconstruct_batch

            n_exc = np.asarray(dec.n_exc)
            ris = d8_reconstruct_batch(
                np.asarray(dec.d8),
                np.asarray(dec.exc_pd),
                np.asarray(dec.exc_val),
                n_exc,
                np.asarray(dec.delta),
            )
            over = np.flatnonzero(n_exc[:live] > dec.exc_pd.shape[1])
            if over.size:
                # Rare lossless fallback: a frame with more exceptions than
                # the fixed CAP downloads its raw u16 grid rows instead.
                riq = np.asarray(dec.range_u16)
                d = np.asarray(dec.delta)
                for i in over:
                    ris[i] = riq[i].astype(np.float32) * d[i]
            return ris, live
        if self._u16_down:
            ris = np.asarray(dec.range_u16).astype(np.float32)
            ris *= np.asarray(dec.delta)[:, None, None]
        else:
            ris = np.asarray(dec.range_image)
        return ris, live

    def _points_from_ris(self, ris: np.ndarray, live: int) -> List[np.ndarray]:
        if not hasattr(self, "_tm_np"):
            from rpcc.ops.projection import build_transform_map

            self._tm_np = build_transform_map(self.lidar)
        return [ris[i][..., None] * self._tm_np for i in range(live)]

    def _points4_from_ris(self, ris: np.ndarray, live: int) -> List[np.ndarray]:
        """-> list of compacted (n, 4) f32 xyz0 rows per live frame — the
        datalist save format (reference dataset.py:74-75 drop rule).  Same
        row count and drop decisions as HostDecoder.decode_blobs_points;
        byte-identical to it in f32-transfer mode, within the documented
        u16 snap bound (<= step/32) in reduced-transfer modes (the m8/d8
        decode downlinks re-snap the reconstruction to the u16 grid).

        Native single pass (decode.cpp::backproject_compact); the numpy
        twin applies the same sum(xyz) != 0 rule in the same f32 order.
        The full-cloud broadcast it replaces ((H, W, 1) * (H, W, 3), then
        save_point_cloud's mask + concat) was a large share of the datalist
        device-decode host time."""
        from rpcc.codec.lz4block import native_lib

        if not hasattr(self, "_tm_planar"):
            from rpcc.ops.projection import build_transform_planes

            self._tm_planar = np.ascontiguousarray(
                build_transform_planes(self.lidar).reshape(3, self.hw),
                np.float32,
            )
        lib = native_lib()
        out: List[np.ndarray] = []
        if lib is not None and hasattr(lib, "backproject_compact"):
            import ctypes as ct

            tm_p = self._tm_planar.ctypes.data_as(ct.c_void_p)
            for i in range(live):
                ri = np.ascontiguousarray(ris[i], np.float32)
                buf = np.empty((self.hw, 4), np.float32)
                n = lib.backproject_compact(
                    ri.ctypes.data_as(ct.c_void_p), tm_p,
                    ct.c_int64(self.hw), buf.ctypes.data_as(ct.c_void_p),
                )
                out.append(buf[: int(n)])
            return out
        for i in range(live):
            pts = ris[i].reshape(-1, 1) * self._tm_planar.T  # (HW, 3) f32
            keep = pts.sum(-1) != 0
            n = int(keep.sum())
            buf = np.zeros((n, 4), np.float32)
            buf[:, :3] = pts[keep]
            out.append(buf)
        return out

    def decode_blobs_points(self, blobs: Sequence[bytes]) -> List[np.ndarray]:
        """Device decode -> compacted (n, 4) f32 xyz0 rows per frame (the
        .bin save format) — mirror of HostDecoder.decode_blobs_points."""
        return self._points4_from_ris(
            *self._materialize_ris(*self._dispatch_decode(self._prepare_decode(blobs)))
        )

    def _back_project(self, dec, live: int) -> List[np.ndarray]:
        return self._points_from_ris(*self._materialize_ris(dec, live))

    def prewarm_fallback_decoder(
        self, stream_len: Optional[int] = None, seq_len: Optional[int] = None
    ) -> None:
        """Compile the full-i16 fallback decoder program up front.

        The fallback only runs when a frame overflows EXC_CAP on the decode
        uplink; left to compile lazily, the first such frame stalls
        production for one full-graph XLA compile (then cached).  The program is shape-keyed on the BUCKETED stream/sequence
        lengths (quantum 8192), so pass a typical live ``stream_len`` /
        ``seq_len`` from your content (e.g. a real frame's) — the defaults
        warm the full-grid bucket, which production-size 64E frames
        (~122k-entry streams) also land in."""
        from rpcc.models.encoder import num_model_rows

        b = self.batch_size
        nm = num_model_rows(self.cfg)
        m_stream = _bucket(stream_len or self.hw, self.hw)
        m_seq = _bucket(seq_len or 1, self.hw)
        contour = np.zeros((b, (self.hw + 7) // 8), np.uint8)
        seq = np.zeros((b, m_seq), np.uint16)
        seq[:, 0] = 1  # one full-image run of cluster id 1 (zero pixels)
        stream = np.zeros((b, m_stream), np.int16)
        models = np.zeros((b, nm, 4), np.float32)
        args = (contour, seq, stream, models, self._step_arg)
        if self.cfg.uniform:
            dec = self._decode_b(*args)
        else:
            dec = self._decode_b(*args, np.zeros((b, nm), np.uint8))
        jax.block_until_ready(dec)

    def decode_blobs(self, blobs: Sequence[bytes]) -> List[np.ndarray]:
        dec, live = self.decode_blobs_device(blobs)
        return self._back_project(dec, live)

    def decode_pipeline(self, blob_batches, stats=None, points4=True):
        """4-deep, 4-thread pipelined decode over an iterable of blob lists
        (mirror of ``encode_pipeline``): stacker entropy-decodes batch k,
        uploader transfers + dispatches k-1, downloader materializes k-2's
        range images, caller back-projects k-3.

        With ``points4=True`` (default) yields compacted (n, 4) f32 xyz0
        rows per frame — the datalist save format, byte-identical to the
        synchronous ``decode_blobs_points`` and mirroring the host
        backend's method of the same name.  Pass ``points4=False`` for the
        full (H, W, 3) cloud semantics of ``decode_blobs`` (eval paths)."""
        final = self._points4_from_ris if points4 else self._points_from_ris
        return self._run_pipeline(
            blob_batches,
            self._prepare_decode,
            self._dispatch_decode,
            lambda dl: self._materialize_ris(*dl),
            lambda rl: final(*rl),
            stats=stats,
        )
