"""Hybrid device-rANS container (method name ``rans``).

The dominant bitstream field is the cluster-ordered quantized residual
stream.  It is not i.i.d. — residuals vary smoothly along the row-major
cluster order (measured on KITTI: H(q) = 6.3 bits/symbol but H(Δq) = 2.36,
vs bzip2's 2.49 achieved bits/symbol) — so the model here is **delta +
zigzag + order-0 rANS**, which beats bzip2's ratio on the residual field
while running as a batched jax kernel (ops/rans.py) or native C++.
``compress_delta_batch`` entropy-codes a whole frame batch in one device
call (one model per frame, lanes advance in lockstep across the batch).

Integer fields (int16/uint16 ndarrays) take the delta-rANS path; small side
fields (packed contour bits, float32 model table, salience bytes) fall back
to bzip2 — they are a few KB and not worth a device round trip.

Context container layout ('C', little-endian; legacy order-0 'D' decodes too):
  u8 magic  u8 log2(lanes)  u16 T(steps/lane)  u32 n_symbols  i32 q0
  u32 n_escapes [u32 escape zigzag values ...]     (|Δ| at/over ESCAPE, rare)
  NUM_CTX compact freq tables (see _pack_table: present-id bitmap + u8
    freqs with u16 escapes — ~4x smaller than flat sparse u16 tables, which
    cost ~2KB/frame and used to hand the adaptive pick to bzip2-delta)
  u32 states[lanes]  u16 counts[lanes]  u16 words[sum(counts)]  u8 dtype
Contour container ('N'): the seg-map contour bits, column-major so each
  lane's previous symbol is the bit ABOVE — a 2-context binary model
  (~0.25 bits/px vs bzip2's ~0.30 on the packed rows).
Bzip2 fallback: u8 magic 'B' + bzip2 stream.
"""

from __future__ import annotations

import bz2
import contextlib
import os
import struct
from typing import List, Sequence

import numpy as np

from rpcc.ops import rans as _r

# Where the rANS kernels run.  "cpu" (default): the native C++ per-lane
# loops (codec/native/rans.cpp, bit-exact to the jax kernels and far faster
# than lax.scan), falling back to the jax kernels pinned to the CPU backend
# if no compiler is available.  "default": the jax kernels on the default
# backend (an opt-in; its speed on the accelerator is not measured).
_RANS_DEVICE = os.environ.get("RPCC_RANS_DEVICE", "cpu")


def _native():
    if _RANS_DEVICE != "cpu":
        return None
    from rpcc.codec import rans_native

    return rans_native if rans_native.available() else None


def _rans_backend():
    if _RANS_DEVICE != "cpu":
        return contextlib.nullcontext()
    import jax

    try:
        cpu = jax.devices("cpu")[0]
    except Exception:  # no cpu backend registered
        return contextlib.nullcontext()
    return jax.default_device(cpu)

MAGIC_DELTA = 0x44  # 'D' — order-0 delta container (still decodable)
MAGIC_CTX = 0x43  # 'C' — context-modeled delta container
MAGIC_BZD = 0x5A  # 'Z' — bzip2 over the zigzag-delta stream
MAGIC_BITS = 0x4E  # 'N' — column-major context-coded contour bits
MAGIC_BZ = 0x42  # 'B'
MAGIC_ZL8 = 0x38  # '8' — zlib over the u8 view of a u16 field (ids <= 255)
ALPHABET = 512
ESCAPE = ALPHABET - 1  # symbol id reserved for |delta| outside table range
# 32 lanes: header overhead is 6 bytes/lane (state + count) and the scan's
# steady-state cost is work-bound, not step-bound — measured identical
# encode/decode times at 32 vs 128 lanes, 487 fewer header bytes per frame.
MAX_LANES = 32
T_BUCKET = 16  # steps-per-lane rounded up to this, bounding jit variants

# Fields above this size always take the device delta-rANS path; smaller
# fields are cheap enough to try both and keep the smaller container.
BIG_FIELD_BYTES = 64 * 1024

# The bzip2-over-delta ('Z') and plain-bzip2 comparisons are only attempted
# below these sizes: with compact tables the ctx-rANS container wins on
# every measured large stream, and bz2 on the residual field is pure host
# overhead.  RPCC_RANS_ADAPTIVE=full
# restores the exhaustive per-frame comparison.
BZD_TRY_MAX_SYMBOLS = 32768
CONTOUR_BZ_TRY_MAX_PIXELS = 65536
_ADAPTIVE_FULL = os.environ.get("RPCC_RANS_ADAPTIVE", "") == "full"


def _lanes_for(n: int) -> int:
    lanes = 1
    while lanes < MAX_LANES and lanes * 64 < n:
        lanes *= 2
    return lanes


def _zigzag(d: np.ndarray) -> np.ndarray:
    return np.where(d >= 0, 2 * d, -2 * d - 1).astype(np.int64)


def _unzigzag(z: np.ndarray) -> np.ndarray:
    return np.where(z % 2 == 0, z // 2, -(z + 1) // 2).astype(np.int64)


def compress_seq_u16(data: np.ndarray) -> bytes:
    """Best coder for the idx_sequence field (small-alphabet run values):
    zlib over the u8 view — beats both bz2 and delta-rANS on every measured
    frame (32/32, 5-8% smaller than bz2).  Level 6, not 9: on real KITTI
    sequences level 9 saves only ~31 B of ~2 KB (+0.09% of the whole blob)
    but costs 4x the host time."""
    import zlib

    data = np.ascontiguousarray(data, np.uint16)
    if data.size == 0 or int(data.max(initial=0)) <= 255:
        return bytes([MAGIC_ZL8]) + zlib.compress(data.astype(np.uint8).tobytes(), 6)
    return bytes([MAGIC_BZ]) + bz2.compress(data.tobytes())


def compress(data, lanes: int | None = None) -> bytes:
    if isinstance(data, np.ndarray) and data.dtype in (np.int16, np.uint16, np.int32):
        delta = compress_delta_batch([data], lanes=lanes)[0]
        if data.nbytes > BIG_FIELD_BYTES:
            return delta
        candidates = [delta, bytes([MAGIC_BZ]) + bz2.compress(data.tobytes())]
        if data.dtype == np.uint16:
            candidates.append(compress_seq_u16(data))
        return min(candidates, key=len)
    raw = data.tobytes() if isinstance(data, np.ndarray) else bytes(data)
    return bytes([MAGIC_BZ]) + bz2.compress(raw)


def decompress(blob: bytes) -> bytes:
    if blob[0] == MAGIC_BZ:
        return bz2.decompress(blob[1:])
    if blob[0] == MAGIC_ZL8:
        import zlib

        u8 = np.frombuffer(zlib.decompress(blob[1:]), np.uint8)
        return u8.astype(np.uint16).tobytes()
    if blob[0] == MAGIC_BITS:
        return _decompress_bits(blob)
    if blob[0] in (MAGIC_DELTA, MAGIC_CTX, MAGIC_BZD):
        return decompress_delta_batch([blob])[0]
    raise ValueError("unknown rans container magic")


# ------------------------------------------------- compact freq-table codec
def _pack_table(freq_row: np.ndarray) -> bytes:
    """Compact normalized-freq table: u16 max present id (0xFFFF = empty),
    presence bitmap over [0, max_id], then one u8 per present symbol with
    255 escaping to a trailing u16 list.  ~4x smaller than flat sparse
    {u16 id, u16 freq} pairs for typical KITTI delta tables."""
    present = np.nonzero(freq_row)[0]
    if present.size == 0:
        return struct.pack("<H", 0xFFFF)
    max_id = int(present[-1])
    bitmap = np.zeros(max_id + 1, np.uint8)
    bitmap[present] = 1
    vals = freq_row[present].astype(np.int64)
    small = vals < 255
    return b"".join(
        [
            struct.pack("<H", max_id),
            np.packbits(bitmap).tobytes(),
            np.where(small, vals, 255).astype(np.uint8).tobytes(),
            vals[~small].astype("<u2").tobytes(),
        ]
    )


def _unpack_table(blob: bytes, off: int, alphabet: int):
    (max_id,) = struct.unpack_from("<H", blob, off)
    off += 2
    freq = np.zeros(alphabet, np.int32)
    if max_id == 0xFFFF:
        return freq, off
    nbytes = (max_id + 8) // 8
    bitmap = np.unpackbits(np.frombuffer(blob, np.uint8, nbytes, off))[: max_id + 1]
    off += nbytes
    present = np.nonzero(bitmap)[0]
    n = present.size
    b = np.frombuffer(blob, np.uint8, n, off).astype(np.int64)
    off += n
    n_esc = int((b == 255).sum())
    esc = np.frombuffer(blob, "<u2", n_esc, off).astype(np.int64)
    off += 2 * n_esc
    vals = b.copy()
    vals[b == 255] = esc
    freq[present] = vals
    return freq, off


# --------------------------------------------- contour bit-plane container
def compress_contour(packed: np.ndarray, H: int, W: int) -> bytes:
    """Context-coded contour bits ('N') vs bzip2 of the packed rows — keep
    the smaller.  Bits are laid out column-major so each rANS lane's previous
    symbol is the bit above (the strongest single-context predictor of the
    row-difference contour)."""
    ctx_blob = _compress_bits(np.asarray(packed, np.uint8), H, W)
    if not (_ADAPTIVE_FULL or H * W <= CONTOUR_BZ_TRY_MAX_PIXELS):
        return ctx_blob
    bz = bytes([MAGIC_BZ]) + bz2.compress(np.asarray(packed, np.uint8).tobytes())
    return min(ctx_blob, bz, key=len)


def compress_contour_batch(packed_list: Sequence[np.ndarray], H: int, W: int) -> List[bytes]:
    """Batch variant: every frame's contour bit plane coded in ONE device
    call (adaptive vs per-frame bzip2 for small planes, like the
    single-frame path; large planes take the wavefront coder outright)."""
    ctx_blobs = _compress_bits_batch([np.asarray(p, np.uint8) for p in packed_list], H, W)
    if not (_ADAPTIVE_FULL or H * W <= CONTOUR_BZ_TRY_MAX_PIXELS):
        return ctx_blobs
    out = []
    for p, cb in zip(packed_list, ctx_blobs):
        bzb = bytes([MAGIC_BZ]) + bz2.compress(np.asarray(p, np.uint8).tobytes())
        out.append(min(cb, bzb, key=len))
    return out


def _compress_bits(packed: np.ndarray, H: int, W: int) -> bytes:
    return _compress_bits_batch([packed], H, W)[0]


def _compress_bits_batch(packed_list: Sequence[np.ndarray], H: int, W: int) -> List[bytes]:
    """Diagonal wavefront layout: lane r = image row r, delayed r steps, so
    at decode step t every lane's own previous symbol is its LEFT neighbor
    and the lane above's previous symbol is the neighbor ABOVE — a 4-context
    (above, left) binary model the decoder reproduces from its scan carry."""
    B = len(packed_list)
    nat = _native()
    if nat is not None and nat.fused_available():
        T = -(-(W + H - 1) // T_BUCKET) * T_BUCKET
        pb = np.stack([np.asarray(p, np.uint8) for p in packed_list])
        packed, n_words, counts, states, freqs = nat.contour_encode_frames(pb, H, W, T)
        return [
            b"".join(
                [
                    struct.pack("<BHHH", MAGIC_BITS, T, H, W),
                    freqs[i].astype("<u2").tobytes(),
                    states[i].astype("<u4").tobytes(),
                    counts[i].astype("<u2").tobytes(),
                    packed[i, : n_words[i]].astype("<u2").tobytes(),
                ]
            )
            for i in range(B)
        ]
    bits = np.unpackbits(np.stack(packed_list).reshape(B, -1), axis=1)[:, : H * W]
    bits = bits.reshape(B, H, W)
    T = -(-(W + H - 1) // T_BUCKET) * T_BUCKET
    sym = np.zeros((B, H, T), np.int32)
    rows = np.arange(H)[:, None]
    cols = np.arange(W)[None, :]
    sym[:, rows, cols + rows] = bits
    left = np.zeros_like(sym)
    left[:, :, 1:] = sym[:, :, :-1]
    above = np.zeros_like(sym)
    above[:, 1:, 1:] = sym[:, :-1, :-1]
    ctx = 2 * above + left
    ctx[:, :, 0] = 0
    if nat is not None:
        words_np, counts_np, states_raw, freqs_raw = nat.encode_ctx_batch(sym, ctx, 2, 4)
        freqs_np = freqs_raw.astype("<u2")
        states_np = states_raw.astype("<u4")
    else:
        with _rans_backend():
            code, freqs = _r.encode_streams_batch_ctx_explicit(sym, ctx, 2, 4)
        freqs_np = np.asarray(freqs).astype("<u2")  # (B, 4, 2)
        counts_np = np.asarray(code.counts)  # (B, H)
        states_np = np.asarray(code.states).astype("<u4")
        words_np = np.asarray(code.words)
    out: List[bytes] = []
    for i in range(B):
        cnts = counts_np[i]
        n_words = int(cnts.sum())
        if n_words:
            lane_of = np.repeat(np.arange(H), cnts)
            starts = np.concatenate([[0], np.cumsum(cnts)[:-1]])
            pos = np.arange(n_words) - np.repeat(starts, cnts)
            packed_words = words_np[i, lane_of, pos].astype("<u2")
        else:
            packed_words = np.zeros(0, "<u2")
        out.append(
            b"".join(
                [
                    struct.pack("<BHHH", MAGIC_BITS, T, H, W),
                    freqs_np[i].tobytes(),
                    states_np[i].tobytes(),
                    cnts.astype("<u2").tobytes(),
                    packed_words.tobytes(),
                ]
            )
        )
    return out


def _decompress_bits(blob: bytes) -> bytes:
    return decompress_contour_batch([blob])[0]


def decompress_contour_batch(blobs: Sequence[bytes]) -> List[bytes]:
    """Decode a batch of 'N' contour containers in ONE device call."""
    B = len(blobs)
    heads = [struct.unpack_from("<BHHH", b, 0) for b in blobs]
    T, H, W = heads[0][1], heads[0][2], heads[0][3]
    assert all(h[1:] == (T, H, W) for h in heads), "mixed contour geometries"
    if T < H + W - 1 or H < 1 or W < 1:
        # The wavefront skew stores row r at offset r, so the de-skew reads
        # sym[r*T + r + c] up to (H-1)*(T+1)+W-1 — a container claiming a
        # smaller T would read past the (B, H, T) symbol block in the
        # native finalize (heap disclosure into decoder output).
        raise ValueError(
            f"corrupt contour container: T={T} < H+W-1 for {H}x{W}"
        )
    freqs = np.zeros((B, 4, 2), np.int32)
    states = np.zeros((B, H), np.uint32)
    counts = np.zeros((B, H), np.int32)
    words = np.zeros((B, H, T), np.uint16)
    for i, blob in enumerate(blobs):
        off = 7
        freqs[i] = np.frombuffer(blob, "<u2", 8, off).astype(np.int32).reshape(4, 2)
        off += 16
        states[i] = np.frombuffer(blob, "<u4", H, off)
        off += 4 * H
        cnt = np.frombuffer(blob, "<u2", H, off).astype(np.int32)
        off += 2 * H
        counts[i] = cnt
        n_words = int(cnt.sum())
        if n_words:
            packed_w = np.frombuffer(blob, "<u2", n_words, off).astype(np.uint16)
            lane_of = np.repeat(np.arange(H), cnt)
            starts = np.concatenate([[0], np.cumsum(cnt)[:-1]])
            pos = np.arange(n_words) - np.repeat(starts, cnt)
            words[i, lane_of, pos] = packed_w
    nat = _native()
    if nat is not None:
        sym = nat.decode_ctx_batch(
            words, counts, states, freqs, T, nat.MODE_WAVEFRONT
        ).reshape(B, H, T)
        packed = nat.contour_finalize_frames(sym, H, W, T)
        if packed is not None:  # fused de-skew + packbits (C++)
            return [packed[i].tobytes() for i in range(B)]
    else:
        code = _r.RansCode(words, counts, states)
        with _rans_backend():
            sym = np.asarray(
                _r.decode_streams_batch_ctx(
                    code, freqs, T, ctx_fn=_r.wavefront_bit_context
                )
            ).reshape(B, H, T)
    rows = np.arange(H)[:, None]
    cols = np.arange(W)[None, :]
    bits = sym[:, rows, cols + rows].astype(np.uint8)
    return [np.packbits(bits[i].reshape(-1)).tobytes() for i in range(B)]


def batch_decode_big_fields(packed: Sequence[dict]):
    """Batch-decode the two big fields across a blob batch when every frame
    carries a matching container magic: ``-> (resid_bytes | None,
    contour_bytes | None)`` with one list entry per frame.

    Single-frame CLI blobs may pick plain bz2 for small residual fields
    (``compress`` candidates) — a mixed batch returns None for that field
    and the caller dispatches each frame on its own magic.  Shared by
    BatchEngine._prepare_decode and HostDecoder.entropy_decode_blobs so the
    two decode paths can never disagree on which blobs batch-decode.
    """
    delta_magics = (MAGIC_DELTA, MAGIC_CTX, MAGIC_BZD)
    resid = None
    if all(p["residual_quantized"][0] in delta_magics for p in packed):
        resid = decompress_delta_batch([p["residual_quantized"] for p in packed])
    return resid, batch_decode_contours(packed)


def batch_decode_contours(packed: Sequence[dict]):
    """Contour half of :func:`batch_decode_big_fields` — one list entry per
    frame when every frame's contour_map is a 'bits' container, else None
    (the caller then dispatches each frame on its own magic).  This is THE
    gate for which blobs batch-decode their contours: the engine's fused i8
    path calls it directly so it can never disagree with the general path."""
    cms = [p["contour_map"] for p in packed]
    if cms and all(len(c) > 0 and c[0] == MAGIC_BITS for c in cms):
        return decompress_contour_batch(cms)
    return None


# --------------------------------------------------- bz2-over-delta variant
def _compress_bzd(sym, escapes, q0: int, n: int, dtype) -> bytes:
    """'Z' container: the same zigzag-delta stream, bzip2-coded.  On KITTI
    residuals this is ~5% smaller than bzip2 over the raw stream and often
    edges out the rANS container (whose tables cost ~2KB); the encoder picks
    the smaller per frame."""
    zz16 = np.where(sym == ESCAPE, ESCAPE, sym).astype("<u2")
    payload = bz2.compress(zz16.tobytes())
    return b"".join(
        [
            struct.pack("<BBIi", MAGIC_BZD, _dtype_code(dtype), n, q0),
            struct.pack("<I", escapes.shape[0]),
            escapes.astype("<u4").tobytes(),
            payload,
        ]
    )


def _decompress_bzd(blob: bytes) -> bytes:
    magic, dt_code, n, q0 = struct.unpack_from("<BBIi", blob, 0)
    off = 10
    (n_esc,) = struct.unpack_from("<I", blob, off)
    off += 4
    escapes = np.frombuffer(blob, "<u4", n_esc, off).astype(np.int64)
    off += 4 * n_esc
    if n == 0:
        return b""
    sym = np.frombuffer(bz2.decompress(blob[off:]), "<u2").astype(np.int64)[:n]
    zz = sym.copy()
    if n_esc:
        zz[sym == ESCAPE] = escapes
    d = _unzigzag(zz)
    d[0] = 0
    q = q0 + np.cumsum(d)
    return q.astype(_CODE_DTYPE[dt_code]).tobytes()


def _zigzag_ctx_np(sym3d: np.ndarray) -> np.ndarray:
    """numpy twin of ops/rans.py::_ctx_of with the zigzag-magnitude model."""
    prev = np.zeros_like(sym3d)
    prev[:, :, 1:] = sym3d[:, :, :-1]
    mag = (prev + 1) // 2
    ctx = (mag >= 1).astype(np.int32) + (mag >= 3) + (mag >= 8)
    ctx[:, :, 0] = 0
    return ctx.astype(np.int32)


def _dtype_code(dt) -> int:
    return {np.dtype(np.int16): 0, np.dtype(np.uint16): 1, np.dtype(np.int32): 2}[np.dtype(dt)]


_CODE_DTYPE = {0: np.int16, 1: np.uint16, 2: np.int32}


def _symbolize(arr: np.ndarray):
    """array -> (zigzag-delta symbols int32, escapes, q0, n)."""
    q = arr.astype(np.int64).reshape(-1)
    n = q.shape[0]
    d = np.empty(n, np.int64)
    if n:
        d[0] = 0
        d[1:] = np.diff(q)
    zz = _zigzag(d)
    esc_mask = zz >= ESCAPE
    escapes = zz[esc_mask]
    sym = np.where(esc_mask, ESCAPE, zz).astype(np.int32)
    return sym, escapes, (int(q[0]) if n else 0), n


def compress_delta_batch(arrays: Sequence[np.ndarray], lanes: int | None = None) -> List[bytes]:
    """Entropy-code a batch of integer streams.

    Context-modeled ('C' container): each symbol is coded under one of
    NUM_CTX models selected by the previous delta's magnitude bucket
    (measured on KITTI: 2.36 -> 2.16 bits/symbol vs order-0).

    Large frames take the fully-fused native path (zigzag + contexts +
    histogram + normalize + encode + word packing in one C++ call —
    byte-identical containers, ~10x less host time than the numpy
    pre-pass); small frames keep the numpy path, which also runs the
    bzip2-over-delta adaptive comparison.
    """
    nat = _native()
    if nat is None or not nat.fused_available() or _ADAPTIVE_FULL:
        return _compress_delta_batch_np(arrays, lanes)
    routed = _route_wide_escape_frames(
        arrays, lambda rest: compress_delta_batch(rest, lanes)
    )
    if routed is not None:
        return routed
    B = len(arrays)
    out: List[bytes] = [b""] * B
    big_ix = [
        i for i, a in enumerate(arrays) if np.asarray(a).size > BZD_TRY_MAX_SYMBOLS
    ]
    big_set = set(big_ix)
    small_ix = [i for i in range(B) if i not in big_set]
    if small_ix:
        for i, blob in zip(
            small_ix, _compress_delta_batch_np([arrays[i] for i in small_ix], lanes)
        ):
            out[i] = blob
    if big_ix:
        subs = [np.ascontiguousarray(arrays[i]) for i in big_ix]
        n_max = max(a.size for a in subs)
        L = lanes if lanes is not None else _lanes_for(n_max)
        T = max(1, -(-n_max // L))
        T = -(-T // T_BUCKET) * T_BUCKET
        packed, n_words, counts, states, freqs, escapes, esc_counts, q0s = (
            nat.delta_encode_frames(subs, L, T, ALPHABET, _r.NUM_CTX)
        )
        for k, i in enumerate(big_ix):
            if esc_counts[k] < 0:  # escape-capacity overflow: numpy fallback
                out[i] = _compress_delta_batch_np([arrays[i]], lanes)[0]
                continue
            parts = [
                struct.pack(
                    "<BBHIi", MAGIC_CTX, L.bit_length() - 1, T, subs[k].size,
                    int(q0s[k]),
                ),
                struct.pack("<I", int(esc_counts[k])),
                escapes[k, : esc_counts[k]].astype("<u4").tobytes(),
            ]
            for c in range(_r.NUM_CTX):
                parts.append(_pack_table(freqs[k, c].astype(np.int64)))
            parts += [
                states[k].astype("<u4").tobytes(),
                counts[k].astype("<u2").tobytes(),
                packed[k, : n_words[k]].astype("<u2").tobytes(),
                struct.pack("<B", _dtype_code(subs[k].dtype)),
            ]
            out[i] = b"".join(parts)
    return out


def build_ctx_container(L: int, T: int, n: int, q0: int, escapes: np.ndarray,
                        freqs: np.ndarray, states: np.ndarray,
                        counts: np.ndarray, packed_words: np.ndarray,
                        dtype) -> bytes:
    """Assemble a 'C' container from raw pieces (shared by the fused C++
    and on-device encoders)."""
    # Per-lane word counts ride the wire as u16: a T beyond 0xFFFF (grid
    # over ~2.1M pixels at 32 lanes) would silently wrap into an
    # undecodable container — fail loudly instead.
    if T > 0xFFFF:
        raise ValueError(f"ctx container lane length T={T} overflows u16")
    parts = [
        struct.pack("<BBHIi", MAGIC_CTX, L.bit_length() - 1, T, n, int(q0)),
        struct.pack("<I", escapes.shape[0]),
        np.ascontiguousarray(escapes, "<u4").tobytes(),
    ]
    for c in range(freqs.shape[0]):
        parts.append(_pack_table(freqs[c].astype(np.int64)))
    parts += [
        np.ascontiguousarray(states, "<u4").tobytes(),
        np.ascontiguousarray(counts, "<u2").tobytes(),
        np.ascontiguousarray(packed_words, "<u2").tobytes(),
        struct.pack("<B", _dtype_code(dtype)),
    ]
    return b"".join(parts)


def build_bits_container(T: int, H: int, W: int, freqs: np.ndarray,
                         states: np.ndarray, counts: np.ndarray,
                         packed_words: np.ndarray) -> bytes:
    """Assemble an 'N' contour container from raw pieces."""
    if T > 0xFFFF:
        raise ValueError(f"bits container lane length T={T} overflows u16")
    return b"".join(
        [
            struct.pack("<BHHH", MAGIC_BITS, T, H, W),
            np.ascontiguousarray(freqs, "<u2").tobytes(),
            np.ascontiguousarray(states, "<u4").tobytes(),
            np.ascontiguousarray(counts, "<u2").tobytes(),
            np.ascontiguousarray(packed_words, "<u2").tobytes(),
        ]
    )


def _needs_wide_escapes(a: np.ndarray) -> bool:
    """int32 streams whose first-differences overflow int32 cannot ride the
    delta containers: escape values are u32 on the wire (zigzag of an int33
    delta wraps), and every backend would silently truncate.  i16/u16
    streams are always safe (zigzag <= 131071)."""
    if a.dtype != np.int32 or a.size < 2:
        return False
    d = np.diff(a.astype(np.int64))
    return bool(d.min() < -(2**31) or d.max() > 2**31 - 1)


def _route_wide_escape_frames(arrays, encode_rest):
    """Split off frames that need >u32 escapes to lossless plain-bz2 ('B')
    containers; ``encode_rest`` codes the remaining frames.  Returns None
    when no frame needs routing (the common case, zero-copy)."""
    wide = [i for i, a in enumerate(arrays) if _needs_wide_escapes(np.asarray(a))]
    if not wide:
        return None
    out: List[bytes] = [b""] * len(arrays)
    for i in wide:
        out[i] = bytes([MAGIC_BZ]) + bz2.compress(np.asarray(arrays[i]).tobytes())
    rest = [i for i in range(len(arrays)) if i not in set(wide)]
    if rest:
        for i, blob in zip(rest, encode_rest([arrays[i] for i in rest])):
            out[i] = blob
    return out


def _compress_delta_batch_np(arrays: Sequence[np.ndarray], lanes: int | None = None) -> List[bytes]:
    """numpy/jax-kernel implementation (also runs the bzd comparison)."""
    routed = _route_wide_escape_frames(
        arrays, lambda rest: _compress_delta_batch_np(rest, lanes)
    )
    if routed is not None:
        return routed
    B = len(arrays)
    per = [_symbolize(np.asarray(a)) for a in arrays]
    n_max = max((p[3] for p in per), default=0)
    if lanes is None:
        lanes = _lanes_for(max(n_max, 1))
    T = max(1, -(-n_max // lanes))
    T = -(-T // T_BUCKET) * T_BUCKET
    sym3d = np.zeros((B, lanes, T), np.int32)
    for i, (sym, _, _, n) in enumerate(per):
        sym3d[i].reshape(-1)[:n] = sym
    ns = np.asarray([p[3] for p in per], np.int64)
    nat = _native()
    if nat is not None:
        ctx3d = _zigzag_ctx_np(sym3d)
        words_np, counts_np, states_raw, freqs_raw = nat.encode_ctx_batch(
            sym3d, ctx3d, ALPHABET, _r.NUM_CTX, ns=ns
        )
        freqs_np = freqs_raw.astype(np.int64)
        states_np = states_raw.astype("<u4")
    else:
        import jax.numpy as jnp

        with _rans_backend():
            code, freqs = _r.encode_streams_batch_ctx(
                sym3d, ALPHABET, ns=jnp.asarray(ns, jnp.int32)
            )
        freqs_np = np.asarray(freqs).astype(np.int64)  # (B, C, A)
        counts_np = np.asarray(code.counts)  # (B, L)
        states_np = np.asarray(code.states).astype("<u4")  # (B, L)
        words_np = np.asarray(code.words)  # (B, L, T)

    out: List[bytes] = []
    for i, (sym, escapes, q0, n) in enumerate(per):
        cnts = counts_np[i]
        n_words = int(cnts.sum())
        if n_words:
            lane_of = np.repeat(np.arange(lanes), cnts)
            starts = np.concatenate([[0], np.cumsum(cnts)[:-1]])
            pos = np.arange(n_words) - np.repeat(starts, cnts)
            packed_words = words_np[i, lane_of, pos].astype("<u2")
        else:
            packed_words = np.zeros(0, "<u2")
        parts = [
            struct.pack("<BBHIi", MAGIC_CTX, lanes.bit_length() - 1, T, n, q0),
            struct.pack("<I", escapes.shape[0]),
            escapes.astype("<u4").tobytes(),
        ]
        for c in range(_r.NUM_CTX):
            parts.append(_pack_table(freqs_np[i, c]))
        parts += [
            states_np[i].tobytes(),
            cnts.astype("<u2").tobytes(),
            packed_words.tobytes(),
            struct.pack("<B", _dtype_code(arrays[i].dtype)),
        ]
        ctx_blob = b"".join(parts)
        if _ADAPTIVE_FULL or n <= BZD_TRY_MAX_SYMBOLS:
            bzd_blob = _compress_bzd(sym, escapes, q0, n, arrays[i].dtype)
            out.append(min(ctx_blob, bzd_blob, key=len))
        else:
            out.append(ctx_blob)
    return out


def _parse_delta(blob: bytes):
    magic, log_lanes, T, n, q0 = struct.unpack_from("<BBHIi", blob, 0)
    off = 12
    if (1 << log_lanes) > MAX_LANES:
        # Encoders never emit more than MAX_LANES; a corrupt log_lanes
        # would otherwise drive a multi-GB words allocation in the batch
        # decoder before any other check fires.
        raise ValueError(
            f"corrupt delta container: lanes=2^{log_lanes} > {MAX_LANES}"
        )
    lanes = 1 << log_lanes
    if n > lanes * T:
        # The decoders produce at most lanes*T symbols; a container
        # claiming more would return np.empty tail bytes (heap disclosure)
        # from the native finalize, or a silently short buffer from numpy.
        raise ValueError(
            f"corrupt delta container: n={n} > lanes*T={lanes}*{T}"
        )
    (n_esc,) = struct.unpack_from("<I", blob, off)
    off += 4
    escapes = np.frombuffer(blob, "<u4", n_esc, off).astype(np.int64)
    off += 4 * n_esc
    n_tables = _r.NUM_CTX if magic == MAGIC_CTX else 1
    freqs = np.zeros((n_tables, ALPHABET), np.int32)
    for c in range(n_tables):
        freqs[c], off = _unpack_table(blob, off, ALPHABET)
    states = np.frombuffer(blob, "<u4", lanes, off).astype(np.uint32)
    off += 4 * lanes
    counts = np.frombuffer(blob, "<u2", lanes, off).astype(np.int32)
    off += 2 * lanes
    n_words = int(counts.sum())
    packed = np.frombuffer(blob, "<u2", n_words, off).astype(np.uint16)
    off += 2 * n_words
    (dt_code,) = struct.unpack_from("<B", blob, off)
    return magic, lanes, T, n, q0, escapes, freqs, states, counts, packed, dt_code


def decompress_delta_batch(blobs: Sequence[bytes]) -> List[bytes]:
    """Decode a batch of delta containers in ONE device rANS call.

    Frames may have different encoded T; decoding runs max(T) forward steps —
    steps beyond a frame's own T produce discarded symbols (rANS decoding is
    forward-causal, so earlier outputs are unaffected).
    """
    if not blobs:
        return []
    if any(b[0] in (MAGIC_BZD, MAGIC_BZ) for b in blobs):
        # 'Z' (bz2-over-delta) and 'B' (plain bz2 — the wide-escape route
        # for int32 streams whose deltas overflow u32) decode per frame.
        out = [None] * len(blobs)
        rans_ix = [i for i, b in enumerate(blobs) if b[0] not in (MAGIC_BZD, MAGIC_BZ)]
        for i, b in enumerate(blobs):
            if b[0] == MAGIC_BZD:
                out[i] = _decompress_bzd(b)
            elif b[0] == MAGIC_BZ:
                out[i] = bz2.decompress(b[1:])
        if rans_ix:
            sub = decompress_delta_batch([blobs[i] for i in rans_ix])
            for j, i in enumerate(rans_ix):
                out[i] = sub[j]
        return out

    B = len(blobs)
    parsed = [_parse_delta(b) for b in blobs]
    magic = parsed[0][0]
    lanes = parsed[0][1]
    if not all(p[0] == magic and p[1] == lanes for p in parsed):
        # Mixed container versions / lane counts in one batch (e.g. a tiny
        # frame got a group-local lane count next to full frames): decode
        # homogeneous sub-batches and reassemble in order.
        out = [None] * B
        groups: dict = {}
        for i, p in enumerate(parsed):
            groups.setdefault((p[0], p[1]), []).append(i)
        for ix in groups.values():
            sub = decompress_delta_batch([blobs[i] for i in ix])
            for j, i in enumerate(ix):
                out[i] = sub[j]
        return out
    T_max, words, counts, states, lives = _assemble_delta_batch(parsed, lanes)
    nat = _native()
    if nat is not None:
        if magic == MAGIC_CTX:
            freqs = np.stack([p[6] for p in parsed])  # (B, C, A)
            sym_all = nat.decode_ctx_batch(
                words, counts, states, freqs, T_max, nat.MODE_ZIGZAG, lives=lives
            )
        else:
            freqs = np.stack([p[6][:1] for p in parsed])  # (B, 1, A)
            sym_all = nat.decode_ctx_batch(
                words, counts, states, freqs, T_max, nat.MODE_ORDER0, lives=lives
            )
        # Fused finalize (escape substitution + unzigzag + prefix sum +
        # dtype cast in C++) — byte-identical to the numpy tail below.
        outs = nat.delta_finalize_frames_3d(
            sym_all.reshape(B, lanes, T_max), ALPHABET,
            [p[2] for p in parsed], [p[3] for p in parsed],
            [p[4] for p in parsed], [p[5] for p in parsed],
            [p[10] for p in parsed],
        )
        if outs is not None:
            return [o.tobytes() for o in outs]
    else:
        import jax.numpy as jnp

        code = _r.RansCode(words, counts, states)
        lives_j = jnp.asarray(lives)
        with _rans_backend():
            if magic == MAGIC_CTX:
                freqs = np.stack([p[6] for p in parsed])  # (B, C, A)
                sym_all = np.asarray(
                    _r.decode_streams_batch_ctx(code, freqs, T_max, lives=lives_j)
                )
            else:
                freqs = np.stack([p[6][0] for p in parsed])  # (B, A)
                sym_all = np.asarray(
                    _r.decode_streams_batch_ctx(
                        code, freqs[:, None, :], T_max,
                        ctx_fn=lambda p_: jnp.zeros_like(p_), lives=lives_j,
                    )
                )

    out: List[bytes] = []
    for i, (_m, _l, T, n, q0, escapes, _f, _s, _c, _p, dt_code) in enumerate(parsed):
        if n == 0:
            out.append(b"")
            continue
        sym2d = sym_all[i].reshape(lanes, T_max)[:, :T].reshape(-1)
        sym = sym2d[:n].astype(np.int64)
        zz = sym.copy()
        n_esc_seen = int((sym == ESCAPE).sum())
        if n_esc_seen != escapes.shape[0]:
            # Same loud failure as the native finalize: a corrupt/truncated
            # container must never return silently-garbage residuals.
            raise ValueError(
                f"corrupt delta container: frame {i} decoded {n_esc_seen} "
                f"ESCAPE symbols for an escape list of {escapes.shape[0]}"
            )
        if escapes.shape[0]:
            zz[sym == ESCAPE] = escapes
        d = _unzigzag(zz)
        d[0] = 0
        q = q0 + np.cumsum(d)
        return_dtype = _CODE_DTYPE[dt_code]
        out.append(q.astype(return_dtype).tobytes())
    return out


def peek_delta_ns(blobs: Sequence[bytes]):
    """Stream lengths from the fixed container header, or None unless every
    frame is a rANS delta container ('D'/'C') — the cheap pre-check the
    fused i8 decode path uses to size its output before parsing.  An empty
    batch returns None (there is nothing to size; both batch decoders would
    otherwise index parsed[0] of an empty list)."""
    if not blobs:
        return None
    ns = []
    for b in blobs:
        if len(b) < 12 or b[0] not in (MAGIC_DELTA, MAGIC_CTX):
            return None
        ns.append(int(struct.unpack_from("<I", b, 4)[0]))
    return ns


def _assemble_delta_batch(parsed, lanes):
    """Scatter per-frame packed word lists into the (B, lanes, T_max) batch
    layout the native/device decoders consume, plus per-lane live symbol
    counts (the encoders lay frames out with their OWN T; mixed-T batches
    decode at T_max).  Shared by :func:`decompress_delta_batch` and
    :func:`decompress_delta_batch_i8` so the two decode paths can never
    disagree on the wire layout."""
    B = len(parsed)
    T_max = max(p[2] for p in parsed)
    words = np.zeros((B, lanes, T_max), np.uint16)
    counts = np.zeros((B, lanes), np.int32)
    states = np.zeros((B, lanes), np.uint32)
    for i, (_m, _l, _T, _n, _q0, _esc, _f, st, cnt, packed, _dt) in enumerate(
        parsed
    ):
        if packed.shape[0]:
            lane_of = np.repeat(np.arange(lanes), cnt)
            starts_i = np.concatenate([[0], np.cumsum(cnt)[:-1]])
            pos = np.arange(packed.shape[0]) - np.repeat(starts_i, cnt)
            words[i, lane_of, pos] = packed
        counts[i] = cnt
        states[i] = st
    lives = np.zeros((B, lanes), np.int32)
    for i, p in enumerate(parsed):
        lives[i] = np.clip(p[3] - np.arange(lanes) * p[2], 0, p[2])
    return T_max, words, counts, states, lives


def decompress_delta_batch_i8(
    blobs: Sequence[bytes],
    out8: np.ndarray,     # (B_out, m) int8, caller-zeroed, B_out >= len(blobs)
    exc_pos: np.ndarray,  # (B_out, cap) int32, caller-prefilled sentinel
    exc_val: np.ndarray,  # (B_out, cap) int16, caller-zeroed
):
    """Decode a batch of i16 delta containers DIRECTLY into the
    i8+exception decode-uplink wire view (q at |q| <= 127, -128 + an
    exception pair otherwise) — skipping the full i16 materialization and
    the three full-array rescan passes BatchEngine._prepare_decode used to
    pay.  Returns (B,) exception counts (entries may exceed
    the cap — the caller falls back to the i16 path then), or None when
    this path cannot apply (non-rANS/mixed containers, non-i16 payload,
    a stream longer than out8's row, or no native library).  Raises the
    same ValueError as :func:`decompress_delta_batch` on corrupt input."""
    nat = _native()
    if nat is None or not hasattr(nat, "delta_finalize_frames_i8"):
        return None
    if not blobs:
        return None
    if any(len(b) < 12 or b[0] not in (MAGIC_DELTA, MAGIC_CTX) for b in blobs):
        return None
    B = len(blobs)
    parsed = [_parse_delta(b) for b in blobs]
    magic = parsed[0][0]
    lanes = parsed[0][1]
    if not all(p[0] == magic and p[1] == lanes for p in parsed):
        return None  # mixed sub-batches: rare, keep the general path
    if any(p[10] != 0 for p in parsed):  # only i16 streams ride this view
        return None
    if any(p[3] > out8.shape[1] for p in parsed):
        return None
    T_max, words, counts, states, lives = _assemble_delta_batch(parsed, lanes)
    if magic == MAGIC_CTX:
        freqs = np.stack([p[6] for p in parsed])  # (B, C, A)
        mode = nat.MODE_ZIGZAG
    else:
        freqs = np.stack([p[6][:1] for p in parsed])  # (B, 1, A)
        mode = nat.MODE_ORDER0
    sym_all = nat.decode_ctx_batch(words, counts, states, freqs, T_max, mode,
                                   lives=lives)
    return nat.delta_finalize_frames_i8(
        sym_all.reshape(B, lanes, T_max), ALPHABET,
        [p[2] for p in parsed], [p[3] for p in parsed],
        [p[4] for p in parsed], [p[5] for p in parsed],
        [out8[i] for i in range(B)],
        [exc_pos[i] for i in range(B)],
        [exc_val[i] for i in range(B)],
        exc_pos.shape[1],
    )
