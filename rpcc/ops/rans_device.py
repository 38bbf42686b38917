"""On-device rANS encode for the two big bitstream fields.

Produces containers byte-identical to the host coders (codec/native/rans.cpp
and the jax spec in ops/rans.py): same histograms-over-padded-stream, same
f32 normalize_freqs semantics, same 16-bit renormalization walking symbols
in reverse — so the existing host/C++ decoders read the output unchanged,
and the engine can skip BOTH the residual-stream download (~3.2 MB/batch ->
~30 KB of compressed words) and the host entropy encode.

Design notes:
- The per-symbol (freq, cum, recip) table lookups are the classic rANS
  gather; here lookups ride TWO batched sorts
  (sort by (ctx, sym) key, expand per-key values at run boundaries by
  telescoping-diff + cumsum, sort back by position) — the same machinery the
  codec uses everywhere else.  The contour field's 8-entry table skips the
  sorts entirely (8 broadcast selects).
- The sequential renorm walks as ONE `lax.scan` over T steps with a
  (B, L) u32 carry (XLA fuses the scan body).
- Exact u32 division by the 14-bit frequency uses a precomputed 2^31
  reciprocal table and a software 32x32->64 mulhi built from 16-bit limbs
  (x64 stays off), with a bounded correction step.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from rpcc.ops.rans import M, PROB_BITS, normalize_freqs

# Plain python ints (weak-typed): module-level jnp scalars would be device
# buffers shared across traces, which tickles executable-arg mismatches on
# multi-device test backends.
RANS_L = 1 << 16
_U16 = 0xFFFF


def _recip_table(max_f: int = 1 << PROB_BITS) -> np.ndarray:
    """floor(2^31 / f) for f in [0, max_f]; entry 0/1 unused (f=1 is
    special-cased: q = x)."""
    f = np.arange(max_f + 1, dtype=np.uint64)
    f[0] = 1
    return (np.uint64(1 << 31) // f).astype(np.uint32)


_RECIP_NP = _recip_table()


def _mulhi_shift31(x: jnp.ndarray, m: jnp.ndarray) -> jnp.ndarray:
    """floor(x * m / 2^31) for u32 x, m (m <= 2^30) without 64-bit ints."""
    xh, xl = x >> 16, x & _U16
    mh, ml = m >> 16, m & _U16
    p0 = xl * ml
    p1 = xl * mh
    p2 = xh * ml
    p3 = xh * mh
    mid1 = p1 + (p0 >> 16)  # <= (2^16-1)^2 + 2^16 < 2^32: no overflow
    mid = mid1 + p2
    carry = (mid < p2).astype(jnp.uint32)  # u32 wraparound detection
    high = p3 + (mid >> 16) + (carry << 16)
    low = (mid << 16) + (p0 & _U16)  # exact low 32 bits (mod 2^32)
    return (high << 1) | (low >> 31)


def exact_div_mod(x: jnp.ndarray, f: jnp.ndarray, recip: jnp.ndarray):
    """(x // f, x % f) exactly, for u32 x and f in [1, 2^14].

    recip = floor(2^31 / f) (precomputed alongside f).  q_est from the
    reciprocal is in [q-2, q]; the residue is < 3*2^14, small enough for an
    exact f32 correction division.
    """
    q_est = _mulhi_shift31(x, recip)
    r = x - q_est * f  # true remainder + k*f for k in {0,1,2}: < 3*2^14
    rf = r.astype(jnp.float32)
    ff = f.astype(jnp.float32)
    e = jnp.floor(rf * (jnp.float32(1.0) / ff)).astype(jnp.uint32)
    r2 = r - e * f
    # one fix each way covers the f32 rounding of the tiny division
    over = r2 >= f
    e = jnp.where(over, e + 1, e)
    r2 = jnp.where(over, r2 - f, r2)
    neg = r2 > jnp.uint32(3 << PROB_BITS)  # u32 underflow marker
    e = jnp.where(neg, e - 1, e)
    r2 = jnp.where(neg, r2 + f, r2)
    q = q_est + e
    one = f == 1
    return jnp.where(one, x, q), jnp.where(one, 0, r2)


def rans_encode_scan(sym_rev, f_rev, c_rev, recip_rev, active_rev):
    """Vectorized interleaved-lane renorm walk.

    All inputs are (T, ...) already in ENCODE order (symbol index T-1 down
    to 0); ``active_rev`` marks live positions (live-aware lanes skip the
    tail padding entirely).  Returns (words (T, ...) u16 in emission order,
    emit (T, ...) bool, states (...) u32).
    """
    x0 = jnp.full(sym_rev.shape[1:], RANS_L, jnp.uint32)

    def step(x, fcra):
        f, c, rcp, active = fcra
        emit = active & ((x >> 18) >= f)
        word = (x & _U16).astype(jnp.uint16)
        x = jnp.where(emit, x >> 16, x)
        q, r = exact_div_mod(x, f, rcp)
        x = jnp.where(active, q * jnp.uint32(M) + c + r, x)
        return x, (word, emit)

    states, (words, emits) = jax.lax.scan(
        step, x0, (f_rev, c_rev, recip_rev, active_rev)
    )
    return words, emits, states


def recip_from_freq(f: jnp.ndarray) -> jnp.ndarray:
    """floor(2^31 / max(f, 1)) for u32 f in [0, 2^14] — bit-identical to the
    _RECIP_NP table, computed arithmetically so the per-position reciprocal
    never rides the big position sort (f fits 15 bits and packs with cum
    into one u32 payload; recip needs 31).  f32 seed division + exact i32
    residue corrections make the result exact regardless of the backend's
    f32 division rounding (pinned exhaustively in tests/test_rans.py).
    """
    f2 = jnp.maximum(f, 2).astype(jnp.uint32)
    ff = f2.astype(jnp.float32)
    e0 = (jnp.float32(2.0**31) / ff).astype(jnp.uint32)  # |err| <= ~128
    r = (jnp.uint32(1 << 31) - e0 * f2).astype(jnp.int32)  # exact mod 2^32
    f2i = f2.astype(jnp.int32)
    d = jnp.floor(r.astype(jnp.float32) / ff).astype(jnp.int32)  # |err| <= 1
    r2 = r - d * f2i
    for _ in range(2):  # two fixes each way: covers >=2-ulp division error
        over = r2 >= f2i
        d = d + over.astype(jnp.int32)
        r2 = r2 - jnp.where(over, f2i, 0)
        neg = r2 < 0
        d = d - neg.astype(jnp.int32)
        r2 = r2 + jnp.where(neg, f2i, 0)
    e = e0 + d.astype(jnp.uint32)
    return jnp.where(f <= 1, jnp.uint32(1 << 31), e)


def _expand_sorted_runs(vals_by_key: jnp.ndarray, bounds: jnp.ndarray, n: int):
    """(K,) per-key values + (K+1,) run boundaries -> (n,) expanded, via the
    codec's telescoping-diff scatter + cumsum (K scatters, no gathers)."""
    v32 = vals_by_key.astype(jnp.int32)
    diffs = jnp.concatenate([v32[:1], v32[1:] - v32[:-1]])
    base = jnp.zeros((n,), jnp.int32).at[bounds[:-1]].add(diffs, mode="drop")
    return jnp.cumsum(base)


def encode_field_device(sym3d: jnp.ndarray, ctx3d: jnp.ndarray, alphabet: int,
                        num_ctx: int, small_tables: bool = False,
                        n_live=None):
    """Single-frame (L, T) symbol/ctx planes -> container pieces.

    With ``n_live`` (scalar) the lanes are live-aware: flat positions >=
    n_live are neither modeled nor coded — matching the host coders.

    Returns (packed_words (L*T,) u16 emission-ordered lane-major,
    n_words () i32, counts (L,) i32, states (L,) u32,
    freqs (num_ctx, alphabet) i32).  vmap over frames.
    """
    L, T = sym3d.shape
    n = L * T
    key = (ctx3d * alphabet + sym3d).reshape(-1)
    if n_live is None:
        live_mask = jnp.ones((n,), bool)
        live_lane = jnp.full((L,), T, jnp.int32)
    else:
        live_mask = jnp.arange(n, dtype=jnp.int32) < n_live
        live_lane = jnp.clip(
            n_live - jnp.arange(L, dtype=jnp.int32) * T, 0, T
        )

    # Histogram over the LIVE stream + bit-exact normalize (the spec
    # semantics shared with ops/rans.py and rans.cpp).  The big-alphabet
    # path shares ONE sorted key array between the histogram and the table
    # lookups (dead positions carry the K bin and sort to the end, so bins
    # [0, K) are unaffected).
    K = num_ctx * alphabet
    key_h = jnp.where(live_mask, key, K)
    if small_tables:
        counts_h = jnp.stack(
            [(key_h == k).sum() for k in range(K)]
        ).astype(jnp.int32)
        bounds = pos_s = None
    else:
        iota = jnp.arange(n, dtype=jnp.int32)
        key_s, pos_s = jax.lax.sort((key_h, iota), num_keys=1, is_stable=True)
        # Histogram by chunked compare-reduce, NOT searchsorted: the queries
        # are arange(K+2), so the bounds are just prefix sums of the key
        # histogram.  searchsorted's binary-search lowering is a 17-round
        # gather while loop and method='sort' costs two more 128k-element
        # sorts plus a rank-extraction fusion; the dense compare-reduce is
        # elementwise work with no gathers.
        # Dead positions carry key K and never match a bin in [0, K).
        counts_h = jnp.concatenate([
            (key_h[:, None] == jnp.arange(c0, c0 + 128, dtype=key_h.dtype))
            .sum(0, dtype=jnp.int32)
            for c0 in range(0, K, 128)
        ]) if K % 128 == 0 else None
        if counts_h is None:  # ragged alphabet: single padded chunk set
            kp = -(-K // 128) * 128
            counts_h = jnp.concatenate([
                (key_h[:, None] == jnp.arange(c0, c0 + 128, dtype=key_h.dtype))
                .sum(0, dtype=jnp.int32)
                for c0 in range(0, kp, 128)
            ])[:K]
        bounds = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts_h)]
        )  # (K+1,): run starts for bins 0..K-1 plus n_live (dead-run start)
    freqs = jax.vmap(normalize_freqs)(counts_h.reshape(num_ctx, alphabet))
    freqs_flat = freqs.reshape(-1)
    cums2 = jnp.concatenate(
        [jnp.zeros((num_ctx, 1), jnp.int32), jnp.cumsum(freqs, -1)[:, :-1]], axis=1
    )
    cums_flat = cums2.reshape(-1)
    recip_np = jnp.asarray(_RECIP_NP)
    recip_flat = recip_np[jnp.clip(freqs_flat, 0, M)]  # (K,) gather: K=2048 max

    if small_tables:
        key2 = key.reshape(L, T)
        f_all = jnp.zeros((L, T), jnp.uint32)
        c_all = jnp.zeros((L, T), jnp.uint32)
        r_all = jnp.zeros((L, T), jnp.uint32)
        for k in range(K):
            m = key2 == k
            f_all = jnp.where(m, freqs_flat[k].astype(jnp.uint32), f_all)
            c_all = jnp.where(m, cums_flat[k].astype(jnp.uint32), c_all)
            r_all = jnp.where(m, recip_flat[k].astype(jnp.uint32), r_all)
    else:
        # expand per-key table values over the shared sorted runs, then
        # sort back by position (dead tail gets the last bin's value —
        # masked out of the scan anyway).  freq (<= 2^14, 15 bits) and cum
        # (< 2^14) pack into ONE i32 payload so the position sort carries 2
        # arrays instead of 4; the 31-bit reciprocal is recomputed from
        # freq after the sort (recip_from_freq, bit-identical to the table).
        fc_flat = freqs_flat * (1 << 15) + cums_flat  # < 2^30: i32-safe
        fc_s = _expand_sorted_runs(fc_flat, bounds[: K + 1], n)
        _, fc_o = jax.lax.sort((pos_s, fc_s), num_keys=1)
        fc_all = fc_o.astype(jnp.uint32).reshape(L, T)
        f_all = fc_all >> 15
        c_all = fc_all & jnp.uint32((1 << 15) - 1)
        r_all = recip_from_freq(f_all)

    # Renorm walk in reverse symbol order (live-aware).
    rev = slice(None, None, -1)
    t_arange = jnp.arange(T, dtype=jnp.int32)
    active_lt = t_arange[None, :] < live_lane[:, None]  # (L, T)
    words_rev, emit_rev, states = rans_encode_scan(
        sym3d.T[rev], f_all.T[rev], c_all.T[rev], r_all.T[rev],
        active_lt.T[rev],
    )  # (T, L) each, emission-ordered along axis 0
    words_lt = words_rev.T  # (L, T) emission order within lane
    emit_lt = emit_rev.T
    counts = emit_lt.sum(axis=1).astype(jnp.int32)

    # Compact: emitted words first, ordered (lane, emission index) — one
    # packed-key sort.  19 useful key bits < 2^30.
    t_idx = jnp.arange(T, dtype=jnp.int32)[None, :]
    lane = jnp.arange(L, dtype=jnp.int32)[:, None]
    big = jnp.int32(L * T)
    k_pack = jnp.where(emit_lt, lane * T + t_idx, big).reshape(-1)
    _, packed = jax.lax.sort(
        (k_pack, words_lt.reshape(-1)), num_keys=1, is_stable=True
    )
    n_words = counts.sum()
    return packed, n_words, counts, states, freqs


# ----------------------------------------------------- field-level encoders
RESID_LANES = 32  # matches codec/rans_codec.py MAX_LANES — container field
ESC_CAP_DEV = 512  # per-frame escape capacity; overflow -> host fallback
ALPHABET = 512
ESCAPE = ALPHABET - 1
NUM_CTX = 4
_T_BUCKET = 16  # = codec/rans_codec.py T_BUCKET (container steps-per-lane)


def resid_T(hw: int) -> int:
    """Steps per lane of the device residual container for an HW-pixel grid
    — the single source the engine's container assembly must agree with."""
    t = -(-hw // RESID_LANES)
    return -(-t // _T_BUCKET) * _T_BUCKET


def contour_T(H: int, W: int) -> int:
    """Steps per lane of the wavefront contour container (geometry-fixed,
    matches rans_codec._compress_bits_batch)."""
    return -(-(W + H - 1) // _T_BUCKET) * _T_BUCKET


def _zigzag_ctx(sym3d: jnp.ndarray) -> jnp.ndarray:
    """In-graph twin of rans_codec._zigzag_ctx_np over (L, T)."""
    prev = jnp.concatenate(
        [jnp.zeros((sym3d.shape[0], 1), sym3d.dtype), sym3d[:, :-1]], axis=1
    )
    mag = (prev + 1) // 2
    return ((mag >= 1).astype(jnp.int32) + (mag >= 3) + (mag >= 8))


def encode_residual_field_device(q: jnp.ndarray, stream_len: jnp.ndarray):
    """(HW,) i32 quantized residual stream (zeroed past stream_len) ->
    the 'C' container pieces, matching the host coders symbol-for-symbol.

    Returns (packed (L*T,) u16, n_words, counts (L,), states (L,),
    freqs (C, A) i32, escapes (ESC_CAP_DEV,) u32 in stream order,
    n_esc () i32 — caller must fall back to host coding past ESC_CAP_DEV,
    q0 () i32).
    """
    hw = q.shape[0]
    L = RESID_LANES
    T = resid_T(hw)
    iota = jnp.arange(hw, dtype=jnp.int32)
    live = iota < stream_len
    prev = jnp.concatenate([jnp.zeros((1,), q.dtype), q[:-1]])
    d = jnp.where(live & (iota > 0), q - prev, 0)
    zz = jnp.where(d >= 0, 2 * d, -2 * d - 1)
    is_esc = zz >= ESCAPE
    n_esc = is_esc.sum().astype(jnp.int32)
    # order-preserving escape compaction: top_k of (hw - pos) over escapes
    # yields positions ascending; gather the few values.
    rank = jnp.where(is_esc, hw - iota, 0)
    _, esc_pos = jax.lax.top_k(rank, ESC_CAP_DEV)
    escapes = zz[esc_pos].astype(jnp.uint32)
    sym = jnp.where(is_esc, ESCAPE, zz).astype(jnp.int32)
    pad = L * T - hw
    sym3d = jnp.concatenate([sym, jnp.zeros((pad,), jnp.int32)]).reshape(L, T)
    ctx3d = _zigzag_ctx(sym3d)
    packed, n_words, counts, states, freqs = encode_field_device(
        sym3d, ctx3d, ALPHABET, NUM_CTX, n_live=stream_len
    )
    return packed, n_words, counts, states, freqs, escapes, n_esc, q[0]


def _wavefront_shear(bits: jnp.ndarray, T: int) -> jnp.ndarray:
    """(H, W) -> (H, T) with row r shifted right by r (pure pad/reshape)."""
    H, W = bits.shape
    padded = jnp.concatenate([bits, jnp.zeros((H, H), bits.dtype)], axis=1)
    sheared = padded.reshape(-1)[: H * (W + H - 1)].reshape(H, W + H - 1)
    if T > W + H - 1:
        sheared = jnp.concatenate(
            [sheared, jnp.zeros((H, T - (W + H - 1)), bits.dtype)], axis=1
        )
    return sheared


def encode_contour_field_device(contour: jnp.ndarray):
    """(H, W) {0,1} contour plane -> 'N' container pieces (diagonal
    wavefront, 4-context binary model) — byte-identical to the host path
    (geometry-determined T, so no padding drift)."""
    H, W = contour.shape
    T = contour_T(H, W)
    sym3d = _wavefront_shear(contour.astype(jnp.int32), T)
    left = jnp.concatenate([jnp.zeros((H, 1), jnp.int32), sym3d[:, :-1]], axis=1)
    above = jnp.zeros_like(sym3d)
    above = above.at[1:, 1:].set(sym3d[:-1, :-1])
    ctx3d = 2 * above + left
    ctx3d = ctx3d.at[:, 0].set(0)
    return encode_field_device(sym3d, ctx3d, 2, 4, small_tables=True)
