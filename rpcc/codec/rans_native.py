"""Native (C++) backend for the interleaved-lane rANS kernels.

Bit-exact to the jax kernels in :mod:`rpcc.ops.rans` — same PROB_BITS,
renormalization, freq normalization and container-visible outputs — but the
sequential per-lane loops run as tight C++ (codec/native/rans.cpp) instead
of a lax.scan on the CPU backend, an order of magnitude faster; multi-core
hosts get OpenMP over frames.  Table preparation (histograms, normalization, slot
tables) stays in vectorized numpy.

Decode ctx modes: 0 = zigzag-magnitude buckets (residual streams),
1 = wavefront bits (contour planes), 2 = always-0 (order-0 containers).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

PROB_BITS = 14
M = 1 << PROB_BITS

MODE_ZIGZAG = 0
MODE_WAVEFRONT = 1
MODE_ORDER0 = 2

_sigs_registered = False


def _lib():
    global _sigs_registered
    from rpcc.codec.lz4block import native_lib

    lib = native_lib()
    if lib is None or not hasattr(lib, "rans_encode_ctx_batch"):
        return None
    if not _sigs_registered:
        import ctypes as ct

        lib.rans_encode_ctx_batch.restype = None
        lib.rans_encode_ctx_batch.argtypes = [ct.c_void_p] * 5 + [ct.c_int] * 5 + [ct.c_void_p] * 3
        lib.rans_decode_ctx_batch.restype = None
        lib.rans_decode_ctx_batch.argtypes = [ct.c_void_p] * 7 + [ct.c_int] * 6 + [ct.c_void_p]
        if hasattr(lib, "rans_delta_encode_frames"):
            lib.rans_delta_encode_frames.restype = None
            lib.rans_delta_encode_frames.argtypes = (
                [ct.c_void_p] * 3 + [ct.c_int] * 6 + [ct.c_void_p] * 8
            )
            lib.rans_contour_encode_frames.restype = None
            lib.rans_contour_encode_frames.argtypes = (
                [ct.c_void_p, ct.c_int, ct.c_int64] + [ct.c_int] * 3 + [ct.c_void_p] * 5
            )
        if hasattr(lib, "rans_delta_finalize_frames"):
            # returns the count of frames whose ESCAPE occurrences mismatch
            # their escape list (corrupt container) — wrapper raises on it
            lib.rans_delta_finalize_frames.restype = ct.c_int
            lib.rans_delta_finalize_frames.argtypes = (
                [ct.c_void_p] + [ct.c_int] * 4 + [ct.c_void_p] * 7
            )
            lib.rans_contour_finalize_frames.restype = None
            lib.rans_contour_finalize_frames.argtypes = (
                [ct.c_void_p] + [ct.c_int] * 4 + [ct.c_void_p]
            )
        if hasattr(lib, "rans_delta_finalize_frames_i8"):
            lib.rans_delta_finalize_frames_i8.restype = ct.c_int
            lib.rans_delta_finalize_frames_i8.argtypes = (
                [ct.c_void_p] + [ct.c_int] * 4 + [ct.c_void_p] * 8
                + [ct.c_int, ct.c_void_p]
            )
        _sigs_registered = True
    return lib


def available() -> bool:
    return _lib() is not None


def normalize_freqs(counts: np.ndarray) -> np.ndarray:
    """Vectorized bit-exact port of ops/rans.py::normalize_freqs over the
    last axis (f32 arithmetic order preserved), including its repair pass
    for pathological near-uniform histograms whose top symbol cannot absorb
    the negative correction."""
    counts = counts.astype(np.int32)
    present = counts > 0
    total = np.maximum(counts.sum(-1, keepdims=True), 1)
    f = np.floor(
        counts.astype(np.float32) * (np.float32(M) / total.astype(np.float32))
    ).astype(np.int32)
    f = np.where(present & (f == 0), 1, f)
    delta = (M - f.sum(-1, keepdims=True)).astype(np.int32)
    top = np.argmax(f, -1)[..., None]
    ok = np.take_along_axis(f, top, -1) + delta >= 1
    np.put_along_axis(f, top, np.take_along_axis(f, top, -1) + delta, -1)
    if not ok.all():
        a_pos = present.sum(-1, keepdims=True).astype(np.int32)
        scale2 = (M - a_pos).astype(np.float32) / total.astype(np.float32)
        f2 = np.floor(counts.astype(np.float32) * scale2).astype(np.int32)
        f2 = f2 + present.astype(np.int32)
        delta2 = (M - f2.sum(-1, keepdims=True)).astype(np.int32)
        top2 = np.argmax(f2, -1)[..., None]
        np.put_along_axis(f2, top2, np.take_along_axis(f2, top2, -1) + delta2, -1)
        f = np.where(ok, f, f2)
    return f


def _cums(freqs: np.ndarray) -> np.ndarray:
    c = np.zeros_like(freqs, np.uint32)
    c[..., 1:] = np.cumsum(freqs, -1)[..., :-1]
    return c


def _slot2sym(freqs: np.ndarray) -> np.ndarray:
    """(..., A) freqs -> (..., M) uint16 slot table."""
    lead = freqs.shape[:-1]
    A = freqs.shape[-1]
    flat = freqs.reshape(-1, A)
    out = np.empty((flat.shape[0], M), np.uint16)
    ids = np.arange(A)
    for i in range(flat.shape[0]):
        out[i] = np.repeat(ids, flat[i]).astype(np.uint16)
    return out.reshape(*lead, M)


def hist_joint(sym: np.ndarray, ctx: np.ndarray, alphabet: int, num_ctx: int,
               ns: np.ndarray | None = None) -> np.ndarray:
    """(B, ...) symbols+contexts -> (B, C, A) counts (over the live prefix
    only when ``ns`` is given)."""
    B = sym.shape[0]
    out = np.empty((B, num_ctx, alphabet), np.int64)
    for i in range(B):
        joint = ctx[i].reshape(-1) * alphabet + sym[i].reshape(-1)
        if ns is not None:
            joint = joint[: int(ns[i])]
        out[i] = np.bincount(joint, minlength=num_ctx * alphabet).reshape(num_ctx, alphabet)
    return out


def encode_ctx_batch(
    sym3d: np.ndarray, ctx3d: np.ndarray, alphabet: int, num_ctx: int,
    ns: np.ndarray | None = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """-> (words (B,L,T) u16, counts (B,L) i32, states (B,L) u32,
    freqs (B,C,A) i32), matching the jax kernels bit-for-bit.

    With ``ns`` (B,) the lanes are live-aware (positions >= ns[b] are not
    modeled or coded)."""
    lib = _lib()
    B, L, T = sym3d.shape
    counts_h = hist_joint(sym3d, ctx3d, alphabet, num_ctx, ns=ns)
    freqs = normalize_freqs(counts_h)
    cums = _cums(freqs)
    sym_c = np.ascontiguousarray(sym3d, np.int32)
    ctx_c = np.ascontiguousarray(ctx3d, np.int32)
    freqs_c = np.ascontiguousarray(freqs, np.uint16)
    cums_c = np.ascontiguousarray(cums, np.uint32)
    words = np.zeros((B, L, T), np.uint16)
    counts = np.zeros((B, L), np.int32)
    states = np.zeros((B, L), np.uint32)
    lens_c = None if ns is None else np.ascontiguousarray(ns, np.int64)
    lib.rans_encode_ctx_batch(
        sym_c.ctypes.data, ctx_c.ctypes.data, freqs_c.ctypes.data, cums_c.ctypes.data,
        None if lens_c is None else lens_c.ctypes.data,
        B, L, T, num_ctx, alphabet,
        words.ctypes.data, counts.ctypes.data, states.ctypes.data,
    )
    return words, counts, states, freqs


def fused_available() -> bool:
    lib = _lib()
    return lib is not None and hasattr(lib, "rans_delta_encode_frames")


def delta_encode_frames(arrays, L: int, T: int, alphabet: int, num_ctx: int,
                        esc_cap: int = 8192):
    """Fully-fused residual encode: raw integer arrays -> container pieces.

    -> (packed (B, L*T) u16, n_words (B,), counts (B, L), states (B, L) u32,
    freqs (B, C, A) i32, escapes (B, esc_cap) u32, esc_counts (B,), q0s (B,)).
    esc_counts[i] == -1 flags escape overflow: caller must re-encode frame i
    via the numpy path.  Bit-identical containers otherwise.
    """
    import ctypes as ct

    lib = _lib()
    B = len(arrays)
    dt_map = {np.dtype(np.int16): 0, np.dtype(np.uint16): 1, np.dtype(np.int32): 2}
    arrays = [np.ascontiguousarray(a) for a in arrays]
    q_ptrs = np.asarray([a.ctypes.data for a in arrays], np.uint64)
    dtypes = np.asarray([dt_map[a.dtype] for a in arrays], np.uint8)
    lens = np.asarray([a.size for a in arrays], np.int64)
    if lens.size and int(lens.max()) > L * T:
        # The C kernel writes sym[j]/ctx[j] for every j < lens[b] into
        # L*T-element buffers with no bound check of its own — a
        # mismatched T from a future call site would corrupt the heap.
        raise ValueError(
            f"delta_encode_frames: max frame size {int(lens.max())} "
            f"exceeds lanes*T = {L}*{T}"
        )
    packed = np.zeros((B, L * T), np.uint16)
    n_words = np.zeros(B, np.int32)
    counts = np.zeros((B, L), np.int32)
    states = np.zeros((B, L), np.uint32)
    freqs = np.zeros((B, num_ctx, alphabet), np.int32)
    escapes = np.zeros((B, esc_cap), np.uint32)
    esc_counts = np.zeros(B, np.int32)
    q0s = np.zeros(B, np.int64)
    lib.rans_delta_encode_frames(
        q_ptrs.ctypes.data, dtypes.ctypes.data, lens.ctypes.data,
        B, L, T, num_ctx, alphabet, esc_cap,
        packed.ctypes.data, n_words.ctypes.data, counts.ctypes.data,
        states.ctypes.data, freqs.ctypes.data, escapes.ctypes.data,
        esc_counts.ctypes.data, q0s.ctypes.data,
    )
    return packed, n_words, counts, states, freqs, escapes, esc_counts, q0s


def contour_encode_frames(packed_bits: np.ndarray, H: int, W: int, T: int):
    """Fully-fused contour encode: (B, nbytes) packbits rows -> container
    pieces (packed (B, H*T) u16, n_words (B,), counts (B, H),
    states (B, H) u32, freqs (B, 4, 2) i32)."""
    lib = _lib()
    packed_bits = np.ascontiguousarray(packed_bits, np.uint8)
    B, nbytes = packed_bits.shape
    packed = np.zeros((B, H * T), np.uint16)
    n_words = np.zeros(B, np.int32)
    counts = np.zeros((B, H), np.int32)
    states = np.zeros((B, H), np.uint32)
    freqs = np.zeros((B, 4, 2), np.int32)
    lib.rans_contour_encode_frames(
        packed_bits.ctypes.data, B, nbytes, H, W, T,
        packed.ctypes.data, n_words.ctypes.data, counts.ctypes.data,
        states.ctypes.data, freqs.ctypes.data,
    )
    return packed, n_words, counts, states, freqs


def decode_ctx_batch(
    words: np.ndarray,
    counts: np.ndarray,
    states: np.ndarray,
    freqs: np.ndarray,  # (B, C, A)
    T: int,
    mode: int,
    lives: np.ndarray | None = None,  # (B, L) live symbols per lane
) -> np.ndarray:
    """-> (B, L*T) int32 symbols (live-aware when ``lives`` given; per-lane
    counts support mixed-T batches decoded at a common T_max)."""
    lib = _lib()
    B, C, A = freqs.shape
    L = counts.shape[1]
    cums = _cums(freqs)
    s2s = _slot2sym(freqs)
    words_c = np.ascontiguousarray(words, np.uint16)
    counts_c = np.ascontiguousarray(counts, np.int32)
    states_c = np.ascontiguousarray(states, np.uint32)
    freqs_c = np.ascontiguousarray(freqs, np.uint16)
    cums_c = np.ascontiguousarray(cums, np.uint32)
    s2s_c = np.ascontiguousarray(s2s, np.uint16)
    sym = np.zeros((B, L, T), np.int32)
    lives_c = None if lives is None else np.ascontiguousarray(lives, np.int32)
    lib.rans_decode_ctx_batch(
        words_c.ctypes.data, counts_c.ctypes.data, states_c.ctypes.data,
        freqs_c.ctypes.data, cums_c.ctypes.data, s2s_c.ctypes.data,
        None if lives_c is None else lives_c.ctypes.data,
        B, L, T, C, A, mode,
        sym.ctypes.data,
    )
    return sym.reshape(B, L * T)


def delta_finalize_frames_3d(sym3d, A, Ts, ns, q0s, escapes, dtypes):
    """Fused decode tail: escape substitution + unzigzag + prefix sum +
    dtype cast per frame.  ``sym3d`` is decode_ctx_batch's output reshaped
    (B, L, Tmax); ``escapes`` a list of (n_i,) u32 arrays.  -> list of
    (n_i,) arrays of each frame's dtype, or None when the native symbol is
    missing."""
    import ctypes as ct

    lib = _lib()
    if lib is None or not hasattr(lib, "rans_delta_finalize_frames"):
        return None
    B, L, Tmax = sym3d.shape
    sym_c = np.ascontiguousarray(sym3d, np.int32)
    Ts_c = np.ascontiguousarray(Ts, np.int32)
    ns_c = np.ascontiguousarray(ns, np.int64)
    q0s_c = np.ascontiguousarray(q0s, np.int64)
    esc_arrs = [np.ascontiguousarray(e, "<u4") for e in escapes]
    esc_ptrs = np.asarray([e.ctypes.data for e in esc_arrs], np.uint64)
    esc_counts = np.asarray([e.shape[0] for e in esc_arrs], np.int32)
    dt_codes = np.ascontiguousarray(dtypes, np.uint8)
    outs = [
        np.empty(int(n), _FINALIZE_DTYPES[int(dc)])
        for n, dc in zip(ns_c, dt_codes)
    ]
    out_ptrs = np.asarray([o.ctypes.data for o in outs], np.uint64)
    bad = lib.rans_delta_finalize_frames(
        sym_c.ctypes.data, B, L, Tmax, A,
        Ts_c.ctypes.data, ns_c.ctypes.data, q0s_c.ctypes.data,
        esc_ptrs.ctypes.data, esc_counts.ctypes.data,
        dt_codes.ctypes.data, out_ptrs.ctypes.data,
    )
    if bad:
        # The numpy tail raises the same way (zz[sym == ESCAPE] = escapes is
        # a shape-checked assignment): never hand back garbage residuals.
        raise ValueError(
            f"corrupt delta container: {bad} frame(s) decoded an ESCAPE "
            "count different from their escape list"
        )
    return outs


_FINALIZE_DTYPES = {0: np.int16, 1: np.uint16, 2: np.int32}


def delta_finalize_frames_i8(
    sym3d, A, Ts, ns, q0s, escapes,
    out8_rows, excpos_rows, excval_rows, exc_cap: int,
):
    """Fused decode tail straight into the i8+exception decode-uplink view
    (i16 streams only): per-frame int8 rows get q (or -128 at |q| > 127),
    exception (pos, val) pairs land in the caller's prefilled arrays.
    Returns (B,) exception counts (may exceed ``exc_cap`` — the caller
    falls back to the full-i16 path then), or None when the native symbol
    is missing.  Raises on corrupt escape lists exactly like
    :func:`delta_finalize_frames_3d`."""
    lib = _lib()
    if lib is None or not hasattr(lib, "rans_delta_finalize_frames_i8"):
        return None
    B, L, Tmax = sym3d.shape
    sym_c = np.ascontiguousarray(sym3d, np.int32)
    Ts_c = np.ascontiguousarray(Ts, np.int32)
    ns_c = np.ascontiguousarray(ns, np.int64)
    q0s_c = np.ascontiguousarray(q0s, np.int64)
    esc_arrs = [np.ascontiguousarray(e, "<u4") for e in escapes]
    esc_ptrs = np.asarray([e.ctypes.data for e in esc_arrs], np.uint64)
    esc_counts = np.asarray([e.shape[0] for e in esc_arrs], np.int32)
    assert all(
        o.dtype == np.int8 and o.flags.c_contiguous and o.shape[0] >= int(n)
        for o, n in zip(out8_rows, ns_c)
    )
    out_ptrs = np.asarray([o.ctypes.data for o in out8_rows], np.uint64)
    xp_ptrs = np.asarray([p.ctypes.data for p in excpos_rows], np.uint64)
    xv_ptrs = np.asarray([v.ctypes.data for v in excval_rows], np.uint64)
    n_exc = np.zeros(B, np.int32)
    bad = lib.rans_delta_finalize_frames_i8(
        sym_c.ctypes.data, B, L, Tmax, A,
        Ts_c.ctypes.data, ns_c.ctypes.data, q0s_c.ctypes.data,
        esc_ptrs.ctypes.data, esc_counts.ctypes.data,
        out_ptrs.ctypes.data, xp_ptrs.ctypes.data, xv_ptrs.ctypes.data,
        int(exc_cap), n_exc.ctypes.data,
    )
    if bad:
        raise ValueError(
            f"corrupt delta container: {bad} frame(s) decoded an ESCAPE "
            "count different from their escape list"
        )
    return n_exc


def contour_finalize_frames(sym3d, H, W, T):
    """Fused contour decode tail: de-skew + packbits -> (B, H*W/8) u8,
    or None when the native symbol is missing."""
    lib = _lib()
    if lib is None or not hasattr(lib, "rans_contour_finalize_frames"):
        return None
    B = sym3d.shape[0]
    sym_c = np.ascontiguousarray(sym3d, np.int32)
    out = np.empty((B, (H * W + 7) // 8), np.uint8)
    lib.rans_contour_finalize_frames(
        sym_c.ctypes.data, B, H, W, T, out.ctypes.data
    )
    return out
