"""rANS kernel tests: exact roundtrip, compression ratio sanity, edge cases."""

import numpy as np
import jax.numpy as jnp

from rpcc.ops.rans import (
    RansCode,
    cumulative,
    decode_stream,
    encode_stream,
    normalize_freqs,
    pack_symbols,
    rans_decode,
    rans_encode,
    slot_to_symbol,
    M,
)


def roundtrip(flat, alphabet, lanes=16):
    flat = jnp.asarray(flat, jnp.int32)
    code, freqs = encode_stream(flat, alphabet, lanes)
    n = flat.shape[0]
    T = max(1, -(-n // lanes))
    dec = decode_stream(code, freqs, T)
    return np.asarray(dec)[:n], code, freqs


def test_normalize_freqs_sums_to_M():
    rng = np.random.default_rng(0)
    for _ in range(5):
        counts = rng.integers(0, 1000, 300)
        f = np.asarray(normalize_freqs(jnp.asarray(counts)))
        assert f.sum() == M
        assert (f[counts > 0] >= 1).all()
        assert (f[counts == 0] == 0).all()


def test_rans_roundtrip_skewed():
    rng = np.random.default_rng(1)
    # Laplacian-ish quantized residuals mapped to symbols
    q = np.rint(rng.laplace(0, 6, 20000)).astype(np.int64)
    sym = np.clip(q + 128, 0, 255)
    dec, code, freqs = roundtrip(sym, 256, lanes=32)
    np.testing.assert_array_equal(dec, sym)

    # coded size should beat raw 8 bits/symbol substantially
    n_words = int(np.asarray(code.counts).sum())
    coded_bits = n_words * 16 + 32 * 32  # words + states
    raw_bits = sym.shape[0] * 8
    assert coded_bits < 0.75 * raw_bits

    # and be close to the empirical entropy
    p = np.bincount(sym, minlength=256) / sym.shape[0]
    ent = -(p[p > 0] * np.log2(p[p > 0])).sum() * sym.shape[0]
    assert coded_bits < 1.1 * ent + 32 * 64


def test_rans_roundtrip_uniformish():
    rng = np.random.default_rng(2)
    sym = rng.integers(0, 200, 5000)
    dec, _, _ = roundtrip(sym, 256, lanes=8)
    np.testing.assert_array_equal(dec, sym)


def test_rans_all_same_symbol():
    sym = np.full(1000, 7)
    dec, code, _ = roundtrip(sym, 16, lanes=4)
    np.testing.assert_array_equal(dec, sym)
    # certain event costs ~nothing
    assert int(np.asarray(code.counts).sum()) == 0


def test_rans_binary_alphabet():
    rng = np.random.default_rng(3)
    sym = (rng.random(30000) < 0.06).astype(np.int64)  # contour-like bits
    dec, code, _ = roundtrip(sym, 2, lanes=32)
    np.testing.assert_array_equal(dec, sym)
    n_words = int(np.asarray(code.counts).sum())
    # H(0.06) ~ 0.327 bits/symbol; raw packbits is 1 bit/symbol
    assert n_words * 16 < 0.45 * sym.shape[0]


def test_rans_tiny_and_empty():
    dec, _, _ = roundtrip(np.array([3]), 8, lanes=4)
    np.testing.assert_array_equal(dec, [3])
    dec, _, _ = roundtrip(np.array([], dtype=np.int64), 8, lanes=4)
    assert dec.shape[0] == 0


def test_empty_batch_decoders():
    """Empty blob batches return empty/None instead of indexing parsed[0]
    (an engine decode_blobs([]) used to reach an IndexError through
    peek_delta_ns([]) -> [] passing the 'is not None' gate)."""
    from rpcc.codec import rans_codec as rc

    assert rc.peek_delta_ns([]) is None
    assert rc.decompress_delta_batch([]) == []
    out8 = np.zeros((1, 8), np.int8)
    exc_pos = np.full((1, 4), 8, np.int32)
    exc_val = np.zeros((1, 4), np.int16)
    assert rc.decompress_delta_batch_i8([], out8, exc_pos, exc_val) is None


def test_native_and_jax_kernels_bit_identical():
    """The C++ rANS kernels must produce byte-identical containers to the
    jax kernels, and each must decode the other's output."""
    import numpy as np

    from rpcc.codec import rans_codec, rans_native
    from rpcc.ops import rans as _r

    if not rans_native.available():
        import pytest

        pytest.skip("native library unavailable")

    rng = np.random.default_rng(7)
    sym3d = rng.integers(0, 120, (3, 8, 256)).astype(np.int32)
    ctx3d = rans_codec._zigzag_ctx_np(sym3d)

    w_n, c_n, s_n, f_n = rans_native.encode_ctx_batch(sym3d, ctx3d, 512, _r.NUM_CTX)
    import jax.numpy as jnp

    code, freqs_j = _r.encode_streams_batch_ctx(jnp.asarray(sym3d), 512)
    assert np.array_equal(f_n, np.asarray(freqs_j))
    assert np.array_equal(c_n, np.asarray(code.counts))
    assert np.array_equal(s_n, np.asarray(code.states))
    # words agree on the valid (front-packed) prefixes
    w_j = np.asarray(code.words)
    for b in range(3):
        for l in range(8):
            n = c_n[b, l]
            assert np.array_equal(w_n[b, l, :n], w_j[b, l, :n])

    # cross-decode: native decodes the jax code and vice versa
    sym_nat = rans_native.decode_ctx_batch(
        w_j, np.asarray(code.counts), np.asarray(code.states),
        np.asarray(freqs_j), 256, rans_native.MODE_ZIGZAG,
    )
    assert np.array_equal(sym_nat.reshape(3, 8, 256), sym3d)
    code_n = _r.RansCode(jnp.asarray(w_n), jnp.asarray(c_n), jnp.asarray(s_n))
    sym_jax = np.asarray(_r.decode_streams_batch_ctx(code_n, jnp.asarray(f_n), 256))
    assert np.array_equal(sym_jax.reshape(3, 8, 256), sym3d)


def test_contour_container_backends_agree():
    import numpy as np

    from rpcc.codec import rans_codec, rans_native

    if not rans_native.available():
        import pytest

        pytest.skip("native library unavailable")
    rng = np.random.default_rng(11)
    packed = [
        np.packbits(((rng.random((16, 256)) < 0.3)).astype(np.uint8).reshape(-1))
        for _ in range(4)
    ]
    blobs_native = rans_codec._compress_bits_batch(packed, 16, 256)
    orig_device = rans_codec._RANS_DEVICE
    try:
        rans_codec._RANS_DEVICE = "jax-test"  # disable native
        blobs_jax = rans_codec._compress_bits_batch(packed, 16, 256)
        assert blobs_native == blobs_jax
        recs = rans_codec.decompress_contour_batch(blobs_native)
    finally:
        rans_codec._RANS_DEVICE = orig_device  # not a literal: env-var-derived
    recs2 = rans_codec.decompress_contour_batch(blobs_jax)
    assert recs == recs2 == [p.tobytes() for p in packed]


def test_fused_native_delta_containers_byte_identical_and_fallback():
    """The fully-fused C++ delta encode (rans_delta_encode_frames) must emit
    byte-identical containers to the numpy+kernel path for every dtype, and
    fall back losslessly on escape-capacity overflow."""
    from rpcc.codec import rans_codec as rc
    from rpcc.codec import rans_native as rn
    import pytest

    if not rn.fused_available():
        pytest.skip("native fused kernels unavailable")

    rng = np.random.default_rng(9)
    arrays = []
    for i in range(4):
        n = 40000 + 1000 * i
        a = np.cumsum(rng.integers(-4, 5, n)).astype(np.int16)
        a[rng.integers(0, n, 20)] = rng.integers(-2000, 2000, 20).astype(np.int16)
        arrays.append(a)
    arrays.append(rng.integers(0, 150, 50000).astype(np.uint16))
    arrays.append(rng.integers(-80, 80, 70000).astype(np.int32))

    fused = rc.compress_delta_batch(arrays)
    plain = rc._compress_delta_batch_np(arrays)
    for i, (f, p) in enumerate(zip(fused, plain)):
        if arrays[i].size > rc.BZD_TRY_MAX_SYMBOLS:
            assert f == p, f"frame {i} container differs"
        assert rc.decompress_delta_batch([f])[0] == arrays[i].tobytes()

    # escape overflow: > esc_cap large deltas -> numpy fallback, still exact
    wild = rng.integers(-30000, 30000, 60000).astype(np.int16)
    blob = rc.compress_delta_batch([wild])[0]
    assert rc.decompress_delta_batch([blob])[0] == wild.tobytes()


def test_fused_native_contour_containers_byte_identical():
    from rpcc.codec import rans_codec as rc
    from rpcc.codec import rans_native as rn
    import pytest

    if not rn.fused_available():
        pytest.skip("native fused kernels unavailable")

    rng = np.random.default_rng(11)
    H, W = 32, 500
    bits = (rng.random((5, H * W)) < 0.15).astype(np.uint8)
    pk = np.packbits(bits, axis=1)
    fused = rc._compress_bits_batch([pk[i] for i in range(5)], H, W)
    orig = rn.fused_available
    rn.fused_available = lambda: False
    try:
        plain = rc._compress_bits_batch([pk[i] for i in range(5)], H, W)
    finally:
        rn.fused_available = orig
    for i, (f, p) in enumerate(zip(fused, plain)):
        assert f == p, f"contour {i} differs"
        assert rc.decompress_contour_batch([f])[0] == pk[i].tobytes()


def test_mixed_lane_batch_decodes():
    """A tiny frame next to a full frame gets a group-local lane count; the
    batch decoder must handle the mixed-lane batch (sub-batch regrouping)."""
    from rpcc.codec import rans_codec as rc

    rng = np.random.default_rng(3)
    tiny = np.asarray([123, 124, 120], np.int16)
    big = np.cumsum(rng.integers(-3, 4, 40000)).astype(np.int16)
    blobs = rc.compress_delta_batch([tiny, big, tiny])
    out = rc.decompress_delta_batch(blobs)
    assert out[0] == tiny.tobytes()
    assert out[1] == big.tobytes()
    assert out[2] == tiny.tobytes()


def test_corrupt_escape_list_raises():
    """A container whose decoded ESCAPE occurrences mismatch its escape
    list (corrupt/truncated input) must raise, not return garbage — on BOTH
    the fused native finalize and the numpy tail."""
    import struct

    import pytest

    from rpcc.codec import rans_codec as rc

    rng = np.random.default_rng(5)
    # mostly-small deltas with a sprinkle of table-range overshoots: real
    # ESCAPE symbols but well under the native 8192 escape capacity; > 32768
    # symbols keeps it out of the bzd adaptive pick ('C' container for sure)
    d = rng.integers(-40, 40, 40000)
    d[rng.random(40000) < 0.01] = 5000
    data = np.cumsum(d).astype(np.int32)
    blob = rc.compress_delta_batch([data])[0]
    assert blob[0] == rc.MAGIC_CTX
    n_esc = struct.unpack_from("<I", blob, 12)[0]
    assert n_esc > 0, "fixture must exercise escapes"
    # drop the last escape value and decrement the count: the stream still
    # decodes n_esc ESCAPE symbols but the list only carries n_esc - 1
    buf = bytearray(blob)
    struct.pack_into("<I", buf, 12, n_esc - 1)
    corrupt = bytes(buf[: 16 + 4 * (n_esc - 1)]) + bytes(buf[16 + 4 * n_esc :])
    with pytest.raises(ValueError, match="(?i)escape"):
        rc.decompress_delta_batch([corrupt])
    # the untampered container still roundtrips
    assert rc.decompress_delta_batch([blob])[0] == data.tobytes()


def test_normalize_freqs_pathological_repair():
    """A near-uniform histogram over a large alphabet can overdraw the
    bump-to-1 budget so far that the top symbol cannot absorb the negative
    correction (255 symbols x 513 + 257 singletons -> f[top] would go to
    -129).  The repair pass must produce a valid table (present >= 1, sum
    == M) identically in the numpy and jax implementations."""
    from rpcc.codec import rans_native as rn
    from rpcc.ops import rans as _rj

    counts = np.zeros(512, np.int64)
    counts[:255] = 513
    counts[255:] = 1
    f_np = rn.normalize_freqs(counts[None].astype(np.int64))[0]
    f_jax = np.asarray(_rj.normalize_freqs(jnp.asarray(counts, jnp.int32)))
    assert int(f_np.sum()) == rn.M
    assert int(f_jax.sum()) == rn.M
    assert (f_np[counts > 0] >= 1).all()
    assert (f_np[counts == 0] == 0).all()
    assert np.array_equal(f_np, f_jax)
    # an ordinary skewed histogram still takes the original branch
    skew = np.zeros(512, np.int64)
    skew[:8] = [90000, 4000, 900, 200, 50, 20, 5, 1]
    f_s = rn.normalize_freqs(skew[None])[0]
    assert int(f_s.sum()) == rn.M and f_s[0] > 10000


def test_int32_wide_escape_routes_to_lossless_bz2():
    """int32 streams whose first-differences overflow int32 cannot ride the
    delta containers (escape values are u32 on the wire) — they must route
    to a plain-bz2 container and roundtrip losslessly instead of silently
    truncating."""
    from rpcc.codec import rans_codec as rc

    wild = np.asarray([-(2**31), 2**31 - 1, 0, -(2**31), 5], np.int32)
    blob = rc.compress_delta_batch([wild])[0]
    assert blob[0] == rc.MAGIC_BZ
    assert rc.decompress_delta_batch([blob])[0] == wild.tobytes()
    assert rc.decompress(blob) == wild.tobytes()
    # mixed batch: the wide frame routes, the sane frame stays a delta container
    sane = np.cumsum(np.random.default_rng(0).integers(-3, 4, 40000)).astype(np.int32)
    blobs = rc.compress_delta_batch([wild, sane])
    assert blobs[0][0] == rc.MAGIC_BZ and blobs[1][0] != rc.MAGIC_BZ
    out = rc.decompress_delta_batch(blobs)
    assert out[0] == wild.tobytes() and out[1] == sane.tobytes()
    # the generic compress() entry point roundtrips too
    assert rc.decompress(rc.compress(wild)) == wild.tobytes()


def test_corrupt_container_headers_raise():
    """Wire-derived header fields that would drive the native finalizers
    out of bounds (contour T smaller than the wavefront needs, delta n
    beyond lanes*T) must raise before any kernel runs."""
    import struct

    import pytest

    from rpcc.codec import rans_codec as rc

    # contour: shrink the claimed T below H+W-1 (build the 'N' container
    # directly — compress_contour may adaptively pick bz2 for this content)
    bits = np.packbits((np.random.default_rng(1).random(32 * 64) < 0.2))
    blob = rc._compress_bits(bits, 32, 64)
    assert blob[0] == rc.MAGIC_BITS
    buf = bytearray(blob)
    struct.pack_into("<H", buf, 1, 16)  # T := 16 < 32+64-1
    with pytest.raises(ValueError, match="corrupt contour"):
        rc.decompress_contour_batch([bytes(buf)])

    # delta: inflate the claimed n beyond lanes*T
    data = np.cumsum(np.random.default_rng(2).integers(-3, 4, 4096)).astype(np.int16)
    dblob = rc.compress_delta_batch([data])[0]
    if dblob[0] in (rc.MAGIC_CTX, rc.MAGIC_DELTA):
        dbuf = bytearray(dblob)
        struct.pack_into("<I", dbuf, 4, 10_000_000)
        with pytest.raises(ValueError, match="corrupt delta"):
            rc.decompress_delta_batch([bytes(dbuf)])

    # fused encoder refuses frames larger than its lanes*T buffers
    from rpcc.codec import rans_native as rn

    if rn.fused_available():
        with pytest.raises(ValueError, match="exceeds lanes"):
            rn.delta_encode_frames([np.zeros(1000, np.int16)], 2, 4, 512, 4)


def test_corrupt_lane_count_raises():
    """A corrupt log_lanes (beyond MAX_LANES) must raise at parse time —
    it would otherwise drive a multi-GB words allocation in the batch
    decoder before any other validation fires."""
    import struct

    import pytest

    from rpcc.codec import rans_codec as rc

    data = np.cumsum(np.random.default_rng(4).integers(-3, 4, 40000)).astype(np.int16)
    blob = rc.compress_delta_batch([data])[0]
    assert blob[0] in (rc.MAGIC_CTX, rc.MAGIC_DELTA)
    buf = bytearray(blob)
    struct.pack_into("<B", buf, 1, 16)  # log_lanes := 16 -> 65536 lanes
    with pytest.raises(ValueError, match="corrupt delta container: lanes"):
        rc.decompress_delta_batch([bytes(buf)])


def test_recip_from_freq_exhaustive():
    """recip_from_freq must reproduce the _RECIP_NP table bit-for-bit over
    the ENTIRE frequency domain [0, 2^14] — it replaced carrying the 31-bit
    reciprocal through the device coder's position sort (the f32-seeded
    division is backend-dependent; the i32 residue corrections make the
    floor exact everywhere or nowhere, so the exhaustive sweep is cheap
    and decisive)."""
    import jax
    import jax.numpy as jnp

    from rpcc.ops.rans_device import _RECIP_NP, recip_from_freq

    f = jnp.arange(_RECIP_NP.size, dtype=jnp.uint32)  # 0..16384 inclusive
    got = np.asarray(jax.jit(recip_from_freq)(f))
    np.testing.assert_array_equal(got, _RECIP_NP)
