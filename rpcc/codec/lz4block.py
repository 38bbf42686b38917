"""LZ4 block codec: ctypes binding to the native library, python fallback.

The native library (codec/native/*.cpp) is compiled with g++ on the machine
that loads it, into ``build/native/`` under the checkout.  Its file name
carries a hash of the sources, the compiler flags and the host CPU, so a
library built with ``-march=native`` on another machine is never loaded.
If the build fails, a warning is printed and the pure-python/numpy
fallbacks keep the format working (much slower); :func:`build_library`
raises instead, for callers that must run the native path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading

from rpcc.runtime import REPO_ROOT

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")
BUILD_DIR = os.path.join(REPO_ROOT, "build", "native")
_SOURCES = ["lz4.cpp", "deflate.cpp", "rans.cpp", "raster.cpp", "decode.cpp"]
# -ffp-contract=off: raster.cpp's projection must stay bit-identical to
# the numpy fallback; a compiler-fused FMA would change the angle bits.
# -fno-math-errno / -fno-trapping-math let sqrt and guarded divisions
# vectorize (IEEE results unchanged — only errno/exception flags are
# dropped); full -ffast-math would break the bit-exactness contract.
CXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-fno-math-errno",
             "-fno-trapping-math", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib = None
_lib_failed = False


def host_cpu_id(cpuinfo: str = "/proc/cpuinfo") -> str:
    """CPU model and feature flags of this host (what -march=native sees)."""
    try:
        with open(cpuinfo) as f:
            lines = f.read().splitlines()
    except OSError:
        import platform

        return platform.machine() + " " + platform.processor()
    keep = [ln for ln in lines if ln.split(":")[0].strip() in ("model name", "flags")]
    return "\n".join(dict.fromkeys(keep))  # first CPU's lines, order kept


def library_path(flags=CXX_FLAGS, cpu_id: str | None = None) -> str:
    """Host-keyed path of the native library built from the current sources."""
    h = hashlib.sha256()
    for name in _SOURCES:
        with open(os.path.join(_NATIVE_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join(flags).encode())
    h.update((host_cpu_id() if cpu_id is None else cpu_id).encode())
    return os.path.join(BUILD_DIR, f"librpcc_native-{h.hexdigest()[:16]}.so")


def build_library() -> str:
    """Build the native library for this host unless it exists; returns its
    path.  Raises RuntimeError with the compiler's message on failure."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    srcs = [os.path.join(_NATIVE_DIR, s) for s in _SOURCES]
    # OpenMP parallelizes the batched coders over frames; retry without it
    # for toolchains that ship no libgomp.
    err = b""
    for extra in (["-fopenmp"], []):
        cmd = ["g++", *CXX_FLAGS, *extra, "-o", tmp, *srcs, "-lz"]
        try:
            r = subprocess.run(cmd, capture_output=True)
        except OSError as e:
            raise RuntimeError(f"native build failed: {e}") from e
        if r.returncode == 0:
            os.replace(tmp, path)  # atomic: concurrent builders race safely
            return path
        err = r.stderr
    lines = err.decode(errors="replace").strip().splitlines()
    raise RuntimeError("native build failed:\n  " + "\n  ".join(lines[:8]))


def _load():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            lib = ctypes.CDLL(build_library())
        except (RuntimeError, OSError) as e:
            # Every hot path drops onto numpy fallbacks (~15x slower
            # projection, slower entropy) — say so, so a broken build
            # cannot pass for a performance regression.
            print(f"WARNING: rpcc native library unavailable — falling back "
                  f"to numpy paths. {e}", file=sys.stderr)
            _lib_failed = True
            return None
        lib.lz4_compress_bound.restype = ctypes.c_size_t
        lib.lz4_compress_bound.argtypes = [ctypes.c_size_t]
        lib.lz4_compress_block.restype = ctypes.c_size_t
        lib.lz4_compress_block.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t,
        ]
        lib.lz4_decompress_block.restype = ctypes.c_size_t
        lib.lz4_decompress_block.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t,
        ]
        for name in ("gzip_compress_buf",):
            fn = getattr(lib, name, None)
            if fn is not None:
                fn.restype = ctypes.c_size_t
                fn.argtypes = [
                    ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
                    ctypes.c_size_t, ctypes.c_int,
                ]
        fn = getattr(lib, "gzip_decompress_buf", None)
        if fn is not None:
            fn.restype = ctypes.c_size_t
            fn.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t,
            ]
        fn = getattr(lib, "project_bin_raster", None)
        if fn is not None:
            # c_float argtypes are required: untyped ctypes calls promote
            # python floats to double and corrupt the ABI.
            fn.restype = None
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_float, ctypes.c_float, ctypes.c_float,
                ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
            ]
        fn = getattr(lib, "project_bin_raster_u16", None)
        if fn is not None:
            fn.restype = None
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_float, ctypes.c_float, ctypes.c_float,
                ctypes.c_void_p, ctypes.c_int32, ctypes.c_float,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ]
        fn = getattr(lib, "project_bin_raster_d8", None)
        if fn is not None:
            fn.restype = ctypes.c_int64
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_float, ctypes.c_float, ctypes.c_float,
                ctypes.c_void_p, ctypes.c_int32, ctypes.c_float,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ]
        fn = getattr(lib, "project_bin_raster_m8", None)
        if fn is not None:
            fn.restype = ctypes.c_int64
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_float, ctypes.c_float, ctypes.c_float,
                ctypes.c_void_p, ctypes.c_int32, ctypes.c_float,
            ] + [ctypes.c_void_p] * 8
        fn = getattr(lib, "m8_reconstruct_batch", None)
        if fn is not None:
            fn.restype = None
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 4 + [
                ctypes.c_void_p,
            ]
        fn = getattr(lib, "d8_reconstruct_batch", None)
        if fn is not None:
            fn.restype = None
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p,
            ]
        fn = getattr(lib, "backproject_compact", None)
        if fn is not None:
            fn.restype = ctypes.c_int64
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p,
            ]
        fn = getattr(lib, "host_decode_frame", None)
        if fn is not None:
            # c_float argtypes required (see project_bin_raster note).
            fn.restype = ctypes.c_int64
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int32,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
                ctypes.c_float, ctypes.c_void_p,
                ctypes.c_int32, ctypes.c_int32,
                ctypes.c_void_p, ctypes.c_void_p,
            ]
        _lib = lib
        return _lib


def native_lib():
    """The loaded native library handle (or None)."""
    return _load()


def compress_block(data: bytes) -> bytes:
    lib = _load()
    if lib is not None:
        cap = lib.lz4_compress_bound(len(data))
        out = ctypes.create_string_buffer(cap)
        n = lib.lz4_compress_block(data, len(data), out, cap)
        if n == 0:
            raise RuntimeError("lz4 native compression failed")
        return out.raw[:n]
    return _py_compress(data)


def decompress_block(blob: bytes, out_len: int) -> bytes:
    lib = _load()
    if lib is not None:
        out = ctypes.create_string_buffer(out_len if out_len else 1)
        n = lib.lz4_decompress_block(blob, len(blob), out, out_len)
        if n != out_len:
            raise RuntimeError(f"lz4 native decompression failed ({n} != {out_len})")
        return out.raw[:out_len]
    return _py_decompress(blob, out_len)


# ----------------------------------------------------------------- fallback
MINMATCH = 4
MFLIMIT = 12
LASTLITERALS = 5


def _py_compress(data: bytes) -> bytes:
    n = len(data)
    if n == 0:
        return b"\x00"
    out = bytearray()
    table: dict[bytes, int] = {}
    anchor = 0
    i = 0
    mflimit = n - MFLIMIT

    def emit(lit_start, lit_end, off=None, mlen=None):
        lit = lit_end - lit_start
        token_pos = len(out)
        out.append(0)
        if lit >= 15:
            out[token_pos] = 15 << 4
            l = lit - 15
            while l >= 255:
                out.append(255)
                l -= 255
            out.append(l)
        else:
            out[token_pos] = lit << 4
        out.extend(data[lit_start:lit_end])
        if off is not None:
            out.append(off & 0xFF)
            out.append(off >> 8)
            ml = mlen - MINMATCH
            if ml >= 15:
                out[token_pos] |= 15
                m = ml - 15
                while m >= 255:
                    out.append(255)
                    m -= 255
                out.append(m)
            else:
                out[token_pos] |= ml

    while i < mflimit:
        key = data[i : i + 4]
        j = table.get(key)
        table[key] = i
        if j is None or i - j > 65535:
            i += 1
            continue
        mlen = MINMATCH
        limit = n - LASTLITERALS
        while i + mlen < limit and data[j + mlen] == data[i + mlen]:
            mlen += 1
        emit(anchor, i, i - j, mlen)
        i += mlen
        anchor = i
    emit(anchor, n)
    return bytes(out)


def _py_decompress(blob: bytes, out_len: int) -> bytes:
    out = bytearray()
    i, n = 0, len(blob)
    while i < n:
        token = blob[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = blob[i]
                i += 1
                lit += b
                if b != 255:
                    break
        out.extend(blob[i : i + lit])
        i += lit
        if i >= n:
            break
        off = blob[i] | (blob[i + 1] << 8)
        i += 2
        mlen = token & 15
        if mlen == 15:
            while True:
                b = blob[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        mlen += MINMATCH
        if off == 0 or off > len(out):
            # The native decoder rejects offsets beyond the produced
            # output (`op - dst < off`); Python negative indexing would
            # otherwise silently copy from the END of the buffer and
            # decode garbage of the correct length.
            raise RuntimeError(
                f"lz4 python decompression failed (bad offset {off} "
                f"at {len(out)} bytes)"
            )
        start = len(out) - off
        for k in range(mlen):
            out.append(out[start + k])
    if len(out) != out_len:
        raise RuntimeError(f"lz4 python decompression failed ({len(out)} != {out_len})")
    return bytes(out)
