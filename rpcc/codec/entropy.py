"""Pluggable byte-level entropy coders.

Same surface as the reference ``BasicCompressor``
(``utils/compress_utils.py:232-310``): methods ``lz4 | bzip2 | gzip |
deflate`` selected by YAML or ``set_method``, operating on bytes-like numpy
buffers.

Implementation notes:
  * ``bzip2`` — stdlib ``bz2`` (byte-identical to the reference).
  * ``gzip``/``deflate`` — stdlib ``gzip`` with ``mtime=0`` so output bytes
    are deterministic (the reference embeds the current time in the gzip
    header; sizes are identical).
  * ``lz4`` — the reference pins ``lz4==0.7.0`` whose ``dumps`` emits a
    4-byte little-endian uncompressed size followed by one LZ4 block.  We
    ship our own LZ4 block codec (native C++ in codec/native, ctypes-loaded,
    with a pure-python fallback) writing the same container.
  * ``rans`` — this framework's own extra (not in the
    reference): see codec/rans.py; registered here once available.

All stdlib codecs release the GIL, so the datalist thread pool gets real
parallelism on multi-core hosts.
"""

from __future__ import annotations

import bz2
import gzip
import struct
from typing import Dict, Optional

METHODS = ("lz4", "bzip2", "gzip", "deflate", "rans")


class BasicCompressor:
    def __init__(
        self,
        compressor_yaml: Optional[str] = None,
        method_name: Optional[str] = None,
        contour_shape: Optional[tuple] = None,
    ):
        self.method_name: Optional[str] = None
        # (H, W) of the range image: lets the ``rans`` method context-code
        # the contour bit plane (bit-above model) instead of bzip2ing packed
        # row-major bytes.  Optional — without it contour falls back to bz2.
        self.contour_shape = contour_shape
        if compressor_yaml is not None:
            from rpcc.config import load_flat_yaml

            raw = load_flat_yaml(compressor_yaml)
            self.method_name = raw.get("basic_compressor")
        if method_name is not None:
            self.method_name = method_name
        if self.method_name is not None:
            self._check()

    def _check(self):
        assert self.method_name in METHODS, (
            "Compression method is not existed. (%s)" % ", ".join(METHODS)
        )

    def set_method(self, method_name: str):
        self.method_name = method_name
        self._check()

    # -- dict-of-fields helpers (compress_utils.py:255-265) -----------------
    def compress_dict(self, data_dict: Dict[str, object]) -> Dict[str, bytes]:
        out = {}
        for k, v in data_dict.items():
            if (
                k == "contour_map"
                and self.method_name == "rans"
                and self.contour_shape is not None
            ):
                from rpcc.codec import rans_codec

                out[k] = rans_codec.compress_contour(v, *self.contour_shape)
            else:
                out[k] = self.compress(v)
        return out

    def decompress_dict(self, data_dict: Dict[str, bytes]) -> Dict[str, bytes]:
        return {k: self.decompress(v) for k, v in data_dict.items()}

    # -- single buffer -------------------------------------------------------
    def compress(self, np_array) -> bytes:
        if self.method_name == "rans":
            from rpcc.codec import rans_codec

            return rans_codec.compress(np_array)
        data = _as_bytes(np_array)
        if self.method_name == "lz4":
            return lz4_compress(data)
        if self.method_name == "bzip2":
            return bz2.compress(data)
        if self.method_name in ("gzip", "deflate"):
            return gzip.compress(data, mtime=0)
        raise ValueError(f"unknown method {self.method_name}")

    def decompress(self, bitstream: bytes) -> bytes:
        if self.method_name == "rans":
            from rpcc.codec import rans_codec

            return rans_codec.decompress(bitstream)
        if self.method_name == "lz4":
            return lz4_decompress(bitstream)
        if self.method_name == "bzip2":
            return bz2.decompress(bitstream)
        if self.method_name in ("gzip", "deflate"):
            return gzip.decompress(bitstream)
        raise ValueError(f"unknown method {self.method_name}")

    def calc_compressed_bytes(self, np_array) -> int:
        return len(self.compress(np_array))


def _as_bytes(x) -> bytes:
    if isinstance(x, (bytes, bytearray, memoryview)):
        return bytes(x)
    return x.tobytes()


# --------------------------------------------------------------------------
# LZ4 block container: 4-byte LE uncompressed length + LZ4 block, the python
# lz4==0.7.0 ``dumps``/``loads`` wire format the reference uses.
# --------------------------------------------------------------------------

def lz4_compress(data: bytes) -> bytes:
    from rpcc.codec import lz4block

    return struct.pack("<I", len(data)) + lz4block.compress_block(data)


def lz4_decompress(blob: bytes) -> bytes:
    from rpcc.codec import lz4block

    (n,) = struct.unpack("<I", blob[:4])
    return lz4block.decompress_block(blob[4:], n)


if __name__ == "__main__":
    # Coder self-benchmark (reference parity: the BasicCompressor __main__
    # block at utils/compress_utils.py:313-342): roundtrip + relative speed
    # of every pluggable byte codec on a range-image-sized random array.
    import time as _time

    import numpy as _np

    rand_array = _np.random.randint(50, size=(64, 2000)).astype(_np.int8)
    rand_bytes = rand_array.tobytes()
    repeat_time = 100

    bc = BasicCompressor()
    for method in ("lz4", "bzip2", "gzip", "deflate", "rans"):
        print("\nTest ", method)
        bc.set_method(method)
        t0 = _time.time()
        for _ in range(repeat_time):
            compressed_data = bc.compress(rand_array)
        t1 = _time.time()
        for _ in range(repeat_time):
            decompressed_data = bc.decompress(compressed_data)
        print(
            "%d times compress cost time: %.04f, decompress cost time: %.04f"
            % (repeat_time, t1 - t0, _time.time() - t1)
        )
        print("Compression rate: ", len(rand_bytes) / len(compressed_data))
        recovered = _np.ndarray(shape=(64, 2000), dtype=_np.int8, buffer=decompressed_data)
        assert _np.array_equal(recovered, rand_array), "%s is not working." % method
    print("All compression methods are working.")
