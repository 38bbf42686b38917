"""Host-side bitstream framing and entropy coding."""

from rpcc.codec.entropy import BasicCompressor
from rpcc.codec.bitstream import (
    save_compressed_bitstream,
    read_compressed_bitstream,
    FIELD_ORDER,
)
