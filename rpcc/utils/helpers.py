"""Small host helpers (reference ``utils/utils.py`` parity)."""

from __future__ import annotations

import sys

from rpcc.config import CodecConfig, load_codec_config  # noqa: F401  (re-export)


def sys_size(data) -> int:
    return sys.getsizeof(data)


def bit_size(data) -> int:
    return len(data)


def np_size(data) -> int:
    return data.nbytes


def load_compressor_cfg(yaml_file: str) -> CodecConfig:
    """YAML -> CodecConfig (reference returns an EasyDict; ours is typed and
    also dict-accessible via dataclasses.asdict when needed)."""
    return load_codec_config(yaml_file)
