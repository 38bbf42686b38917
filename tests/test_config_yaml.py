"""The flat YAML reader against PyYAML on every config the repo ships and on
a user-style codec file (quoted strings, comments, bools, negative numbers,
flow lists)."""

import glob
import os

import pytest

from rpcc.config import load_flat_yaml, parse_flat_yaml

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "rpcc")
SHIPPED = sorted(os.path.relpath(p, PKG)
                 for p in glob.glob(os.path.join(PKG, "**", "*.yaml"), recursive=True))
USER_YAML = """\
# a user's --compressor_yaml
compress_framework: "non-uniform"   # quoted
accuracy: 0.035
level_key_point_num: [40, 12, 4, 0]
level_delta_acc: [0, 0.01, 0.03, -0.0]
segment_method: DBSCAN
DBSCAN_eps: 1.2
cpu_fps: false
device_entropy: True
transfer_precision: 'f32 # not a comment'
seed: -3
"""


@pytest.mark.parametrize("name", SHIPPED + ["user-compressor.yaml"])
def test_flat_reader_matches_pyyaml(name, tmp_path):
    yaml = pytest.importorskip("yaml")
    if name == "user-compressor.yaml":
        path = tmp_path / name
        path.write_text(USER_YAML)
    else:
        path = os.path.join(PKG, name)
    with open(path) as f:
        assert load_flat_yaml(str(path)) == yaml.safe_load(f)
    with pytest.raises(ValueError):
        parse_flat_yaml("nested:\n  key: 1\n")
