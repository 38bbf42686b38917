"""Every f32 matmul in the codec graphs is pinned to Precision.HIGHEST.

An unpinned f32 dot may run with bf16 or TF32 inputs on an accelerator
(3-4 significant digits): at LiDAR coordinate scale that moves segment
assignments and plane fits, so the bitstream would differ from the CPU's.
The audit walks the traced jaxprs, sub-programs of scans, loops and
conditionals included.
"""

import jax
import numpy as np
import pytest

from rpcc.config import CodecConfig
from rpcc.models.decoder import build_decode_fn
from rpcc.models.encoder import build_encode_fn, num_model_rows

from tests.test_roundtrip import SMALL

MODES = {
    "point": CodecConfig(cluster_num=16),
    "plane": CodecConfig(cluster_num=16, modeling_method="plane"),
    "non-uniform": CodecConfig(cluster_num=16, compress_framework="non-uniform"),
    "DBSCAN": CodecConfig(cluster_num=16, segment_method="DBSCAN"),
}


def _dots(jaxpr):
    """All dot_general equations of a jaxpr and its sub-jaxprs."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for v in eqn.params.values():
            for sub in v if isinstance(v, (list, tuple)) else (v,):
                if hasattr(sub, "eqns"):
                    yield from _dots(sub)
                elif hasattr(getattr(sub, "jaxpr", None), "eqns"):
                    yield from _dots(sub.jaxpr)


def _unpinned_f32(closed) -> tuple:
    highest = jax.lax.Precision.HIGHEST
    dots = list(_dots(closed.jaxpr))
    bad = []
    for eqn in dots:
        if eqn.invars[0].aval.dtype != np.float32:
            continue
        prec = eqn.params.get("precision")
        precs = prec if isinstance(prec, tuple) else (prec, prec)
        if any(p != highest for p in precs):
            bad.append(str(eqn)[:160])
    return dots, bad


@pytest.mark.parametrize("mode", sorted(MODES))
def test_f32_dots_are_highest_precision(mode):
    cfg = MODES[mode]
    H, W = SMALL.height, SMALL.width
    step = (np.float32(cfg.step) if cfg.uniform
            else np.asarray(cfg.level_acc, np.float32))
    enc = jax.make_jaxpr(build_encode_fn(SMALL, cfg, from_ri=True))(
        np.zeros((H, W), np.float32), np.uint32(0), step
    )
    enc_dots, bad = _unpinned_f32(enc)
    assert not bad, f"unpinned f32 dots in the {mode} encoder: {bad}"
    # the cluster-center distance block (FPS modes) and the RANSAC
    # covariance fits are real matmuls — the audit must have seen them
    assert any(e.invars[0].aval.dtype == np.float32 for e in enc_dots)

    m = num_model_rows(cfg)
    args = [np.zeros((H * W // 8,), np.uint8), np.zeros((H * W,), np.int32),
            np.zeros((H * W,), np.int32), np.zeros((m, 4), np.float32), step]
    if not cfg.uniform:
        args.append(np.zeros((m,), np.int32))
    dec = jax.make_jaxpr(build_decode_fn(SMALL, cfg))(*args)
    _, bad = _unpinned_f32(dec)
    assert not bad, f"unpinned f32 dots in the {mode} decoder: {bad}"
