"""Unit tests for the stream-space engine (ops/stream.py)."""

import jax
import jax.numpy as jnp
import numpy as np

from rpcc.ops.quantize import cluster_sort
from rpcc.ops.stream import (
    compact_flagged,
    expand_per_cluster,
    materialized_cumsum,
    per_cluster_sums,
    point_means_stream,
    stream_sort,
    stream_to_pixel,
)


def make_seg(hw=4096, num_models=12, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, num_models, hw).astype(np.int32), rng


def test_stream_sort_matches_cluster_sort_semantics():
    seg, rng = make_seg()
    vals = rng.normal(size=seg.shape[0]).astype(np.float32)
    num_models = 12

    order, (vals_s,) = stream_sort(jnp.asarray(seg), [jnp.asarray(vals)], num_models)
    ref = cluster_sort(jnp.asarray(seg), num_models)

    # Same stream permutation (id-major, row-major, id 1 last).
    perm = np.asarray(order.perm)
    expected = []
    for m in list(range(0, 1)) + list(range(2, num_models)) + [1]:
        expected.extend(np.where(seg == m)[0])
    np.testing.assert_array_equal(perm, np.asarray(expected))
    np.testing.assert_array_equal(np.asarray(order.counts), np.asarray(ref.counts))
    assert int(order.stream_len) == int(ref.stream_len)
    # payload carried correctly
    np.testing.assert_array_equal(np.asarray(vals_s), vals[perm])


def test_expand_per_cluster_bit_exact():
    seg, rng = make_seg(seed=1)
    num_models = 12
    order, _ = stream_sort(jnp.asarray(seg), [], num_models)
    vals = rng.normal(size=num_models).astype(np.float32)
    vals[3] = 0.0  # exact zero must survive
    expanded = np.asarray(expand_per_cluster(jnp.asarray(vals), order, seg.shape[0]))
    seg_s = np.asarray(order.seg)
    # bit-exact per slot (the telescoping runs in the int32 bitcast domain)
    np.testing.assert_array_equal(expanded, vals[seg_s])


def test_per_cluster_sums_and_means():
    seg, rng = make_seg(seed=2)
    num_models = 12
    ri = rng.uniform(1, 50, seg.shape[0]).astype(np.float32)
    order, (ri_s,) = stream_sort(jnp.asarray(seg), [jnp.asarray(ri)], num_models)
    sums = np.asarray(per_cluster_sums(ri_s, order))
    for m in range(num_models):
        np.testing.assert_allclose(sums[m], ri[seg == m].sum(), rtol=1e-5)
    means = np.asarray(point_means_stream(ri_s, order))
    assert means[0] == 0 and means[1] == 0
    for m in range(2, num_models):
        np.testing.assert_allclose(means[m], ri[seg == m].mean(), rtol=1e-5)


def test_stream_to_pixel_inverts_permutation():
    seg, rng = make_seg(seed=3)
    vals = rng.normal(size=seg.shape[0]).astype(np.float32)
    order, (vals_s,) = stream_sort(jnp.asarray(seg), [jnp.asarray(vals)], 12)
    back = np.asarray(stream_to_pixel(vals_s, order))
    np.testing.assert_array_equal(back, vals)


def test_compact_flagged():
    rng = np.random.default_rng(4)
    flags = (rng.random(1000) < 0.1).astype(np.int32)
    vals = rng.integers(0, 99, 1000).astype(np.int32)
    comp, n = compact_flagged(jnp.asarray(flags), jnp.asarray(vals))
    n = int(n)
    np.testing.assert_array_equal(np.asarray(comp)[:n], vals[flags == 1])


def _count_prims(jaxpr, name: str) -> int:
    n = 0
    for eqn in jaxpr.eqns:
        n += eqn.primitive.name == name
        for sub in jax.core.jaxprs_in_params(eqn.params):
            n += _count_prims(sub, name)
    return n


def test_plane_model_cumsums_are_materialized():
    """Every cumsum of the plane fit is written out before it is gathered:
    fused into its small consumers, XLA:GPU re-evaluates the scan per read
    element, O(HW^2) for the nested refit/validation sums."""
    from rpcc.ops.modeling import plane_models_stream

    seg, rng = make_seg(seed=5)
    num_models = 12
    ri = rng.uniform(2, 50, seg.shape[0]).astype(np.float32)
    order, (ri_s,) = stream_sort(jnp.asarray(seg), [jnp.asarray(ri)], num_models)
    rays = tuple(jnp.full(seg.shape, v, jnp.float32) for v in (0.6, 0.0, 0.8))
    fn = lambda r: plane_models_stream(r, order, jax.random.PRNGKey(0), num_models, 60.0, rays)
    jaxpr = jax.make_jaxpr(fn)(ri_s).jaxpr
    cumsums = _count_prims(jaxpr, "cumsum")
    assert cumsums > 0
    assert _count_prims(jaxpr, "optimization_barrier") == cumsums
    got = np.asarray(materialized_cumsum(jnp.asarray(ri)))
    np.testing.assert_array_equal(got, np.asarray(jnp.cumsum(jnp.asarray(ri))))
