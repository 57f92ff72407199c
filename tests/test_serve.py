"""Serving layer: AOT compile, export/deserialize roundtrip, persistent
cache, bucketed batching.

No reference counterpart (the reference is a library with no deployment
story); this pins the production subsystem: compiled executables must be
bit-identical to `jit`, serialized payloads must survive a roundtrip, and
the bucket ladder must bound the number of XLA programs.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cortex_tpu.serve import (
    BucketedServer,
    aot_compile,
    enable_persistent_cache,
    export_serialized,
    load_serialized,
)
from cortex_tpu.models import LGSSM


def _smooth_fn():
    model = LGSSM(A=0.9, Q=0.5, H=1.0, R=1.0)

    def fn(y):
        marg = model.smooth(y, method="scan")
        return marg.mean, marg.variance

    return fn


def test_aot_compile_matches_jit():
    fn = _smooth_fn()
    rng = np.random.default_rng(0)
    y = jnp.asarray(rng.normal(size=(16, 32)), jnp.float32)
    compiled = aot_compile(fn, y)
    m1, v1 = compiled(y)
    m2, v2 = jax.jit(fn)(y)
    np.testing.assert_allclose(m1, m2, rtol=1e-6)
    np.testing.assert_allclose(v1, v2, rtol=1e-6)


def test_aot_cost_and_memory_analysis_exposed():
    fn = _smooth_fn()
    y = jnp.zeros((8, 16), jnp.float32)
    compiled = aot_compile(fn, y)
    cost = compiled.cost_analysis()
    assert isinstance(cost, dict) and cost.get("flops", 0) > 0
    assert compiled.memory_analysis() is not None
    assert "hlo" in compiled.as_text().lower() or len(compiled.as_text()) > 0


def test_export_roundtrip_matches_original():
    fn = _smooth_fn()
    rng = np.random.default_rng(1)
    y = jnp.asarray(rng.normal(size=(4, 24)), jnp.float32)
    blob = export_serialized(fn, y)
    assert isinstance(blob, (bytes, bytearray)) and len(blob) > 100
    rehydrated = load_serialized(bytes(blob))
    m1, v1 = rehydrated(y)
    m2, v2 = jax.jit(fn)(y)
    np.testing.assert_allclose(m1, m2, rtol=1e-6)
    np.testing.assert_allclose(v1, v2, rtol=1e-6)


def test_persistent_cache_populates(tmp_path):
    cache_dir = str(tmp_path / "xla_cache")
    enable_persistent_cache(cache_dir)

    def fresh(x):
        return jnp.tanh(x) * 3.14159 + jnp.sum(x**3)

    jax.jit(fresh)(jnp.arange(7.0, dtype=jnp.float32)).block_until_ready()
    import os

    assert os.path.isdir(cache_dir)
    assert len(os.listdir(cache_dir)) >= 1


def test_bucketed_server_pads_and_slices_correctly():
    fn = _smooth_fn()
    example = (jnp.zeros((8, 20), jnp.float32),)
    server = BucketedServer(fn, example, max_batch=64, min_bucket=8)
    rng = np.random.default_rng(2)
    direct = jax.jit(fn)
    for n in (3, 8, 9, 33, 64):
        y = jnp.asarray(rng.normal(size=(n, 20)), jnp.float32)
        m_s, v_s = server(y)
        m_d, v_d = direct(y)
        assert m_s.shape == (n, 20)
        np.testing.assert_allclose(m_s, m_d, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(v_s, v_d, rtol=1e-5, atol=1e-6)
    # 3→8, 8→8, 9→16, 33→64, 64→64: exactly three programs compiled.
    assert server.compiled_buckets == (8, 16, 64)


def test_bucketed_server_rejects_oversize_and_precompiles():
    fn = _smooth_fn()
    example = (jnp.zeros((4, 10), jnp.float32),)
    server = BucketedServer(fn, example, max_batch=16, min_bucket=4, precompile=True)
    assert server.compiled_buckets == (4, 8, 16)
    with pytest.raises(ValueError, match="exceeds"):
        server(jnp.zeros((17, 10), jnp.float32))


def test_bucketed_server_example_larger_than_small_buckets():
    """Regression: an example batch bigger than a bucket must slice down, not
    emit negative pad widths."""
    fn = _smooth_fn()
    example = (jnp.zeros((32, 10), jnp.float32),)
    server = BucketedServer(fn, example, max_batch=64, min_bucket=8)
    y = jnp.asarray(np.random.default_rng(3).normal(size=(5, 10)), jnp.float32)
    out_m, _ = server(y)
    ref_m, _ = jax.jit(fn)(y)
    np.testing.assert_allclose(out_m, ref_m, rtol=1e-5, atol=1e-6)
    assert server.compiled_buckets == (8,)
