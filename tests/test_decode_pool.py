"""Decode-token compression tests: ring flush into the quantized decode
pool, long generations past the ring, sliding-window semantics, and fused
kernel parity with a populated pool.

The reference is prefill-only (its decode tokens accumulate uncompressed
forever, /root/reference/src/models/modified_llama.py:83-85); the decode
pool has no reference counterpart and is required for long generations to
keep the memory win.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from realtime_kv_cache_compression_tpu import (CompressionConfig,
                                               tiny_test_model)
from realtime_kv_cache_compression_tpu.compression import kv_cache as kvc
from realtime_kv_cache_compression_tpu.models import llama

MCFG = tiny_test_model(num_layers=2)


def make_ccfg(**kw):
    base = dict(num_layers=2, high_precision_bits=8, medium_precision_bits=4,
                low_precision_bits=2)
    base.update(kw)
    return CompressionConfig(**base)


def test_flush_recent_bookkeeping(rng):
    ccfg = make_ccfg(decode_pool_blocks=2, decode_pool_bits=8)
    b, r = 2, 8
    recent = kvc.init_recent_cache(b, r, MCFG)
    pool = kvc.init_decode_pool(b, r, ccfg, MCFG)
    # Fill row 0's ring only.
    for i in range(r):
        k = jnp.asarray(rng.normal(size=(b, 1, MCFG.num_kv_heads,
                                         MCFG.head_dim)).astype(np.float32))
        pos = jnp.full((b, 1), 100 + i, jnp.int32)
        app = kvc.append_recent(recent, k, k, pos)
        # Row 1 stays empty: re-insert its original (empty) state.
        recent = dataclasses.replace(
            app, length=app.length.at[1].set(recent.length[1]))
    assert int(recent.length[0]) == r and int(recent.length[1]) == 0

    new_recent, new_pool = kvc.flush_recent(recent, pool, ccfg, MCFG)
    # Row 0 flushed: length reset, block 0 valid, write_block advanced.
    assert int(new_recent.length[0]) == 0
    assert int(new_pool.write_block[0]) == 1
    assert bool(new_pool.valid[0, :r].all())
    np.testing.assert_array_equal(np.asarray(new_pool.positions[0, :r]),
                                  100 + np.arange(r))
    # Row 1 untouched.
    assert int(new_pool.write_block[1]) == 0
    assert not bool(new_pool.valid[1].any())

    # Dequantized pool contents approximate the flushed ring K (8-bit).
    k_d, _, _, valid = kvc.dequantize_decode_pool(new_pool)
    err = np.abs(np.asarray(k_d[0, :r]) - np.asarray(recent.k[0]))
    assert err.max() < 0.05


def test_generation_beyond_ring_exact_with_raw_pool(rng):
    """16-bit pool stores flushed tokens verbatim, so generation past the
    ring must be bit-identical to a run whose ring holds everything."""
    params = llama.init_params(jax.random.PRNGKey(0), MCFG)
    ids = jax.random.randint(jax.random.PRNGKey(1), (2, 64), 0,
                             MCFG.vocab_size)
    n_steps = 40

    def run(ccfg, max_decode_len):
        logits, state, _ = llama.prefill_compressed(
            params, ids, MCFG, ccfg, max_decode_len=max_decode_len)
        tok = jnp.argmax(logits, axis=-1)
        toks, _ = llama.decode_loop(params, tok, state, n_steps, MCFG, ccfg)
        return np.asarray(toks)

    big = run(make_ccfg(), max_decode_len=n_steps + 1)   # no pool, big ring
    pooled = run(make_ccfg(decode_pool_blocks=4, decode_pool_bits=16),
                 max_decode_len=8)                        # ring 8, 4 blocks
    np.testing.assert_array_equal(big, pooled)


def test_long_generation_with_quantized_pool():
    """4-bit pool: 200-step generation with ring 16 completes, stays finite,
    and the decode-token storage is a bounded sliding window."""
    ccfg = make_ccfg(decode_pool_blocks=4, decode_pool_bits=4)
    params = llama.init_params(jax.random.PRNGKey(0), MCFG)
    ids = jax.random.randint(jax.random.PRNGKey(1), (1, 64), 0,
                             MCFG.vocab_size)
    logits, state, _ = llama.prefill_compressed(params, ids, MCFG, ccfg,
                                                max_decode_len=16)
    tok = jnp.argmax(logits, axis=-1)
    n_steps = 200
    toks, state = llama.decode_loop(params, tok, state, n_steps, MCFG, ccfg)
    assert toks.shape == (1, n_steps)
    assert bool((toks >= 0).all())
    # Window semantics: pool fully valid (wrapped), ring partially filled.
    pool = state.pools[0]
    assert bool(pool.valid.all())
    assert int(state.recents[0].length[0]) <= 16
    # Memory: decode tokens occupy ring (16 raw) + pool (64 @ 4 bits)
    # regardless of the 200 generated — vs 200 raw slots uncompressed.
    pool_bytes = sum(
        np.asarray(a).size * np.asarray(a).dtype.itemsize
        for a in (pool.k_stored, pool.v_stored, pool.k_scale, pool.k_zp,
                  pool.v_scale, pool.v_zp))
    dense_bytes = 2 * n_steps * MCFG.num_kv_heads * MCFG.head_dim * 4
    assert pool_bytes < dense_bytes


def test_fused_decode_with_pool_matches_xla(rng):
    """fused_decode_attention(pool=...) (interpret) == XLA dense path."""
    from realtime_kv_cache_compression_tpu.ops.pallas.decode_attention import \
        fused_decode_attention

    ccfg = make_ccfg(decode_pool_blocks=2, decode_pool_bits=4)
    params = llama.init_params(jax.random.PRNGKey(0), MCFG)
    ids = jax.random.randint(jax.random.PRNGKey(1), (2, 64), 0,
                             MCFG.vocab_size)
    logits, state, _ = llama.prefill_compressed(params, ids, MCFG, ccfg,
                                                max_decode_len=8)
    tok = jnp.argmax(logits, axis=-1)
    # 20 steps -> at least one flush (ring 8); pools populated.
    toks, state = llama.decode_loop(params, tok, state, 20, MCFG, ccfg)
    assert bool(state.pools[0].valid.any())

    q = jnp.asarray(rng.normal(size=(2, 1, MCFG.num_heads,
                                     MCFG.head_dim)).astype(np.float32))
    q_pos = state.position[:, None]
    cache, recent, pool = (state.caches[0], state.recents[0], state.pools[0])

    from realtime_kv_cache_compression_tpu.compression.compressor import \
        dequantize_layer_cache
    from realtime_kv_cache_compression_tpu.compression.kv_cache import \
        dequantize_decode_pool
    from realtime_kv_cache_compression_tpu.ops.attention import \
        attention_over_tokens

    k_c, v_c, pos_c, valid_c = dequantize_layer_cache(cache, ccfg, q.dtype)
    k_p, v_p, pos_p, valid_p = dequantize_decode_pool(pool, q.dtype)
    rec_valid = jnp.arange(recent.capacity)[None] < recent.length[:, None]
    ref = attention_over_tokens(
        q,
        jnp.concatenate([k_c, recent.k, k_p], axis=1),
        jnp.concatenate([v_c, recent.v, v_p], axis=1),
        jnp.concatenate([pos_c, recent.positions, pos_p], axis=1),
        jnp.concatenate([valid_c, rec_valid, valid_p], axis=1),
        q_pos)
    out = fused_decode_attention(q, cache, recent, q_pos, ccfg, pool=pool)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=2e-4, atol=2e-5)


def test_pool_config_validation():
    with pytest.raises(ValueError):
        make_ccfg(decode_pool_bits=3)
    with pytest.raises(ValueError):
        make_ccfg(decode_pool_blocks=-1)
