"""Split-K packed-cache decode kernel (interpret mode on CPU) vs the XLA
dequant path, and the rule that picks between them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from realtime_kv_cache_compression_tpu import (CompressionConfig,
                                               tiny_test_model)
from realtime_kv_cache_compression_tpu.compression import (
    append_recent, compress_layer_kv, dequantize_layer_cache,
    init_recent_cache)
from realtime_kv_cache_compression_tpu.models import llama
from realtime_kv_cache_compression_tpu.ops.attention import (
    attention_over_tokens)
from realtime_kv_cache_compression_tpu.ops.pallas.decode_attention import (
    fused_decode_attention)


def build_state(rng, b=2, s=96, hq=4, hkv=2, d=32, n_recent=2, mcfg=None,
                ccfg=None):
    mcfg = mcfg or tiny_test_model(num_kv_heads=hkv, num_heads=hq, head_dim=d)
    ccfg = ccfg or CompressionConfig(num_layers=mcfg.num_layers,
                                     high_precision_bits=8,
                                     medium_precision_bits=4,
                                     low_precision_bits=2)
    k = jnp.asarray(rng.normal(size=(b, s, hkv, d)).astype(np.float32))
    v = jnp.asarray(rng.normal(size=(b, s, hkv, d)).astype(np.float32))
    mass = jnp.asarray(rng.random((b, s)).astype(np.float32))
    cache, _ = compress_layer_kv(k, v, mass, 0, ccfg, mcfg)
    recent = init_recent_cache(b, 8, mcfg, dtype=jnp.float32)
    pos = s
    for i in range(n_recent):
        kn = jnp.asarray(rng.normal(size=(b, 1, hkv, d)).astype(np.float32))
        vn = jnp.asarray(rng.normal(size=(b, 1, hkv, d)).astype(np.float32))
        recent = append_recent(recent, kn, vn,
                               jnp.full((b, 1), pos + i, jnp.int32))
    q = jnp.asarray(rng.normal(size=(b, 1, hq, d)).astype(np.float32))
    q_pos = jnp.full((b, 1), pos + n_recent, jnp.int32)
    return q, cache, recent, q_pos, ccfg


def xla_reference(q, cache, recent, q_pos, ccfg):
    k_c, v_c, pos_c, valid_c = dequantize_layer_cache(cache, ccfg,
                                                      jnp.float32)
    rec_valid = jnp.arange(recent.capacity)[None] < recent.length[:, None]
    k_all = jnp.concatenate([k_c, recent.k], axis=1)
    v_all = jnp.concatenate([v_c, recent.v], axis=1)
    pos_all = jnp.concatenate([pos_c, recent.positions], axis=1)
    valid_all = jnp.concatenate([valid_c, rec_valid], axis=1)
    return attention_over_tokens(q, k_all, v_all, pos_all, valid_all, q_pos)


@pytest.mark.parametrize("tier_mode", ["quantile", "threshold"])
def test_fused_matches_xla(rng, tier_mode):
    mcfg = tiny_test_model(num_kv_heads=2, num_heads=4, head_dim=32)
    ccfg = CompressionConfig(num_layers=mcfg.num_layers,
                             high_precision_bits=8, medium_precision_bits=4,
                             low_precision_bits=2, tier_mode=tier_mode)
    q, cache, recent, q_pos, ccfg = build_state(rng, mcfg=mcfg, ccfg=ccfg)
    ref = xla_reference(q, cache, recent, q_pos, ccfg)
    out = fused_decode_attention(q, cache, recent, q_pos, ccfg)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=2e-5)


def test_fused_mha_single_rep(rng):
    """n_rep == 1 exercises the query-row padding path."""
    mcfg = tiny_test_model(num_kv_heads=4, num_heads=4, head_dim=16)
    q, cache, recent, q_pos, ccfg = build_state(rng, hq=4, hkv=4, d=16,
                                                mcfg=mcfg)
    ref = xla_reference(q, cache, recent, q_pos, ccfg)
    out = fused_decode_attention(q, cache, recent, q_pos, ccfg)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=2e-5)


def test_fused_16bit_tier(rng):
    mcfg = tiny_test_model(num_kv_heads=2, num_heads=4, head_dim=32)
    ccfg = CompressionConfig(num_layers=mcfg.num_layers,
                             high_precision_bits=16, medium_precision_bits=8,
                             low_precision_bits=4)
    q, cache, recent, q_pos, ccfg = build_state(rng, mcfg=mcfg, ccfg=ccfg)
    ref = xla_reference(q, cache, recent, q_pos, ccfg)
    out = fused_decode_attention(q, cache, recent, q_pos, ccfg)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=2e-5)


def test_fused_empty_recent(rng):
    """Right after prefill, the recent ring is empty (length 0)."""
    mcfg = tiny_test_model(num_kv_heads=2, num_heads=4, head_dim=32)
    q, cache, recent, q_pos, ccfg = build_state(rng, n_recent=0, mcfg=mcfg)
    ref = xla_reference(q, cache, recent, q_pos, ccfg)
    out = fused_decode_attention(q, cache, recent, q_pos, ccfg)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("chunk", [16, 64])
def test_multi_segment_chunked_matches_xla(rng, chunk):
    """Small pack_chunk_tokens forces multi-segment tiers: the single-launch
    kernel walks every chunk with carried softmax state == XLA path."""
    mcfg = tiny_test_model(num_kv_heads=2, num_heads=4, head_dim=32)
    ccfg = CompressionConfig(num_layers=mcfg.num_layers,
                             high_precision_bits=8, medium_precision_bits=4,
                             low_precision_bits=2, pack_chunk_tokens=chunk)
    q, cache, recent, q_pos, ccfg = build_state(rng, s=256, mcfg=mcfg,
                                                ccfg=ccfg)
    # Multi-segment check: at least one tier spans > 1 chunk.
    assert any(t.capacity > chunk for t in cache.tiers)
    ref = xla_reference(q, cache, recent, q_pos, ccfg)
    out = fused_decode_attention(q, cache, recent, q_pos, ccfg)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=2e-5)


def test_chunked_16bit_tier(rng):
    mcfg = tiny_test_model(num_kv_heads=2, num_heads=4, head_dim=32)
    ccfg = CompressionConfig(num_layers=mcfg.num_layers,
                             high_precision_bits=16, medium_precision_bits=8,
                             low_precision_bits=4, pack_chunk_tokens=32)
    q, cache, recent, q_pos, ccfg = build_state(rng, s=128, mcfg=mcfg,
                                                ccfg=ccfg)
    ref = xla_reference(q, cache, recent, q_pos, ccfg)
    out = fused_decode_attention(q, cache, recent, q_pos, ccfg)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("group_size", [16, 32])
def test_fused_group_scales(rng, group_size):
    """quant_group_size < head_dim (finer scale groups — the quality knob
    config.py advertises) runs through the kernel as column slices of
    head_dim, each with its own rank-1 correction."""
    mcfg = tiny_test_model(num_kv_heads=2, num_heads=4, head_dim=64)
    ccfg = CompressionConfig(num_layers=mcfg.num_layers,
                             high_precision_bits=8, medium_precision_bits=4,
                             low_precision_bits=2,
                             quant_group_size=group_size)
    q, cache, recent, q_pos, ccfg = build_state(rng, d=64, mcfg=mcfg,
                                                ccfg=ccfg)
    assert cache.tiers[0].k_scale.shape[-1] == 64 // group_size
    ref = xla_reference(q, cache, recent, q_pos, ccfg)
    out = fused_decode_attention(q, cache, recent, q_pos, ccfg)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=2e-5)


def test_decode_step_use_fused_matches(rng):
    """decode_step(use_fused=True) == use_fused=False through the model."""
    cfg = tiny_test_model(num_layers=2)
    ccfg = CompressionConfig(num_layers=2, high_precision_bits=8,
                             medium_precision_bits=4, low_precision_bits=2)
    params = llama.init_params(jax.random.PRNGKey(0), cfg)
    ids = jax.random.randint(jax.random.PRNGKey(1), (1, 64), 0,
                             cfg.vocab_size)
    _, state, _ = llama.prefill_compressed(params, ids, cfg, ccfg,
                                           max_decode_len=4)
    tok = jnp.array([3])
    l_ref, _ = llama.decode_step(params, tok, state, cfg, ccfg,
                                 use_fused=False)
    l_fused, _ = llama.decode_step(params, tok, state, cfg, ccfg,
                                   use_fused=True)
    np.testing.assert_allclose(np.asarray(l_fused), np.asarray(l_ref),
                               atol=1e-4)


def test_group_scales_below_16_columns_rejected(rng):
    """Scale groups narrower than the kernel's 16-column dot go to the XLA
    path: the kernel raises instead of computing them."""
    mcfg = tiny_test_model(num_kv_heads=2, num_heads=4, head_dim=32)
    ccfg = CompressionConfig(num_layers=mcfg.num_layers, quant_group_size=8)
    q, cache, recent, q_pos, ccfg = build_state(rng, mcfg=mcfg, ccfg=ccfg)
    with pytest.raises(ValueError):
        fused_decode_attention(q, cache, recent, q_pos, ccfg)


class TestResolveFusedDecode:
    """use_fused=None: the kernel on the GPU for shapes it takes and state
    on one device; the XLA path on the CPU (never the interpreter), over a
    mesh, and for narrow scale groups."""

    def test_cpu_never_interprets(self):
        cfg = tiny_test_model(head_dim=32)
        assert not llama.resolve_fused_decode(cfg, CompressionConfig())

    def test_gpu_picks_kernel(self, monkeypatch):
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        cfg = tiny_test_model(head_dim=128)
        assert llama.resolve_fused_decode(cfg, CompressionConfig())
        assert llama.resolve_fused_decode(
            cfg, CompressionConfig(quant_group_size=32))

    def test_gpu_xla_for_mesh_and_narrow_groups(self, monkeypatch):
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        cfg = tiny_test_model(head_dim=128)
        assert not llama.resolve_fused_decode(cfg, CompressionConfig(),
                                              mesh=object())
        assert not llama.resolve_fused_decode(
            cfg, CompressionConfig(quant_group_size=8))
