"""Flash prefill (cuDNN/XLA + mass-from-lse, and the Triton-route kernel in
interpret mode on CPU) vs the dense reference.

Golden checks: attention output and prompt-mass side-channel must match the
dense implementation (ops/attention.py) to fp32 tolerance, across GQA
ratios, head dims, ragged prompts and sequence lengths that are not a
multiple of the kernel's blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from realtime_kv_cache_compression_tpu.ops.attention import (
    chunk_attention_with_prompt_mass, positioned_attention_with_prompt_mass,
    prefill_attention_with_prompt_mass)
from realtime_kv_cache_compression_tpu.ops.pallas import flash_prefill as fp
from realtime_kv_cache_compression_tpu.ops.pallas.flash_prefill import (
    flash_prefill_with_prompt_mass)


def make_qkv(rng, b, s, hq, hkv, d):
    q = jnp.asarray(rng.normal(size=(b, s, hq, d)).astype(np.float32))
    k = jnp.asarray(rng.normal(size=(b, s, hkv, d)).astype(np.float32))
    v = jnp.asarray(rng.normal(size=(b, s, hkv, d)).astype(np.float32))
    return q, k, v


@pytest.mark.parametrize("impl", ["xla", "triton"])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
def test_flash_matches_dense(rng, hq, hkv, impl):
    b, s, d, p = 2, 256, 32, 32
    q, k, v = make_qkv(rng, b, s, hq, hkv, d)
    o_ref, pm_ref = prefill_attention_with_prompt_mass(q, k, v, p)
    o, pm = flash_prefill_with_prompt_mass(q, k, v, p, impl=impl)
    np.testing.assert_allclose(np.asarray(o), np.asarray(o_ref), atol=2e-5)
    np.testing.assert_allclose(np.asarray(pm), np.asarray(pm_ref), atol=2e-5)


@pytest.mark.parametrize("plens", [(50, 17), (1, 64), (64, 64)])
def test_mass_from_lse_ragged_prompts(rng, plens):
    """The square path's mass pass (lse from XLA's attention here, from
    cuDNN on the GPU) follows each row's own prompt length exactly."""
    b, s, hq, hkv, d, p = 2, 200, 4, 2, 32, 64
    q, k, v = make_qkv(rng, b, s, hq, hkv, d)
    plen = jnp.asarray(plens, jnp.int32)
    o_ref, pm_ref = prefill_attention_with_prompt_mass(
        q, k, v, p, prompt_lens=plen)
    o, pm = flash_prefill_with_prompt_mass(q, k, v, p, prompt_lens=plen,
                                           impl="xla")
    np.testing.assert_allclose(np.asarray(o), np.asarray(o_ref), atol=2e-5)
    np.testing.assert_allclose(np.asarray(pm), np.asarray(pm_ref), atol=2e-5)


def test_mass_from_lse_matches_reference_lse(rng):
    """prompt_mass_from_lse given the exact lse reproduces the dense mass."""
    b, s, hq, hkv, d, p = 1, 96, 4, 1, 16, 24
    q, k, v = make_qkv(rng, b, s, hq, hkv, d)
    scores = jnp.einsum("bqhd,bkhd->bhqk", q,
                        jnp.repeat(k, hq // hkv, axis=2)) / np.sqrt(d)
    causal = jnp.tril(jnp.ones((s, s), bool))
    lse = jax.nn.logsumexp(jnp.where(causal, scores, -jnp.inf), axis=-1)
    pm = fp.prompt_mass_from_lse(q, k, lse, p)
    _, pm_ref = prefill_attention_with_prompt_mass(q, k, v, p)
    np.testing.assert_allclose(np.asarray(pm), np.asarray(pm_ref), atol=1e-5)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (8, 1)])
@pytest.mark.parametrize("d", [64, 128])
def test_triton_modes_match_reference(rng, hq, hkv, d):
    """Square, chunk (rect), positioned and non-causal pair modes of the
    Triton-route kernel (interpret mode) at GQA ratios 1/4/8 and head dims
    64/128, with S = 150 — not a multiple of any block."""
    b, s, p, off = 1, 150, 20, 70
    c = s - off
    q, k, v = make_qkv(rng, b, s, hq, hkv, d)
    o_ref, pm_ref = prefill_attention_with_prompt_mass(q, k, v, p)
    o, pm = flash_prefill_with_prompt_mass(q, k, v, p, impl="triton")
    np.testing.assert_allclose(np.asarray(o), np.asarray(o_ref), atol=2e-5)
    np.testing.assert_allclose(np.asarray(pm), np.asarray(pm_ref), atol=2e-5)

    qc = q[:, off:]
    o_ref, pm_ref = chunk_attention_with_prompt_mass(qc, k, v, jnp.int32(off),
                                                     p)
    o, pm = fp.flash_chunk_attention_with_prompt_mass(qc, k, v,
                                                      jnp.int32(off), p)
    np.testing.assert_allclose(np.asarray(o), np.asarray(o_ref), atol=2e-5)
    np.testing.assert_allclose(np.asarray(pm), np.asarray(pm_ref), atol=2e-5)

    kpos = jnp.asarray(rng.permutation(s)[None].astype(np.int32))
    valid = jnp.asarray(rng.random((b, s)) > 0.3)
    qpos = (off + jnp.arange(c))[None]
    o_ref, pm_ref = positioned_attention_with_prompt_mass(
        qc, k, v, kpos, valid, qpos, p)
    o, _lse, pmh = fp.flash_positioned_attention(
        qc, k, v, jnp.where(valid, kpos, fp.POS_SENTINEL), jnp.int32(off), p)
    np.testing.assert_allclose(np.asarray(o), np.asarray(o_ref), atol=2e-5)
    np.testing.assert_allclose(np.asarray(pmh.mean(axis=1)),
                               np.asarray(pm_ref), atol=2e-5)

    # Non-causal pair: every key visible; mass over the first p keys.
    o, lse, pmh = fp.flash_pair_attention(qc, k, v, jnp.asarray([p]),
                                          causal=False)
    allvis = jnp.ones((b, s), bool)
    o_ref, pm_ref = positioned_attention_with_prompt_mass(
        qc, k, v, jnp.arange(s)[None], allvis, jnp.full((b, c), s), p)
    np.testing.assert_allclose(np.asarray(o), np.asarray(o_ref), atol=2e-5)
    np.testing.assert_allclose(np.asarray(pmh.mean(axis=1)),
                               np.asarray(pm_ref), atol=2e-5)


def test_flash_unpadded_vs_padded_sequence(rng):
    """S not divisible by the block size exercises the masked tail."""
    b, s, hq, hkv, d, p = 1, 192, 2, 2, 32, 24
    q, k, v = make_qkv(rng, b, s, hq, hkv, d)
    o_ref, pm_ref = prefill_attention_with_prompt_mass(q, k, v, p)
    o, pm = flash_prefill_with_prompt_mass(q, k, v, p, impl="triton")
    assert o.shape == (b, s, hq, d)
    np.testing.assert_allclose(np.asarray(o), np.asarray(o_ref), atol=2e-5)
    np.testing.assert_allclose(np.asarray(pm), np.asarray(pm_ref), atol=2e-5)


def test_flash_block_size_invariance(rng):
    b, s, hq, hkv, d, p = 1, 256, 2, 1, 32, 16
    q, k, v = make_qkv(rng, b, s, hq, hkv, d)
    plen = jnp.asarray([p], jnp.int32)
    o1, l1, pm1 = fp._flash(q, k, v, plen, 0, causal=True, block_rows=64,
                            block_k=32)
    o2, l2, pm2 = fp._flash(q, k, v, plen, 0, causal=True, block_rows=128,
                            block_k=64)
    np.testing.assert_allclose(np.asarray(o1), np.asarray(o2), atol=2e-5)
    np.testing.assert_allclose(np.asarray(l1), np.asarray(l2), atol=2e-5)
    np.testing.assert_allclose(np.asarray(pm1), np.asarray(pm2), atol=2e-5)


def test_flash_bf16_inputs(rng):
    b, s, hq, hkv, d, p = 1, 256, 2, 2, 32, 16
    q, k, v = make_qkv(rng, b, s, hq, hkv, d)
    qb, kb, vb = (x.astype(jnp.bfloat16) for x in (q, k, v))
    o, pm = flash_prefill_with_prompt_mass(qb, kb, vb, p)
    o_ref, pm_ref = prefill_attention_with_prompt_mass(qb, kb, vb, p)
    assert o.dtype == jnp.bfloat16
    np.testing.assert_allclose(np.asarray(o.astype(jnp.float32)),
                               np.asarray(o_ref.astype(jnp.float32)),
                               atol=2e-2)
    np.testing.assert_allclose(np.asarray(pm), np.asarray(pm_ref), atol=2e-2)


@pytest.mark.parametrize("impl", ["xla", "triton"])
def test_flash_prompt_mass_full_prompt_sums_to_one(rng, impl):
    """P = S ⇒ every row's prompt mass is its full softmax mass = 1."""
    b, s, hq, hkv, d = 1, 128, 2, 2, 32
    q, k, v = make_qkv(rng, b, s, hq, hkv, d)
    _, pm = flash_prefill_with_prompt_mass(q, k, v, s, impl=impl)
    np.testing.assert_allclose(np.asarray(pm), 1.0, atol=1e-5)


def test_model_prefill_with_flash_matches_dense(rng):
    """prefill_compressed(use_flash=True) == use_flash=False end to end."""
    from realtime_kv_cache_compression_tpu import (CompressionConfig,
                                                   tiny_test_model)
    from realtime_kv_cache_compression_tpu.models import llama

    cfg = tiny_test_model(num_layers=2)
    ccfg = CompressionConfig(num_layers=2)
    params = llama.init_params(jax.random.PRNGKey(0), cfg)
    ids = jax.random.randint(jax.random.PRNGKey(1), (1, 64), 0,
                             cfg.vocab_size)
    l_dense, _, st_d = llama.prefill_compressed(params, ids, cfg, ccfg,
                                                use_flash=False)
    l_flash, _, st_f = llama.prefill_compressed(params, ids, cfg, ccfg,
                                                use_flash=True)
    np.testing.assert_allclose(np.asarray(l_flash), np.asarray(l_dense),
                               atol=5e-4)
    np.testing.assert_allclose(
        np.asarray(st_f[0]["importance_mean"]),
        np.asarray(st_d[0]["importance_mean"]), atol=1e-4)


class TestBackendChoice:
    """Kernels interpret on the CPU, compile on the GPU, and refuse any
    other backend; the square prefill picks its implementation by backend,
    dtype and head_dim, and raises instead of falling back to [S, S]."""

    def test_cpu_interprets(self):
        from realtime_kv_cache_compression_tpu.ops.pallas.backend import (
            interpret_mode)
        assert jax.default_backend() == "cpu"
        assert interpret_mode() is True
        assert fp.square_impl(jnp.bfloat16, 128) == "xla"

    def test_gpu_compiles(self, monkeypatch):
        from realtime_kv_cache_compression_tpu.ops.pallas.backend import (
            interpret_mode)
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        assert interpret_mode() is False
        assert fp.square_impl(jnp.bfloat16, 128) == "cudnn"
        assert fp.square_impl(jnp.float16, 64) == "cudnn"
        assert fp.square_impl(jnp.float32, 128) == "triton"
        assert fp.square_impl(jnp.bfloat16, 256) == "triton"
        with pytest.raises(ValueError):
            fp.square_impl(jnp.float32, 96)

    @pytest.mark.parametrize("backend", ["rocm", "metal"])
    def test_unknown_backend_raises(self, monkeypatch, backend):
        from realtime_kv_cache_compression_tpu.ops.pallas.backend import (
            interpret_mode)
        monkeypatch.setattr(jax, "default_backend", lambda: backend)
        with pytest.raises(NotImplementedError):
            interpret_mode()
        with pytest.raises(NotImplementedError):
            fp.square_impl(jnp.bfloat16, 128)
