"""Card-only tests: the kernels as compiled for the GPU (Triton route,
cuDNN) against the plain references. They skip without a GPU; run them on
the card with `pytest -m gpu tests/`.

References run in float32 at precision HIGHEST (a float32 matmul would
otherwise run in TF32 on the card). Tolerances are for bf16 inputs and
outputs (8 mantissa bits): 2e-2 on attention outputs, 5e-3 on the prompt
mass (a sum of probabilities in [0, 1], accumulated in float32).
"""

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
from realtime_kv_cache_compression_tpu.ops import attention as ref
from realtime_kv_cache_compression_tpu.ops.pallas import flash_prefill as fp
from realtime_kv_cache_compression_tpu.ops.pallas.decode_attention import (
    fused_decode_attention)

pytestmark = pytest.mark.gpu

OUT_TOL = 2e-2
MASS_TOL = 5e-3


def _qkv(seed, b, s, hq, hkv, d, n=None):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    n = n or s
    mk = lambda k, shp: jax.random.normal(k, shp, jnp.float32).astype(
        jnp.bfloat16)
    return (mk(ks[0], (b, s, hq, d)), mk(ks[1], (b, n, hkv, d)),
            mk(ks[2], (b, n, hkv, d)))


def _close(got, want, tol):
    got = np.asarray(jnp.asarray(got, jnp.float32))
    want = np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def _f32(*xs):
    return [x.astype(jnp.float32) for x in xs]


@pytest.mark.parametrize("impl", ["cudnn", "triton"])
@pytest.mark.parametrize("hq,hkv,d", [(32, 8, 128), (32, 4, 64)])
def test_square_prefill_compiled(gpu, impl, hq, hkv, d):
    q, k, v = _qkv(0, 1, 1000, hq, hkv, d)
    o, pm = jax.jit(lambda q, k, v: fp.flash_prefill_with_prompt_mass(
        q, k, v, 128, impl=impl))(q, k, v)
    with jax.default_matmul_precision("highest"):
        o_r, pm_r = ref.prefill_attention_with_prompt_mass(*_f32(q, k, v),
                                                           128)
    _close(o, o_r, OUT_TOL)
    _close(pm, pm_r, MASS_TOL)


def test_chunk_positioned_pair_compiled(gpu):
    hq, hkv, d, n, c, off, p = 32, 8, 128, 1536, 512, 1024, 100
    q, k, v = _qkv(1, 2, c, hq, hkv, d, n=n)
    qf, kf, vf = _f32(q, k, v)
    o, pm = jax.jit(fp.flash_chunk_attention_with_prompt_mass,
                    static_argnums=4)(q, k, v, jnp.int32(off), p)
    with jax.default_matmul_precision("highest"):
        o_r, pm_r = ref.chunk_attention_with_prompt_mass(
            qf, kf, vf, jnp.int32(off), p)
    _close(o, o_r, OUT_TOL)
    _close(pm, pm_r, MASS_TOL)

    kpos = jax.random.permutation(jax.random.PRNGKey(2), n)[None].repeat(
        2, 0).astype(jnp.int32)
    valid = jax.random.uniform(jax.random.PRNGKey(3), (2, n)) > 0.3
    o, _lse, pmh = jax.jit(fp.flash_positioned_attention, static_argnums=5)(
        q, k, v, jnp.where(valid, kpos, fp.POS_SENTINEL), jnp.int32(off), p)
    qpos = jnp.broadcast_to(off + jnp.arange(c)[None], (2, c))
    with jax.default_matmul_precision("highest"):
        o_r, pm_r = ref.positioned_attention_with_prompt_mass(
            qf, kf, vf, kpos, valid, qpos, p)
    _close(o, o_r, OUT_TOL)
    _close(pmh.mean(axis=1), pm_r, MASS_TOL)

    o, _lse, pmh = jax.jit(fp.flash_pair_attention, static_argnums=4)(
        q, k, v, jnp.full((2,), p, jnp.int32), False)
    with jax.default_matmul_precision("highest"):
        o_r, pm_r = ref.positioned_attention_with_prompt_mass(
            qf, kf, vf, jnp.broadcast_to(jnp.arange(n)[None], (2, n)),
            jnp.ones((2, n), bool), jnp.full((2, c), n), p)
    _close(o, o_r, OUT_TOL)
    _close(pmh.mean(axis=1), pm_r, MASS_TOL)


@pytest.mark.parametrize("group", [0, 32])
def test_decode_kernel_compiled(gpu, group):
    mcfg = tiny_test_model(num_heads=32, num_kv_heads=8, head_dim=128,
                           dtype="bfloat16")
    ccfg = CompressionConfig(num_layers=mcfg.num_layers,
                             quant_group_size=group)
    b, s = 2, 2048
    _q, k, v = _qkv(4, b, 1, 32, 8, 128, n=s)
    mass = jax.random.uniform(jax.random.PRNGKey(5), (b, s))
    cache, _ = compress_layer_kv(k, v, mass, 0, ccfg, mcfg)
    recent = init_recent_cache(b, 16, mcfg)
    for i in range(5):
        kn, vn = (x[:, i:i + 1] for x in (k, v))
        recent = append_recent(recent, kn, vn, jnp.full((b, 1), s + i))
    q = jax.random.normal(jax.random.PRNGKey(6), (b, 1, 32, 128),
                          jnp.float32).astype(jnp.bfloat16)
    q_pos = jnp.full((b, 1), s + 5, jnp.int32)
    out = jax.jit(lambda q, c, r: fused_decode_attention(q, c, r, q_pos,
                                                         ccfg))(
        q, cache, recent)
    with jax.default_matmul_precision("highest"):
        k_c, v_c, pos_c, valid_c = dequantize_layer_cache(cache, ccfg,
                                                          jnp.float32)
        live = jnp.arange(16)[None] < recent.length[:, None]
        want = ref.attention_over_tokens(
            q.astype(jnp.float32),
            jnp.concatenate([k_c, recent.k.astype(jnp.float32)], 1),
            jnp.concatenate([v_c, recent.v.astype(jnp.float32)], 1),
            jnp.concatenate([pos_c, recent.positions], 1),
            jnp.concatenate([valid_c, live], 1), q_pos)
    _close(out, want, OUT_TOL)


def test_model_paths_compiled(gpu):
    """bf16 model: flash prefill == dense prefill, fused decode == XLA
    decode, and forward_logits through cuDNN == dense."""
    cfg = tiny_test_model(num_layers=2, num_heads=8, num_kv_heads=2,
                          head_dim=64, hidden_size=256, intermediate_size=512,
                          dtype="bfloat16")
    ccfg = CompressionConfig(num_layers=2)
    params = llama.init_params(jax.random.PRNGKey(0), cfg)
    ids = jax.random.randint(jax.random.PRNGKey(1), (2, 256), 0,
                             cfg.vocab_size)
    l_f, st, _ = jax.jit(lambda p, i: llama.prefill_compressed(
        p, i, cfg, ccfg, max_decode_len=8, use_flash=True))(params, ids)
    l_d, _ = jax.jit(lambda p, i: llama.prefill_uncompressed(p, i, cfg))(
        params, ids)
    _close(l_f, l_d, 5e-2)
    tok = jnp.argmax(l_f, axis=-1)
    step = jax.jit(lambda p, t, s, f: llama.decode_step(
        p, t, s, cfg, ccfg, use_fused=f), static_argnums=3)
    _close(step(params, tok, st, True)[0], step(params, tok, st, False)[0],
           5e-2)
    lf = jax.jit(lambda p, i: llama.forward_logits(p, i, cfg,
                                                   use_flash=True))(params,
                                                                    ids)
    ld = jax.jit(lambda p, i: llama.forward_logits(p, i, cfg))(params, ids)
    _close(lf, ld, 5e-2)
