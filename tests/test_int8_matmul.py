"""W8A8 int8 x int8 matmul (XLA dot_general with int32 accumulation)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from realtime_kv_cache_compression_tpu import (CompressionConfig,
                                               tiny_test_model)
from realtime_kv_cache_compression_tpu.models import llama
from realtime_kv_cache_compression_tpu.models.quantized_params import (
    quantize_params, quantize_tensor)
from realtime_kv_cache_compression_tpu.ops.int8_matmul import (
    dynamic_int8_matmul, int8_matmul, quantize_activations)


@pytest.mark.parametrize("m,k,n", [(24, 128, 256), (1, 4096, 96),
                                   (7, 100, 33)])
def test_int8_matmul_exact_integer_accumulation(rng, m, k, n):
    """The int32 accumulation is exact: it matches an int64 numpy product
    scaled per row and column."""
    x_q = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    w_q = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    xs = rng.random(m).astype(np.float32) + 0.01
    ws = rng.random(n).astype(np.float32) + 0.01
    want = (x_q.astype(np.int64) @ w_q.astype(np.int64)).astype(np.float32)
    want = want * xs[:, None] * ws[None, :]
    out = int8_matmul(jnp.asarray(x_q), jnp.asarray(w_q), jnp.asarray(xs),
                      jnp.asarray(ws), out_dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-6, atol=1e-6)


def test_dynamic_matmul_approximates_dense(rng):
    """Activation + weight int8 quantization stays close to the f32 matmul
    (relative error bounded by the two quantization steps)."""
    x = jnp.asarray(rng.normal(size=(8, 64)).astype(np.float32))
    w = jnp.asarray(rng.normal(size=(64, 128)).astype(np.float32))
    qt = quantize_tensor(w, axis=1)
    ref = x @ w
    out = dynamic_int8_matmul(x, qt.q, qt.scale)
    err = np.abs(np.asarray(out, np.float32) - np.asarray(ref))
    scale = np.abs(np.asarray(ref)).mean()
    assert err.mean() / scale < 0.02, (err.mean(), scale)


def test_dynamic_matmul_leading_dims(rng):
    """[..., K] activations keep their leading dims and dtype."""
    x = jnp.asarray(rng.normal(size=(2, 3, 64)).astype(np.float32))
    qt = quantize_tensor(jnp.asarray(rng.normal(size=(64, 48)), jnp.float32),
                         axis=1)
    out = dynamic_int8_matmul(x.astype(jnp.bfloat16), qt.q, qt.scale)
    assert out.shape == (2, 3, 48) and out.dtype == jnp.bfloat16
    flat = dynamic_int8_matmul(x.reshape(6, 64).astype(jnp.bfloat16), qt.q,
                               qt.scale)
    np.testing.assert_array_equal(np.asarray(out.reshape(6, 48), np.float32),
                                  np.asarray(flat, np.float32))


def test_quantize_activations_roundtrip(rng):
    x = jnp.asarray(rng.normal(size=(4, 32)).astype(np.float32))
    x_q, s = quantize_activations(x)
    recon = np.asarray(x_q, np.float32) * np.asarray(s)[:, None]
    assert np.abs(recon - np.asarray(x)).max() <= float(s.max()) / 2 + 1e-6


def test_act_quant_model_logits_close(rng):
    """Full model with act_quant int8 matmuls: logits close to the
    weight-only int8 path; generation runs end-to-end."""
    mcfg = tiny_test_model(num_layers=2)
    ccfg = CompressionConfig(num_layers=2)
    params = llama.init_params(jax.random.PRNGKey(0), mcfg)
    qp_w = quantize_params(params)                  # weight-only
    qp_a = quantize_params(params, act_quant=True)  # + activation int8
    ids = jax.random.randint(jax.random.PRNGKey(1), (1, 64), 0,
                             mcfg.vocab_size)
    lw, _, _ = llama.prefill_compressed(params, ids, mcfg, ccfg,
                                        max_decode_len=4)
    la, _, _ = llama.prefill_compressed(qp_a, ids, mcfg, ccfg,
                                        max_decode_len=4)
    # Same top-k structure: compare normalized logits, loose tolerance
    # (two quantization steps over 2 layers).
    lw_n = np.asarray(lw, np.float32)
    la_n = np.asarray(la, np.float32)
    corr = np.corrcoef(lw_n.ravel(), la_n.ravel())[0, 1]
    assert corr > 0.99, corr

    out, _ = llama.generate(qp_a, ids, mcfg, ccfg, max_new_tokens=4)
    assert out.shape == (1, 4)
