"""W8A8 matmul: int8 activations x int8 weights -> int32, scaled on the way
out.

North-star "quantized-inference engine" path (ARCHITECTURE round-2 item 3):
weight-only int8 (models/quantized_params.py) already halves weight
streaming; `act_quant=True` additionally quantizes the *activations* per
row (symmetric, absmax/127) so the product itself runs int8 x int8 -> int32
— on the H100 XLA hands that `dot_general` to cuBLASLt's int8 tensor-core
GEMM — and applies the per-row x per-channel scales on the way out.

y[m, n] = (sum_k x_q[m, k] * w_q[k, n]) * x_scale[m] * w_scale[n]

The reference has no counterpart (its quantization never touched the
compute path — fake-quant only, dynamic_quantization.py:120-126).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

Array = jax.Array


def quantize_activations(x: Array) -> Tuple[Array, Array]:
    """Per-row symmetric int8: x ~ x_q * scale. x: [..., K]."""
    xf = x.astype(jnp.float32)
    absmax = jnp.max(jnp.abs(xf), axis=-1, keepdims=True)
    scale = jnp.maximum(absmax, 1e-8) / 127.0
    x_q = jnp.clip(jnp.round(xf / scale), -127, 127).astype(jnp.int8)
    return x_q, scale[..., 0]


def int8_matmul(x_q: Array, w_q: Array, x_scale: Array, w_scale: Array,
                out_dtype=jnp.bfloat16) -> Array:
    """[M, K] int8 @ [K, N] int8 -> [M, N] out_dtype, scaled per
    row/channel (int32 accumulation)."""
    acc = jax.lax.dot_general(
        x_q, w_q, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32).astype(jnp.float32)
    return (acc * x_scale[:, None] * w_scale[None, :]).astype(out_dtype)


def dynamic_int8_matmul(x: Array, w_q: Array, w_scale: Array) -> Array:
    """bf16/f32 activations [..., K] x int8 weights [K, N] via an int8 GEMM.

    Quantizes activations per token on the fly (one elementwise pass XLA
    fuses with the producer), then runs the int8 x int8 matmul.
    """
    lead = x.shape[:-1]
    k = x.shape[-1]
    x_q, x_scale = quantize_activations(x.reshape(-1, k))
    y = int8_matmul(x_q, w_q, x_scale, w_scale, out_dtype=x.dtype)
    return y.reshape(*lead, w_q.shape[1])
