"""Llama-family decoder in pure JAX with real-time prefill KV compression.

Capability parity with the reference model-integration layer
(/root/reference/src/models/modified_llama.py):
  * `CompressedLlamaAttention` (:13-168) → `_attention_block` +
    `prefill_compressed` — compression runs per layer during prefill
    (q_len > 1) only; decode attends to the compressed survivors.
  * `CompressedLlamaDecoderLayer`/`CompressedLlamaForCausalLM` (:170-339) →
    functional `prefill_*` / `decode_step` over a params pytree.
  * `create_compressed_llama_model` (:349-386) → `init_params` (random) and
    `models/weights.py` (HF safetensors loading).

Redesign notes:
  * No nn.Module state; params are a pytree, every step is jit-able, layers
    unroll at trace time (per-layer tier capacities are static and differ by
    layer group, so a uniform `lax.scan` over layers is not applicable).
  * GQA via `num_kv_heads` (the reference is MHA-only).
  * Prefill attention uses the prompt-mass side-channel instead of
    materializing [B, H, S, S] (modified_llama.py:88); with
    `use_flash=True` flash attention computes both (ops/pallas/
    flash_prefill.py).
  * Decode attends over packed tier pools + an uncompressed recent ring with
    exact original-position causality (fixes modified_llama.py:132-134).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp

from ..compression.compressor import compress_layer_kv, dequantize_layer_cache
from ..compression.kv_cache import (CompressedLayerCache, DecodePool,
                                    RecentCache, append_recent,
                                    dequantize_decode_pool, flush_recent,
                                    init_decode_pool, init_recent_cache)
from ..config import CompressionConfig, ModelConfig
from ..ops.attention import (attention_over_tokens,
                             prefill_attention_with_prompt_mass)
from ..ops.sampling import (SamplingParams, init_counts, sample_logits,
                            update_counts)

Array = jax.Array
Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Parameter initialization
# ---------------------------------------------------------------------------

def init_params(key: Array, cfg: ModelConfig) -> Params:
    """Random-init params pytree (for tests/benchmarks; real weights via
    weights.load_hf_checkpoint)."""
    dtype = jnp.dtype(cfg.dtype)
    h, qd, kvd, i = (cfg.hidden_size, cfg.q_dim, cfg.kv_dim,
                     cfg.intermediate_size)
    keys = iter(jax.random.split(key, 4 + 10 * cfg.num_layers))

    def dense(k, fan_in, shape):
        return (jax.random.normal(k, shape, jnp.float32)
                * (fan_in ** -0.5)).astype(dtype)

    layers = []
    for _ in range(cfg.num_layers):
        layer = {
            "wq": dense(next(keys), h, (h, qd)),
            "wk": dense(next(keys), h, (h, kvd)),
            "wv": dense(next(keys), h, (h, kvd)),
            "wo": dense(next(keys), qd, (qd, h)),
            "input_norm": jnp.ones((h,), dtype),
            "post_norm": jnp.ones((h,), dtype),
        }
        if cfg.num_experts:  # Mixtral-style sparse MLP (ops/moe.py)
            layer["moe"] = {
                "gate": dense(next(keys), h, (h, cfg.num_experts)),
                "w_gate": dense(next(keys), h, (cfg.num_experts, h, i)),
                "w_up": dense(next(keys), h, (cfg.num_experts, h, i)),
                "w_down": dense(next(keys), i, (cfg.num_experts, i, h)),
            }
        else:
            layer.update({
                "w_gate": dense(next(keys), h, (h, i)),
                "w_up": dense(next(keys), h, (h, i)),
                "w_down": dense(next(keys), i, (i, h)),
            })
        if cfg.qkv_bias:  # random (not zero) so tests exercise the adds
            layer["bq"] = dense(next(keys), h, (qd,))
            layer["bk"] = dense(next(keys), h, (kvd,))
            layer["bv"] = dense(next(keys), h, (kvd,))
        layers.append(layer)
    params = {
        "embed": dense(next(keys), h, (cfg.vocab_size, h)),
        "layers": layers,
        "final_norm": jnp.ones((h,), dtype),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense(next(keys), h, (h, cfg.vocab_size))
    return params


def _concat_weights(ws, axis=1):
    """Concatenate matmul weights along the OUT axis — raw arrays or
    quantized leaves (per-out-channel int8 / grouped int4 both keep their
    scales per output column, so concatenation is numerically identical to
    running the matmuls separately)."""
    from .quantized_params import Int4Tensor, QuantizedTensor

    w0 = ws[0]
    if isinstance(w0, QuantizedTensor):
        assert all(w.axis == 1 for w in ws)
        return QuantizedTensor(
            q=jnp.concatenate([w.q for w in ws], axis=1),
            scale=jnp.concatenate([w.scale for w in ws], axis=0),
            axis=1, act_quant=w0.act_quant)
    if isinstance(w0, Int4Tensor):
        assert all(w.in_dim == w0.in_dim
                   and w.group_size == w0.group_size for w in ws)
        return Int4Tensor(
            q_packed=jnp.concatenate([w.q_packed for w in ws], axis=1),
            scale=jnp.concatenate([w.scale for w in ws], axis=1),
            in_dim=w0.in_dim)
    return jnp.concatenate(ws, axis=axis)


def fuse_params(params: Params) -> Params:
    """Fuse each layer's QKV projections into one `wqkv` and gate/up into
    one `w_gateup` matmul weight (dense layers only; MoE layers untouched).

    Batch-1 decode is weight-streaming-bound and each of the 7 per-layer
    matmuls carries fixed dispatch/epilogue overhead; fusing 3+2 of them
    into 2 larger dots removes ~40% of that overhead. Each output
    column's math and per-column quantization scales are unchanged, so
    results match to dot-reassociation tolerance (XLA may re-block the
    wider reduction; ~1e-6 relative) and greedy decode tokens are
    identical in practice (tests/test_quantized_weights.py).

    Works on raw bf16 trees and on already-quantized trees (int8/int4) —
    `_qkv`/`_mlp` dispatch on the fused key names. NOTE: the fused layout
    is for single-device / data-parallel serving; tensor-parallel sharding
    specs address the unfused names (parallel/sharding.py).
    """
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = []
    for layer in params["layers"]:
        lo = dict(layer)
        if "wq" in lo and "moe" not in lo:
            lo["wqkv"] = _concat_weights([lo.pop("wq"), lo.pop("wk"),
                                          lo.pop("wv")])
            if "bq" in lo:
                lo["bqkv"] = jnp.concatenate([lo.pop("bq"), lo.pop("bk"),
                                              lo.pop("bv")])
        if "w_gate" in lo and "moe" not in lo:
            lo["w_gateup"] = _concat_weights([lo.pop("w_gate"),
                                              lo.pop("w_up")])
        out["layers"].append(lo)
    return out


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def _matmul(x: Array, w) -> Array:
    """x @ w for raw, int8-, or int4-quantized weights.

    For `QuantizedTensor` (axis=1, per-out-channel), the int8 operand is
    converted inside the dot's operand stream, then the f32 scale is
    applied to the [..., out] result. With `act_quant`, activations
    quantize per token and the product runs int8 x int8
    (ops/int8_matmul.py).

    For `Int4Tensor` (group-wise scales along the reduction axis), the
    grouped-einsum form below: unpack, per-group dot, scale, sum over
    groups. Whether XLA keeps the unpack in the dot's operand stream or
    materializes the unpacked weight is recorded in PERF.md.
    """
    from .quantized_params import Int4Tensor, QuantizedTensor

    if isinstance(w, QuantizedTensor):
        if w.act_quant and w.axis == 1:
            from ..ops.int8_matmul import dynamic_int8_matmul
            return dynamic_int8_matmul(x, w.q, w.scale)
        y = jnp.dot(x, w.q.astype(x.dtype),
                    preferred_element_type=jnp.float32)
        return (y * w.scale[None, :]).astype(x.dtype)
    if isinstance(w, Int4Tensor):
        n_g = w.scale.shape[0]
        if n_g == 1:
            y = jnp.dot(x, w.unpack_codes().astype(x.dtype),
                        preferred_element_type=jnp.float32)
            return (y * w.scale[0][None, :]).astype(x.dtype)
        g = w.group_size
        out_dim = w.q_packed.shape[-1]
        codes = w.unpack_codes().astype(x.dtype).reshape(n_g, g, out_dim)
        lead = x.shape[:-1]
        xg = x.reshape(*lead, n_g, g)
        y = jnp.einsum("...gi,gio->...go", xg, codes,
                       preferred_element_type=jnp.float32)
        y = (y * w.scale.reshape((1,) * len(lead) + (n_g, out_dim))
             ).sum(axis=-2)
        return y.astype(x.dtype)
    return x @ w


def _embed_lookup(embed, input_ids: Array, dtype, cfg=None) -> Array:
    from .quantized_params import QuantizedTensor

    if isinstance(embed, QuantizedTensor):
        rows = embed.q[input_ids].astype(jnp.float32)
        out = (rows * embed.scale[input_ids][..., None]).astype(dtype)
    else:
        out = embed[input_ids].astype(dtype)
    if cfg is not None and cfg.scale_embeddings:
        # Gemma scales embeddings by sqrt(hidden) in the model dtype. The
        # scale must live HERE, not in the weights: the tied LM head reads
        # the same matrix unscaled.
        out = out * jnp.asarray(cfg.hidden_size ** 0.5, dtype)
    return out


def rmsnorm(x: Array, w: Array, eps: float) -> Array:
    xf = x.astype(jnp.float32)
    var = jnp.mean(xf * xf, axis=-1, keepdims=True)
    return (xf * jax.lax.rsqrt(var + eps)).astype(x.dtype) * w


def rope_tables(positions: Array, head_dim: int, theta: float,
                scaling=None) -> Tuple[Array, Array]:
    """cos/sin tables at given positions. positions: [B, S] → [B, S, D/2].

    scaling: optional config.RopeScaling — "linear" divides all frequencies
    by `factor`; "llama3" is the Llama-3.1 scheme (HF rope_type "llama3"):
    wavelengths past original_max_position/low_freq_factor divide by
    `factor`, wavelengths under original_max_position/high_freq_factor stay,
    with a smooth ramp in between.
    """
    inv_freq = 1.0 / (theta ** (jnp.arange(0, head_dim, 2,
                                           dtype=jnp.float32) / head_dim))
    if scaling is not None:
        if scaling.kind == "linear":
            inv_freq = inv_freq / scaling.factor
        elif scaling.kind == "llama3":
            wavelen = 2.0 * jnp.pi / inv_freq
            low_wl = scaling.original_max_position / scaling.low_freq_factor
            high_wl = (scaling.original_max_position
                       / scaling.high_freq_factor)
            smooth = ((scaling.original_max_position / wavelen
                       - scaling.low_freq_factor)
                      / (scaling.high_freq_factor - scaling.low_freq_factor))
            smooth = jnp.clip(smooth, 0.0, 1.0)
            blended = ((1.0 - smooth) * inv_freq / scaling.factor
                       + smooth * inv_freq)
            inv_freq = jnp.where(wavelen > low_wl, inv_freq / scaling.factor,
                                 jnp.where(wavelen < high_wl, inv_freq,
                                           blended))
        else:
            raise ValueError(f"unknown rope scaling kind {scaling.kind!r}")
    angles = positions.astype(jnp.float32)[..., None] * inv_freq  # [B,S,D/2]
    return jnp.cos(angles), jnp.sin(angles)


def apply_rope(x: Array, cos: Array, sin: Array) -> Array:
    """Half-split RoPE (HF Llama convention). x: [B, S, H, D]."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return jnp.concatenate([out1, out2], axis=-1).astype(x.dtype)


def _qkv(layer: Params, x: Array, cfg: ModelConfig
         ) -> Tuple[Array, Array, Array]:
    b, s, _ = x.shape
    if "wqkv" in layer:  # fused projection (fuse_params) — one dot
        qkv = _matmul(x, layer["wqkv"])
        if "bqkv" in layer:
            qkv = qkv + layer["bqkv"]
        q = qkv[..., :cfg.q_dim]
        k = qkv[..., cfg.q_dim:cfg.q_dim + cfg.kv_dim]
        v = qkv[..., cfg.q_dim + cfg.kv_dim:]
    else:
        q = _matmul(x, layer["wq"])
        k = _matmul(x, layer["wk"])
        v = _matmul(x, layer["wv"])
        if "bq" in layer:  # Qwen2-style projection biases (cfg.qkv_bias)
            q = q + layer["bq"]
            k = k + layer["bk"]
            v = v + layer["bv"]
    return (q.reshape(b, s, cfg.num_heads, cfg.head_dim),
            k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim),
            v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim))


def _act(x: Array, name: str) -> Array:
    if name == "silu":
        return jax.nn.silu(x)
    if name == "gelu_tanh":  # HF "gelu_pytorch_tanh" (Gemma)
        return jax.nn.gelu(x, approximate=True)
    raise ValueError(f"unknown hidden_act {name!r}")


def _mlp(layer: Params, x: Array, cfg: Optional[ModelConfig] = None) -> Array:
    if "moe" in layer:  # Mixtral-style sparse MLP
        from ..ops.moe import moe_mlp
        return moe_mlp(layer["moe"], x, cfg)
    act = cfg.hidden_act if cfg is not None else "silu"
    if "w_gateup" in layer:  # fused gate|up projection (fuse_params)
        gu = _matmul(x, layer["w_gateup"])
        i = gu.shape[-1] // 2
        return _matmul(_act(gu[..., :i], act) * gu[..., i:],
                       layer["w_down"])
    return _matmul(_act(_matmul(x, layer["w_gate"]), act)
                   * _matmul(x, layer["w_up"]), layer["w_down"])


def logits_from_hidden(params: Params, h: Array, cfg: ModelConfig) -> Array:
    from .quantized_params import QuantizedTensor

    h = rmsnorm(h, params["final_norm"], cfg.rms_norm_eps)
    if cfg.tie_word_embeddings:
        embed = params["embed"]
        if isinstance(embed, QuantizedTensor):
            y = jnp.dot(h, embed.q.T.astype(h.dtype),
                        preferred_element_type=jnp.float32)
            return (y * embed.scale[None, :]).astype(h.dtype)
        return h @ embed.T
    return _matmul(h, params["lm_head"])


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass
class DecodeState:
    """Everything decode needs: per-layer compressed pools + recent rings
    (+ optional quantized decode pools for generations past the ring)."""

    caches: Tuple[CompressedLayerCache, ...]
    recents: Tuple[RecentCache, ...]
    position: Array  # [B] next position index
    # One DecodePool per layer when ccfg.decode_pool_blocks > 0, else Nones.
    pools: Tuple[Optional[DecodePool], ...] = ()


def _prefill_attention(q, k, v, prompt_len, use_flash, prompt_lens=None):
    if use_flash:
        from ..ops.pallas.flash_prefill import flash_prefill_with_prompt_mass
        return flash_prefill_with_prompt_mass(q, k, v, prompt_len,
                                              prompt_lens=prompt_lens)
    return prefill_attention_with_prompt_mass(q, k, v, prompt_len,
                                              prompt_lens=prompt_lens)


def prefill_layers_compressed(
    layer_params: List[Params],
    layer_offset: int,
    h: Array,
    positions: Array,
    cos: Array,
    sin: Array,
    prompt_len: int,
    cfg: ModelConfig,
    ccfg: CompressionConfig,
    max_decode_len: int,
    use_flash: bool = False,
    token_valid: Optional[Array] = None,
    prompt_lens: Optional[Array] = None,
):
    """Compressed prefill over a contiguous range of layers.

    The per-layer body of `prefill_compressed`, factored so pipeline stages
    (parallel/pipeline.py) can run their own layer slice over incoming
    hidden states. `layer_offset` is the global index of layer_params[0]
    (layer-group ratios and layer weights depend on absolute depth).

    Returns (h, caches, recents, pools, stats) for the given layers.
    """
    b, s = h.shape[:2]
    caches, recents, pools, all_stats = [], [], [], []
    need_qmass = ccfg.importance_source != "prompt"
    lengths = (token_valid.sum(axis=-1).astype(jnp.int32)
               if (need_qmass and token_valid is not None) else None)
    for i, layer in enumerate(layer_params):
        layer_idx = layer_offset + i
        x = rmsnorm(h, layer["input_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(layer, x, cfg)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        attn_out, prompt_mass = _prefill_attention(q, k, v, prompt_len,
                                                   use_flash, prompt_lens)
        qmass = None
        if need_qmass:
            # Observation-window side-channel (config.importance_source):
            # attention each token receives from the last-W queries — the
            # signal that finds needle-at-depth content. Dense but tiny:
            # W x S per head vs prefill's S x S-equivalent flash work.
            from ..ops.attention import query_attention_mass
            qmass = query_attention_mass(
                q, k, ccfg.query_window_for(s), lengths=lengths,
                pool=ccfg.query_mass_pool)

        cache, stats = compress_layer_kv(k, v, prompt_mass, layer_idx, ccfg,
                                         cfg, token_valid=token_valid,
                                         prompt_lens=prompt_lens,
                                         query_mass=qmass)
        caches.append(cache)
        all_stats.append(stats)
        recents.append(init_recent_cache(b, max_decode_len, cfg))
        pools.append(init_decode_pool(b, max_decode_len, ccfg, cfg))

        if ccfg.recompute_prefill_attention:
            # Reference-parity mode (modified_llama.py:125-140): the prefill
            # output itself is recomputed against compressed K/V — here with
            # exact survivor positions instead of a truncated mask.
            k_d, v_d, pos_c, valid = dequantize_layer_cache(cache, ccfg,
                                                            jnp.float32)
            attn_out = attention_over_tokens(
                q, k_d.astype(q.dtype), v_d.astype(q.dtype), pos_c, valid,
                positions)

        h = h + _matmul(attn_out.reshape(b, s, cfg.q_dim), layer["wo"])
        x2 = rmsnorm(h, layer["post_norm"], cfg.rms_norm_eps)
        h = h + _mlp(layer, x2, cfg)
    return h, caches, recents, pools, all_stats


def prefill_compressed(
    params: Params,
    input_ids: Array,
    cfg: ModelConfig,
    ccfg: CompressionConfig,
    max_decode_len: int = 128,
    use_flash: bool = False,
    lengths: Optional[Array] = None,
    mesh=None,
) -> Tuple[Array, DecodeState, List[Dict[str, Array]]]:
    """Full-sequence prefill with per-layer real-time KV compression.

    Args:
      lengths: optional [B] true sequence lengths for ragged batches
        (sequences left-aligned, padded to the bucket on the right). Causal
        masking already isolates real queries from padding keys; compression
        additionally never stores padding tokens, and last-position logits /
        decode positions follow the true lengths.
      mesh: optional jax.sharding.Mesh — when given, the returned decode
        state's layout is *committed* to the mesh (tier pools, rings and
        decode pools sharded P(data, None, model, None); positions/validity
        replicated over `model`) via sharding constraints, rather than left
        to GSPMD propagation.

    Returns (logits for the last position [B, V], decode state, per-layer
    compression stats).
    """
    b, s = input_ids.shape
    prompt_len = ccfg.prompt_length(s)
    h = _embed_lookup(params["embed"], input_ids, jnp.dtype(cfg.dtype),
                      cfg=cfg)
    positions = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
    if lengths is not None:
        token_valid = positions < lengths[:, None]
        # Reference heuristic per row: max(1, min(len * frac, cap))
        # (unified_compressor.py:55), dynamic over the ragged batch.
        prompt_lens = jnp.clip(
            (lengths.astype(jnp.float32) * ccfg.prompt_frac).astype(jnp.int32),
            1, prompt_len)
    else:
        token_valid = None
        prompt_lens = None
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta,
            cfg.rope_scaling)

    h, caches, recents, pools, all_stats = prefill_layers_compressed(
        params["layers"], 0, h, positions, cos, sin, prompt_len, cfg, ccfg,
        max_decode_len, use_flash=use_flash, token_valid=token_valid,
        prompt_lens=prompt_lens)

    if lengths is not None:
        last_h = jnp.take_along_axis(
            h, (lengths - 1)[:, None, None].astype(jnp.int32), axis=1)[:, 0]
        end_pos = lengths.astype(jnp.int32)
    else:
        last_h = h[:, -1]
        end_pos = jnp.full((b,), s, jnp.int32)
    logits = logits_from_hidden(params, last_h, cfg)
    state = DecodeState(caches=tuple(caches), recents=tuple(recents),
                        position=end_pos, pools=tuple(pools))
    if mesh is not None:
        from ..parallel.sharding import constrain_decode_state
        state = constrain_decode_state(state, mesh)
    return logits, state, all_stats


def forward_logits(params: Params, input_ids: Array, cfg: ModelConfig,
                   use_flash: bool = False) -> Array:
    """All-position logits [B, S, V] (no KV cache; training/eval scoring).

    With use_flash=True, attention runs through
    `jax.nn.dot_product_attention(is_causal=True)` — cuDNN's fused flash
    attention on the GPU (GQA-native, with a VJP, so training scales past
    dense-attention context lengths); XLA's form on the CPU.
    """
    b, s = input_ids.shape
    h = _embed_lookup(params["embed"], input_ids, jnp.dtype(cfg.dtype),
                      cfg=cfg)
    positions = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta,
            cfg.rope_scaling)
    for layer in params["layers"]:
        x = rmsnorm(h, layer["input_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(layer, x, cfg)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if use_flash:
            from ..ops.pallas.flash_prefill import square_impl

            impl = square_impl(q.dtype, cfg.head_dim)
            if impl == "triton":
                raise ValueError(
                    f"forward_logits(use_flash=True) needs bf16/fp16 with "
                    f"head_dim <= 128 on the GPU (cuDNN); got "
                    f"{q.dtype}/{cfg.head_dim}")
            attn_out = jax.nn.dot_product_attention(
                q, k, v, is_causal=True, implementation=impl)
        else:
            attn_out, _ = prefill_attention_with_prompt_mass(q, k, v, 1)
        h = h + _matmul(attn_out.reshape(b, s, cfg.q_dim), layer["wo"])
        h = h + _mlp(layer, rmsnorm(h, layer["post_norm"], cfg.rms_norm_eps),
                     cfg)
    return logits_from_hidden(params, h, cfg)


def prefill_uncompressed(
    params: Params,
    input_ids: Array,
    cfg: ModelConfig,
    lengths: Optional[Array] = None,
    use_flash: bool = False,
) -> Tuple[Array, Tuple[Array, Array]]:
    """Vanilla prefill (baseline arm). Returns (last-pos logits, (K, V))
    with K/V stacked over layers: [L, B, S, H_kv, D]. With `lengths`,
    right-padded ragged batches gather logits at the true last position
    (padding keys are isolated by causality; decode overwrites pad slots)."""
    b, s = input_ids.shape
    h = _embed_lookup(params["embed"], input_ids, jnp.dtype(cfg.dtype),
                      cfg=cfg)
    positions = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta,
            cfg.rope_scaling)
    ks, vs = [], []
    for layer in params["layers"]:
        x = rmsnorm(h, layer["input_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(layer, x, cfg)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        attn_out, _ = _prefill_attention(q, k, v, 1, use_flash)
        ks.append(k)
        vs.append(v)
        h = h + _matmul(attn_out.reshape(b, s, cfg.q_dim), layer["wo"])
        h = h + _mlp(layer, rmsnorm(h, layer["post_norm"], cfg.rms_norm_eps),
                     cfg)
    if lengths is not None:
        last_h = jnp.take_along_axis(
            h, (lengths - 1)[:, None, None].astype(jnp.int32), axis=1)[:, 0]
    else:
        last_h = h[:, -1]
    logits = logits_from_hidden(params, last_h, cfg)
    return logits, (jnp.stack(ks), jnp.stack(vs))


# ---------------------------------------------------------------------------
# Chunked prefill (serving: interleaves prompt processing with decode)
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ChunkedPrefillState:
    """Carry between prefill chunks: per-layer K/V buffers filled up to
    `offset`, the per-layer prompt-mass side-channel, and the hidden state
    at each row's final position (captured by the chunk containing it).
    With query-guided importance (config.importance_source != "prompt"),
    `q_tails` additionally buffers each layer's observation-window query
    rows (the last W valid positions per row) so the finish pass can
    compute the query mass against the completed K buffers."""

    k_bufs: Tuple[Array, ...]   # per layer [B, S, H_kv, D]
    v_bufs: Tuple[Array, ...]
    masses: Tuple[Array, ...]   # per layer [B, S] float32
    last_h: Array               # [B, hidden]
    offset: Array               # scalar int32: next write position
    q_tails: Tuple[Array, ...] = ()  # per layer [B, W, H_q, D] (optional)


def prefill_chunked_init(batch: int, seq_len: int, cfg: ModelConfig,
                         ccfg: Optional[CompressionConfig] = None
                         ) -> ChunkedPrefillState:
    """Zero-initialized chunked-prefill carry for a [batch, seq_len] bucket.

    `ccfg` is needed only when it selects query-guided importance (the
    carry then includes the per-layer observation-window query buffers)."""
    dtype = jnp.dtype(cfg.dtype)
    kv = lambda: jnp.zeros((batch, seq_len, cfg.num_kv_heads, cfg.head_dim),
                           dtype)
    q_tails = ()
    if ccfg is not None and ccfg.importance_source != "prompt":
        w = ccfg.query_window_for(seq_len)
        q_tails = tuple(
            jnp.zeros((batch, w, cfg.num_heads, cfg.head_dim), dtype)
            for _ in range(cfg.num_layers))
    return ChunkedPrefillState(
        k_bufs=tuple(kv() for _ in range(cfg.num_layers)),
        v_bufs=tuple(kv() for _ in range(cfg.num_layers)),
        masses=tuple(jnp.zeros((batch, seq_len), jnp.float32)
                     for _ in range(cfg.num_layers)),
        last_h=jnp.zeros((batch, cfg.hidden_size), dtype),
        offset=jnp.zeros((), jnp.int32),
        q_tails=q_tails,
    )


def prefill_chunked_step(
    params: Params,
    chunk_ids: Array,
    st: ChunkedPrefillState,
    cfg: ModelConfig,
    ccfg: CompressionConfig,
    lengths: Optional[Array] = None,
    use_flash: bool = False,
) -> ChunkedPrefillState:
    """Advance the prefill by one chunk of tokens.

    The chunk's offset is carried in the state (traced), so ONE compiled
    program serves every chunk of a bucket — the serving engine dispatches
    it between decode chunks to bound head-of-line blocking by the chunk
    time instead of the full-prompt time (vLLM-style chunked prefill).
    Per-row softmax over the position-ordered buffer is identical to
    full-sequence causal attention, so caches, masses, and logits match the
    one-shot `prefill_compressed` (ops.attention.chunk_attention docstring).

    use_flash routes the chunk attention through the rectangular flash
    kernel (ops/pallas/flash_prefill.flash_chunk_attention_with_prompt_mass)
    — required at long contexts: the dense form materializes [c, S] float32
    scores per query head (16 GiB per layer for a 4K chunk over a 32K
    buffer at Mistral-7B widths).
    """
    if use_flash:
        from ..ops.pallas.flash_prefill import (
            flash_chunk_attention_with_prompt_mass as
            chunk_attention_with_prompt_mass)
    else:
        from ..ops.attention import chunk_attention_with_prompt_mass

    b, c = chunk_ids.shape
    s_total = st.k_bufs[0].shape[1]
    prompt_len = ccfg.prompt_length(s_total)
    prompt_lens = None
    if lengths is not None:
        prompt_lens = jnp.clip(
            (lengths.astype(jnp.float32) * ccfg.prompt_frac).astype(
                jnp.int32), 1, prompt_len)

    h = _embed_lookup(params["embed"], chunk_ids, jnp.dtype(cfg.dtype),
                      cfg=cfg)
    q_pos = st.offset + jnp.arange(c)
    positions = jnp.broadcast_to(q_pos[None], (b, c))
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                           cfg.rope_scaling)

    k_bufs, v_bufs, masses, q_tails = [], [], [], []
    tails = bool(st.q_tails)
    if tails:
        w_win = st.q_tails[0].shape[1]
        # Window slot t of row b holds the query at global position
        # len_b - W + t; capture the slots whose position falls in this
        # chunk (same capture pattern as last_h below).
        lens_b = (lengths.astype(jnp.int32) if lengths is not None
                  else jnp.full((b,), s_total, jnp.int32))
        tail_pos = lens_b[:, None] - w_win + jnp.arange(w_win)[None]  # [B,W]
        t_in_chunk = (tail_pos >= st.offset) & (tail_pos < st.offset + c)
        t_idx = jnp.clip(tail_pos - st.offset, 0, c - 1)
    for li, layer in enumerate(params["layers"]):
        x = rmsnorm(h, layer["input_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(layer, x, cfg)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        k_buf = jax.lax.dynamic_update_slice(
            st.k_bufs[li], k.astype(st.k_bufs[li].dtype),
            (0, st.offset, 0, 0))
        v_buf = jax.lax.dynamic_update_slice(
            st.v_bufs[li], v.astype(st.v_bufs[li].dtype),
            (0, st.offset, 0, 0))
        attn_out, mass_c = chunk_attention_with_prompt_mass(
            q, k_buf, v_buf, st.offset, prompt_len, prompt_lens=prompt_lens)
        k_bufs.append(k_buf)
        v_bufs.append(v_buf)
        masses.append(jax.lax.dynamic_update_slice(
            st.masses[li], mass_c, (0, st.offset)))
        if tails:
            cand = jnp.take_along_axis(
                q.astype(st.q_tails[li].dtype),
                t_idx[:, :, None, None], axis=1)
            q_tails.append(jnp.where(t_in_chunk[:, :, None, None], cand,
                                     st.q_tails[li]))
        h = h + _matmul(attn_out.reshape(b, c, cfg.q_dim), layer["wo"])
        h = h + _mlp(layer, rmsnorm(h, layer["post_norm"], cfg.rms_norm_eps),
                     cfg)

    # Capture the hidden state at each row's final position if it falls in
    # this chunk (rows keep their previous capture otherwise).
    last_pos = (lengths - 1 if lengths is not None
                else jnp.full((b,), s_total - 1, jnp.int32))
    in_chunk = (last_pos >= st.offset) & (last_pos < st.offset + c)
    idx = jnp.clip(last_pos - st.offset, 0, c - 1)
    cand = jnp.take_along_axis(h, idx[:, None, None], axis=1)[:, 0]
    last_h = jnp.where(in_chunk[:, None], cand, st.last_h)

    return ChunkedPrefillState(k_bufs=tuple(k_bufs), v_bufs=tuple(v_bufs),
                               masses=tuple(masses), last_h=last_h,
                               offset=st.offset + c,
                               q_tails=tuple(q_tails))


def prefill_chunked_finish(
    params: Params,
    st: ChunkedPrefillState,
    cfg: ModelConfig,
    ccfg: CompressionConfig,
    max_decode_len: int = 128,
    lengths: Optional[Array] = None,
    mesh=None,
) -> Tuple[Array, DecodeState, List[Dict[str, Array]]]:
    """Compress the accumulated buffers into the decode state + last logits.

    Compression happens ONCE over the complete K/V + prompt mass, exactly as
    the one-shot prefill's per-layer `compress_layer_kv` — chunking changes
    when attention math runs, not what gets compressed."""
    b, s = st.masses[0].shape
    token_valid = None
    prompt_lens = None
    if lengths is not None:
        token_valid = jnp.arange(s)[None] < lengths[:, None]
        prompt_lens = jnp.clip(
            (lengths.astype(jnp.float32) * ccfg.prompt_frac).astype(
                jnp.int32), 1, ccfg.prompt_length(s))
    tails = bool(st.q_tails)
    if tails:
        from ..ops.attention import window_attention_mass
        w_win = st.q_tails[0].shape[1]
        lens_b = (lengths.astype(jnp.int32) if lengths is not None
                  else jnp.full((b,), s, jnp.int32))
        tail_pos = lens_b[:, None] - w_win + jnp.arange(w_win)[None]
        row_ok = tail_pos >= 0
        key_ok = (token_valid if token_valid is not None
                  else jnp.ones((b, s), bool))
    caches, recents, pools, all_stats = [], [], [], []
    for li in range(cfg.num_layers):
        qmass = None
        if tails:
            qmass = window_attention_mass(
                st.q_tails[li], jnp.maximum(tail_pos, 0), row_ok,
                st.k_bufs[li], key_ok, pool=ccfg.query_mass_pool)
        cache, stats = compress_layer_kv(
            st.k_bufs[li], st.v_bufs[li], st.masses[li], li, ccfg, cfg,
            token_valid=token_valid, prompt_lens=prompt_lens,
            query_mass=qmass)
        caches.append(cache)
        all_stats.append(stats)
        recents.append(init_recent_cache(b, max_decode_len, cfg))
        pools.append(init_decode_pool(b, max_decode_len, ccfg, cfg))
    logits = logits_from_hidden(params, st.last_h, cfg)
    end_pos = (lengths.astype(jnp.int32) if lengths is not None
               else jnp.full((b,), s, jnp.int32))
    state = DecodeState(caches=tuple(caches), recents=tuple(recents),
                        position=end_pos, pools=tuple(pools))
    if mesh is not None:
        from ..parallel.sharding import constrain_decode_state
        state = constrain_decode_state(state, mesh)
    return logits, state, all_stats


def prefill_compressed_chunked(
    params: Params,
    input_ids: Array,
    cfg: ModelConfig,
    ccfg: CompressionConfig,
    chunk_size: int,
    max_decode_len: int = 128,
    lengths: Optional[Array] = None,
    mesh=None,
    jit_steps: bool = True,
    use_flash: bool = False,
) -> Tuple[Array, DecodeState, List[Dict[str, Array]]]:
    """Convenience driver: init → chunk steps → finish.

    Equivalent to `prefill_compressed` (same caches/logits to fp tolerance);
    the serving engine calls the three phases itself to interleave chunks
    with decode."""
    b, s = input_ids.shape
    if s % chunk_size:
        raise ValueError(f"seq len {s} not a multiple of chunk {chunk_size}")
    st = prefill_chunked_init(b, s, cfg, ccfg)
    step = (jax.jit(lambda p, i, t, n: prefill_chunked_step(
        p, i, t, cfg, ccfg, lengths=n, use_flash=use_flash)) if jit_steps
        else (lambda p, i, t, n: prefill_chunked_step(
            p, i, t, cfg, ccfg, lengths=n, use_flash=use_flash)))
    for off in range(0, s, chunk_size):
        st = step(params, input_ids[:, off:off + chunk_size], st, lengths)
    return prefill_chunked_finish(params, st, cfg, ccfg,
                                  max_decode_len=max_decode_len,
                                  lengths=lengths, mesh=mesh)


# ---------------------------------------------------------------------------
# Compressed-prefix chunked prefill (VERDICT r4 item 2: TTFT improved BY
# compression — later chunks attend over the compressed pools of earlier
# chunks instead of the full uncompressed KV buffer)
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass
class CompressedChunkedState:
    """Carry for compressed-prefix chunked prefill.

    Unlike `ChunkedPrefillState` there are NO full-length K/V/mass buffers:
    each chunk is compressed into its slot range of the preallocated tier
    pools as soon as its attention completes, so per-layer state is the
    compressed cache (~kept x mixed-bit) instead of [B, S, H, D] bf16 —
    the difference between ~1.4 GB and ~0.3 GB of carry at 32K for
    TinyLlama, and the mechanism that removes prefix-attention FLOPs
    (chunk t attends over kept*t*c prefix tokens, not t*c).

    Approximation vs the full-buffer path (documented, measured in
    experiments/quality_demo.py --tasks chunked_prefix): (a) later chunks
    see the quantized/selected prefix; (b) each chunk's importance
    normalization is chunk-local (its own mass min-max); (c) each chunk's
    mass comes only from queries up to that chunk (later queries cannot
    rescore an already-compressed prefix). Prompt-source importance only —
    query-guided needs the end-of-sequence window, which does not exist
    when early chunks are compressed (use the full-buffer path for that).
    """

    caches: Tuple[CompressedLayerCache, ...]
    last_h: Array               # [B, hidden]
    offset: Array               # scalar int32: next write position


def prefill_chunked_compressed_init(
        batch: int, seq_len: int, chunk_size: int, cfg: ModelConfig,
        ccfg: CompressionConfig) -> CompressedChunkedState:
    from ..compression.compressor import empty_layer_cache

    if seq_len % chunk_size:
        raise ValueError(f"seq len {seq_len} not a multiple of chunk "
                         f"{chunk_size}")
    if ccfg.importance_source != "prompt":
        raise ValueError(
            "compressed-prefix chunked prefill supports importance_source="
            "'prompt' only (the observation window lives at the END of the "
            "sequence — it cannot score chunks that are compressed before "
            "it exists; use prefill_chunked_* for query-guided scoring)")
    n_chunks = seq_len // chunk_size
    caches = tuple(
        empty_layer_cache(batch, chunk_size, n_chunks, li, ccfg, cfg)
        for li in range(cfg.num_layers))
    return CompressedChunkedState(
        caches=caches,
        last_h=jnp.zeros((batch, cfg.hidden_size), jnp.dtype(cfg.dtype)),
        offset=jnp.zeros((), jnp.int32))


def prefill_chunked_compressed_step(
    params: Params,
    chunk_ids: Array,
    st: CompressedChunkedState,
    cfg: ModelConfig,
    ccfg: CompressionConfig,
    total_len: int,
    use_flash: bool = False,
) -> CompressedChunkedState:
    """Advance compressed-prefix prefill by one chunk (uniform batches).

    Per layer: attention of the chunk's queries over {compressed pools so
    far} ++ {own chunk K/V} with explicit positions (causality and the
    prompt-column indicator follow stored global positions — invalid slots
    are masked), then the chunk is compressed with its own prompt mass
    (chunk-local min-max normalization, global position bias via
    shard_offset/total_len) and written into its slot range. The offset is
    traced, so ONE compiled program serves every chunk of a bucket.
    """
    from ..compression.compressor import update_cache_chunk
    from ..ops.attention import positioned_attention_with_prompt_mass

    b, c = chunk_ids.shape
    prompt_len = ccfg.prompt_length(total_len)
    chunk_idx = st.offset // c

    h = _embed_lookup(params["embed"], chunk_ids, jnp.dtype(cfg.dtype),
                      cfg=cfg)
    q_pos = st.offset + jnp.arange(c)
    positions = jnp.broadcast_to(q_pos[None], (b, c))
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                           cfg.rope_scaling)

    caches = []
    for li, layer in enumerate(params["layers"]):
        x = rmsnorm(h, layer["input_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(layer, x, cfg)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        cache = st.caches[li]
        k_p, v_p, pos_p, valid_p = dequantize_layer_cache(cache, ccfg,
                                                          q.dtype)
        if use_flash:
            from ..ops.pallas.flash_prefill import (
                flash_compressed_prefix_attention)
            attn_out, mass_c = flash_compressed_prefix_attention(
                q, k_p.astype(q.dtype), v_p.astype(q.dtype), pos_p, valid_p,
                k, v, st.offset, prompt_len)
        else:
            ks = jnp.concatenate([k_p.astype(q.dtype), k], axis=1)
            vs = jnp.concatenate([v_p.astype(q.dtype), v], axis=1)
            pos_all = jnp.concatenate([pos_p, positions], axis=1)
            valid_all = jnp.concatenate(
                [valid_p, jnp.ones((b, c), bool)], axis=1)
            attn_out, mass_c = positioned_attention_with_prompt_mass(
                q, ks, vs, pos_all, valid_all, positions, prompt_len)

        mn = mass_c.min(axis=-1, keepdims=True)
        mx = mass_c.max(axis=-1, keepdims=True)
        # A chunk whose mass is (near-)constant — e.g. it lies entirely
        # inside the prompt region, where every row's mass is 1.0 — must
        # score as constant: min-max normalizing a float-noise-wide range
        # would amplify backend noise (dense vs flash softmax) to full
        # score scale and scramble selection. Widen the span so the
        # normalized alpha term collapses to ~0 and the deterministic
        # position/floor terms decide.
        mx = jnp.where(mx - mn < 1e-3, mn + 1e6, mx)
        chunk_cache, _ = compress_layer_kv(
            k, v, mass_c, li, ccfg, cfg, shard_offset=st.offset,
            total_len=total_len, minmax=(mn, mx))
        caches.append(update_cache_chunk(cache, chunk_cache, chunk_idx))

        h = h + _matmul(attn_out.reshape(b, c, cfg.q_dim), layer["wo"])
        h = h + _mlp(layer, rmsnorm(h, layer["post_norm"], cfg.rms_norm_eps),
                     cfg)

    last_pos = jnp.full((b,), total_len - 1, jnp.int32)
    in_chunk = (last_pos >= st.offset) & (last_pos < st.offset + c)
    idx = jnp.clip(last_pos - st.offset, 0, c - 1)
    cand = jnp.take_along_axis(h, idx[:, None, None], axis=1)[:, 0]
    last_h = jnp.where(in_chunk[:, None], cand, st.last_h)

    return CompressedChunkedState(caches=tuple(caches), last_h=last_h,
                                  offset=st.offset + c)


def prefill_chunked_compressed_finish(
    params: Params,
    st: CompressedChunkedState,
    cfg: ModelConfig,
    ccfg: CompressionConfig,
    max_decode_len: int = 128,
    mesh=None,
) -> Tuple[Array, DecodeState, List[Dict[str, Array]]]:
    """Last-position logits + DecodeState over the incrementally-built
    caches (which ARE the decode caches — no separate compression pass).
    Stats are summarized from the final pools (selection already happened
    per chunk)."""
    b = st.last_h.shape[0]
    all_stats = []
    for li, cache in enumerate(st.caches):
        kept = sum(t.valid.sum(axis=-1) for t in cache.tiers)
        total = jnp.asarray(st.offset, jnp.float32)
        all_stats.append({
            "seq_len": jnp.full((b,), 1, jnp.int32) * st.offset,
            "kept_tokens": kept,
            "compression_ratio": kept / jnp.maximum(total, 1.0),
            "token_memory_savings": 1.0 - kept / jnp.maximum(total, 1.0),
        })
    logits = logits_from_hidden(params, st.last_h, cfg)
    recents = tuple(init_recent_cache(b, max_decode_len, cfg)
                    for _ in range(cfg.num_layers))
    pools = tuple(init_decode_pool(b, max_decode_len, ccfg, cfg)
                  for _ in range(cfg.num_layers))
    state = DecodeState(
        caches=st.caches, recents=recents,
        position=jnp.broadcast_to(st.offset[None], (b,)).astype(jnp.int32),
        pools=pools)
    if mesh is not None:
        from ..parallel.sharding import constrain_decode_state
        state = constrain_decode_state(state, mesh)
    return logits, state, all_stats


def prefill_compressed_prefix_chunked(
    params: Params,
    input_ids: Array,
    cfg: ModelConfig,
    ccfg: CompressionConfig,
    chunk_size: int,
    max_decode_len: int = 128,
    jit_steps: bool = True,
    use_flash: bool = False,
    mesh=None,
) -> Tuple[Array, DecodeState, List[Dict[str, Array]]]:
    """Convenience driver: init → compressed-prefix chunk steps → finish.

    The init is jitted (zero args): built eagerly it issues hundreds of
    small zeros ops, one dispatch each."""
    b, s = input_ids.shape
    init = lambda: prefill_chunked_compressed_init(b, s, chunk_size, cfg,
                                                   ccfg)
    step = lambda p, i, t: prefill_chunked_compressed_step(
        p, i, t, cfg, ccfg, total_len=s, use_flash=use_flash)
    if jit_steps:
        init = jax.jit(init)
        step = jax.jit(step)
    st = init()
    for off in range(0, s, chunk_size):
        st = step(params, input_ids[:, off:off + chunk_size], st)
    return prefill_chunked_compressed_finish(
        params, st, cfg, ccfg, max_decode_len=max_decode_len, mesh=mesh)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def decode_layers_step(
    layer_params: List[Params],
    h: Array,
    caches,
    recents,
    pools,
    q_pos: Array,
    cos: Array,
    sin: Array,
    cfg: ModelConfig,
    ccfg: CompressionConfig,
    use_fused: bool = False,
):
    """One decode step over a contiguous range of layers.

    The per-layer body of `decode_step`, factored so pipeline stages
    (parallel/pipeline.py) can advance their own layer slice. `caches`,
    `recents`, `pools` are indexed locally (entry i belongs to
    layer_params[i]); pools may be an empty tuple or hold None entries.

    Returns (h, new_recents, new_pools).
    """
    b = h.shape[0]
    new_recents, new_pools = [], []
    have_pools = bool(pools) and pools[0] is not None
    for i, layer in enumerate(layer_params):
        x = rmsnorm(h, layer["input_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(layer, x, cfg)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        recent = recents[i]
        pool = pools[i] if have_pools else None
        if pool is not None:
            # Decode-token compression: a full ring is quantized into the
            # layer's decode pool before this step's token is appended, so
            # the ring never overflows and long generations keep the
            # memory win (decode tokens at decode_pool_bits).
            recent, pool = flush_recent(recent, pool, ccfg, cfg)
        recent = append_recent(recent, k, v, q_pos)
        new_recents.append(recent)
        new_pools.append(pool)
        cache = caches[i]

        if use_fused:
            from ..ops.pallas.decode_attention import fused_decode_attention
            attn_out = fused_decode_attention(q, cache, recent, q_pos, ccfg,
                                              pool=pool)
        else:
            # Dequantize straight to the compute dtype: bf16 K/V stream at
            # half the HBM bandwidth of f32 into the attention matmuls.
            k_c, v_c, pos_c, valid_c = dequantize_layer_cache(cache, ccfg,
                                                              q.dtype)
            rec_valid = (jnp.arange(recent.capacity)[None]
                         < recent.length[:, None])
            ks = [k_c.astype(q.dtype), recent.k]
            vs = [v_c.astype(q.dtype), recent.v]
            ps = [pos_c, recent.positions]
            vds = [valid_c, rec_valid]
            if pool is not None:
                k_p, v_p, pos_p, valid_p = dequantize_decode_pool(pool,
                                                                  q.dtype)
                ks.append(k_p)
                vs.append(v_p)
                ps.append(pos_p)
                vds.append(valid_p)
            attn_out = attention_over_tokens(
                q, jnp.concatenate(ks, axis=1), jnp.concatenate(vs, axis=1),
                jnp.concatenate(ps, axis=1), jnp.concatenate(vds, axis=1),
                q_pos)

        h = h + _matmul(attn_out.reshape(b, 1, cfg.q_dim), layer["wo"])
        h = h + _mlp(layer, rmsnorm(h, layer["post_norm"], cfg.rms_norm_eps),
                     cfg)
    return h, new_recents, new_pools


def decode_step(
    params: Params,
    token: Array,
    state: DecodeState,
    cfg: ModelConfig,
    ccfg: CompressionConfig,
    use_fused: bool = False,
) -> Tuple[Array, DecodeState]:
    """One greedy-decode step over the compressed caches.

    Args:
      token: [B] current token ids.
      state: decode state from `prefill_compressed`.

    Returns (logits [B, V], updated state).
    """
    b = token.shape[0]
    h = _embed_lookup(params["embed"], token, jnp.dtype(cfg.dtype),
                      cfg=cfg)[:, None]  # [B,1,H]
    q_pos = state.position[:, None]  # [B, 1]
    cos, sin = rope_tables(q_pos, cfg.head_dim, cfg.rope_theta,
            cfg.rope_scaling)

    h, new_recents, new_pools = decode_layers_step(
        params["layers"], h, state.caches, state.recents, state.pools,
        q_pos, cos, sin, cfg, ccfg, use_fused=use_fused)

    logits = logits_from_hidden(params, h[:, 0], cfg)
    have_pools = bool(state.pools) and state.pools[0] is not None
    state = DecodeState(caches=state.caches, recents=tuple(new_recents),
                        position=state.position + 1,
                        pools=tuple(new_pools) if have_pools
                        else state.pools)
    return logits, state


def resolve_fused_decode(cfg: ModelConfig, ccfg: CompressionConfig,
                         mesh=None) -> bool:
    """Auto choice of the decode attention path (use_fused=None).

    The split-K kernel over the packed cache (ops/pallas/
    decode_attention.py) on the GPU, where it reads the codes at their
    packed width (PERF.md, kernel decisions); the XLA dequant path on the
    CPU (the kernel would run in the interpreter), over a mesh (a Pallas
    call does not partition) and for scale groups the kernel does not take.
    """
    if jax.default_backend() != "gpu" or mesh is not None:
        return False
    from ..ops.pallas.decode_attention import decode_supported

    return decode_supported(cfg.head_dim, ccfg.quant_group_size)


def decode_loop(
    params: Params,
    first_token: Array,
    state: DecodeState,
    n_steps: int,
    cfg: ModelConfig,
    ccfg: CompressionConfig,
    use_fused: Optional[bool] = None,
    temperature: float = 0.0,
    rng: Optional[Array] = None,
    sampling: Optional[SamplingParams] = None,
    counts: Optional[Array] = None,
    return_counts: bool = False,
    return_logprobs: bool = False,
):
    """n_steps of decode inside one XLA program (lax.scan over steps).

    use_fused=None → auto: `resolve_fused_decode`.

    One dispatch for the whole generation: no per-step host round trip.
    temperature == 0 → greedy; > 0 → categorical sampling (requires `rng`).
    `sampling` (ops.sampling.SamplingParams) supersedes `temperature` and
    adds top-k / top-p / min-p filtering plus repetition/presence/frequency
    penalties inside the scanned program. Penalties track per-row token
    occurrence counts in the scan carry; pass `counts` ([B, vocab] int32,
    already including every previously generated token) to continue an
    earlier generation (the serving engine does, across decode chunks) —
    omitted, a fresh count seeded with `first_token` is used. With
    `return_counts=True` the final counts come back as a third result.

    Generation length: with decode pools (ccfg.decode_pool_blocks > 0) any
    n_steps is supported — full rings flush into the quantized pool, and
    past ring*(blocks+1) decode tokens the oldest pool block is overwritten
    (sliding window; prefill pools are never evicted). Without pools,
    n_steps must stay <= the recent-ring capacity set at prefill (appends
    past a full ring are dropped).

    Returns (tokens [B, n_steps], state) — plus final counts when
    `return_counts`, plus per-token logprobs [B, n_steps] when
    `return_logprobs` (in that order). Logprobs are of the model's raw
    next-token distribution (log-softmax of the unprocessed logits at the
    emitted token — the OpenAI-API convention), independent of temperature,
    filters, and penalties.
    """
    if use_fused is None:
        use_fused = resolve_fused_decode(cfg, ccfg)
    if sampling is None:
        sampling = SamplingParams(temperature=temperature)
    if not sampling.is_greedy and rng is None:
        raise ValueError("sampling (temperature > 0) requires an rng key")
    if rng is None:
        rng = jax.random.PRNGKey(0)  # unused in greedy mode
    track_counts = sampling.uses_penalties or return_counts
    if track_counts and counts is None:
        counts = init_counts(first_token.shape[0], cfg.vocab_size,
                             first_token)
    if not track_counts:
        counts = jnp.zeros((), jnp.int32)  # inert carry placeholder

    def body(carry, _):
        tok, st, key, cnt = carry
        logits, st = decode_step(params, tok, st, cfg, ccfg,
                                 use_fused=use_fused)
        key, sub = jax.random.split(key)
        nxt = sample_logits(logits, sub, sampling,
                            counts=cnt if track_counts else None)
        if track_counts:
            cnt = update_counts(cnt, nxt)
        out = nxt
        if return_logprobs:
            lp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
            out = (nxt, jnp.take_along_axis(lp, nxt[:, None], axis=-1)[:, 0])
        return (nxt, st, key, cnt), out

    (_, state, _, counts), out = jax.lax.scan(
        body, (first_token, state, rng, counts), None, length=n_steps)
    toks, lps = out if return_logprobs else (out, None)
    result = [toks.T, state]
    if return_counts:
        result.append(counts)
    if return_logprobs:
        result.append(lps.T)
    return tuple(result) if len(result) > 2 else (result[0], result[1])


def decode_step_uncompressed(
    params: Params,
    token: Array,
    kv: Tuple[Array, Array],
    position: Array,
    cfg: ModelConfig,
    max_len: int,
) -> Tuple[Array, Tuple[Array, Array], Array]:
    """Baseline decode over a padded dense KV cache.

    kv: (K, V) [L, B, M, H, D] with M >= current length; positions < `position`
    are live.
    """
    b = token.shape[0]
    ks, vs = kv
    m = ks.shape[2]
    h = _embed_lookup(params["embed"], token, jnp.dtype(cfg.dtype),
                      cfg=cfg)[:, None]
    q_pos = position[:, None]
    cos, sin = rope_tables(q_pos, cfg.head_dim, cfg.rope_theta,
            cfg.rope_scaling)
    pos_all = jnp.broadcast_to(jnp.arange(m)[None], (b, m))
    new_ks, new_vs = [], []
    bidx = jnp.arange(b)
    for layer_idx, layer in enumerate(params["layers"]):
        x = rmsnorm(h, layer["input_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(layer, x, cfg)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        k_cache = ks[layer_idx].at[bidx, position].set(k[:, 0])
        v_cache = vs[layer_idx].at[bidx, position].set(v[:, 0])
        new_ks.append(k_cache)
        new_vs.append(v_cache)
        valid = pos_all <= q_pos
        attn_out = attention_over_tokens(q, k_cache, v_cache, pos_all, valid,
                                         q_pos)
        h = h + _matmul(attn_out.reshape(b, 1, cfg.q_dim), layer["wo"])
        h = h + _mlp(layer, rmsnorm(h, layer["post_norm"], cfg.rms_norm_eps),
                     cfg)
    logits = logits_from_hidden(params, h[:, 0], cfg)
    return logits, (jnp.stack(new_ks), jnp.stack(new_vs)), position + 1


def decode_loop_uncompressed(
    params: Params,
    first_token: Array,
    kv: Tuple[Array, Array],
    position: Array,
    n_steps: int,
    cfg: ModelConfig,
) -> Tuple[Array, Tuple[Array, Array], Array]:
    """Baseline-arm scan decode over the padded dense cache."""
    max_len = kv[0].shape[2]

    def body(carry, _):
        tok, kv, pos = carry
        logits, kv, pos = decode_step_uncompressed(params, tok, kv, pos, cfg,
                                                   max_len)
        nxt = jnp.argmax(logits, axis=-1)
        return (nxt, kv, pos), nxt

    (_, kv, position), toks = jax.lax.scan(
        body, (first_token, kv, position), None, length=n_steps)
    return toks.T, kv, position


# ---------------------------------------------------------------------------
# Generation driver (host loop; each step is jitted)
# ---------------------------------------------------------------------------

def generate(
    params: Params,
    input_ids: Array,
    cfg: ModelConfig,
    ccfg: CompressionConfig,
    max_new_tokens: int = 32,
    use_flash: bool = False,
    use_fused_decode: Optional[bool] = None,
    eos_token_id: Optional[int] = None,
    temperature: float = 0.0,
    rng: Optional[Array] = None,
    sampling: Optional[SamplingParams] = None,
) -> Tuple[Array, List[Dict[str, Array]]]:
    """Generation with compressed KV (greedy, or sampled when
    temperature > 0; `sampling` adds top-k/top-p/min-p — the HF
    GenerationConfig surface the reference used). Returns
    (generated ids [B, T], per-layer prefill compression stats).

    use_fused_decode=None → auto: `resolve_fused_decode`."""
    if use_fused_decode is None:
        use_fused_decode = resolve_fused_decode(cfg, ccfg)
    if sampling is None:
        sampling = SamplingParams(temperature=temperature)
    if not sampling.is_greedy and rng is None:
        rng = jax.random.PRNGKey(0)
    prefill = jax.jit(lambda p, ids: prefill_compressed(
        p, ids, cfg, ccfg, max_decode_len=max_new_tokens,
        use_flash=use_flash))
    loop = jax.jit(lambda p, t, s, k: decode_loop(
        p, t, s, max_new_tokens - 1, cfg, ccfg, use_fused=use_fused_decode,
        rng=k, sampling=sampling))
    logits, state, stats = prefill(params, input_ids)
    if not sampling.is_greedy:
        rng, sub = jax.random.split(rng)
        tok = sample_logits(logits, sub, sampling)
    else:
        tok = jnp.argmax(logits, axis=-1)
    if max_new_tokens > 1:
        rest, _ = loop(params, tok, state, rng if rng is not None
                       else jax.random.PRNGKey(0))
        out = jnp.concatenate([tok[:, None], rest], axis=1)
    else:
        out = tok[:, None]
    if eos_token_id is not None:
        # Mask everything after the first EOS per row (scan can't early-stop).
        hit = jnp.cumsum((out == eos_token_id).astype(jnp.int32), axis=1)
        out = jnp.where(hit - (out == eos_token_id) > 0, eos_token_id, out)
    return out, stats
