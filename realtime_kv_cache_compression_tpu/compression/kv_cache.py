"""Mixed-precision compressed KV-cache containers (pytrees).

Replacement for the reference's `CompressedKVCache` dict-of-layers
container (/root/reference/src/models/compression_layers.py:7-45): statically
shaped, physically bit-packed, tier-contiguous, and carrying original token
positions so decode attention is exact w.r.t. RoPE and causality.

Layout per layer: three tier pools (HIGH, MID, LOW), each a `TierCache` with
static slot capacity. Within a pool, K/V codes are packed sub-byte along the
token axis (see ops/quantization.py) and per-(token, kv-head, group) scales
ride alongside. Decode attends over the three pools plus an uncompressed
"recent" ring of decode-time tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import CompressionConfig, ModelConfig

Array = jax.Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class TierCache:
    """One precision tier's packed K/V pool.

    Shapes (B = batch, N = static tier capacity, H = kv heads, D = head_dim,
    G = scale groups per head):
      k_stored / v_stored: [B, ceil(N / (8/bits)), H, D] uint8 — codes
          strided-packed sub-byte along the *token* axis (kernel-friendly:
          unpack is shift + mask + sublane concat, no lane movement) — for
          bits < 16, else [B, N, H, D] bf16 raw.
      k_scale / k_zp / v_scale / v_zp: [B, N, H, G] float32.
      positions: [B, N] int32 original token positions (for RoPE/causality).
      valid: [B, N] bool slot-occupancy mask.
      chunk: static packing chunk the codes were packed with (None = whole
          axis as one chunk). Sequence-sharded compression concatenates
          per-shard pools along the slot axis, where the layout is "chunked
          with C = per-shard capacity" — recording C here keeps the cache
          self-describing instead of re-deriving the chunk from the global
          capacity (which would misread shard-local packing).
    """

    k_stored: Array
    v_stored: Array
    k_scale: Array
    k_zp: Array
    v_scale: Array
    v_zp: Array
    positions: Array
    valid: Array
    chunk: Optional[int] = dataclasses.field(
        default=None, metadata=dict(static=True))

    @property
    def capacity(self) -> int:
        return self.positions.shape[1]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class CompressedLayerCache:
    """All tiers of one layer, ordered (HIGH, MID, LOW)."""

    tiers: Tuple[TierCache, TierCache, TierCache]

    @property
    def capacity(self) -> int:
        return sum(t.capacity for t in self.tiers)

    def valid_count(self) -> Array:
        """[B] number of live compressed tokens."""
        return sum(t.valid.sum(axis=-1) for t in self.tiers)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class RecentCache:
    """Uncompressed ring of decode-time K/V tokens appended after prefill.

    k/v: [B, M, H, D] in model dtype; positions: [B, M]; `length`: [B] live
    count (tokens are appended in order, so slot i is valid iff i < length).
    """

    k: Array
    v: Array
    positions: Array
    length: Array

    @property
    def capacity(self) -> int:
        return self.k.shape[1]


def init_recent_cache(batch: int, max_decode_len: int, model_cfg: ModelConfig,
                      dtype=None) -> RecentCache:
    dtype = dtype or jnp.dtype(model_cfg.dtype)
    h, d = model_cfg.num_kv_heads, model_cfg.head_dim
    return RecentCache(
        k=jnp.zeros((batch, max_decode_len, h, d), dtype),
        v=jnp.zeros((batch, max_decode_len, h, d), dtype),
        positions=jnp.zeros((batch, max_decode_len), jnp.int32),
        length=jnp.zeros((batch,), jnp.int32),
    )


def append_recent(cache: RecentCache, k_new: Array, v_new: Array,
                  pos_new: Array, gate: Optional[Array] = None
                  ) -> RecentCache:
    """Append one decode step's K/V ([B, 1, H, D]) into the ring.

    A full ring (length == capacity) DROPS the append and keeps length
    capped — never silently overwriting the last slot (JAX clamps
    out-of-range scatter indices) while the validity mask claims it's the
    new token. Model decode never hits this: `decode_step` flushes the ring
    into the quantized decode pool before it fills (see flush_recent).

    `gate` ([B] bool) additionally drops the append for False rows — used
    by speculative decoding to commit only the accepted prefix of a draft
    block (models/speculative.py).
    """
    b = jnp.arange(cache.k.shape[0])
    cap = cache.capacity
    drop = cache.length >= cap  # [B]
    if gate is not None:
        drop = drop | ~gate
    idx = jnp.minimum(cache.length, cap - 1)
    k_new, v_new = k_new.astype(cache.k.dtype), v_new.astype(cache.v.dtype)
    sel = lambda new, old: jnp.where(drop[:, None, None], old, new)
    return RecentCache(
        k=cache.k.at[b, idx].set(sel(k_new[:, 0], cache.k[b, idx])),
        v=cache.v.at[b, idx].set(sel(v_new[:, 0], cache.v[b, idx])),
        positions=cache.positions.at[b, idx].set(
            jnp.where(drop, cache.positions[b, idx], pos_new[:, 0])),
        length=jnp.where(drop, cache.length,
                         jnp.minimum(cache.length + 1, cap)),
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class DecodePool:
    """Quantized decode-token pool: a ring of ring-sized blocks.

    Decode-token compression (no reference counterpart — the reference is
    prefill-only, so long generations defeat its memory win): each time the
    uncompressed recent ring fills with R tokens, the whole ring is
    quantized at `decode_pool_bits` and written into the next block; with
    all `n_blocks` full, the oldest block is overwritten (sliding window
    over decode tokens — the compressed prefill pools are never evicted).

    Shapes (R = ring capacity = tokens per block, W = n_blocks,
    Rw = rows per block = R / (8 / bits)):
      k_stored / v_stored: [B, W * Rw, H, D] uint8 (packed per block) — or
          [B, W * R, H, D] raw dtype for bits == 16.
      k_scale / k_zp / v_scale / v_zp: [B, W * R, H, G] float32.
      positions: [B, W * R] int32; valid: [B, W * R] bool.
      write_block: [B] int32 — next block to write (wraps mod W).
    """

    k_stored: Array
    v_stored: Array
    k_scale: Array
    k_zp: Array
    v_scale: Array
    v_zp: Array
    positions: Array
    valid: Array
    write_block: Array
    n_blocks: int = dataclasses.field(metadata=dict(static=True), default=0)
    block_tokens: int = dataclasses.field(metadata=dict(static=True),
                                          default=0)
    bits: int = dataclasses.field(metadata=dict(static=True), default=4)

    @property
    def capacity(self) -> int:
        return self.n_blocks * self.block_tokens


def init_decode_pool(batch: int, ring_capacity: int, cfg: CompressionConfig,
                     model_cfg: ModelConfig) -> Optional[DecodePool]:
    """Allocate the decode pool (None when decode_pool_blocks == 0)."""
    w = cfg.decode_pool_blocks
    if w == 0:
        return None
    bits = cfg.decode_pool_bits
    h, d = model_cfg.num_kv_heads, model_cfg.head_dim
    g = d // (cfg.quant_group_size or d)
    r = ring_capacity
    per_byte = 1 if bits >= 8 else 8 // bits
    if bits < 16 and r % per_byte:
        raise ValueError(f"ring capacity {r} must divide {per_byte} "
                         f"tokens/byte for {bits}-bit decode pool packing")
    rows = r if bits == 16 else r // per_byte
    store_dtype = jnp.dtype(model_cfg.dtype) if bits == 16 else jnp.uint8
    return DecodePool(
        k_stored=jnp.zeros((batch, w * rows, h, d), store_dtype),
        v_stored=jnp.zeros((batch, w * rows, h, d), store_dtype),
        k_scale=jnp.ones((batch, w * r, h, g), jnp.float32),
        k_zp=jnp.zeros((batch, w * r, h, g), jnp.float32),
        v_scale=jnp.ones((batch, w * r, h, g), jnp.float32),
        v_zp=jnp.zeros((batch, w * r, h, g), jnp.float32),
        positions=jnp.zeros((batch, w * r), jnp.int32),
        valid=jnp.zeros((batch, w * r), bool),
        write_block=jnp.zeros((batch,), jnp.int32),
        n_blocks=w, block_tokens=r, bits=bits,
    )


def flush_recent(recent: RecentCache, pool: DecodePool,
                 cfg: CompressionConfig, model_cfg: ModelConfig
                 ) -> Tuple[RecentCache, DecodePool]:
    """Flush full ring rows into the decode pool (per-row, vectorized).

    Rows whose ring is full (length == capacity) have their R tokens
    quantized at decode_pool_bits and written into the row's next pool
    block; the ring length resets to 0 (slots are overwritten by subsequent
    appends). Rows that are not full are unchanged. The quantization runs
    for every row every call (cheap, R tokens) and is applied by masking —
    per-row control flow stays in values, as XLA requires.
    """
    from ..ops.quantization import quantize_tier

    b = recent.k.shape[0]
    r = recent.capacity
    bits = pool.bits
    group_size = cfg.quant_group_size or model_cfg.head_dim
    store_dtype = jnp.dtype(model_cfg.dtype)
    full = recent.length >= r  # [B]

    k_new, k_scale, k_zp = quantize_tier(recent.k, bits, group_size,
                                         store_dtype,
                                         clip_frac=cfg.quant_clip_frac)
    v_new, v_scale, v_zp = quantize_tier(recent.v, bits, group_size,
                                         store_dtype,
                                         clip_frac=cfg.quant_clip_frac)

    rows = k_new.shape[1]  # rows per block
    bidx = jnp.arange(b)[:, None]
    w = pool.write_block
    row_idx = w[:, None] * rows + jnp.arange(rows)[None, :]   # [B, rows]
    tok_idx = w[:, None] * r + jnp.arange(r)[None, :]         # [B, R]

    def upd(dst, src, idx):
        old = dst[bidx, idx]
        mask = full.reshape((b,) + (1,) * (src.ndim - 1))
        return dst.at[bidx, idx].set(jnp.where(mask, src.astype(dst.dtype),
                                               old))

    new_pool = dataclasses.replace(
        pool,
        k_stored=upd(pool.k_stored, k_new, row_idx),
        v_stored=upd(pool.v_stored, v_new, row_idx),
        k_scale=upd(pool.k_scale, k_scale, tok_idx),
        k_zp=upd(pool.k_zp, k_zp, tok_idx),
        v_scale=upd(pool.v_scale, v_scale, tok_idx),
        v_zp=upd(pool.v_zp, v_zp, tok_idx),
        positions=upd(pool.positions, recent.positions, tok_idx),
        valid=upd(pool.valid, jnp.ones((b, r), bool), tok_idx),
        write_block=jnp.where(full, (w + 1) % pool.n_blocks, w),
    )
    new_recent = dataclasses.replace(
        recent, length=jnp.where(full, 0, recent.length))
    return new_recent, new_pool


def dequantize_decode_pool(pool: DecodePool, dtype=jnp.float32
                           ) -> Tuple[Array, Array, Array, Array]:
    """Materialize the pool to dense K/V: (k, v, positions, valid) with
    k/v [B, W*R, H, D]. Blocks were packed independently, so unpack runs
    per block (a reshape, no data movement)."""
    from ..ops.quantization import dequantize_tier

    b = pool.positions.shape[0]
    w, r = pool.n_blocks, pool.block_tokens
    h, d = pool.k_stored.shape[-2:]
    g = pool.k_scale.shape[-1]

    def deq(stored, scale, zp):
        s = stored.reshape(b, w, -1, h, d)
        out = dequantize_tier(s, scale.reshape(b, w, r, h, g),
                              zp.reshape(b, w, r, h, g), pool.bits, dtype)
        return out.reshape(b, w * r, h, d)

    k = deq(pool.k_stored, pool.k_scale, pool.k_zp)
    v = deq(pool.v_stored, pool.v_scale, pool.v_zp)
    return k, v, pool.positions, pool.valid


def cache_storage_bytes(cache: CompressedLayerCache) -> int:
    """Physical bytes held by the layer's compressed pools (static)."""
    total = 0
    for t in cache.tiers:
        for arr in (t.k_stored, t.v_stored, t.k_scale, t.k_zp, t.v_scale,
                    t.v_zp, t.positions, t.valid):
            total += arr.size * arr.dtype.itemsize
    return total


def uncompressed_kv_bytes(batch: int, seq_len: int, model_cfg: ModelConfig,
                          bytes_per_el: int = 2) -> int:
    """Bytes a vanilla bf16 KV cache would hold for the same tokens."""
    return 2 * batch * seq_len * model_cfg.num_kv_heads * model_cfg.head_dim * bytes_per_el


def layer_cache_report(cache: CompressedLayerCache, batch: int, seq_len: int,
                       model_cfg: ModelConfig) -> Dict[str, float]:
    """Real allocated-storage compression accounting for one layer."""
    compressed = cache_storage_bytes(cache)
    original = uncompressed_kv_bytes(batch, seq_len, model_cfg)
    return {
        "compressed_bytes": compressed,
        "original_bytes": original,
        "allocated_ratio": compressed / original,
        "allocated_savings": 1.0 - compressed / original,
    }
