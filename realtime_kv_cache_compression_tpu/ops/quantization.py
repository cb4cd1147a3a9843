"""Dynamic-precision KV quantization with REAL bit-packed storage — pure JAX.

Capability parity with the reference `DynamicPrecisionQuantizer`
(/root/reference/src/compression/dynamic_quantization.py:7-241), redesigned:

* The reference fake-quantizes (quantize → clamp → dequantize back to fp16,
  dynamic_quantization.py:120-126) inside a per-token Python double loop
  (:179-194). Here quantization is a single vectorized pass and the codes are
  *actually stored* sub-byte: 8-bit codes as uint8, 4-bit as two-per-byte,
  2-bit as four-per-byte. Memory savings are physical, not estimated.
* Scales/zero-points are per (token, kv-head, channel-group) — strictly finer
  than the reference's single scale across the whole fused token vector
  (dynamic_quantization.py:79-80) — per the north-star requirement for
  group-wise scales.
* Same asymmetric uniform scheme: qmin=0, qmax=2^b-1,
  scale=(max-min)/qmax, zp=-min/scale, with the degenerate max==min case
  mapping to scale=1, zp=0 (dynamic_quantization.py:83-86).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import HIGH, LOW, MID, CompressionConfig

Array = jax.Array


# ---------------------------------------------------------------------------
# Precision assignment
# ---------------------------------------------------------------------------

def assign_precision(scores: Array, cfg: CompressionConfig) -> Tuple[Array, Dict[str, Array]]:
    """Threshold-based precision labels: 2=HIGH, 1=MID, 0=LOW.

    Mirrors dynamic_quantization.py:21-60. Stats are returned as device
    scalars (no `.item()` host syncs in the hot path).
    """
    high = scores >= cfg.theta_h
    mid = (scores >= cfg.theta_m) & ~high
    labels = high.astype(jnp.int32) * HIGH + mid.astype(jnp.int32) * MID
    total = scores.size
    n_high = high.sum()
    n_mid = mid.sum()
    n_low = total - n_high - n_mid
    stats = {
        "high_count": n_high, "medium_count": n_mid, "low_count": n_low,
        "high_ratio": n_high / total, "medium_ratio": n_mid / total,
        "low_ratio": n_low / total,
    }
    return labels, stats


def token_costs(labels: Array, cfg: CompressionConfig) -> Array:
    """Byte-cost per token from its precision label
    (selective_propagation.py:40-66)."""
    cost_table = jnp.array(
        [cfg.tier_cost(LOW), cfg.tier_cost(MID), cfg.tier_cost(HIGH)],
        dtype=jnp.float32)
    return cost_table[labels]


# ---------------------------------------------------------------------------
# Quantization params / quantize / dequantize
# ---------------------------------------------------------------------------

def quant_params(x: Array, bits: int, group_size: int,
                 clip_frac: float = 0.0) -> Tuple[Array, Array]:
    """Asymmetric uniform quant params per channel group.

    Args:
      x: [..., D] float tensor; D % group_size == 0.
      bits: target bit width (2/4/8).
      group_size: channels per scale group.
      clip_frac: outlier handling — derive the range from the
        (clip_frac, 1-clip_frac) per-group quantiles instead of absolute
        min/max, so a single outlier channel cannot stretch the scale and
        destroy resolution for the rest of the group (north-star "outlier
        detection"; values are clamped into the clipped range). 0 disables.

    Returns:
      (scale, zero_point), each [..., D // group_size] float32.
    """
    qmax = float(2 ** bits - 1)
    g = x.shape[-1] // group_size
    xg = x.reshape(*x.shape[:-1], g, group_size).astype(jnp.float32)
    if clip_frac > 0.0 and group_size > 2:
        xs = jnp.sort(xg, axis=-1)
        lo_idx = max(0, min(group_size - 1, int(clip_frac * group_size)))
        hi_idx = group_size - 1 - lo_idx
        t_min = xs[..., lo_idx]
        t_max = xs[..., hi_idx]
    else:
        t_min = xg.min(axis=-1)
        t_max = xg.max(axis=-1)
    degenerate = (t_max - t_min) <= 0
    scale = jnp.where(degenerate, 1.0, (t_max - t_min) / qmax)
    zero_point = jnp.where(degenerate, 0.0, -t_min / scale)
    return scale, zero_point


def quantize(x: Array, scale: Array, zero_point: Array, bits: int) -> Array:
    """Quantize to integer codes in [0, 2^bits - 1], stored as uint8.

    Same rounding/clamping as dynamic_quantization.py:116-122 — but the codes
    are kept, not dequantized away.
    """
    qmax = 2 ** bits - 1
    g = scale.shape[-1]
    group_size = x.shape[-1] // g
    xg = x.reshape(*x.shape[:-1], g, group_size).astype(jnp.float32)
    q = jnp.round(xg / scale[..., None] + zero_point[..., None])
    q = jnp.clip(q, 0, qmax).astype(jnp.uint8)
    return q.reshape(*x.shape)


def dequantize(codes_f: Array, scale: Array, zero_point: Array,
               dtype=jnp.float32) -> Array:
    """Dequantize float-cast codes: (q - zp) * scale.

    `codes_f` may be real codes cast to float OR raw 16-bit-tier floats with
    scale=1, zp=0 — the formula is uniform across tiers.
    """
    g = scale.shape[-1]
    group_size = codes_f.shape[-1] // g
    cg = codes_f.reshape(*codes_f.shape[:-1], g, group_size).astype(jnp.float32)
    out = (cg - zero_point[..., None]) * scale[..., None]
    return out.reshape(*codes_f.shape).astype(dtype)


# ---------------------------------------------------------------------------
# Physical bit packing (the part the reference only pretended to do)
# ---------------------------------------------------------------------------

def pack_codes(codes: Array, bits: int, axis: int = -3,
               chunk: Optional[int] = None) -> Array:
    """Pack uint8 codes (< 2^bits) sub-byte along `axis` (token axis).

    Strided token-axis packing: with R = ceil(N / (8/bits)) byte rows, token
    j*R + r lives in byte row r at bit offset j*bits. Unpacking is then pure
    shift + mask + concatenate along the sublane axis — no interleaving data
    movement — which is exactly what the packed-cache decode kernel wants
    (channel-axis packing would need a lane reshuffle; interleaved packing
    would need an element-repeat).

    With `chunk` (a multiple of 8 // bits that divides the token count),
    packing is strided *within each chunk of `chunk` tokens independently*:
    chunk c's tokens occupy byte rows [c*chunk/pb, (c+1)*chunk/pb), so a row
    range covering whole chunks corresponds to a CONTIGUOUS token range —
    the property the single-launch decode kernel's segment grid needs
    (scales/positions slice contiguously per segment). chunk=None packs the
    whole axis as one chunk (the round-1 layout).

    8 bits → identity; 4 bits → 2 tokens/byte; 2 bits → 4 tokens/byte.
    The token count is zero-padded to a multiple of 8 // bits (chunk=None).
    """
    if bits == 8:
        return codes
    axis = axis % codes.ndim
    per_byte = 8 // bits
    n = codes.shape[axis]
    if chunk is not None and chunk < n:
        if chunk % per_byte or n % chunk:
            raise ValueError(f"chunk {chunk} must divide tokens {n} and be "
                             f"a multiple of {per_byte}")
        nc = n // chunk
        shp = codes.shape
        cg = codes.reshape(shp[:axis] + (nc, chunk) + shp[axis + 1:])
        packed = pack_codes(cg, bits, axis=axis + 1)
        return packed.reshape(shp[:axis] + (n // per_byte,) + shp[axis + 1:])
    pad = (-n) % per_byte
    if pad:
        widths = [(0, 0)] * codes.ndim
        widths[axis] = (0, pad)
        codes = jnp.pad(codes, widths)
    r = (n + pad) // per_byte
    new_shape = (codes.shape[:axis] + (per_byte, r) + codes.shape[axis + 1:])
    cg = codes.reshape(new_shape)  # token j*R + r → index [j, r]
    shift_shape = [1] * (codes.ndim + 1)
    shift_shape[axis] = per_byte
    shifts = (jnp.arange(per_byte, dtype=jnp.uint8) * bits).reshape(shift_shape)
    return (cg << shifts).sum(axis=axis).astype(jnp.uint8)


def unpack_codes(packed: Array, bits: int, num_tokens: int,
                 axis: int = -3, chunk: Optional[int] = None) -> Array:
    """Inverse of `pack_codes`: packed bytes → uint8 codes ([num_tokens] along
    `axis`). Pure shift+mask+concat (kernel-friendly)."""
    if bits == 8:
        return packed
    axis = axis % packed.ndim
    per_byte = 8 // bits
    if chunk is not None and chunk < num_tokens:
        rows_c = chunk // per_byte
        nc = packed.shape[axis] // rows_c
        shp = packed.shape
        pg = packed.reshape(shp[:axis] + (nc, rows_c) + shp[axis + 1:])
        codes = unpack_codes(pg, bits, chunk, axis=axis + 1)
        return codes.reshape(shp[:axis] + (nc * chunk,) + shp[axis + 1:])
    mask = jnp.uint8(2 ** bits - 1)
    parts = [(packed >> jnp.uint8(j * bits)) & mask for j in range(per_byte)]
    codes = jnp.concatenate(parts, axis=axis)
    return jax.lax.slice_in_dim(codes, 0, num_tokens, axis=axis)


def quantize_tier(x: Array, bits: int, group_size: int,
                  store_dtype=jnp.bfloat16,
                  clip_frac: float = 0.0,
                  chunk: Optional[int] = None) -> Tuple[Array, Array, Array]:
    """Quantize + physically pack one precision tier.

    Args:
      x: [..., N, H, D] float tensor (N tokens of one tier; packing runs
        along the token axis -3).
      bits: tier bit width; 16 stores raw `store_dtype` with unit scales.
      group_size: channels per scale group.
      chunk: tokens per packing chunk (see pack_codes) — the decode
        kernel's segment granularity. None = whole-axis strided.

    Returns:
      (stored, scale, zero_point) — `stored` is uint8 token-packed codes
      [..., ceil(N / (8/bits)), H, D] for bits<16, or raw values for
      bits==16; scale/zp are [..., N, H, D // group_size] float32.
    """
    if bits == 16:
        g = x.shape[-1] // group_size
        ones = jnp.ones((*x.shape[:-1], g), jnp.float32)
        zeros = jnp.zeros_like(ones)
        return x.astype(store_dtype), ones, zeros
    scale, zp = quant_params(x, bits, group_size, clip_frac=clip_frac)
    codes = quantize(x, scale, zp, bits)
    return pack_codes(codes, bits, axis=-3, chunk=chunk), scale, zp


def dequantize_tier(stored: Array, scale: Array, zero_point: Array, bits: int,
                    dtype=jnp.float32, chunk: Optional[int] = None) -> Array:
    """Unpack + dequantize one tier back to float [..., N, H, D]."""
    if bits == 16:
        return stored.astype(dtype)
    num_tokens = scale.shape[-3]
    codes = unpack_codes(stored, bits, num_tokens, axis=-3, chunk=chunk)
    return dequantize(codes.astype(jnp.float32), scale, zero_point, dtype)


def max_roundtrip_error(scale: Array) -> Array:
    """Upper bound on |x - dequant(quant(x))| = scale / 2 (uniform quant)."""
    return scale / 2.0


# ---------------------------------------------------------------------------
# Memory accounting — real bytes, not estimates
# ---------------------------------------------------------------------------

def storage_bytes(shape_tokens: int, head_dim: int, num_kv_heads: int,
                  bits: int, group_size: int, scale_bytes: int = 4) -> int:
    """Physical bytes to store K+V codes + scales/zps for `shape_tokens` tokens."""
    d = head_dim * num_kv_heads
    if bits == 16:
        code_bytes = shape_tokens * d * 2
    else:
        code_bytes = shape_tokens * d * bits // 8
    n_groups = d // group_size
    param_bytes = shape_tokens * n_groups * scale_bytes * 2  # scale + zp
    return 2 * code_bytes + 2 * param_bytes  # K and V


def memory_report(labels: Array, valid: Array, cfg: CompressionConfig,
                  head_dim: int, original_tokens=None,
                  group_size: int = 0) -> Dict[str, Array]:
    """Per-tier element counts and compressed/original byte ratio.

    Semantics of dynamic_quantization.py:198-241 (fp16 reference baseline),
    computed from actually-stored tokens. `original_tokens` is the true
    pre-compression token count (defaults to the slot count, which
    *understates* savings — callers should pass batch * seq_len).

    `group_size` is the effective channels-per-scale-group over the fused
    `head_dim` token vector; the per-(token, group) float32 scale+zero-point
    storage (8 bytes per group per tensor) is charged to compressed_bytes so
    the ratio reflects real allocated bytes, not codes only. 0 → one group
    per token vector (the coarsest, minimum overhead).
    """
    lab = jnp.where(valid, labels, -1)
    n_high = (lab == HIGH).sum()
    n_mid = (lab == MID).sum()
    n_low = (lab == LOW).sum()
    total_tokens = (original_tokens if original_tokens is not None
                    else labels.shape[-1] * labels.shape[0])
    original_bytes = total_tokens * head_dim * 2.0
    # float32 scale + zero-point per (token, group), stored for every tier
    # (16-bit tiers physically allocate unit scales too — see quantize_tier).
    n_groups = head_dim // (group_size or head_dim)
    param_bytes_per_token = n_groups * 4 * 2
    n_stored = n_high + n_mid + n_low
    compressed_bytes = (
        n_high * head_dim * cfg.tier_bits(HIGH) / 8.0
        + n_mid * head_dim * cfg.tier_bits(MID) / 8.0
        + n_low * head_dim * cfg.tier_bits(LOW) / 8.0
        + n_stored * param_bytes_per_token)
    ratio = compressed_bytes / original_bytes
    return {
        "high_elements": n_high * head_dim,
        "medium_elements": n_mid * head_dim,
        "low_elements": n_low * head_dim,
        "compression_ratio": ratio,
        "memory_savings": 1.0 - ratio,
    }
