"""Split-K decode attention over the bit-packed cache (Pallas, Triton route).

SURVEY.md §7.3 hard part #2: decode attention reads the bit-packed tier
pools (8/4/2-bit codes with per-token scales), the quantized decode pool
and the uncompressed recent ring, unpacking *inside* the kernel — codes
stream from device memory at their packed width. Decode at small batch is
far below the GPU's FLOP/byte balance point, so bytes set the pace; the XLA
path (models/llama.py `decode_layers_step`, use_fused=False) instead writes
dequantized bf16 K/V for every layer at every step and reads it back.

Layout of the work: grid (batch, kv_head, split). Every pool (HIGH | MID |
LOW tiers, decode pool, recent ring) is cut into units of one row block of
one packing chunk; each split walks a contiguous run of one pool's units,
unpacks the codes in registers and keeps an online softmax (m, l, acc). The
partials of all splits merge in plain JAX (`_merge_partials`).

Per-token scales never expand to [N, D]: with q the query and c the integer
codes of one scale group,
    s[r, n] = (q·cᵏ − (Σ_d q)·zpᵏ) · scᵏ · sm_scale
    o[r, d] = (p·scᵛ)·cᵛ − Σ_n p·(scᵛ·zpᵛ)
i.e. the (code − zp)·scale affine folds into rank-1 corrections around the
raw integer-code products. Scale groups (quant_group_size) run as column
slices of head_dim, each with its own correction.

Layout contract (ops/quantization.py): codes are chunk-strided token-packed
— within each packing chunk, token j*R + r lives in byte row r at bit
offset j*bits — so one loaded row block unpacks into `8 // bits` token
blocks with shift + mask. Masking contract: the caller folds validity into
positions (invalid slot → POS_SENTINEL); the kernel's only mask is
position <= query position.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ...compression.kv_cache import (CompressedLayerCache, DecodePool,
                                     RecentCache)
from ...config import HIGH, LOW, MID, CompressionConfig
from .backend import interpret_mode

Array = jax.Array

LOG2E = 1.4426950408889634
MASK_VALUE = -1e30
POS_SENTINEL = 1 << 30

# Row blocks and program count measured on the H100 (PERF.md, kernel
# decisions; scripts/kernel_timing.py): up to 128 stored rows per load and
# enough splits for ~2 programs per SM (264 on 132 SMs).
ROW_BLOCK = 128
TARGET_PROGRAMS = 264
NUM_WARPS = 4
NUM_STAGES = 2


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


class _Pool(NamedTuple):
    """Static description of one pool in the split walk."""

    bits: int
    chunk: int         # tokens per packing chunk
    rows_c: int        # stored rows per chunk
    n_chunks: int
    row_block: int     # rows per unit (power of two)
    n_rb: int          # row blocks per chunk
    split0: int        # first split index of this pool
    n_splits: int

    @property
    def units(self) -> int:
        return self.n_chunks * self.n_rb

    @property
    def per_byte(self) -> int:
        return 1 if self.bits >= 8 else 8 // self.bits


def _pool_kernel(e: _Pool, refs, split, q_ref, qpos, *, groups: int, gs: int,
                 block_h: int, scale2: float, cdt):
    """Walk this split's units of pool `e`; returns (accs, m, l)."""
    if e.bits == 16:
        k_ref, v_ref, pos_ref = refs
    else:
        k_ref, v_ref, ksc_ref, kzp_ref, vsc_ref, vzp_ref, pos_ref = refs
    local = split - e.split0
    u0 = jax.lax.div(local * e.units, e.n_splits)
    u1 = jax.lax.div((local + 1) * e.units, e.n_splits)
    rb = e.row_block
    mask_bits = (1 << e.bits) - 1
    qs = [q_ref[:, pl.ds(g * gs, gs)] for g in range(groups)]
    qsums = [jnp.sum(qg.astype(jnp.float32), axis=1) for qg in qs]

    def unit(u, carry):
        accs, m, l = carry
        c = jax.lax.div(u, e.n_rb)
        t = u - c * e.n_rb
        ridx = t * rb + jnp.arange(rb, dtype=jnp.int32)   # row within chunk
        row_ok = ridx < e.rows_c
        rows = pl.ds(c * e.rows_c + t * rb, rb)
        toks, tok_ok, vis = [], [], []
        for j in range(e.per_byte):
            tok_in_chunk = j * e.rows_c + ridx
            ok = row_ok & (tok_in_chunk < e.chunk)
            tok0 = c * e.chunk + j * e.rows_c + t * rb
            pos = plt.load(pos_ref.at[pl.ds(tok0, rb)], mask=ok,
                           other=POS_SENTINEL)
            toks.append(tok0)
            tok_ok.append(ok)
            vis.append(ok & (pos <= qpos))
        # Scores of every token block of this unit, summed over groups.
        s = [jnp.zeros((block_h, rb), jnp.float32)
             for _ in range(e.per_byte)]
        for g in range(groups):
            cols = pl.ds(g * gs, gs)
            kc = plt.load(k_ref.at[rows, cols], mask=row_ok[:, None],
                          other=0)
            if e.bits == 16:
                s[0] = s[0] + pl.dot(qs[g], kc.astype(cdt), trans_b=True)
                continue
            kc = kc.astype(jnp.int32)
            for j in range(e.per_byte):
                ck = ((kc >> (j * e.bits)) & mask_bits).astype(cdt)
                sc = plt.load(ksc_ref.at[pl.ds(toks[j], rb), g],
                              mask=tok_ok[j], other=0.0)
                zp = plt.load(kzp_ref.at[pl.ds(toks[j], rb), g],
                              mask=tok_ok[j], other=0.0)
                dot = pl.dot(qs[g], ck, trans_b=True)
                s[j] = s[j] + (dot - qsums[g][:, None] * zp[None, :]) \
                    * sc[None, :]
        s = [jnp.where(vis[j][None, :], s[j] * scale2, MASK_VALUE)
             for j in range(e.per_byte)]
        m_new = m
        for sj in s:
            m_new = jnp.maximum(m_new, jnp.max(sj, axis=1))
        alpha = jnp.exp2(m - m_new)
        p = [jnp.where(vis[j][None, :], jnp.exp2(s[j] - m_new[:, None]), 0.0)
             for j in range(e.per_byte)]
        l_new = alpha * l
        for pj in p:
            l_new = l_new + jnp.sum(pj, axis=1)
        new_accs = []
        for g in range(groups):
            cols = pl.ds(g * gs, gs)
            vc = plt.load(v_ref.at[rows, cols], mask=row_ok[:, None],
                          other=0)
            acc = accs[g] * alpha[:, None]
            if e.bits == 16:
                acc = acc + pl.dot(p[0].astype(cdt), vc.astype(cdt))
            else:
                vc = vc.astype(jnp.int32)
                for j in range(e.per_byte):
                    cv = ((vc >> (j * e.bits)) & mask_bits).astype(cdt)
                    sc = plt.load(vsc_ref.at[pl.ds(toks[j], rb), g],
                                  mask=tok_ok[j], other=0.0)
                    zp = plt.load(vzp_ref.at[pl.ds(toks[j], rb), g],
                                  mask=tok_ok[j], other=0.0)
                    ps = p[j] * sc[None, :]
                    acc = (acc + pl.dot(ps.astype(cdt), cv)
                           - jnp.sum(ps * zp[None, :], axis=1)[:, None])
            new_accs.append(acc)
        return tuple(new_accs), m_new, l_new

    init = (tuple(jnp.zeros((block_h, gs), jnp.float32)
                  for _ in range(groups)),
            jnp.full((block_h,), MASK_VALUE, jnp.float32),
            jnp.zeros((block_h,), jnp.float32))
    return jax.lax.fori_loop(u0, u1, unit, init)


def _decode_kernel(qpos_ref, q_ref, *refs, pools: Tuple[_Pool, ...],
                   n_refs: Tuple[int, ...], groups: int, gs: int,
                   block_h: int, scale2: float):
    o_ref, m_ref, l_ref = refs[-3:]
    refs = refs[:-3]
    split = pl.program_id(2)
    qpos = qpos_ref[...]
    cdt = q_ref.dtype
    start = 0
    for e, n in zip(pools, n_refs):
        pool_refs = refs[start:start + n]
        start += n

        @pl.when((split >= e.split0) & (split < e.split0 + e.n_splits))
        def _run(e=e, pool_refs=pool_refs):
            accs, m, l = _pool_kernel(e, pool_refs, split, q_ref, qpos,
                                      groups=groups, gs=gs, block_h=block_h,
                                      scale2=scale2, cdt=cdt)
            for g in range(groups):
                o_ref[:, pl.ds(g * gs, gs)] = accs[g]
            m_ref[...] = m
            l_ref[...] = l


def _merge_partials(o, m, l):
    """Exact base-2 log-sum-exp merge over the split axis (axis 2)."""
    m_all = jnp.max(m, axis=2, keepdims=True)
    w = jnp.exp2(m - m_all)                          # [B, H, S, BH]
    l_sum = jnp.sum(l * w, axis=2)                   # [B, H, BH]
    acc = jnp.sum(o * w[..., None], axis=2)          # [B, H, BH, D]
    return acc / jnp.where(l_sum > 0.0, l_sum, 1.0)[..., None]


def _pool_entry(bits: int, stored_k, stored_v, scales, positions,
                chunk: Optional[int]):
    """(static geometry, arrays) for one pool; `chunk` None = whole axis."""
    n = positions.shape[1]
    if chunk is None or chunk >= n:
        chunk = n
    n_chunks = n // chunk
    rows_c = stored_k.shape[1] // n_chunks
    rb = min(ROW_BLOCK, max(16, _next_pow2(rows_c)))
    n_rb = -(-rows_c // rb)
    geo = dict(bits=bits, chunk=chunk, rows_c=rows_c,
               n_chunks=n_chunks, row_block=rb, n_rb=n_rb)
    arrays = [stored_k, stored_v]
    if bits != 16:
        arrays += list(scales)
    arrays.append(positions)
    return geo, arrays


def decode_supported(head_dim: int, group_size: int) -> bool:
    """Shapes the kernel takes: power-of-two scale groups of >= 16 columns."""
    gs = group_size or head_dim
    return gs >= 16 and gs & (gs - 1) == 0 and head_dim % gs == 0


def fused_decode_attention(
    q: Array,
    cache: CompressedLayerCache,
    recent: RecentCache,
    q_pos: Array,
    cfg: CompressionConfig,
    pool: Optional[DecodePool] = None,
) -> Array:
    """Decode attention over packed tier pools + decode pool + recent ring.

    Args:
      q: [B, 1, H_q, D] (RoPE'd).
      cache: layer's compressed pools (chunk-packed, see module docstring).
      recent: uncompressed decode-token ring.
      q_pos: [B, 1] int32 current positions.
      cfg: compression config (tier bit widths, packing chunk).
      pool: optional quantized decode-token pool (flushed ring blocks).

    Returns: [B, 1, H_q, D] attention output.
    """
    b, _, hq, d = q.shape
    hkv = recent.k.shape[2]
    rep = hq // hkv
    group_size = cfg.quant_group_size or d
    if not decode_supported(d, group_size):
        raise ValueError(f"decode kernel needs power-of-two scale groups of "
                         f">= 16 columns; head_dim {d}, group {group_size}")
    groups = d // group_size
    block_h = max(16, _next_pow2(rep))

    entries = []
    for tier, t in zip((HIGH, MID, LOW), cache.tiers):
        if t.capacity == 0:
            continue
        chunk = t.chunk if t.chunk is not None else cfg.tier_chunk(
            t.capacity)
        entries.append(_pool_entry(
            cfg.tier_bits(tier), t.k_stored, t.v_stored,
            (t.k_scale, t.k_zp, t.v_scale, t.v_zp),
            jnp.where(t.valid, t.positions, POS_SENTINEL), chunk))
    if pool is not None and pool.n_blocks:
        entries.append(_pool_entry(
            pool.bits, pool.k_stored, pool.v_stored,
            (pool.k_scale, pool.k_zp, pool.v_scale, pool.v_zp),
            jnp.where(pool.valid, pool.positions, POS_SENTINEL),
            pool.block_tokens))
    if recent.capacity:
        live = jnp.arange(recent.capacity)[None, :] < recent.length[:, None]
        entries.append(_pool_entry(
            16, recent.k, recent.v, None,
            jnp.where(live, recent.positions, POS_SENTINEL), None))

    # Splits per pool in proportion to its units (one unit = one row block
    # of one chunk, roughly equal bytes), enough to fill the card.
    total_units = sum(g["n_chunks"] * g["n_rb"] for g, _ in entries)
    want = max(len(entries), -(-TARGET_PROGRAMS // (b * hkv)))
    pools: List[_Pool] = []
    cursor = 0
    for geo, _ in entries:
        units = geo["n_chunks"] * geo["n_rb"]
        n_splits = max(1, min(units, round(want * units / total_units)))
        pools.append(_Pool(split0=cursor, n_splits=n_splits, **geo))
        cursor += n_splits
    n_total = cursor

    q_r = q[:, 0].reshape(b, hkv, rep, d)
    if block_h != rep:
        q_r = jnp.pad(q_r, ((0, 0), (0, 0), (0, block_h - rep), (0, 0)))
    inputs = [q_pos.astype(jnp.int32).reshape(b), q_r]
    in_specs = [
        pl.BlockSpec((None,), lambda bi, h, s: (bi,)),
        pl.BlockSpec((None, None, block_h, d), lambda bi, h, s: (bi, h, 0, 0)),
    ]
    n_refs = []
    for e, (_, arrays) in zip(pools, entries):
        for a in arrays:
            if a.ndim == 4:      # stored codes [B, rows, H, D] / scales
                in_specs.append(pl.BlockSpec(
                    (None, a.shape[1], None, a.shape[3]),
                    lambda bi, h, s: (bi, 0, h, 0)))
            else:                # positions [B, N]
                in_specs.append(pl.BlockSpec((None, a.shape[1]),
                                             lambda bi, h, s: (bi, 0)))
            inputs.append(a)
        n_refs.append(len(arrays))

    kernel = functools.partial(
        _decode_kernel, pools=tuple(pools), n_refs=tuple(n_refs),
        groups=groups, gs=group_size, block_h=block_h,
        scale2=LOG2E / (d ** 0.5))
    o, m, l = pl.pallas_call(
        kernel,
        grid=(b, hkv, n_total),
        in_specs=in_specs,
        out_specs=[
            pl.BlockSpec((None, None, None, block_h, d),
                         lambda bi, h, s: (bi, h, s, 0, 0)),
            pl.BlockSpec((None, None, None, block_h),
                         lambda bi, h, s: (bi, h, s, 0)),
            pl.BlockSpec((None, None, None, block_h),
                         lambda bi, h, s: (bi, h, s, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((b, hkv, n_total, block_h, d), jnp.float32),
            jax.ShapeDtypeStruct((b, hkv, n_total, block_h), jnp.float32),
            jax.ShapeDtypeStruct((b, hkv, n_total, block_h), jnp.float32),
        ],
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=NUM_STAGES),
        backend="triton",
        interpret=interpret_mode(),
        name="decode_packed_attention",
    )(*inputs)
    out = _merge_partials(o, m, l)[:, :, :rep]          # [B, Hkv, rep, D]
    return out.reshape(b, 1, hq, d).astype(q.dtype)
