"""Prefill attention with the prompt-mass side-channel, for the GPU.

Contract (plain reference: ops/attention.py): the causal attention output
plus, per query row i, the prompt attention mass
    A_P,i = mean_h Σ_{j<P, j<=i} softmax(s)_ij
— the signal the importance scorer reads (token_importance.py:41-45
semantics; SURVEY.md §7.3 hard part #1) — without materializing the
[S, S] score matrix.

Two implementations:

* Square causal prefill (one-shot `prefill_compressed`): cuDNN's fused
  flash attention returns the output and the per-row log-sum-exp, and the
  mass is recovered exactly in one O(S·P·D) pass,
      mass_i = mean_h Σ_{j<P_b, j<=i} exp(s_ij − lse_i),
  with P <= prompt_cap (128) — at most P/S of the attention work, so a fused
  hand-written mass can only win if the hand-written attention itself beats
  cuDNN (PERF.md, kernel decisions).
* Chunk (rect), positioned and ring-pair modes, which cuDNN cannot express
  without a materialized mask: `_flash_kernel`, a Pallas kernel on the
  Triton route. One program per (query tile, batch row, kv-head group): the
  GQA group's query heads fold into the tile's rows so one K/V load serves
  the whole group; the kv loop runs inside the program up to the causal
  bound; m, l, acc and the mass stay in registers; the mass accumulates only
  over kv blocks below the prompt bound (every block in positioned mode,
  where keys carry arbitrary positions that the program loads itself).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from .backend import interpret_mode

Array = jax.Array

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)
POS_SENTINEL = 1 << 30  # matches decode_attention / kv_cache convention

# Tiles: 128 folded query rows x 64 keys per step, 8 warps at head_dim 128
# and 4 below, 2 pipeline stages (the shape of JAX's own Triton attention
# example; timed on the H100 in PERF.md, not swept).
BLOCK_ROWS = 128
BLOCK_K = 64
NUM_STAGES = 2


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _flash_kernel(plen_ref, qoff_ref, q_ref, k_ref, v_ref, *rest,
                  sm_scale: float, group: int, block_rows: int, block_k: int,
                  n_keys: int, n_tiles: int, causal: bool, positioned: bool):
    """One (query tile, batch row, head group) program.

    Rows of the tile are position-major: row r is query position
    q_start + r // group of head r % group of the group. Scores live in
    base-2 space (sm_scale·log2 e folded into q), so the running max/sum use
    exp2; lse converts back to natural log at the end."""
    if positioned:
        kpos_ref, o_ref, lse_ref, pm_ref = rest
    else:
        o_ref, lse_ref, pm_ref = rest
    tile = n_tiles - 1 - pl.program_id(0)  # latest (heaviest) tiles first
    tq = block_rows // group
    q_start = qoff_ref[...] + tile * tq
    qpos = q_start + jax.lax.div(jnp.arange(block_rows, dtype=jnp.int32),
                                 group)
    plen = plen_ref[...]
    q = q_ref[...]
    q = (q.astype(jnp.float32) * (sm_scale * LOG2E)).astype(q.dtype)
    n_blocks = pl.cdiv(n_keys, block_k)
    ragged = n_keys % block_k != 0

    def step(j, carry, with_mass: bool, masked: bool):
        acc, m, l, pm = carry
        start = j * block_k
        kidx = start + jnp.arange(block_k, dtype=jnp.int32)
        rows = pl.ds(start, block_k)
        if ragged:
            ok = (kidx < n_keys)[:, None]
            k = plt.load(k_ref.at[rows, :], mask=ok, other=0.0)
            v = plt.load(v_ref.at[rows, :], mask=ok, other=0.0)
        else:
            k = k_ref[rows, :]
            v = v_ref[rows, :]
        s = pl.dot(q, k, trans_b=True)                    # [rows, bk] f32
        if positioned:
            if ragged:
                kp = plt.load(kpos_ref.at[rows], mask=kidx < n_keys,
                              other=POS_SENTINEL)
            else:
                kp = kpos_ref[rows]
            visible = kp[None, :] <= qpos[:, None]
            prompt = kp < plen
        else:
            if causal:
                visible = kidx[None, :] <= qpos[:, None]
            else:
                visible = (kidx < n_keys)[None, :]
            prompt = kidx < plen
        if masked:
            s = jnp.where(visible, s, MASK_VALUE)
        m_new = jnp.maximum(m, jnp.max(s, axis=1))
        alpha = jnp.exp2(m - m_new)
        p = jnp.exp2(s - m_new[:, None])
        if masked:
            # A row with no visible key yet has m_new == MASK_VALUE and
            # p == 1 at masked columns; zeroing keeps its l at 0.
            p = jnp.where(visible, p, 0.0)
        l = alpha * l + jnp.sum(p, axis=1)
        pm = alpha * pm
        if with_mass:
            pm = pm + jnp.sum(jnp.where(prompt[None, :], p, 0.0), axis=1)
        acc = acc * alpha[:, None] + pl.dot(p.astype(v.dtype), v)
        return acc, m_new, l, pm

    d = q.shape[-1]
    carry = (jnp.zeros((block_rows, d), jnp.float32),
             jnp.full((block_rows,), -jnp.inf, jnp.float32),
             jnp.zeros((block_rows,), jnp.float32),
             jnp.zeros((block_rows,), jnp.float32))
    loop = jax.lax.fori_loop
    if positioned:
        carry = loop(0, n_blocks, functools.partial(
            step, with_mass=True, masked=True), carry)
    else:
        if causal:
            q_last = q_start + tq - 1
            upper = jnp.minimum(jax.lax.div(q_last, block_k) + 1, n_blocks)
            # Blocks [0, n_full) lie wholly below every row's diagonal.
            n_full = jnp.minimum(jax.lax.div(q_start + 1, block_k), upper)
        else:
            upper = n_blocks
            n_full = n_keys // block_k
        n_prompt = jnp.minimum(jax.lax.div(plen + block_k - 1, block_k),
                               upper)
        mid_end = jnp.maximum(n_prompt, n_full)
        carry = loop(0, n_prompt, functools.partial(
            step, with_mass=True, masked=True), carry)
        carry = loop(n_prompt, mid_end, functools.partial(
            step, with_mass=False, masked=False), carry)
        carry = loop(mid_end, upper, functools.partial(
            step, with_mass=False, masked=True), carry)
    acc, m, l, pm = carry
    live = l > 0.0
    inv = jnp.where(live, 1.0 / jnp.where(live, l, 1.0), 0.0)
    o_ref[...] = (acc * inv[:, None]).astype(o_ref.dtype)
    lse_ref[...] = jnp.where(live, (m + jnp.log2(jnp.where(live, l, 1.0)))
                             * LN2, -jnp.inf)
    pm_ref[...] = pm * inv


def _flash(q: Array, k: Array, v: Array, plen: Array, q_offset,
           causal: bool, k_pos: Optional[Array] = None,
           block_rows: int = BLOCK_ROWS, block_k: int = BLOCK_K
           ) -> Tuple[Array, Array, Array]:
    """Run `_flash_kernel`.

    q: [B, c, Hq, D] queries at global positions q_offset + t (causal) or
    after every key (causal=False); k, v: [B, N, Hkv, D]; plen: [B] prompt
    bound in key coordinates; k_pos: optional [B, N] key positions
    (positioned mode; invalid slots carry POS_SENTINEL).

    Returns (o [B, c, Hq, D] normalized, lse [B, Hq, c] natural log — -inf
    on rows with no visible key —, pm [B, Hq, c] per-head normalized prompt
    mass)."""
    b, c, hq, d = q.shape
    n, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    if d < 16 or d & (d - 1):
        raise ValueError(f"flash kernel needs a power-of-two head_dim >= 16, "
                         f"got {d}")
    # Fold the GQA group into the rows when it is a power of two that leaves
    # at least one query position per tile; otherwise one head per program.
    group = rep if (rep & (rep - 1)) == 0 and rep <= block_rows else 1
    n_groups = hq // group
    per_kv = rep // group
    block_rows = min(block_rows, max(16, _next_pow2(c * group)))
    block_rows = max(block_rows, group)
    block_k = min(block_k, max(16, _next_pow2(n)))
    tq = block_rows // group
    n_tiles = -(-c // tq)
    cp = n_tiles * tq

    qg = q.reshape(b, c, n_groups, group, d)
    if cp != c:
        qg = jnp.pad(qg, ((0, 0), (0, cp - c), (0, 0), (0, 0), (0, 0)))
    qg = qg.transpose(0, 2, 1, 3, 4).reshape(b, n_groups, cp * group, d)
    plen = jnp.asarray(plen, jnp.int32).reshape(b)
    qoff = jnp.asarray(q_offset, jnp.int32).reshape(())

    tile_of = lambda i: n_tiles - 1 - i
    in_specs = [
        pl.BlockSpec((None,), lambda i, bi, g: (bi,)),
        pl.BlockSpec((), lambda i, bi, g: ()),
        pl.BlockSpec((None, None, block_rows, d),
                     lambda i, bi, g: (bi, g, tile_of(i), 0)),
        pl.BlockSpec((None, n, None, d), lambda i, bi, g: (bi, 0, g // per_kv,
                                                           0)),
        pl.BlockSpec((None, n, None, d), lambda i, bi, g: (bi, 0, g // per_kv,
                                                           0)),
    ]
    operands = [plen, qoff, qg, k, v]
    if k_pos is not None:
        in_specs.append(pl.BlockSpec((None, n), lambda i, bi, g: (bi, 0)))
        operands.append(k_pos.astype(jnp.int32))
    row_spec = pl.BlockSpec((None, None, block_rows),
                            lambda i, bi, g: (bi, g, tile_of(i)))
    kernel = functools.partial(
        _flash_kernel, sm_scale=1.0 / (d ** 0.5), group=group,
        block_rows=block_rows, block_k=block_k, n_keys=n, n_tiles=n_tiles,
        causal=causal, positioned=k_pos is not None)
    o, lse, pm = pl.pallas_call(
        kernel,
        grid=(n_tiles, b, n_groups),
        in_specs=in_specs,
        out_specs=[
            pl.BlockSpec((None, None, block_rows, d),
                         lambda i, bi, g: (bi, g, tile_of(i), 0)),
            row_spec, row_spec,
        ],
        out_shape=[
            jax.ShapeDtypeStruct((b, n_groups, cp * group, d), q.dtype),
            jax.ShapeDtypeStruct((b, n_groups, cp * group), jnp.float32),
            jax.ShapeDtypeStruct((b, n_groups, cp * group), jnp.float32),
        ],
        compiler_params=plt.CompilerParams(num_warps=8 if d >= 128 else 4,
                                           num_stages=NUM_STAGES),
        backend="triton",
        interpret=interpret_mode(),
        name="flash_prompt_mass",
    )(*operands)
    o = (o.reshape(b, n_groups, cp, group, d).transpose(0, 2, 1, 3, 4)
         .reshape(b, cp, hq, d)[:, :c])
    stat = lambda x: (x.reshape(b, n_groups, cp, group).transpose(0, 1, 3, 2)
                      .reshape(b, hq, cp)[:, :, :c])
    return o, stat(lse), stat(pm)


# ---------------------------------------------------------------------------
# Square causal prefill: cuDNN (GPU) / XLA (CPU) + exact mass from the lse
# ---------------------------------------------------------------------------

def square_impl(dtype, head_dim: int) -> str:
    """Which implementation the square causal prefill takes.

    GPU: cuDNN's fused attention for bf16/fp16 at head_dim <= 128 (multiple
    of 8), else the Triton kernel (float32, other power-of-two head dims).
    CPU: XLA's attention (the tests' path). Any other case raises — never a
    silent switch to the dense [S, S] form."""
    backend = jax.default_backend()
    if backend == "cpu":
        return "xla"
    if backend != "gpu":
        raise NotImplementedError(
            f"flash prefill runs on 'gpu' (or 'cpu' for tests), not "
            f"{backend!r}; use use_flash=False")
    if (jnp.dtype(dtype) in (jnp.dtype(jnp.bfloat16), jnp.dtype(jnp.float16))
            and head_dim % 8 == 0 and head_dim <= 128):
        return "cudnn"
    if head_dim >= 16 and head_dim & (head_dim - 1) == 0:
        return "triton"
    raise ValueError(f"no flash prefill for dtype {jnp.dtype(dtype)} and "
                     f"head_dim {head_dim} on the GPU; use use_flash=False")


def _attention_with_lse(q: Array, k: Array, v: Array, impl: str
                        ) -> Tuple[Array, Array]:
    """Causal attention output [B, S, Hq, D] and lse [B, Hq, S] (float32,
    natural log) from cuDNN or XLA."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    if impl == "cudnn":
        # The cuDNN wrapper under jax.nn.dot_product_attention: the public
        # function rounds the lse to the input dtype, and a bf16 lse (8
        # mantissa bits, spacing 0.06 at lse ~ 10) would put up to ~3% error
        # on the mass. This one returns cuDNN's float32 softmax statistics.
        from jax._src.cudnn.fused_attention_stablehlo import (
            MaskType, dot_product_attention)
        o, lse = dot_product_attention(q, k, v, scale=scale,
                                       mask_type=MaskType.CAUSAL,
                                       return_residual=True)
        return o, lse.astype(jnp.float32)                  # lse [B, Hq, S]
    # XLA (CPU): computed in float32 so the lse keeps full precision.
    o, lse = jax.nn.dot_product_attention(
        q.astype(jnp.float32), k.astype(jnp.float32), v.astype(jnp.float32),
        scale=scale, is_causal=True, implementation="xla",
        return_residual=True)
    return o.astype(q.dtype), lse.transpose(0, 2, 1)       # [B, S, Hq] ->


def prompt_mass_from_lse(q: Array, k: Array, lse: Array, prompt_len: int,
                         prompt_lens: Optional[Array] = None) -> Array:
    """Exact head-averaged causal prompt mass from the per-row lse.

    q: [B, S, Hq, D]; k: [B, S, Hkv, D]; lse: [B, Hq, S] natural-log
    log-sum-exp of each row's scaled scores. Only the first `prompt_len`
    key columns are scored: O(S·P·D) per head. Returns [B, S] float32."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    rep = hq // hkv
    p = min(prompt_len, s)
    scale = 1.0 / (d ** 0.5)
    q5 = q.reshape(b, s, hkv, rep, d)
    scores = jnp.einsum("bshrd,bphd->bhrsp", q5, k[:, :p],
                        preferred_element_type=jnp.float32) * scale
    probs = jnp.exp(scores - lse.reshape(b, hkv, rep, s)[..., None])
    col = jnp.arange(p)
    keep = col[None, :] <= jnp.arange(s)[:, None]                 # [S, P]
    if prompt_lens is not None:
        keep = keep[None] & (col[None, None, :]
                             < prompt_lens.astype(jnp.int32)[:, None, None])
        keep = keep[:, None, None]                                # [B,1,1,S,P]
    probs = jnp.where(keep, probs, 0.0)
    return probs.sum(axis=-1).mean(axis=(1, 2))


def flash_prefill_with_prompt_mass(
    q: Array,
    k: Array,
    v: Array,
    prompt_len: int,
    prompt_lens: Optional[Array] = None,
    impl: Optional[str] = None,
) -> Tuple[Array, Array]:
    """Causal prefill attention + prompt mass without an [S, S] matrix.

    Drop-in for `ops.attention.prefill_attention_with_prompt_mass`.

    Args:
      q: [B, S, H_q, D]; k, v: [B, S, H_kv, D].
      prompt_len: static prompt prefix length P (upper bound for ragged
        batches).
      prompt_lens: optional [B] dynamic per-row prompt lengths <= P.
      impl: "cudnn", "xla" or "triton"; None picks by backend, dtype and
        shape (`square_impl`).

    Returns:
      out: [B, S, H_q, D]; prompt_mass: [B, S] float32 (head-averaged).
    """
    b, s, hq, d = q.shape
    impl = impl or square_impl(q.dtype, d)
    if impl == "triton":
        plens = (jnp.full((b,), prompt_len, jnp.int32) if prompt_lens is None
                 else prompt_lens)
        o, _lse, pm = _flash(q, k, v, plens, 0, causal=True)
        return o, pm.mean(axis=1)
    o, lse = _attention_with_lse(q, k, v, impl)
    return o, prompt_mass_from_lse(q, k, lse, prompt_len, prompt_lens)


def flash_chunk_attention_with_prompt_mass(
    q: Array,
    k_buf: Array,
    v_buf: Array,
    q_offset: Array,
    prompt_len: int,
    prompt_lens: Optional[Array] = None,
) -> Tuple[Array, Array]:
    """Flash form of `ops.attention.chunk_attention_with_prompt_mass`.

    Rectangular causal attention of one prefill CHUNK (queries at traced
    global positions q_offset..q_offset+c-1) over the position-ordered KV
    buffer [B, S, H_kv, D] — without the [c, S] score matrix the dense form
    allocates (B·Hq·c·S float32: 16 GiB per layer for a 4K chunk over a 32K
    buffer at Mistral-7B widths). q_offset is traced, so ONE compiled
    program serves every chunk of a bucket. Buffer rows past the current
    fill hold later positions and are causally invisible.

    Returns (out [B, c, H_q, D], prompt_mass [B, c]).
    """
    b = q.shape[0]
    plens = (jnp.full((b,), prompt_len, jnp.int32) if prompt_lens is None
             else prompt_lens)
    o, _lse, pm = _flash(q, k_buf, v_buf, plens, q_offset, causal=True)
    return o, pm.mean(axis=1)


def flash_pair_attention(
    q: Array,
    k: Array,
    v: Array,
    plen_local: Array,
    causal: bool,
) -> Tuple[Array, Array, Array]:
    """One (query block, key block) pair of blockwise/ring attention.

    The building block of sequence-parallel ring prefill (SURVEY.md §7.2
    Phase 4): each pair returns partial-softmax statistics that merge
    exactly across pairs via the log-sum-exp combination — the prompt-mass
    side-channel participates in the same rescale, so the merged mass
    equals the single-device value.

    Args:
      q: [B, S_q, H_q, D] queries (RoPE'd at their global positions).
      k, v: [B, S_k, H_kv, D] one key block (same layout).
      plen_local: [B] prompt length in the KEY block's local coordinates
        (clip(prompt_len - k_offset, 0, S_k)).
      causal: True for the diagonal pair (q and k are the same block of the
        global sequence); False when the key block globally precedes every
        query (full attention).

    Returns:
      (o, lse, pmass): o [B, S_q, H_q, D] normalized partial output;
      lse [B, H_q, S_q]; pmass [B, H_q, S_q] PER-HEAD normalized prompt mass
      (the merge weights are per-head, so averaging happens after merging).
      Rows with no visible keys have lse = -inf and o = 0.
    """
    return _flash(q, k, v, plen_local, 0, causal=causal)


def merge_attention_partials(parts):
    """Exact log-sum-exp merge of normalized attention partials.

    parts: sequence of (o [B, S, Hq, D], lse [B, Hq, S], pm [B, Hq, S])
    from flash_pair_attention / flash_positioned_attention over DISJOINT
    key sets. Returns (out [B, S, Hq, D], pmass [B, Hq, S]) — identical math
    to the ring-attention merge (parallel/ring_attention.py).
    """
    lse_all = jnp.stack([p[1] for p in parts])          # [T, B, Hq, S]
    m = jnp.max(lse_all, axis=0)
    m = jnp.where(jnp.isfinite(m), m, 0.0)
    w = jnp.exp(lse_all - m[None])
    w_sum = jnp.maximum(w.sum(axis=0), 1e-30)
    o_all = jnp.stack([p[0].astype(jnp.float32) for p in parts])
    w_q = jnp.moveaxis(w, 3, 2)                         # [T, B, S, Hq]
    out = (o_all * w_q[..., None]).sum(axis=0) / \
        jnp.moveaxis(w_sum, 2, 1)[..., None]            # [B, S, Hq, D]
    pm_all = jnp.stack([p[2] for p in parts])
    pm = (pm_all * w).sum(axis=0) / w_sum               # [B, Hq, S]
    return out, pm


def flash_positioned_attention(
    q: Array,
    k: Array,
    v: Array,
    k_pos: Array,
    q_offset: Array,
    prompt_len: int,
) -> Tuple[Array, Array, Array]:
    """Flash attention of chunk queries over POSITIONED key slots.

    The pool half of compressed-prefix chunked prefill: keys are compressed
    pool slots at arbitrary global positions (invalid slots folded to
    POS_SENTINEL by the caller); visibility is k_pos <= q_offset+row and
    the prompt indicator is k_pos < prompt_len — per element inside the
    kernel, which loads the key positions itself.

    Args:
      q: [B, c, H_q, D]; k, v: [B, N, H_kv, D] dequantized pool slots.
      k_pos: [B, N] int32 global positions (invalid -> POS_SENTINEL).
      q_offset: traced scalar — global position of the chunk's first row.
      prompt_len: static prompt bound.

    Returns (o [B, c, Hq, D] normalized partial, lse [B, Hq, c],
    pm [B, Hq, c]) for `merge_attention_partials`.
    """
    b = q.shape[0]
    return _flash(q, k, v, jnp.full((b,), prompt_len, jnp.int32), q_offset,
                  causal=True, k_pos=k_pos)


def flash_compressed_prefix_attention(
    q: Array,
    k_pool: Array,
    v_pool: Array,
    pos_pool: Array,
    valid_pool: Array,
    k_chunk: Array,
    v_chunk: Array,
    q_offset: Array,
    prompt_len: int,
) -> Tuple[Array, Array]:
    """Chunk attention over {compressed pools} ++ {own chunk}, flash form.

    Two flash partials — positioned over the dequantized pools, square
    causal over the chunk itself — merged with the exact lse combination.
    Drop-in for the dense `ops.attention.positioned_attention_with_
    prompt_mass` over the concatenated set (models/llama.py
    prefill_chunked_compressed_step use_flash=True).

    Returns (out [B, c, Hq, D], prompt_mass [B, c]).
    """
    b, c = q.shape[:2]
    kpos = jnp.where(valid_pool, pos_pool, POS_SENTINEL)
    part_pool = flash_positioned_attention(q, k_pool, v_pool, kpos, q_offset,
                                           prompt_len)
    plen_local = jnp.clip(prompt_len - q_offset, 0, c)
    part_self = flash_pair_attention(q, k_chunk, v_chunk,
                                     jnp.broadcast_to(plen_local, (b,)),
                                     causal=True)
    out, pm = merge_attention_partials([part_pool, part_self])
    return out.astype(q.dtype), pm.mean(axis=1)
