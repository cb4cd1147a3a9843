"""Sequence-parallel (ring) prefill attention with the exact prompt-mass
side-channel, over a `seq` mesh axis.

North-star component (SURVEY.md §7.2 Phase 4, §5 "long-context"): the
reference handles long context only by *truncating the data*
(/root/reference/src/utils/data_utils.py:154-168); here the prefill
sequence axis shards across devices, K/V blocks rotate around the ring
with `ppermute`, and each (query-shard, key-block) pair runs the flash
kernel (ops/pallas/flash_prefill.flash_pair_attention). Partial
softmax statistics merge with the standard log-sum-exp combination; the
prompt attention mass participates in the same per-head rescale, so the
merged mass — and therefore importance scoring, selection, and the
compressed caches — is EXACT w.r.t. the single-device computation.

Design notes:
  * Block skip is control flow over *values*: every shard traces the same
    program; pairs whose key block lies entirely in a query's future run
    a `lax.cond` skip branch that returns neutral statistics (lse = -inf).
  * The diagonal pair (t = 0) is statically causal; all rotated pairs
    (t > 0) are statically non-causal (visible iff the key block precedes
    the query block) — so the kernel's `causal` flag stays trace-time
    static (it selects the kernel's program).
  * Work per shard: S_loc x S_global scores blockwise — the same FLOPs as
    single-device flash split n ways, with no S x S materialization and
    only K/V-block ppermutes (2 * S_loc * H_kv * D per step) between
    devices.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

Array = jax.Array

NEG_INF = -jnp.inf


def _neutral_pair(b, s_loc, hq, d, dtype):
    return (jnp.zeros((b, s_loc, hq, d), dtype),
            jnp.full((b, hq, s_loc), NEG_INF, jnp.float32),
            jnp.zeros((b, hq, s_loc), jnp.float32))


def ring_prefill_attention(
    q: Array,
    k: Array,
    v: Array,
    prompt_len: int,
    axis_name: str,
    n_shards: int,
    prompt_lens: Optional[Array] = None,
) -> Tuple[Array, Array]:
    """Causal flash attention + prompt mass with the sequence axis sharded.

    Must run inside shard_map over `axis_name`. Shard i holds queries and
    the i-th K/V block of the global sequence (global offset i * S_loc).

    Args:
      q: [B, S_loc, H_q, D] local queries, RoPE'd at global positions.
      k, v: [B, S_loc, H_kv, D] local keys/values (RoPE'd, global).
      prompt_len: static global prompt prefix length P.
      axis_name: mesh axis carrying the sequence.
      n_shards: static size of that axis.
      prompt_lens: optional [B] dynamic per-row prompt lengths (ragged
        batches) — the mass side-channel then follows each row's true
        prompt region. Padding keys sit at the global END, so causality
        already hides them from real queries; padding query rows emit
        garbage the caller masks.

    Returns:
      (out [B, S_loc, H_q, D], prompt_mass [B, S_loc] head-averaged) — the
      local rows of the exact global result.
    """
    b, s_loc, hq, d = q.shape
    my = jax.lax.axis_index(axis_name)
    q_off = my * s_loc

    from ..ops.pallas.flash_prefill import flash_pair_attention as pair

    os, lses, pms = [], [], []
    kk, vv = k, v
    for t in range(n_shards):
        src = jax.lax.rem(my - t + n_shards, n_shards)
        k_off = src * s_loc
        plen_g = prompt_len if prompt_lens is None else prompt_lens
        plen_loc = jnp.clip(plen_g - k_off, 0, s_loc)
        plen_b = jnp.broadcast_to(plen_loc, (b,))
        if t == 0:
            o, lse, pm = pair(q, kk, vv, plen_b, causal=True)
        else:
            o, lse, pm = jax.lax.cond(
                k_off < q_off,
                lambda args: pair(args[0], args[1], args[2], args[3],
                                  causal=False),
                lambda args: _neutral_pair(b, s_loc, hq, d, q.dtype),
                (q, kk, vv, plen_b))
        os.append(o.astype(jnp.float32))
        lses.append(lse)
        pms.append(pm)
        if t + 1 < n_shards:
            perm = [(i, (i + 1) % n_shards) for i in range(n_shards)]
            kk = jax.lax.ppermute(kk, axis_name, perm)
            vv = jax.lax.ppermute(vv, axis_name, perm)

    # Log-sum-exp merge across pairs (exact): w_t = exp(lse_t - M).
    lse_all = jnp.stack(lses)                      # [T, B, Hq, S]
    m = jnp.max(lse_all, axis=0)                   # [B, Hq, S]
    w = jnp.exp(lse_all - m[None])                 # [T, B, Hq, S]
    w_sum = jnp.maximum(w.sum(axis=0), 1e-30)
    o_all = jnp.stack(os)                          # [T, B, S, Hq, D]
    w_q = jnp.moveaxis(w, 3, 2)                    # [T, B, S, Hq]
    out = (o_all * w_q[..., None]).sum(axis=0) / \
        jnp.moveaxis(w_sum, 2, 1)[..., None]       # [B, S, Hq, D]
    pm_all = jnp.stack(pms)                        # [T, B, Hq, S]
    pm_merged = (pm_all * w).sum(axis=0) / w_sum   # [B, Hq, S]
    return out.astype(q.dtype), pm_merged.mean(axis=1)
