"""Speculative decoding over the compressed KV cache.

No reference counterpart (the reference decodes strictly one token per
forward, src/evaluation/longbench_eval.py:131-139 via HF `generate`); this
is a throughput lever on top of the compressed cache: batch-1 decode is
weight-streaming-bound, so verifying K
draft tokens in ONE forward pass reads the weights once for up to K+1
emitted tokens.

Design:
  - Drafting is pluggable; the default is prompt-lookup (n-gram) drafting:
    match the last bigram of the generated stream against the prompt and
    propose the tokens that followed it there. Zero model cost, and
    long-context QA/summarization outputs copy prompt spans, so acceptance
    is high exactly in this framework's target regime.
  - `verify_forward` scores all K+1 tokens in one pass over
    [compressed tier pools | recent ring | decode pool | the draft block
    itself] using the exact position-based causal mask
    (ops/attention.attention_over_tokens), so intra-block causality is
    free.  It mutates NO state.
  - `commit_block` then replays ring flush + append for ONLY the accepted
    prefix (gated `append_recent`), so the cache is byte-identical to the
    one sequential decode would have built.

Exactness: emitted tokens are greedy-argmax verified, and the accepted run
is truncated at the ring-fill boundary so flushes happen at iteration start
exactly where sequential `decode_step` would flush. Output is therefore
token-identical to `decode_loop` (greedy) — asserted in
tests/test_speculative.py. Without decode pools the same ring-capacity
bound as `decode_loop` applies (appends past a full ring drop).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp

from ..compression.compressor import dequantize_layer_cache
from ..compression.kv_cache import (append_recent, dequantize_decode_pool,
                                    flush_recent)
from ..config import CompressionConfig, ModelConfig
from ..ops.attention import attention_over_tokens
from .llama import (DecodeState, _embed_lookup, _matmul, _mlp, _qkv,
                    apply_rope, logits_from_hidden, rmsnorm, rope_tables)

Array = jax.Array
Params = Dict


# ---------------------------------------------------------------------------
# Drafting: prompt-lookup (n-gram) proposer
# ---------------------------------------------------------------------------

def propose_prompt_lookup(prompt_ids: Array, prompt_lens: Array,
                          last2: Array, n_draft: int) -> Array:
    """Draft `n_draft` tokens by bigram lookup in the prompt.

    Finds the LATEST position j in each row's prompt where
    (prompt[j-1], prompt[j]) == (last2[0], last2[1]) and proposes
    prompt[j+1 : j+1+n_draft]. No match -> repeat the last token (those
    drafts are simply rejected by verification; drafts only affect speed,
    never correctness).

    Args:
      prompt_ids: [B, S] int32 (right-padded).
      prompt_lens: [B] true prompt lengths.
      last2: [B, 2] the two most recent tokens of the generated stream.
    Returns: [B, n_draft] int32 draft tokens.
    """
    b, s = prompt_ids.shape
    pos = jnp.arange(s)[None]                                     # [1, S]
    prev = jnp.concatenate([jnp.zeros((b, 1), prompt_ids.dtype),
                            prompt_ids[:, :-1]], axis=1)
    # A usable match must have at least one continuation token inside the
    # prompt (a match ending at the prompt tail proposes nothing).
    match = ((prev == last2[:, 0:1]) & (prompt_ids == last2[:, 1:2])
             & (pos >= 1) & (pos + 1 < prompt_lens[:, None]))      # [B, S]
    any_match = jnp.any(match, axis=1)                            # [B]
    j_best = jnp.argmax(jnp.where(match, pos, -1), axis=1)        # [B]
    cont = j_best[:, None] + 1 + jnp.arange(n_draft)[None]        # [B, K]
    looked_up = jnp.take_along_axis(prompt_ids, jnp.minimum(cont, s - 1),
                                    axis=1)                       # [B, K]
    usable = any_match[:, None] & (cont < prompt_lens[:, None])   # per slot
    fallback = jnp.broadcast_to(last2[:, 1:2], (b, n_draft))
    return jnp.where(usable, looked_up, fallback)


# ---------------------------------------------------------------------------
# Verify + commit
# ---------------------------------------------------------------------------

def verify_forward(params: Params, tokens: Array, state: DecodeState,
                   cfg: ModelConfig, ccfg: CompressionConfig
                   ) -> Tuple[Array, List[Tuple[Array, Array]]]:
    """Score T tokens in one forward over the compressed caches.

    tokens[:, 0] is the pending last emitted token, tokens[:, 1:] the
    drafts. Attention runs over [tier pools | recent ring | decode pool |
    the block itself]; the position-based mask gives exact intra-block
    causality. State is NOT mutated.

    Returns (logits [B, T, V], per-layer [(k_blk, v_blk)] for commit).
    """
    b, t = tokens.shape
    h = _embed_lookup(params["embed"], tokens, jnp.dtype(cfg.dtype),
                      cfg=cfg)
    q_pos = state.position[:, None] + jnp.arange(t)[None]          # [B, T]
    cos, sin = rope_tables(q_pos, cfg.head_dim, cfg.rope_theta,
            cfg.rope_scaling)
    have_pools = bool(state.pools) and state.pools[0] is not None
    blocks: List[Tuple[Array, Array]] = []
    blk_valid = jnp.ones((b, t), bool)
    for i, layer in enumerate(params["layers"]):
        x = rmsnorm(h, layer["input_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(layer, x, cfg)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        blocks.append((k, v))
        cache = state.caches[i]
        recent = state.recents[i]
        k_c, v_c, pos_c, valid_c = dequantize_layer_cache(cache, ccfg,
                                                          q.dtype)
        rec_valid = (jnp.arange(recent.capacity)[None]
                     < recent.length[:, None])
        ks = [k_c.astype(q.dtype), recent.k, k]
        vs = [v_c.astype(q.dtype), recent.v, v]
        ps = [pos_c, recent.positions, q_pos]
        vds = [valid_c, rec_valid, blk_valid]
        if have_pools:
            k_p, v_p, pos_p, valid_p = dequantize_decode_pool(
                state.pools[i], q.dtype)
            ks.insert(2, k_p)
            vs.insert(2, v_p)
            ps.insert(2, pos_p)
            vds.insert(2, valid_p)
        attn_out = attention_over_tokens(
            q, jnp.concatenate(ks, axis=1), jnp.concatenate(vs, axis=1),
            jnp.concatenate(ps, axis=1), jnp.concatenate(vds, axis=1),
            q_pos)
        h = h + _matmul(attn_out.reshape(b, t, cfg.q_dim), layer["wo"])
        h = h + _mlp(layer, rmsnorm(h, layer["post_norm"], cfg.rms_norm_eps),
                     cfg)
    return logits_from_hidden(params, h, cfg), blocks


def flush_full_rings(state: DecodeState, cfg: ModelConfig,
                     ccfg: CompressionConfig) -> DecodeState:
    """Flush any full recent rings into the decode pools (no-op rows
    untouched; no-op entirely when pools are disabled). Matches the
    flush-then-attend order of sequential `decode_step`."""
    if not (bool(state.pools) and state.pools[0] is not None):
        return state
    recents, pools = [], []
    for recent, pool in zip(state.recents, state.pools):
        recent, pool = flush_recent(recent, pool, ccfg, cfg)
        recents.append(recent)
        pools.append(pool)
    return dataclasses.replace(state, recents=tuple(recents),
                               pools=tuple(pools))


def commit_block(state: DecodeState, blocks: List[Tuple[Array, Array]],
                 keep: Array, cfg: ModelConfig, ccfg: CompressionConfig
                 ) -> DecodeState:
    """Append the first keep[b] tokens of each layer's draft-block K/V to
    the recent rings (flushing into decode pools exactly as sequential
    steps would) and advance positions by keep."""
    t = blocks[0][0].shape[1]
    have_pools = bool(state.pools) and state.pools[0] is not None
    new_recents, new_pools = [], []
    for i in range(len(state.recents)):
        recent = state.recents[i]
        pool = state.pools[i] if have_pools else None
        k_blk, v_blk = blocks[i]
        for j in range(t):
            if pool is not None:
                recent, pool = flush_recent(recent, pool, ccfg, cfg)
            gate = j < keep
            pos_j = state.position[:, None] + j
            recent = append_recent(recent, k_blk[:, j:j + 1],
                                   v_blk[:, j:j + 1], pos_j, gate=gate)
        new_recents.append(recent)
        new_pools.append(pool)
    return DecodeState(
        caches=state.caches, recents=tuple(new_recents),
        position=state.position + keep,
        pools=tuple(new_pools) if have_pools else state.pools)


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def extend_prefill(
    params: Params,
    state: DecodeState,
    suffix_ids: Array,
    suffix_lens: Array,
    cfg: ModelConfig,
    ccfg: CompressionConfig,
) -> Tuple[Array, DecodeState]:
    """Extend a compressed prefill with additional prompt tokens (the
    longest-prefix prefix-cache continuation; serving/engine.py partial
    hits).

    The suffix attends to [compressed tier pools | decode pool | recent
    ring | itself (causal)] — exactly the approximation decode already
    makes over a compressed prefix — and its K/V append to the recent ring
    (flushing into decode pools as sequential steps would). The cached
    prefix state must have ring headroom for the suffix
    (ServingEngine.register_prefix allocates it); the compressed prefix
    pools are reused verbatim: ~4x denser than a bf16 prefix cache at the
    same context, which is what makes prefix caching cheap here.

    Args:
      state: single-or-batched DecodeState at the prefix length (positions
        carry it). NOT mutated.
      suffix_ids: [B, T] right-padded suffix tokens.
      suffix_lens: [B] true suffix lengths (padding tokens sit at later
        positions, so real queries never attend them; their K/V never
        commit).

    Returns (last_logits [B, V] — logits at each row's final real suffix
    token, the next-token distribution, and the advanced state).
    """
    logits, blocks = verify_forward(params, suffix_ids, state, cfg, ccfg)
    keep = suffix_lens.astype(jnp.int32)
    new_state = commit_block(state, blocks, keep, cfg, ccfg)
    last = jnp.take_along_axis(
        logits, (keep - 1)[:, None, None].astype(jnp.int32), axis=1)[:, 0]
    return last, new_state


def speculative_decode_loop(
    params: Params,
    first_token: Array,
    state: DecodeState,
    n_steps: int,
    cfg: ModelConfig,
    ccfg: CompressionConfig,
    prompt_ids: Array,
    prompt_lens: Optional[Array] = None,
    n_draft: int = 4,
    proposer: Optional[Callable[[Array, Array, Array], Array]] = None,
    prev_token: Optional[Array] = None,
) -> Tuple[Array, DecodeState, Dict[str, Array]]:
    """Greedy speculative decode: token-identical to `decode_loop`, up to
    (n_draft+1)x fewer forward passes.

    One XLA program (lax.while_loop); each iteration drafts n_draft tokens,
    verifies them in one forward, emits the accepted prefix plus the bonus
    token, and commits exactly those tokens' K/V.

    Args:
      first_token: [B] the token sampled from prefill logits (same contract
        as `decode_loop`).
      prompt_ids / prompt_lens: the prompt (right-padded) for the default
        prompt-lookup proposer.
      proposer: optional override, called as proposer(last2 [B,2],
        count [B], out [B,n_steps]) -> [B, n_draft] drafts. `count` is the
        number of tokens emitted so far (excluding first_token).
      prev_token: [B] the token generated immediately BEFORE `first_token`
        (seeds the bigram for the first proposal). Defaults to the prompt's
        last token — correct when `first_token` came from prefill; a
        continuation of an earlier generation (adaptive_speculative_decode's
        chunks) must pass the true predecessor.

    Returns (tokens [B, n_steps], state, stats) where stats carries
    `iterations` (forward passes run) and `drafted_accepted` /
    `draft_rate` for observability.
    """
    b = first_token.shape[0]
    t = n_draft + 1
    if prompt_lens is None:
        prompt_lens = jnp.full((b,), prompt_ids.shape[1], jnp.int32)
    if proposer is None:
        def proposer(last2, count, out):
            return propose_prompt_lookup(prompt_ids, prompt_lens, last2,
                                         n_draft)

    if prev_token is None:
        prev_token = jnp.take_along_axis(
            prompt_ids, (prompt_lens - 1)[:, None].astype(jnp.int32),
            axis=1)[:, 0]
    ring_cap = state.recents[0].capacity
    have_pools = bool(state.pools) and state.pools[0] is not None

    init = dict(
        state=state,
        last_tok=first_token.astype(jnp.int32),
        prev_tok=prev_token.astype(jnp.int32),
        out=jnp.zeros((b, n_steps), jnp.int32),
        count=jnp.zeros((b,), jnp.int32),
        iters=jnp.zeros((), jnp.int32),
        accepted=jnp.zeros((), jnp.int32),
    )

    def cond(c):
        return jnp.any(c["count"] < n_steps)

    def body(c):
        st = flush_full_rings(c["state"], cfg, ccfg)
        last2 = jnp.stack([c["prev_tok"], c["last_tok"]], axis=1)
        drafts = proposer(last2, c["count"], c["out"]).astype(jnp.int32)
        tokens = jnp.concatenate([c["last_tok"][:, None], drafts], axis=1)
        logits, blocks = verify_forward(params, tokens, st, cfg, ccfg)
        greedy = jnp.argmax(logits, axis=-1).astype(jnp.int32)  # [B, T]

        # Accept drafts while they match the greedy verification.
        ok = drafts == greedy[:, :-1]                            # [B, K]
        n_acc = jnp.sum(jnp.cumprod(ok.astype(jnp.int32), axis=1), axis=1)
        m = n_acc + 1                                            # emit count
        if have_pools:
            # Truncate at the ring-fill boundary so flushes land at
            # iteration start exactly where sequential decode flushes
            # (full-ring rows were flushed above, so free >= 1).
            free = ring_cap - st.recents[0].length
            m = jnp.minimum(m, free)
        # Never commit past the requested generation length: the final
        # state must be byte-identical to sequential decode's.
        active = c["count"] < n_steps
        m = jnp.where(active, jnp.minimum(m, n_steps - c["count"]), 0)

        # Emitted tokens are greedy[:, :m] (accepted drafts equal their
        # greedy verification; position m-1 is the bonus token).
        cols = c["count"][:, None] + jnp.arange(t)[None]          # [B, T]
        write = (jnp.arange(t)[None] < m[:, None]) & (cols < n_steps)
        # Non-writes scatter to an out-of-bounds column and are dropped —
        # clipping would collide with (and could clobber) the real write at
        # the last column.
        cols_w = jnp.where(write, cols, n_steps)
        bidx = jnp.arange(b)[:, None]
        out = c["out"].at[bidx, cols_w].set(greedy, mode="drop")

        st = commit_block(st, blocks, m, cfg, ccfg)

        last_idx = jnp.maximum(m - 1, 0)[:, None]
        new_last = jnp.take_along_axis(greedy, last_idx, axis=1)[:, 0]
        new_prev = jnp.where(
            m >= 2,
            jnp.take_along_axis(greedy, jnp.maximum(m - 2, 0)[:, None],
                                axis=1)[:, 0],
            c["last_tok"])
        return dict(
            state=st,
            last_tok=jnp.where(active, new_last, c["last_tok"]),
            prev_tok=jnp.where(active, new_prev, c["prev_tok"]),
            out=out,
            count=jnp.minimum(c["count"] + m, n_steps),
            iters=c["iters"] + 1,
            accepted=c["accepted"] + jnp.sum(jnp.where(active, n_acc, 0)),
        )

    final = jax.lax.while_loop(cond, body, init)
    stats = {
        "iterations": final["iters"],
        "drafted_accepted": final["accepted"],
        "draft_rate": final["accepted"] / jnp.maximum(
            final["iters"] * n_draft * b, 1),
    }
    return final["out"], final["state"], stats


# ---------------------------------------------------------------------------
# Adaptive drafting: fall back to plain decode when acceptance collapses
# ---------------------------------------------------------------------------

# One compiled program per (config, chunk length, n_draft, proposer) — the
# host loop below alternates between entries, so they must persist across
# calls (timing reps / serving requests) or every rep would recompile.
_ADAPTIVE_PROGRAMS: Dict = {}


def _spec_chunk_fn(cfg, ccfg, chunk, n_draft, proposer_key, proposer):
    key = ("spec", cfg, ccfg, chunk, n_draft, proposer_key)
    if key not in _ADAPTIVE_PROGRAMS:
        @jax.jit
        def f(params, first, prev, state, prompt_ids, prompt_lens):
            return speculative_decode_loop(
                params, first, state, chunk, cfg, ccfg, prompt_ids,
                prompt_lens, n_draft, proposer=proposer, prev_token=prev)
        _ADAPTIVE_PROGRAMS[key] = f
    return _ADAPTIVE_PROGRAMS[key]


def _plain_chunk_fn(cfg, ccfg, chunk):
    key = ("plain", cfg, ccfg, chunk)
    if key not in _ADAPTIVE_PROGRAMS:
        from .llama import decode_loop

        @jax.jit
        def f(params, first, state):
            return decode_loop(params, first, state, chunk, cfg, ccfg)
        _ADAPTIVE_PROGRAMS[key] = f
    return _ADAPTIVE_PROGRAMS[key]


def adaptive_speculative_decode(
    params: Params,
    first_token: Array,
    state: DecodeState,
    n_steps: int,
    cfg: ModelConfig,
    ccfg: CompressionConfig,
    prompt_ids: Array,
    prompt_lens: Optional[Array] = None,
    n_draft: int = 4,
    chunk: int = 16,
    min_tokens_per_forward: float = 1.3,
    probe_every: int = 4,
    proposer: Optional[Callable[[Array, Array, Array], Array]] = None,
) -> Tuple[Array, DecodeState, Dict]:
    """Speculative decode that cannot lose to plain decode by more than one
    probe chunk in `probe_every`: a host-side controller measures realized
    tokens-per-forward per chunk and switches arms.

    The failure this guards: when the generation stops copying prompt
    spans, prompt-lookup acceptance collapses and speculative decode runs
    slower than plain decode — misprediction cost is real. A fixed
    n_draft must be chosen per workload; this controller observes the
    workload instead:

      - decode in chunks of `chunk` tokens, each chunk one XLA program
        (the speculative while_loop or plain decode_loop's scan);
      - after a speculative chunk, tokens-per-forward = chunk/iterations
        (EMA-smoothed). Below `min_tokens_per_forward` (verify forward at
        T=n_draft+1 costs ~1.0-1.3x a T=1 step on the weight-streaming-bound
        shapes this targets), switch to plain chunks;
      - re-probe with one speculative chunk every `probe_every` plain chunks
        (acceptance recovers when the generation re-enters a copyable span).

    Output is token-identical to `decode_loop` (greedy): both arms emit
    greedy-verified tokens and commit byte-identical cache state, asserted
    in tests/test_speculative.py for good AND adversarial proposers.

    Returns (tokens [B, n_steps], state, stats). stats["arms"] is the
    per-chunk arm trace [("spec", tokens_per_forward) | ("plain", 1.0)];
    stats["forwards"] the total verify/decode forward count (the cost
    driver); stats["draft_rate"] the acceptance over speculative chunks.
    """
    b = first_token.shape[0]
    if prompt_lens is None:
        prompt_lens = jnp.full((b,), prompt_ids.shape[1], jnp.int32)
    prev = jnp.take_along_axis(
        prompt_ids, (prompt_lens - 1)[:, None].astype(jnp.int32),
        axis=1)[:, 0].astype(jnp.int32)
    last = first_token.astype(jnp.int32)

    proposer_key = proposer  # hashable function object; None = prompt-lookup
    outs: List[Array] = []
    arms: List[Tuple[str, float]] = []
    done = 0
    forwards = 0
    drafted = 0
    accepted = 0
    ema = None
    spec_on = True
    plain_since_probe = 0
    while done < n_steps:
        c = min(chunk, n_steps - done)
        if spec_on:
            run = _spec_chunk_fn(cfg, ccfg, c, n_draft, proposer_key,
                                 proposer)
            out, state, st = run(params, last, prev, state, prompt_ids,
                                 prompt_lens)
            iters = int(st["iterations"])
            forwards += iters
            drafted += iters * n_draft * b
            accepted += int(st["drafted_accepted"])
            tpf = c / max(iters, 1)
            ema = tpf if ema is None else 0.5 * ema + 0.5 * tpf
            arms.append(("spec", tpf))
            if ema < min_tokens_per_forward:
                spec_on = False
                plain_since_probe = 0
                ema = None  # forget the collapsed regime before re-probing
        else:
            run = _plain_chunk_fn(cfg, ccfg, c)
            out, state = run(params, last, state)
            forwards += c
            arms.append(("plain", 1.0))
            plain_since_probe += 1
            if plain_since_probe >= probe_every:
                spec_on = True
        done += c
        prev = out[:, -2] if c >= 2 else last
        last = out[:, -1]
        outs.append(out)

    stats = {
        "arms": arms,
        "forwards": forwards,
        "draft_rate": accepted / max(drafted, 1),
        "spec_chunks": sum(1 for a, _ in arms if a == "spec"),
        "plain_chunks": sum(1 for a, _ in arms if a == "plain"),
    }
    return jnp.concatenate(outs, axis=1), state, stats
