"""Beam search over the compressed KV cache.

API-parity counterpart of the HF `model.generate(num_beams=...)` surface the
reference reached through GenerationConfig (src/evaluation/longbench_eval.py:
131-139 — the reference used `do_sample=False`, i.e. HF's beam machinery was
available but unexercised; this makes it a first-class, jit-safe capability).

Design:
  * The whole search is ONE `lax.scan` program — B·W beam rows decode as a
    single batch through `decode_step`, so each layer runs one fat matmul
    instead of W thin ones.
  * Beam reindexing (each step keeps the W best (parent, token) pairs) is a
    pure axis-0 gather over the decode-state pytree. Because the state is the
    *compressed* cache (packed sub-byte pools + small rings), the per-step
    gather moves ~5x fewer bytes than beam search over a dense KV cache —
    compression makes beam search cheaper exactly where it hurts.
  * Finished beams are frozen in-place: their next-token distribution is
    forced to {EOS: 0, else: -inf}, so their score stops accumulating while
    they keep competing for the final ranking (static shapes throughout —
    no beam ever leaves the batch).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import CompressionConfig, ModelConfig
from . import llama

Array = jax.Array

NEG_INF = -1e30


def _expand_beams(tree, num_beams: int):
    """[B, ...] pytree -> [B*W, ...] with each row repeated W times."""
    return jax.tree_util.tree_map(
        lambda x: jnp.repeat(x, num_beams, axis=0), tree)


def _gather_beams(tree, flat_parent: Array):
    """Reindex the [B*W, ...] pytree rows by flat parent indices [B*W]."""
    return jax.tree_util.tree_map(lambda x: x[flat_parent], tree)


def beam_search(
    params,
    input_ids: Array,
    cfg: ModelConfig,
    ccfg: CompressionConfig,
    num_beams: int = 4,
    max_new_tokens: int = 32,
    length_penalty: float = 1.0,
    eos_token_id: Optional[int] = None,
    use_flash: bool = False,
    use_fused_decode: Optional[bool] = None,
    return_all_beams: bool = False,
) -> Tuple[Array, Array, List[Dict[str, Array]]]:
    """Beam-search generation with compressed KV.

    Args:
      num_beams: beam width W (static).
      length_penalty: final ranking uses score / len**length_penalty
        (len = generated tokens up to and including EOS). 1.0 = average
        log-prob; 0.0 = raw sum (favors short sequences).
      eos_token_id: beams emitting it freeze (score stops accumulating);
        output positions after the first EOS are padded with it.
      return_all_beams: return [B, W, T] sequences and [B, W] scores sorted
        best-first instead of only the top beam.

    Returns (sequences [B, T] ids, scores [B] length-normalized log-probs,
    per-layer prefill compression stats) — beam-expanded shapes with
    `return_all_beams`.
    """
    if use_fused_decode is None:
        from .llama import resolve_fused_decode

        use_fused_decode = resolve_fused_decode(cfg, ccfg)
    b = input_ids.shape[0]
    w = num_beams
    t_total = max_new_tokens
    vocab = cfg.vocab_size
    eos = -1 if eos_token_id is None else eos_token_id

    prefill = jax.jit(lambda p, ids: llama.prefill_compressed(
        p, ids, cfg, ccfg, max_decode_len=max_new_tokens,
        use_flash=use_flash))
    logits, state, stats = prefill(params, input_ids)

    def search(logits, state):
        # First expansion: top-W distinct first tokens per batch row.
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        scores, tokens = jax.lax.top_k(logp, w)          # [B, W]
        state = _expand_beams(state, w)                   # rows: b*W + beam
        seqs = jnp.full((b, w, t_total), eos if eos >= 0 else 0, jnp.int32)
        seqs = seqs.at[:, :, 0].set(tokens)
        finished = (tokens == eos) if eos >= 0 else jnp.zeros((b, w), bool)
        batch_base = (jnp.arange(b) * w)[:, None]         # [B, 1]

        def body(carry, t):
            tokens, state, scores, finished, seqs = carry
            step_logits, state = llama.decode_step(
                params, tokens.reshape(b * w), state, cfg, ccfg,
                use_fused=use_fused_decode)
            logp = jax.nn.log_softmax(
                step_logits.astype(jnp.float32), axis=-1).reshape(b, w, vocab)
            if eos >= 0:
                # Frozen beams may only re-emit EOS, at zero added score.
                frozen = jnp.full((vocab,), NEG_INF).at[eos].set(0.0)
                logp = jnp.where(finished[:, :, None], frozen[None, None],
                                 logp)
            total = (scores[:, :, None] + logp).reshape(b, w * vocab)
            scores, flat = jax.lax.top_k(total, w)        # [B, W]
            parent = flat // vocab                        # [B, W]
            tokens = flat % vocab                         # [B, W]
            flat_parent = (batch_base + parent).reshape(b * w)
            state = _gather_beams(state, flat_parent)
            seqs = jnp.take_along_axis(seqs, parent[:, :, None], axis=1)
            seqs = seqs.at[:, :, t].set(tokens)
            finished = jnp.take_along_axis(finished, parent, axis=1)
            if eos >= 0:
                finished = finished | (tokens == eos)
            return (tokens, state, scores, finished, seqs), None

        init = (tokens, state, scores, finished, seqs)
        if t_total > 1:
            (tokens, state, scores, finished, seqs), _ = jax.lax.scan(
                body, init, jnp.arange(1, t_total))
        else:
            tokens, state, scores, finished, seqs = init

        # Length-normalized final ranking. Generated length = index of the
        # first EOS + 1 (or T when none).
        if eos >= 0:
            is_eos = seqs == eos
            any_eos = is_eos.any(axis=-1)
            first = jnp.argmax(is_eos, axis=-1)           # [B, W]
            lengths = jnp.where(any_eos, first + 1, t_total)
            # Pad everything after the first EOS with EOS.
            past = jnp.arange(t_total)[None, None] > first[:, :, None]
            seqs = jnp.where(past & any_eos[:, :, None], eos, seqs)
        else:
            lengths = jnp.full((b, w), t_total)
        adj = scores / (lengths.astype(jnp.float32) ** length_penalty)
        order = jnp.argsort(-adj, axis=-1)                # best first
        seqs = jnp.take_along_axis(seqs, order[:, :, None], axis=1)
        adj = jnp.take_along_axis(adj, order, axis=1)
        return seqs, adj

    seqs, adj = jax.jit(search)(logits, state)
    if return_all_beams:
        return seqs, adj, stats
    return seqs[:, 0], adj[:, 0], stats
