"""Token sampling: temperature, top-k, nucleus (top-p) and min-p filtering.

API-parity counterpart of the sampling surface the reference delegated to HF
`model.generate` (src/evaluation/longbench_eval.py:131-139 — HF exposes
temperature/top_k/top_p through GenerationConfig). Here sampling is a pure,
jit-safe function designed to live INSIDE the scanned decode program
(models/llama.decode_loop): all filters are static-shape masks over the
logits row — no data-dependent shapes, no host round trips.

Notes:
  * top-k uses `jax.lax.top_k` only to find the k-th value (a [B, k]
    reduction), then masks the full row — no gather/scatter of the vocab.
  * top-p sorts the row once (XLA's bitonic sort on the vocab lane axis) and
    unsorts the keep-mask with one more sort over the permutation — still
    O(V log V) with static shapes, fused by XLA into the decode step.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

Array = jax.Array

# Plain Python float: creating a device array at import time would
# initialize the XLA backend, breaking jax.distributed.initialize in
# multi-process workers (parallel/multihost.py imports this transitively).
NEG_INF = -1e30


class SamplingParams(NamedTuple):
    """Static sampling configuration (hashable; safe as a jit closure).

    temperature: 0.0 → greedy argmax (filters ignored; penalties still
      apply, as in HF where logits processors run before do_sample).
    top_k: keep the k highest-probability tokens (0 → disabled).
    top_p: nucleus sampling — keep the smallest prefix of the
      probability-sorted vocab with cumulative mass >= top_p (1.0 → off).
    min_p: drop tokens whose probability < min_p * max_probability
      (0.0 → off). Applied after top_k/top_p, always keeps the argmax.
    repetition_penalty: CTRL/HF-style — logits of already-generated tokens
      are divided by r when positive, multiplied when negative (1.0 → off).
    presence_penalty: OpenAI-style flat subtraction from logits of tokens
      that have appeared at least once (0.0 → off).
    frequency_penalty: OpenAI-style subtraction proportional to the token's
      occurrence count (0.0 → off).

    Penalties need per-row occurrence counts ([B, vocab] int32); the decode
    loop threads them through the scan carry (models/llama.decode_loop).
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= 0.0

    @property
    def uses_penalties(self) -> bool:
        return (self.repetition_penalty != 1.0
                or self.presence_penalty != 0.0
                or self.frequency_penalty != 0.0)


GREEDY = SamplingParams()


def apply_top_k(logits: Array, k: int) -> Array:
    """Mask all but the k largest logits per row to -inf. k is static."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = jax.lax.top_k(logits, k)[0][..., -1:]  # [B, 1] k-th largest
    return jnp.where(logits < kth, NEG_INF, logits)


def apply_top_p(logits: Array, p: float) -> Array:
    """Nucleus filter: keep the smallest probability-sorted prefix whose
    cumulative probability reaches p. The argmax always survives."""
    if p >= 1.0:
        return logits
    sorted_logits = jnp.sort(logits, axis=-1)[..., ::-1]  # descending
    probs = jax.nn.softmax(sorted_logits, axis=-1)
    cum = jnp.cumsum(probs, axis=-1)
    # Token i is kept iff the mass BEFORE it is < p (so the token that
    # crosses the threshold is included, matching HF's semantics).
    keep_sorted = (cum - probs) < p
    # Cutoff logit value = smallest kept logit; everything below is dropped.
    cutoff = jnp.min(jnp.where(keep_sorted, sorted_logits, jnp.inf),
                     axis=-1, keepdims=True)
    return jnp.where(logits < cutoff, NEG_INF, logits)


def apply_min_p(logits: Array, min_p: float) -> Array:
    """Drop tokens with probability < min_p * p_max (llama.cpp-style)."""
    if min_p <= 0.0:
        return logits
    probs = jax.nn.softmax(logits, axis=-1)
    thresh = min_p * jnp.max(probs, axis=-1, keepdims=True)
    return jnp.where(probs < thresh, NEG_INF, logits)


def apply_penalties(logits: Array, counts: Array,
                    params: SamplingParams) -> Array:
    """Repetition / presence / frequency penalties from occurrence counts.

    counts: [B, V] int32 — how often each token appears in the row's
    generated text so far (see `update_counts`). Matches HF's
    RepetitionPenaltyLogitsProcessor and the OpenAI presence/frequency
    semantics; pure and jit-safe.
    """
    x = logits.astype(jnp.float32)
    if params.repetition_penalty != 1.0:
        r = params.repetition_penalty
        penalized = jnp.where(x > 0, x / r, x * r)
        x = jnp.where(counts > 0, penalized, x)
    if params.presence_penalty != 0.0:
        x = x - params.presence_penalty * (counts > 0)
    if params.frequency_penalty != 0.0:
        x = x - params.frequency_penalty * counts.astype(jnp.float32)
    return x


def update_counts(counts: Array, tokens: Array) -> Array:
    """Record newly generated tokens [B] into occurrence counts [B, V]."""
    rows = jnp.arange(tokens.shape[0])
    return counts.at[rows, tokens].add(1)


def init_counts(batch: int, vocab: int,
                tokens: Optional[Array] = None) -> Array:
    """Fresh [B, V] occurrence counts, optionally seeded with `tokens`."""
    counts = jnp.zeros((batch, vocab), jnp.int32)
    return counts if tokens is None else update_counts(counts, tokens)


def sample_logits(logits: Array, key: Optional[Array],
                  params: SamplingParams,
                  counts: Optional[Array] = None) -> Array:
    """Sample next-token ids [B] from logits [B, V] under `params`.

    Pure and jit-safe; `params` fields are Python statics so each
    configuration traces its own (fully fused) program. Greedy mode needs
    no key. `counts` ([B, V] occurrence counts) enables the repetition/
    presence/frequency penalties — penalties apply in greedy mode too,
    mirroring HF's processor-before-argmax order.
    """
    if params.uses_penalties and counts is not None:
        logits = apply_penalties(logits, counts, params)
    if params.is_greedy:
        return jnp.argmax(logits, axis=-1)
    if key is None:
        raise ValueError("sampling (temperature > 0) requires an rng key")
    x = logits.astype(jnp.float32) / params.temperature
    x = apply_top_k(x, params.top_k)
    x = apply_top_p(x, params.top_p)
    x = apply_min_p(x, params.min_p)
    return jax.random.categorical(key, x, axis=-1)
