"""Speculative decoding tests: greedy equivalence and acceptance mechanics.

The exactness contract (models/speculative.py) is that speculative decode
emits EXACTLY the tokens sequential greedy `decode_loop` emits — drafts and
acceptance only change how many forward passes it takes. That is asserted
here token-for-token, with and without decode pools, batched and ragged.
(No reference counterpart: the reference decodes one token per forward via
HF generate, /root/reference/src/evaluation/longbench_eval.py:131-139.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from realtime_kv_cache_compression_tpu import (CompressionConfig,
                                               tiny_test_model)
from realtime_kv_cache_compression_tpu.models import llama, speculative

MCFG = tiny_test_model(num_layers=2)


def make_ccfg(**kw):
    base = dict(num_layers=2, high_precision_bits=8, medium_precision_bits=4,
                low_precision_bits=2)
    base.update(kw)
    return CompressionConfig(**base)


def setup(rng, batch=2, s=96, ccfg=None, max_decode_len=64):
    ccfg = ccfg or make_ccfg()
    params = llama.init_params(jax.random.PRNGKey(0), MCFG)
    ids = jnp.asarray(rng.integers(0, MCFG.vocab_size, size=(batch, s)),
                      jnp.int32)
    logits, state, _ = llama.prefill_compressed(
        params, ids, MCFG, ccfg, max_decode_len=max_decode_len)
    first = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    return params, ids, ccfg, state, first


@pytest.mark.parametrize("n_draft", [1, 3, 4])
def test_token_identical_to_decode_loop(rng, n_draft):
    params, ids, ccfg, state, first = setup(rng)
    n_steps = 24
    ref_toks, _ = llama.decode_loop(params, first, state, n_steps, MCFG,
                                    ccfg, use_fused=False)
    toks, _, stats = speculative.speculative_decode_loop(
        params, first, state, n_steps, MCFG, ccfg, prompt_ids=ids,
        n_draft=n_draft)
    np.testing.assert_array_equal(np.asarray(toks), np.asarray(ref_toks))
    assert int(stats["iterations"]) <= n_steps


def test_token_identical_with_decode_pools(rng):
    # Small ring + pools: generation crosses several flush boundaries, so
    # the ring-fill truncation logic is exercised.
    ccfg = make_ccfg(decode_pool_blocks=3, decode_pool_bits=8)
    params, ids, ccfg, state, first = setup(rng, ccfg=ccfg,
                                            max_decode_len=8)
    n_steps = 30
    ref_toks, ref_state = llama.decode_loop(params, first, state, n_steps,
                                            MCFG, ccfg, use_fused=False)
    toks, sp_state, _ = speculative.speculative_decode_loop(
        params, first, state, n_steps, MCFG, ccfg, prompt_ids=ids,
        n_draft=3)
    np.testing.assert_array_equal(np.asarray(toks), np.asarray(ref_toks))
    # Committed cache state matches sequential decode exactly too.
    np.testing.assert_array_equal(np.asarray(sp_state.position),
                                  np.asarray(ref_state.position))
    for sr, rr in zip(sp_state.recents, ref_state.recents):
        np.testing.assert_array_equal(np.asarray(sr.length),
                                      np.asarray(rr.length))
        live = np.asarray(rr.length).max()
        # K/V projections run at block shape [B,T] vs [B,1] — same math,
        # different XLA tilings, so ring contents match to fp noise only.
        np.testing.assert_allclose(np.asarray(sr.k[:, :live]),
                                   np.asarray(rr.k[:, :live]),
                                   rtol=1e-4, atol=1e-5)
    for sp_p, ref_p in zip(sp_state.pools, ref_state.pools):
        np.testing.assert_array_equal(np.asarray(sp_p.valid),
                                      np.asarray(ref_p.valid))
        np.testing.assert_array_equal(np.asarray(sp_p.k_stored),
                                      np.asarray(ref_p.k_stored))


def test_oracle_proposer_iteration_bound(rng):
    """With a perfect draft source every iteration emits n_draft+1 tokens,
    so the forward-pass count collapses by that factor — the speedup
    mechanism, asserted structurally (weights are random; real acceptance
    comes from the data, see the prompt-lookup test)."""
    params, ids, ccfg, state, first = setup(rng, batch=1)
    n_steps, n_draft = 24, 3
    ref_toks, _ = llama.decode_loop(params, first, state, n_steps, MCFG,
                                    ccfg, use_fused=False)

    def oracle(last2, count, out):
        cols = count[:, None] + jnp.arange(n_draft)[None]
        return jnp.take_along_axis(
            ref_toks, jnp.minimum(cols, n_steps - 1), axis=1)

    toks, _, stats = speculative.speculative_decode_loop(
        params, first, state, n_steps, MCFG, ccfg, prompt_ids=ids,
        n_draft=n_draft, proposer=oracle)
    np.testing.assert_array_equal(np.asarray(toks), np.asarray(ref_toks))
    assert int(stats["iterations"]) == -(-n_steps // (n_draft + 1))


def test_prompt_lookup_proposes_continuation():
    # Prompt ends with the bigram (7, 8) which appeared earlier followed by
    # 9, 10, 11 — the proposer must find the latest match and copy forward.
    prompt = jnp.asarray([[1, 7, 8, 9, 10, 11, 3, 7, 8]], jnp.int32)
    lens = jnp.asarray([9], jnp.int32)
    drafts = speculative.propose_prompt_lookup(
        prompt, lens, jnp.asarray([[7, 8]], jnp.int32), 3)
    np.testing.assert_array_equal(np.asarray(drafts), [[9, 10, 11]])
    # No match -> repeats the last token (rejected downstream, never wrong).
    drafts = speculative.propose_prompt_lookup(
        prompt, lens, jnp.asarray([[99, 98]], jnp.int32), 3)
    np.testing.assert_array_equal(np.asarray(drafts), [[98, 98, 98]])
    # Match whose continuation runs past the prompt -> fallback tokens.
    drafts = speculative.propose_prompt_lookup(
        prompt, jnp.asarray([5], jnp.int32), jnp.asarray([[8, 9]], jnp.int32),
        3)
    assert drafts.shape == (1, 3)


def test_ragged_prompts_and_batch(rng):
    """Ragged right-padded prompts: per-row prompt_lens drive the lookup
    table and equivalence holds per row."""
    batch, s = 3, 80
    ccfg = make_ccfg()
    params = llama.init_params(jax.random.PRNGKey(0), MCFG)
    ids = jnp.asarray(rng.integers(0, MCFG.vocab_size, size=(batch, s)),
                      jnp.int32)
    lengths = jnp.asarray([80, 57, 64], jnp.int32)
    mask = jnp.arange(s)[None] < lengths[:, None]
    ids = jnp.where(mask, ids, 0)
    logits, state, _ = llama.prefill_compressed(params, ids, MCFG, ccfg,
                                                max_decode_len=48,
                                                lengths=lengths)
    first = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    n_steps = 16
    ref_toks, _ = llama.decode_loop(params, first, state, n_steps, MCFG,
                                    ccfg, use_fused=False)
    toks, _, _ = speculative.speculative_decode_loop(
        params, first, state, n_steps, MCFG, ccfg, prompt_ids=ids,
        prompt_lens=lengths, n_draft=3)
    np.testing.assert_array_equal(np.asarray(toks), np.asarray(ref_toks))


def test_jit_compiles_once(rng):
    """The whole loop jits (while_loop, static shapes) — the jit contract."""
    params, ids, ccfg, state, first = setup(rng, batch=1, s=64)

    @jax.jit
    def run(first, state):
        toks, st, stats = speculative.speculative_decode_loop(
            params, first, state, 12, MCFG, ccfg, prompt_ids=ids, n_draft=3)
        return toks, stats["iterations"]

    toks, iters = run(first, state)
    ref_toks, _ = llama.decode_loop(params, first, state, 12, MCFG, ccfg,
                                    use_fused=False)
    np.testing.assert_array_equal(np.asarray(toks), np.asarray(ref_toks))
    assert int(iters) >= 1


def test_adaptive_token_identical_good_and_bad_drafts(rng):
    """adaptive_speculative_decode is token-identical to decode_loop under
    BOTH a perfect proposer (stays speculative) and an adversarial one
    (controller must fall back to plain chunks), and the adversarial run's
    forward count stays within one probe chunk per probe_every of plain."""
    params, ids, ccfg, state, first = setup(rng, batch=1, s=64,
                                            max_decode_len=96)
    n_steps, n_draft, chunk = 48, 3, 8
    ref_toks, ref_state = llama.decode_loop(params, first, state, n_steps,
                                            MCFG, ccfg, use_fused=False)

    toks, fstate, stats = speculative.adaptive_speculative_decode(
        params, first, state, n_steps, MCFG, ccfg, prompt_ids=ids,
        n_draft=n_draft, chunk=chunk)
    np.testing.assert_array_equal(np.asarray(toks), np.asarray(ref_toks))
    np.testing.assert_array_equal(np.asarray(fstate.position),
                                  np.asarray(ref_state.position))

    def adversarial(last2, count, out):
        # Always-wrong drafts: shift last token by 1 mod vocab.
        bad = (last2[:, 1:2] + 1) % MCFG.vocab_size
        return jnp.broadcast_to(bad, (last2.shape[0], n_draft))

    toks_b, fstate_b, stats_b = speculative.adaptive_speculative_decode(
        params, first, state, n_steps, MCFG, ccfg, prompt_ids=ids,
        n_draft=n_draft, chunk=chunk, probe_every=100,
        proposer=adversarial)
    np.testing.assert_array_equal(np.asarray(toks_b), np.asarray(ref_toks))
    assert stats_b["plain_chunks"] >= 1, stats_b
    # Collapsed acceptance: every speculative chunk costs ~chunk forwards
    # (tokens-per-forward ~1); after the first the controller must switch,
    # so total forwards stay within ~1 spec chunk of plain decoding.
    assert stats_b["forwards"] <= n_steps + chunk + n_draft, stats_b
    # Probe path: with probe_every=2 the controller re-tries speculation.
    toks_c, _, stats_c = speculative.adaptive_speculative_decode(
        params, first, state, n_steps, MCFG, ccfg, prompt_ids=ids,
        n_draft=n_draft, chunk=chunk, probe_every=2, proposer=adversarial)
    np.testing.assert_array_equal(np.asarray(toks_c), np.asarray(ref_toks))
    assert stats_c["spec_chunks"] >= 2, stats_c
