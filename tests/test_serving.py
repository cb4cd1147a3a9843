"""Continuous-batching engine tests (CPU, tiny model)."""

import jax
import numpy as np
import pytest

from realtime_kv_cache_compression_tpu import (CompressionConfig,
                                               tiny_test_model)
from realtime_kv_cache_compression_tpu.models import llama
from realtime_kv_cache_compression_tpu.serving import ServingEngine


@pytest.fixture(scope="module")
def engine_parts():
    mcfg = tiny_test_model(num_layers=2)
    ccfg = CompressionConfig(num_layers=2)
    params = llama.init_params(jax.random.PRNGKey(0), mcfg)
    return params, mcfg, ccfg


def make_engine(engine_parts, **kw):
    params, mcfg, ccfg = engine_parts
    base = dict(num_slots=2, context_len=64, max_new_tokens=9,
                decode_chunk=4)
    base.update(kw)
    return ServingEngine(params, mcfg, ccfg, **base)


def prompt(seed, n=64):
    rng = np.random.default_rng(seed)
    return rng.integers(1, 250, size=n).tolist()


def test_single_request_completes(engine_parts):
    eng = make_engine(engine_parts)
    rid = eng.submit(prompt(0), max_new_tokens=5)
    done = eng.run()
    assert rid in done
    req = done[rid]
    assert req.finished and len(req.tokens) == 5
    assert req.ttft is not None and req.ttft > 0
    assert req.prefill_stats["avg_memory_savings"] > 0


def test_more_requests_than_slots(engine_parts):
    eng = make_engine(engine_parts, num_slots=2)
    rids = [eng.submit(prompt(i), max_new_tokens=5) for i in range(5)]
    done = eng.run()
    assert sorted(done) == sorted(rids)
    assert all(len(done[r].tokens) == 5 for r in rids)
    s = eng.summary()
    assert s["completed"] == 5
    assert s["total_tokens"] == 25


def test_batched_tokens_match_standalone_generation(engine_parts):
    """A request served in a batch must produce the same greedy tokens as
    standalone generate() on the same bucketed prompt."""
    params, mcfg, ccfg = engine_parts
    eng = make_engine(engine_parts, num_slots=2, max_new_tokens=9)
    p = prompt(42)
    rid_a = eng.submit(p, max_new_tokens=8)
    rid_b = eng.submit(prompt(7), max_new_tokens=8)
    done = eng.run()

    import jax.numpy as jnp
    ids = jnp.asarray(p, jnp.int32)[None]
    ref, _ = llama.generate(params, ids, mcfg, ccfg, max_new_tokens=8)
    assert done[rid_a].tokens == [int(t) for t in ref[0]]


def test_async_admission_matches_sync(engine_parts):
    """async admission (the default) produces identical tokens to sync."""
    eng_s = make_engine(engine_parts, num_slots=2, async_admission=False)
    eng_a = make_engine(engine_parts, num_slots=2, async_admission=True)
    prompts = [prompt(i) for i in range(4)]
    rids_s = [eng_s.submit(p, max_new_tokens=5) for p in prompts]
    rids_a = [eng_a.submit(p, max_new_tokens=5) for p in prompts]
    done_s = eng_s.run()
    done_a = eng_a.run()
    for rs, ra in zip(rids_s, rids_a):
        assert done_s[rs].tokens == done_a[ra].tokens
    assert eng_a.summary()["completed"] == 4


def test_interleaved_admission(engine_parts):
    """New requests admitted while others are mid-decode."""
    eng = make_engine(engine_parts, num_slots=2, decode_chunk=2)
    r1 = eng.submit(prompt(1), max_new_tokens=7)
    eng.step()
    eng.step()
    r2 = eng.submit(prompt(2), max_new_tokens=3)
    done = eng.run()
    assert len(done[r1].tokens) == 7
    assert len(done[r2].tokens) == 3


def test_batched_admission_matches_sequential(engine_parts):
    """4 simultaneous arrivals prefill as ONE batched call (slots=4) and
    still produce tokens identical to standalone generation."""
    params, mcfg, ccfg = engine_parts
    eng = make_engine(engine_parts, num_slots=4, max_new_tokens=9)
    prompts = [prompt(i) for i in range(4)]
    rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
    done = eng.run()

    import jax.numpy as jnp
    for p, rid in zip(prompts, rids):
        ids = jnp.asarray(p, jnp.int32)[None]
        ref, _ = llama.generate(params, ids, mcfg, ccfg, max_new_tokens=6)
        assert done[rid].tokens == [int(t) for t in ref[0]]


def test_sharded_serving_matches_single_device(engine_parts):
    """VERDICT #2: the engine over a (2, 4) mesh — slots on `data`, weights
    tensor-parallel, committed cache sharding — produces token-identical
    outputs to the unsharded engine."""
    from realtime_kv_cache_compression_tpu import tiny_test_model
    from realtime_kv_cache_compression_tpu.parallel import create_mesh

    # kv_dim divisible by the model axis.
    mcfg = tiny_test_model(num_layers=2, num_heads=8, num_kv_heads=4,
                           head_dim=16, hidden_size=128,
                           intermediate_size=256)
    ccfg = CompressionConfig(num_layers=2)
    params = llama.init_params(jax.random.PRNGKey(0), mcfg)
    kw = dict(num_slots=2, context_len=64, max_new_tokens=9, decode_chunk=4)

    eng_1 = ServingEngine(params, mcfg, ccfg, **kw)
    mesh = create_mesh(2, 4)
    eng_m = ServingEngine(params, mcfg, ccfg, mesh=mesh, **kw)

    prompts = [prompt(i) for i in range(4)]
    rids_1 = [eng_1.submit(p, max_new_tokens=6) for p in prompts]
    rids_m = [eng_m.submit(p, max_new_tokens=6) for p in prompts]
    done_1 = eng_1.run()
    done_m = eng_m.run()
    for r1, rm in zip(rids_1, rids_m):
        assert done_1[r1].tokens == done_m[rm].tokens
    assert eng_m.summary()["completed"] == 4


def test_sharded_serving_slot_validation(engine_parts):
    from realtime_kv_cache_compression_tpu.parallel import create_mesh

    params, mcfg, ccfg = engine_parts
    mesh = create_mesh(2, 4)
    with pytest.raises(ValueError):
        ServingEngine(params, mcfg, ccfg, num_slots=3, mesh=mesh)


def test_warmup_compiles_every_admission_batch(engine_parts):
    """warmup() must drive one admission at every reachable padded batch
    size WITH DISTINCT PROMPTS (identical prompts dedupe to one prefill
    row — a same-prompt warmup never compiles them) and leave no
    serving state behind."""
    eng = make_engine(engine_parts, num_slots=4, prefix_cache_size=4)
    info = eng.warmup()
    assert info["batch_sizes"] == [1, 2, 4]
    # Admission prefill compiled once per padded batch size.
    assert eng._prefill._cache_size() >= 3
    # No residue: stats, completed map, prefix cache all clean.
    assert eng.summary() == {"completed": 0} or (
        eng.summary().get("completed", 0) == 0)
    assert not eng.completed
    assert len(eng._prefix_cache) == 0
    assert not eng.has_work()
    # Real traffic after warmup behaves normally.
    rid = eng.submit(prompt(99), max_new_tokens=5)
    eng.run()
    assert len(eng.completed[rid].tokens) == 5
