"""Smoke run of the system on one NVIDIA GPU: the quickest proof that the
main path still starts, compiles and computes right on the card.

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. device      — JAX must run on a GPU; the card's name and power limit.
  2. kernels     — every kernel of the main path, compiled, against the
                   plain reference at Mistral-7B widths (float32, HIGHEST).
  3. main path   — Mistral-7B widths, random weights from --seed:
                   compressed prefill (flash) of a 4096-token prompt, its
                   logits against the dense uncompressed prefill, then 32
                   decode steps over the packed cache.
  4. serving     — CompletionServer on localhost around a ServingEngine;
                   HTTP completions of mixed prompt lengths.
  5. card tests  — the `gpu`-marked tests, in this process.
The last line is {"ok": true, "device": {...}} as JAX reports the device.

    python chip_smoke.py                # one card
    python chip_smoke.py --four-cards   # only the four-card phase

With --four-cards it runs only the multi-card paths (tensor-parallel
prefill + decode, and sequence-parallel prefill with sharded compression),
each against the same computation on one card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np

# Tolerances (bf16 has 8 mantissa bits; references run in float32 HIGHEST):
OUT_TOL = 2e-2     # attention outputs, atol = rtol
MASS_TOL = 5e-3    # prompt mass: a float32 sum of probabilities in [0, 1]
# End-to-end logits of a 32-layer bf16 model drift from float32 by a few
# per cent (bf16 rounding compounds over layers), so a path is held to the
# plain bf16 XLA path's own distance from the float32 reference: at most
# twice that, and never tighter than 1e-2 relative L2.
FLOOR_FACTOR, FLOOR_MIN = 2.0, 1e-2
# Compressed vs uncompressed prefill in float32 at HIGHEST precision: the
# programs differ only in what reads K/V, so they agree to float32
# rounding; 1e-3 sits far below compression's own effect (the control).
SAME_PROGRAM_TOL = 1e-3


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Shapes of the card run: Mistral-7B published widths."""

    layers: int = 32
    hidden: int = 4096
    mlp: int = 14336
    heads: int = 32
    kv_heads: int = 8
    head_dim: int = 128
    vocab: int = 32000
    seq: int = 4096            # kernel parity + main-path prompt length
    long_seq: int = 32768      # 32K-class parity shapes
    decode_batch: int = 8
    decode_steps: int = 32
    serve_layers: int = 8
    serve_ctx: int = 4096
    serve_prompts: tuple = (256, 1000, 2048, 3000)
    seq_parallel: int = 16384  # four-card sequence-parallel prompt length
    four_layers: int = 8       # depth of the four-card model (widths full)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(name: str, err: float, tol: float, what: str) -> None:
    ok = bool(np.isfinite(err)) and err <= tol
    log(f"  {name}: err {err:.3e} (tol {tol:g}; {what}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: error {err} above tolerance {tol}")


def rel_l2(got, want) -> float:
    """||got - want|| / ||want|| on the host (arrays may live on
    different devices)."""
    g = np.asarray(jnp.asarray(got, jnp.float32))
    w = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def check_vs_f32(name: str, got, base, f32_ref,
                 base_name: str = "one-card bf16 path") -> None:
    """Gate `got` against the float32 reference at the bf16 noise floor:
    the distance of `base`, a plain bf16 run of the same model, from it."""
    floor = rel_l2(base, f32_ref)
    log(f"  {name}: {base_name} vs float32 reference (relative L2) "
        f"{floor:.3e}; vs each other {rel_l2(got, base):.3e}")
    check(f"{name} vs float32 reference (relative L2)", rel_l2(got, f32_ref),
          max(FLOOR_FACTOR * floor, FLOOR_MIN),
          f"<= max({FLOOR_FACTOR:g} x bf16 floor, {FLOOR_MIN:g})")


def f32_prefill_logits(params, ids, mcfg, ccfg=None):
    """Last-position logits with float32 activations, HIGHEST matmul
    precision and dense XLA attention over the same (bf16) weights: the
    uncompressed prefill, or the compressed one when `ccfg` is given."""
    from realtime_kv_cache_compression_tpu.models import llama

    cfg32 = dataclasses.replace(mcfg, dtype="float32")
    with jax.default_matmul_precision("highest"):
        if ccfg is None:
            fn = jax.jit(lambda p, i: llama.prefill_uncompressed(
                p, i, cfg32)[0])
        else:
            fn = jax.jit(lambda p, i: llama.prefill_compressed(
                p, i, cfg32, ccfg, max_decode_len=8)[0])
        return fn(params, ids)


def max_err(got, want) -> float:
    """max |got - want| / (1 + |want|): atol = rtol = the tolerance."""
    g = np.asarray(jnp.asarray(got, jnp.float32))
    w = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.max(np.abs(g - w) / (1.0 + np.abs(w))))


def model_cfg(z: Sizes, layers=None):
    from realtime_kv_cache_compression_tpu import MISTRAL_7B
    return dataclasses.replace(
        MISTRAL_7B, num_layers=layers or z.layers, hidden_size=z.hidden,
        intermediate_size=z.mlp, num_heads=z.heads, num_kv_heads=z.kv_heads,
        head_dim=z.head_dim, vocab_size=z.vocab)


def rand_bf16(key, shape):
    return jax.random.normal(key, shape, jnp.float32).astype(jnp.bfloat16)


# ---------------------------------------------------------------------------
# Phase 2: kernels against the plain references
# ---------------------------------------------------------------------------

def phase_kernels(z: Sizes, seed: int) -> None:
    from realtime_kv_cache_compression_tpu.ops import attention as ref
    from realtime_kv_cache_compression_tpu.ops.pallas import flash_prefill as fp

    f32 = lambda *xs: [x.astype(jnp.float32) for x in xs]
    hi = lambda: jax.default_matmul_precision("highest")
    keys = iter(jax.random.split(jax.random.PRNGKey(seed), 64))
    p = 128  # prompt_cap: the largest prompt region the scorer uses
    what = "bf16 in/out vs float32 HIGHEST reference"

    square = jax.jit(fp.flash_prefill_with_prompt_mass, static_argnums=3)
    for name, (hq, hkv, d) in (("mistral", (z.heads, z.kv_heads,
                                            z.head_dim)),
                               ("tinyllama", (32, 4, 64))):
        s = z.seq
        q, k, v = (rand_bf16(next(keys), (1, s, h, d))
                   for h in (hq, hkv, hkv))
        impl = fp.square_impl(q.dtype, d)
        o, pm = square(q, k, v, p)
        with hi():
            o_r, pm_r = ref.prefill_attention_with_prompt_mass(
                *f32(q, k, v), p)
        check(f"flash square [{impl}] {name} S={s} H={hq}/{hkv} d={d} out",
              max_err(o, o_r), OUT_TOL, what)
        check(f"flash square [{impl}] {name} S={s} mass",
              max_err(pm, pm_r), MASS_TOL, "float32 mass vs reference")

    # Long context: the dense reference does not fit, so compare the last
    # 256 query rows against the dense chunk reference for those rows.
    hq, hkv, d = z.heads, z.kv_heads, z.head_dim
    s, tail = z.long_seq, 256
    q, k, v = (rand_bf16(next(keys), (1, s, h, d)) for h in (hq, hkv, hkv))
    o, pm = square(q, k, v, p)
    with hi():
        o_r, pm_r = ref.chunk_attention_with_prompt_mass(
            *f32(q[:, -tail:], k, v), jnp.int32(s - tail), p)
    check(f"flash square [{fp.square_impl(q.dtype, d)}] S={s} rows "
          f"{s - tail}.. out", max_err(o[:, -tail:], o_r), OUT_TOL, what)
    check(f"flash square S={s} mass", max_err(pm[:, -tail:], pm_r),
          MASS_TOL, "float32 mass vs reference")

    # Chunk (rect) mode: one 4K chunk at the end of the long buffer.
    c = z.seq
    chunk = jax.jit(fp.flash_chunk_attention_with_prompt_mass,
                    static_argnums=4)
    o, pm = chunk(q[:, -c:], k, v, jnp.int32(s - c), p)
    check(f"flash chunk [triton] c={c} over S={s} out",
          max_err(o[:, -tail:], o_r), OUT_TOL, what)
    check(f"flash chunk c={c} mass", max_err(pm[:, -tail:], pm_r), MASS_TOL,
          "float32 mass vs reference")

    # Positioned mode over a pool of slots at scattered positions.
    n, c = z.seq * 2, z.seq // 4
    q, k, v = (rand_bf16(next(keys), (2, m, h, d))
               for m, h in ((c, hq), (n, hkv), (n, hkv)))
    kpos = jax.random.permutation(next(keys), 2 * n)[:n]
    kpos = jnp.broadcast_to(kpos[None], (2, n)).astype(jnp.int32)
    valid = jax.random.uniform(next(keys), (2, n)) > 0.25
    off = 2 * n - c
    o, _lse, pmh = jax.jit(fp.flash_positioned_attention, static_argnums=5)(
        q, k, v, jnp.where(valid, kpos, fp.POS_SENTINEL), jnp.int32(off), p)
    qpos = jnp.broadcast_to(off + jnp.arange(c)[None], (2, c))
    with hi():
        o_r, pm_r = ref.positioned_attention_with_prompt_mass(
            *f32(q, k, v), kpos, valid, qpos, p)
    check(f"flash positioned [triton] c={c} N={n} out", max_err(o, o_r),
          OUT_TOL, what)
    check("flash positioned mass", max_err(pmh.mean(axis=1), pm_r),
          MASS_TOL, "float32 mass vs reference")

    # Ring pair, non-causal: every key precedes every query.
    o, _lse, pmh = jax.jit(fp.flash_pair_attention, static_argnums=4)(
        q, k, v, jnp.full((2,), p, jnp.int32), False)
    with hi():
        o_r, pm_r = ref.positioned_attention_with_prompt_mass(
            *f32(q, k, v), jnp.broadcast_to(jnp.arange(n)[None], (2, n)),
            jnp.ones((2, n), bool), jnp.full((2, c), n), p)
    check(f"flash pair [triton] non-causal c={c} N={n} out",
          max_err(o, o_r), OUT_TOL, what)
    check("flash pair mass", max_err(pmh.mean(axis=1), pm_r), MASS_TOL,
          "float32 mass vs reference")

    phase_decode_kernel(z, next(keys))


def phase_decode_kernel(z: Sizes, key) -> None:
    from realtime_kv_cache_compression_tpu import CompressionConfig
    from realtime_kv_cache_compression_tpu.compression import (
        append_recent, compress_layer_kv, dequantize_layer_cache,
        init_recent_cache)
    from realtime_kv_cache_compression_tpu.ops.attention import (
        attention_over_tokens)
    from realtime_kv_cache_compression_tpu.ops.pallas.decode_attention import (
        fused_decode_attention)

    mcfg = model_cfg(z)
    ccfg = CompressionConfig(num_layers=mcfg.num_layers)
    b, s = z.decode_batch, z.long_seq
    hkv, hq, d = z.kv_heads, z.heads, z.head_dim
    ks = jax.random.split(key, 4)
    k = rand_bf16(ks[0], (b, s, hkv, d))
    v = rand_bf16(ks[1], (b, s, hkv, d))
    mass = jax.random.uniform(ks[2], (b, s))
    cache, _ = jax.jit(lambda k, v, m: compress_layer_kv(
        k, v, m, 0, ccfg, mcfg))(k, v, mass)
    recent = init_recent_cache(b, 32, mcfg)
    for i in range(8):
        recent = append_recent(recent, k[:, i:i + 1], v[:, i:i + 1],
                               jnp.full((b, 1), s + i, jnp.int32))
    del k, v
    q = rand_bf16(ks[3], (b, 1, hq, d))
    q_pos = jnp.full((b, 1), s + 8, jnp.int32)
    out = jax.jit(lambda q, c, r: fused_decode_attention(
        q, c, r, q_pos, ccfg))(q, cache, recent)
    with jax.default_matmul_precision("highest"):
        k_c, v_c, pos_c, valid_c = dequantize_layer_cache(cache, ccfg,
                                                          jnp.float32)
        live = jnp.arange(recent.capacity)[None] < recent.length[:, None]
        want = attention_over_tokens(
            q.astype(jnp.float32),
            jnp.concatenate([k_c, recent.k.astype(jnp.float32)], 1),
            jnp.concatenate([v_c, recent.v.astype(jnp.float32)], 1),
            jnp.concatenate([pos_c, recent.positions], 1),
            jnp.concatenate([valid_c, live], 1), q_pos)
    check(f"decode split-K [triton] B={b} ctx={s} 8/4/2-bit out",
          max_err(out, want), OUT_TOL,
          "bf16 out vs float32 HIGHEST dequantize + attention")


# ---------------------------------------------------------------------------
# Phase 3: main path
# ---------------------------------------------------------------------------

def phase_main(z: Sizes, seed: int, params, mcfg) -> None:
    from realtime_kv_cache_compression_tpu import CompressionConfig
    from realtime_kv_cache_compression_tpu.models import llama
    from realtime_kv_cache_compression_tpu.utils.timing import timed

    ccfg = CompressionConfig(num_layers=mcfg.num_layers)
    log(f"  model: Mistral-7B widths, {mcfg.num_layers} layers, hidden "
        f"{mcfg.hidden_size}, heads {mcfg.num_heads}/{mcfg.num_kv_heads} x "
        f"{mcfg.head_dim}, mlp {mcfg.intermediate_size}, vocab "
        f"{mcfg.vocab_size}, bf16, random weights (seed {seed})")
    log("  note: ModelConfig has no sliding-window key; Mistral runs with "
        "full attention")
    ids = jax.random.randint(jax.random.PRNGKey(seed + 1), (1, z.seq), 0,
                             mcfg.vocab_size)
    steps = z.decode_steps
    prefill = jax.jit(lambda p, i: llama.prefill_compressed(
        p, i, mcfg, ccfg, max_decode_len=2 * steps, use_flash=True))
    t0 = time.perf_counter()
    compiled = prefill.lower(params, ids).compile()
    log(f"  compile compressed prefill (flash): "
        f"{time.perf_counter() - t0:.1f} s")
    ttft, (logits, state, stats) = timed(lambda: compiled(params, ids))
    dense = jax.jit(lambda p, i: llama.prefill_uncompressed(p, i, mcfg)[0])
    logits_u = dense(params, ids)
    logits_32 = f32_prefill_logits(params, ids, mcfg)
    check_vs_f32("logits: flash prefill (bf16)", logits, logits_u, logits_32,
                 base_name="dense XLA bf16 prefill")
    log(f"  argmax agree with float32: flash "
        f"{bool(jnp.argmax(logits) == jnp.argmax(logits_32))}, dense bf16 "
        f"{bool(jnp.argmax(logits_u) == jnp.argmax(logits_32))}")
    # With recompute_prefill_attention=False the prefill attends over the
    # full K/V and compression only reads it, so compression must not alter
    # the logits. Checked in float32: two separately compiled bf16 programs
    # round differently, and 32 random-weight layers carry that to a few
    # per cent of the logits.
    check("logits: compressed vs uncompressed prefill (float32 HIGHEST, "
          "dense attention; relative L2)",
          rel_l2(f32_prefill_logits(params, ids, mcfg, ccfg), logits_32),
          SAME_PROGRAM_TOL, "compression must not alter prefill outputs")
    # Control: a prefill whose outputs compression does alter (attention
    # recomputed over the compressed cache) shows what each limit rejects.
    ccfg_r = dataclasses.replace(ccfg, recompute_prefill_attention=True)
    ctrl = rel_l2(f32_prefill_logits(params, ids, mcfg, ccfg_r), logits_32)
    log(f"  control, recompute_prefill_attention=True (float32): "
        f"{ctrl:.3e} from the uncompressed float32 logits (limits: "
        f"{SAME_PROGRAM_TOL:g} compressed vs uncompressed, the float32 "
        f"gate above for flash)")

    from realtime_kv_cache_compression_tpu.compression import (
        summarize_layer_stats)
    summ = summarize_layer_stats(stats)
    log(f"  kept ratio {summ['avg_compression_ratio']:.3f}, byte savings "
        f"{summ['avg_memory_savings']:.3f}")

    use_fused = llama.resolve_fused_decode(mcfg, ccfg)
    loop = jax.jit(lambda p, t, s: llama.decode_loop(
        p, t, s, steps, mcfg, ccfg, use_fused=use_fused))
    tok = jnp.argmax(logits, axis=-1)
    t0 = time.perf_counter()
    loop_c = loop.lower(params, tok, state).compile()
    log(f"  compile decode loop ({steps} steps, fused={use_fused}): "
        f"{time.perf_counter() - t0:.1f} s")
    dt, (toks, _st) = timed(lambda: loop_c(params, tok, state))
    toks = np.asarray(toks)
    ok = toks.shape == (1, steps) and bool(
        ((toks >= 0) & (toks < mcfg.vocab_size)).all())
    log(f"  decoded {toks.shape[1]} tokens: {toks[0].tolist()} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"bad decoded tokens {toks}")
    n_params = sum(x.size for x in jax.tree_util.tree_leaves(params))
    flops = (2.0 * n_params * z.seq
             + 2.0 * mcfg.num_heads * z.seq ** 2 * mcfg.head_dim)
    log(f"  TTFT (compressed prefill, {z.seq} tokens, batch 1): "
        f"{ttft * 1e3:.1f} ms -> {flops / ttft / 1e12:.1f} TFLOP/s "
        f"effective (informative)")
    log(f"  decode: {steps / dt:.1f} tok/s, {dt * 1e3 / steps:.2f} ms/step "
        f"(batch 1, informative)")


# ---------------------------------------------------------------------------
# Phase 4: HTTP serving
# ---------------------------------------------------------------------------

def phase_serving(z: Sizes, params, mcfg) -> None:
    from realtime_kv_cache_compression_tpu import CompressionConfig
    from realtime_kv_cache_compression_tpu.serving import ServingEngine
    from realtime_kv_cache_compression_tpu.serving.server import (
        CompletionServer)

    scfg = dataclasses.replace(mcfg, num_layers=z.serve_layers)
    sparams = dict(params, layers=params["layers"][:z.serve_layers])
    ccfg = CompressionConfig(num_layers=scfg.num_layers)
    engine = ServingEngine(sparams, scfg, ccfg, num_slots=2,
                           context_len=z.serve_ctx, max_new_tokens=16,
                           decode_chunk=8, use_flash=True)
    t0 = time.perf_counter()
    engine.warmup()
    log(f"  engine: {scfg.num_layers} layers at Mistral-7B widths, 2 slots, "
        f"context {z.serve_ctx}; warmup {time.perf_counter() - t0:.1f} s")
    srv = CompletionServer(engine, port=0).start()
    rng = np.random.default_rng(0)
    try:
        def ask(n):
            body = json.dumps({"prompt": rng.integers(
                1, scfg.vocab_size, size=n).tolist(),
                "max_tokens": 16}).encode()
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/v1/completions", data=body,
                headers={"Content-Type": "application/json"})
            t = time.perf_counter()
            with urllib.request.urlopen(req, timeout=600) as r:
                out = json.loads(r.read())
            return n, out, time.perf_counter() - t

        with ThreadPoolExecutor(len(z.serve_prompts)) as pool:
            results = list(pool.map(ask, z.serve_prompts))
    finally:
        srv.close()
    for n, out, dt in results:
        got = out["usage"]["completion_tokens"]
        log(f"  prompt {n} tokens -> {got} completion tokens in "
            f"{dt * 1e3:.0f} ms {'ok' if got > 0 else 'FAIL'}")
        if got <= 0:
            raise AssertionError(f"request of {n} tokens returned no tokens")
    log(f"  {len(results)} HTTP completions served")


# ---------------------------------------------------------------------------
# Four cards
# ---------------------------------------------------------------------------

def phase_four_cards(z: Sizes, seed: int) -> None:
    from realtime_kv_cache_compression_tpu import CompressionConfig
    from realtime_kv_cache_compression_tpu.models import llama
    from realtime_kv_cache_compression_tpu.parallel.mesh import create_mesh
    from realtime_kv_cache_compression_tpu.parallel.seq_parallel import (
        create_seq_mesh, seq_parallel_prefill)
    from realtime_kv_cache_compression_tpu.parallel.sharding import (
        shard_params)

    devs = jax.devices()
    if len(devs) < 4:
        raise AssertionError(f"--four-cards needs 4 devices, found "
                             f"{len(devs)}")
    mcfg = model_cfg(z, layers=z.four_layers)
    log(f"  model: Mistral-7B widths, {mcfg.num_layers} layers (depth cut "
        f"for compile time), bf16, random weights (seed {seed})")
    ccfg = CompressionConfig(num_layers=mcfg.num_layers)
    params = jax.device_put(llama.init_params(jax.random.PRNGKey(seed),
                                              mcfg), devs[0])
    ids = jax.random.randint(jax.random.PRNGKey(seed + 1), (1, z.seq), 0,
                             mcfg.vocab_size)
    steps = 16

    # 1. Tensor parallel: weights and packed cache head-sharded over 4.
    log("phase 4c-1: tensor-parallel (data=1, model=4) prefill + decode")
    t_tp = time.perf_counter()
    mesh = create_mesh(data=1, model=4, devices=devs[:4])
    sharded = shard_params(params, mesh, mcfg)
    wq = sharded["layers"][0]["wq"]
    log(f"  wq on {len(wq.sharding.device_set)} devices, shard "
        f"{wq.addressable_shards[0].data.shape} of {wq.shape}")
    if len(wq.sharding.device_set) != 4:
        raise AssertionError("weights did not land on all four devices")

    def run(p, m):
        pre = jax.jit(lambda p, i: llama.prefill_compressed(
            p, i, mcfg, ccfg, max_decode_len=2 * steps, use_flash=True,
            mesh=m))
        logits, state, _ = pre(p, ids)
        loop = jax.jit(lambda p, t, s: llama.decode_loop(
            p, t, s, steps, mcfg, ccfg, use_fused=False))
        toks, _ = loop(p, jnp.argmax(logits, axis=-1), state)
        return logits, state, toks

    with mesh:
        logits_tp, state_tp, toks_tp = run(sharded, mesh)
    k0 = state_tp.caches[0].tiers[0].k_stored
    shard = k0.addressable_shards[0].data.shape
    log(f"  packed cache k_stored {k0.shape} on "
        f"{len(k0.sharding.device_set)} devices, shard {shard} "
        f"({k0.sharding.spec})")
    if len(k0.sharding.device_set) != 4 or shard[2] * 4 != k0.shape[2]:
        raise AssertionError("packed cache is not head-sharded over four "
                             "devices")
    logits_1, state_1, toks_1 = run(params, None)
    check_vs_f32("TP prefill logits", logits_tp, logits_1,
                 f32_prefill_logits(params, ids, mcfg))
    # One decode step from the same token over the same cache (the one-card
    # state, laid out on the mesh like the TP state): greedy paths of a
    # random-weight bf16 model may part at near-ties, and two prefills may
    # select different tokens at bf16 noise; one step may not.
    tok = np.asarray(jnp.argmax(logits_1, axis=-1))
    step = jax.jit(lambda p, t, s: llama.decode_step(p, t, s, mcfg, ccfg)[0])
    state_1_tp = jax.tree_util.tree_map(
        lambda a, b: jax.device_put(np.asarray(a), b.sharding), state_1,
        state_tp)
    with mesh:
        step_tp = step(sharded, tok, state_1_tp)
    step_1 = step(params, tok, state_1)
    cfg32 = dataclasses.replace(mcfg, dtype="float32")
    with jax.default_matmul_precision("highest"):
        step_32 = jax.jit(lambda p, t, s: llama.decode_step(
            p, t, s, cfg32, ccfg)[0])(params, tok, state_1)
    check_vs_f32("TP decode-step logits (same input token)", step_tp,
                 step_1, step_32)
    same = int((np.asarray(toks_tp) == np.asarray(toks_1)).sum())
    log(f"  TP greedy decode: {same}/{steps} tokens equal to one card "
        f"({np.asarray(toks_tp)[0].tolist()})")
    if not bool(((np.asarray(toks_tp) >= 0)
                 & (np.asarray(toks_tp) < mcfg.vocab_size)).all()):
        raise AssertionError("TP decode produced invalid token ids")
    log(f"  tensor-parallel phase: {time.perf_counter() - t_tp:.1f} s")
    del sharded, state_tp

    # 2. Sequence parallel with fully sharded compression.
    s = z.seq_parallel
    log(f"phase 4c-2: sequence-parallel prefill, S={s} over 4, sharded "
        f"compression")
    ids_sp = jax.random.randint(jax.random.PRNGKey(seed + 2), (1, s), 0,
                                mcfg.vocab_size)
    seq_mesh = create_seq_mesh(4, devices=devs[:4])
    replicated = jax.device_put(params, jax.sharding.NamedSharding(
        seq_mesh, jax.sharding.PartitionSpec()))
    t0 = time.perf_counter()
    logits_sp, state_sp, _ = seq_parallel_prefill(
        replicated, ids_sp, mcfg, ccfg, seq_mesh, max_decode_len=8,
        sharded_compression=True)
    logits_sp = jax.block_until_ready(logits_sp)
    log(f"  seq-parallel prefill (compile + run): "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = state_sp.caches[0].tiers[0].k_stored
    shard = t0.addressable_shards[0].data.shape
    log(f"  cache k_stored {t0.shape} on {len(t0.sharding.device_set)} "
        f"devices, shard {shard}")
    if len(t0.sharding.device_set) != 4 or shard[1] * 4 != t0.shape[1]:
        raise AssertionError("cache slot axis is not sharded over four "
                             "devices")
    del replicated, state_sp
    t0 = time.perf_counter()
    logits_1, _, _ = jax.jit(lambda p, i: llama.prefill_compressed(
        p, i, mcfg, ccfg, max_decode_len=8, use_flash=True))(params, ids_sp)
    logits_32 = f32_chunked_logits(params, ids_sp, mcfg, chunk=s // 16)
    log(f"  one-card prefill + float32 reference: "
        f"{time.perf_counter() - t0:.1f} s")
    check_vs_f32("seq-parallel logits", logits_sp, logits_1, logits_32)


def f32_chunked_logits(params, ids, mcfg, chunk):
    """Last-position logits with float32 activations, HIGHEST precision and
    the dense XLA chunk attention, one chunk of queries at a time over the
    growing K/V buffer: the float32 reference at lengths where one dense
    [S, S] score matrix does not fit."""
    from realtime_kv_cache_compression_tpu import CompressionConfig
    from realtime_kv_cache_compression_tpu.models import llama

    cfg32 = dataclasses.replace(mcfg, dtype="float32")
    ccfg = CompressionConfig(num_layers=mcfg.num_layers)
    b, s = ids.shape
    with jax.default_matmul_precision("highest"):
        step = jax.jit(lambda p, i, st: llama.prefill_chunked_step(
            p, i, st, cfg32, ccfg))
        st = llama.prefill_chunked_init(b, s, cfg32)
        for off in range(0, s, chunk):
            st = step(params, ids[:, off:off + chunk], st)
        return jax.jit(lambda p, h: llama.logits_from_hidden(p, h, cfg32))(
            params, st.last_h)


# ---------------------------------------------------------------------------

def phase_card_tests() -> None:
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "tests/test_gpu_kernels.py"])
    log(f"  pytest -m gpu: exit {int(rc)}")
    if int(rc) != 0:
        raise AssertionError(f"card-only tests failed (pytest exit {rc})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phase")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX found {dev.platform!r} devices; chip_smoke.py "
              f"runs only on the card", file=sys.stderr)
        return 1
    from realtime_kv_cache_compression_tpu.utils.compile_cache import (
        enable_compile_cache)
    from realtime_kv_cache_compression_tpu.utils.device import (
        card_info, device_record)

    log(f"compile cache: {enable_compile_cache()}")
    z = Sizes()
    rec = device_record()
    log(f"phase 1: device {rec}")
    card = card_info()
    log(f"  card: {card}")

    t_all = time.perf_counter()
    if args.four_cards:
        phase_four_cards(z, args.seed)
    else:
        log("phase 2: kernels vs plain references")
        phase_kernels(z, args.seed)
        from realtime_kv_cache_compression_tpu.models import llama
        mcfg = model_cfg(z)
        params = llama.init_params(jax.random.PRNGKey(args.seed), mcfg)
        log("phase 3: main path (compressed prefill + packed decode)")
        phase_main(z, args.seed, params, mcfg)
        log("phase 4: HTTP serving")
        phase_serving(z, params, mcfg)
        del params
        log("phase 5: card-only tests")
        phase_card_tests()
    log(f"all phases passed in {time.perf_counter() - t_all:.0f} s")
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
