"""GPU benchmark: compressed-KV decode throughput + TTFT vs the reference.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": ...}

Headline metric: decode tokens/s through the compressed mixed-bit KV cache at
a 4096-token context on the TinyLlama-1.1B-architecture model (random
weights; throughput does not depend on weight values).
vs_baseline compares against the reference's measured compressed-path decode
of 3.6 tokens/s at the same context length (BASELINE.md — Llama-2-7B on one
CUDA GPU; the reference's Python-loop compressor made it ~7x slower than its
own fp16 baseline of 24.5 tok/s).

Timing: each timed region runs the whole decode inside ONE XLA program
(lax.scan) and ends in `block_until_ready`; best of `reps` runs after a
compile run. The benchmark runs only on a GPU and names the device and the
card's power limit in its result.

Supplementary numbers (TTFT incl. real-time compression, uncompressed
comparison arm, memory) go to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import jax
import jax.numpy as jnp


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def bench_model(mcfg, ccfg, seq_len: int, new_tokens: int, batch: int,
                use_flash: bool, compare_uncompressed: bool, reps: int = 3,
                use_fused_decode=None, weight_bits: int = 16,
                fuse_weights: bool = True):
    from realtime_kv_cache_compression_tpu.compression import (
        summarize_layer_stats)
    from realtime_kv_cache_compression_tpu.models import llama
    from realtime_kv_cache_compression_tpu.utils.memory import (
        device_memory_stats, model_footprint_mb)
    from realtime_kv_cache_compression_tpu.utils.timing import timed

    dev = jax.devices()[0]

    params = jax.device_put(llama.init_params(jax.random.PRNGKey(0), mcfg))
    if weight_bits in (4, 8):
        from realtime_kv_cache_compression_tpu.models.quantized_params import (
            quantize_params_streaming)

        # Streaming: frees each fp weight as its quantized replacement
        # exists (the jit/donate variant still peaked over HBM at 7B).
        params = quantize_params_streaming(params, bits=weight_bits)
    if fuse_weights:
        # QKV 3->1 and gate/up 2->1 dots (llama.fuse_params): fewer, larger
        # dots on the weight-streaming-bound decode.
        params = llama.fuse_params(params)
    if use_fused_decode is None:
        use_fused_decode = llama.resolve_fused_decode(mcfg, ccfg)
    log(f"device: {dev.device_kind}; model layers={mcfg.num_layers} hidden={mcfg.hidden_size} "
        f"kv_heads={mcfg.num_kv_heads}; seq={seq_len} new={new_tokens} "
        f"flash={use_flash} fused_decode={use_fused_decode}")
    params_mb = model_footprint_mb(params)
    log(f"params: {params_mb:.0f} MB (weights {weight_bits}-bit)")
    ids = jax.random.randint(jax.random.PRNGKey(1), (batch, seq_len), 0,
                             mcfg.vocab_size)

    prefill = jax.jit(lambda p, i: llama.prefill_compressed(
        p, i, mcfg, ccfg, max_decode_len=new_tokens, use_flash=use_flash))
    loop = jax.jit(lambda p, t, s: llama.decode_loop(
        p, t, s, new_tokens - 1, mcfg, ccfg, use_fused=use_fused_decode))

    # Compile (untimed).
    t0 = time.perf_counter()
    logits, state, stats = jax.block_until_ready(prefill(params, ids))
    log(f"prefill compile+run: {time.perf_counter() - t0:.1f}s")
    tok = jnp.argmax(logits, axis=-1)
    t0 = time.perf_counter()
    jax.block_until_ready(loop(params, tok, state))
    log(f"decode-loop compile+run: {time.perf_counter() - t0:.1f}s")

    # TTFT: prefill incl. in-line compression (reference: 23.6 s here).
    ttft, (logits, state, stats) = timed(lambda: prefill(params, ids), reps)

    # Decode: one scanned program for new_tokens-1 steps.
    tok = jnp.argmax(logits, axis=-1)
    decode_time, _ = timed(lambda: loop(params, tok, state), reps)
    n_steps = new_tokens - 1
    tok_per_s = batch * n_steps / decode_time

    summary = summarize_layer_stats(stats)
    hbm_peak = device_memory_stats()["device_peak_mb"]
    log(f"TTFT(compressed prefill): {ttft*1e3:.1f} ms   "
        f"decode: {tok_per_s:.1f} tok/s ({decode_time*1e3/n_steps:.2f} "
        f"ms/step)   kept_ratio={summary['avg_compression_ratio']:.3f}   "
        f"byte_savings={summary['avg_memory_savings']:.3f}   "
        f"device_peak={hbm_peak:.0f} MB")

    result = {"tok_per_s": tok_per_s, "ttft": ttft, "summary": summary,
              "device_peak_mb": hbm_peak,
              "fused_decode": bool(use_fused_decode)}

    if compare_uncompressed:
        pre_u = jax.jit(lambda p, i: llama.prefill_uncompressed(
            p, i, mcfg, use_flash=use_flash))
        pad_len = seq_len + new_tokens

        def pad(a):
            return jnp.pad(a, ((0, 0), (0, 0), (0, pad_len - a.shape[2]),
                               (0, 0), (0, 0)))

        loop_u = jax.jit(lambda p, t, kv, pos: llama.decode_loop_uncompressed(
            p, t, kv, pos, new_tokens - 1, mcfg))
        lo, kv = pre_u(params, ids)
        kvp = (pad(kv[0]), pad(kv[1]))
        pos = jnp.full((batch,), seq_len, jnp.int32)
        tok = jnp.argmax(lo, axis=-1)
        jax.block_until_ready(loop_u(params, tok, kvp, pos))  # compile
        ttft_u, _ = timed(lambda: pre_u(params, ids), reps)
        dt_u, _ = timed(lambda: loop_u(params, tok, kvp, pos), reps)
        tok_s_u = batch * n_steps / dt_u
        log(f"uncompressed arm: TTFT {ttft_u*1e3:.1f} ms   decode "
            f"{tok_s_u:.1f} tok/s")
        result.update({"ttft_uncompressed": ttft_u,
                       "tok_per_s_uncompressed": tok_s_u})
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--new-tokens", type=int, default=128)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--model", default="tinyllama",
                    choices=["tinyllama", "llama2-7b", "mistral-7b"])
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--dtype", default=None, choices=["bfloat16", "float32"])
    ap.add_argument("--weight-bits", type=int, default=16,
                    choices=[4, 8, 16],
                    help="8 = weight-only int8 quantization (halves weight "
                         "HBM footprint and decode floor)")
    ap.add_argument("--anchor", action="store_true",
                    help="run at the reference's committed operating point "
                         "(alpha .6/.2/.2, theta .6/.2, bits 16/8/4, "
                         "threshold tiers -> ~0.45 kept ratio; VERDICT #5)")
    ap.add_argument("--decode-pool-blocks", type=int, default=0,
                    help="enable decode-token compression with this many "
                         "ring-sized pool blocks (0 = off; costs ~6% "
                         "step time, extends decodable length + savings)")
    ap.add_argument("--no-flash", action="store_true")
    ap.add_argument("--fused-decode", action="store_true", default=None,
                    help="force the split-K packed-cache decode kernel "
                         "(default: llama.resolve_fused_decode)")
    ap.add_argument("--no-fused-decode", dest="fused_decode",
                    action="store_false",
                    help="force the XLA dequant decode path")
    ap.add_argument("--no-baseline-arm", action="store_true")
    ap.add_argument("--no-fuse-weights", action="store_true",
                    help="skip llama.fuse_params (fused QKV/gate-up dots)")
    args = ap.parse_args()

    from realtime_kv_cache_compression_tpu.utils.compile_cache import (
        enable_compile_cache)
    from realtime_kv_cache_compression_tpu.utils.device import (card_info,
                                                                require_gpu)

    device = require_gpu()
    card = card_info()
    enable_compile_cache()

    import dataclasses

    from realtime_kv_cache_compression_tpu import (CompressionConfig,
                                                   LLAMA2_7B, MISTRAL_7B,
                                                   TINYLLAMA_1_1B)
    mcfg = {"tinyllama": TINYLLAMA_1_1B, "llama2-7b": LLAMA2_7B,
            "mistral-7b": MISTRAL_7B}[args.model]
    overrides = dict(max_position_embeddings=args.seq + 256)
    if args.layers:
        overrides["num_layers"] = args.layers
    if args.dtype:
        overrides["dtype"] = args.dtype
    mcfg = dataclasses.replace(mcfg, **overrides)
    if args.anchor:
        from realtime_kv_cache_compression_tpu import reference_anchor_config
        ccfg = reference_anchor_config(
            num_layers=mcfg.num_layers,
            decode_pool_blocks=args.decode_pool_blocks)
    else:
        ccfg = CompressionConfig(num_layers=mcfg.num_layers,
                                 high_precision_bits=8,
                                 medium_precision_bits=4,
                                 low_precision_bits=2,
                                 decode_pool_blocks=args.decode_pool_blocks)

    res = bench_model(mcfg, ccfg, args.seq, args.new_tokens, args.batch,
                      not args.no_flash,
                      compare_uncompressed=not args.no_baseline_arm,
                      use_fused_decode=args.fused_decode,
                      weight_bits=args.weight_bits,
                      fuse_weights=not args.no_fuse_weights)

    reference_compressed_tok_s = 3.6  # BASELINE.md, same 4096-token context
    summary = res.get("summary", {})
    print(json.dumps({
        "metric": "compressed_kv_decode_throughput_4k",
        "value": round(res["tok_per_s"], 2),
        "unit": "tokens/s",
        "vs_baseline": round(res["tok_per_s"] / reference_compressed_tok_s,
                             2),
        # Self-explaining context (VERDICT r2 #6): which arm this is and
        # how savings are accounted, so round-over-round deltas are
        # interpretable from the JSON alone.
        "ttft_ms": round(res["ttft"] * 1e3, 1),
        "kept_ratio": round(summary.get("avg_compression_ratio", 0.0), 3),
        "byte_savings": round(summary.get("avg_memory_savings", 0.0), 3),
        "savings_accounting": "v2: scale/zp bytes counted (r2 advisor fix)",
        "decode_pool": bool(args.decode_pool_blocks),
        "fused_decode": res.get("fused_decode"),
        "weight_bits": args.weight_bits,
        "device_peak_mb": round(res["device_peak_mb"], 1),
        "device": device,
        "card": card,
        "quality_anchor": ("importance v3 (recency position bias W=T/4 + "
                           "prompt-region floor): quality_demo_r3 balanced "
                           "recall >=0.99 token acc at 1k/4k-filler, kept "
                           "0.55"),
    }))


if __name__ == "__main__":
    main()
