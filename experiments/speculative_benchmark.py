#!/usr/bin/env python
"""Speculative-decoding benchmark on the compressed KV cache.

Trains the hermetic recall model (quality_demo's task: the continuation
copies a payload span from the prompt — the same structure as long-context
QA/summarization outputs), then measures greedy decode vs speculative
decode with prompt-lookup drafting THROUGH the compressed cache.

Acceptance here is REAL: the trained model genuinely copies prompt spans,
and the proposer genuinely finds them (vocab is large enough that filler
bigram collisions are negligible). Outputs are asserted token-identical
between the two arms before any timing is reported.

Usage:
  python experiments/speculative_benchmark.py --platform gpu \
      --fillers 512,4096 --payload 48 --n-draft 4
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from experiments.quality_demo import make_batch, train_recall_model  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--platform", default="cpu", choices=["cpu", "gpu"])
    ap.add_argument("--task", default="recall", choices=["recall", "multidoc"])
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--train-batch", type=int, default=16)
    ap.add_argument("--payload", type=int, default=48)
    ap.add_argument("--fillers", default="512,4096")
    ap.add_argument("--n-draft", type=int, default=4)
    ap.add_argument("--eval-batch", type=int, default=1)
    ap.add_argument("--model-layers", type=int, default=6)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--flash", action="store_true",
                    help="flash prefill + library-flash training")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--adaptive", action="store_true",
                    help="add an adaptive_speculative_decode arm (host-side "
                    "controller that falls back to plain decode chunks when "
                    "realized tokens-per-forward collapses)")
    ap.add_argument("--chunk", type=int, default=16,
                    help="adaptive arm chunk length")
    ap.add_argument("--params-dir", default=None,
                    help="orbax checkpoint dir: load the trained model if "
                    "present, else train and save there (same contract as "
                    "quality_demo --params-dir)")
    ap.add_argument("--output-dir",
                    default="experiments/results/speculative")
    args = ap.parse_args()

    import jax

    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    import realtime_kv_cache_compression_tpu as rtc
    from realtime_kv_cache_compression_tpu.models import llama, speculative
    from realtime_kv_cache_compression_tpu.utils.timing import timed

    fillers = [int(f) for f in args.fillers.split(",")]
    # Large vocab keeps filler bigram collisions (which would shadow the
    # payload match and waste drafts) negligible: P ~ F / (V-8)^2.
    max_pos = max(fillers) + (args.payload + 1) * 8 + 16
    mcfg = rtc.tiny_test_model(vocab_size=256, hidden_size=128,
                               intermediate_size=256,
                               num_layers=args.model_layers,
                               num_heads=4, num_kv_heads=2, head_dim=32,
                               max_position_embeddings=max_pos)
    ccfg = rtc.CompressionConfig(num_layers=mcfg.num_layers,
                                 high_precision_bits=8,
                                 medium_precision_bits=4,
                                 low_precision_bits=2)

    ckpt = (os.path.join(os.path.abspath(args.params_dir), args.task)
            if args.params_dir else None)
    if ckpt and os.path.exists(ckpt):
        from realtime_kv_cache_compression_tpu.models import checkpoint
        template = jax.eval_shape(
            lambda: llama.init_params(jax.random.PRNGKey(0), mcfg))
        params = checkpoint.load_checkpoint(ckpt, template)
        print(f"loaded {args.task} params from {ckpt}", flush=True)
    else:
        print(f"training {args.task} model (fillers {fillers})...",
              flush=True)
        params = train_recall_model(mcfg, args.task, args.steps,
                                    args.train_batch, args.payload, fillers,
                                    lr=args.lr, use_flash=args.flash)
        if ckpt:
            from realtime_kv_cache_compression_tpu.models import checkpoint
            checkpoint.save_checkpoint(ckpt, params)
            print(f"saved {args.task} params to {ckpt}", flush=True)

    results = []
    n_steps = args.payload
    for filler in fillers:
        key = jax.random.PRNGKey(7 + filler)
        ids, prompt_len, payload = make_batch(key, args.eval_batch,
                                              args.payload, filler,
                                              mcfg.vocab_size, args.task)
        prompt = ids[:, :prompt_len]

        @jax.jit
        def run_prefill(prompt):
            logits, state, _ = llama.prefill_compressed(
                params, prompt, mcfg, ccfg,
                max_decode_len=n_steps + args.n_draft + 1,
                use_flash=args.flash)
            return jnp.argmax(logits, -1).astype(jnp.int32), state

        first, state = run_prefill(prompt)

        @jax.jit
        def run_greedy(first, state):
            toks, _ = llama.decode_loop(params, first, state, n_steps,
                                        mcfg, ccfg)
            return toks

        @jax.jit
        def run_spec(first, state):
            toks, _, stats = speculative.speculative_decode_loop(
                params, first, state, n_steps, mcfg, ccfg,
                prompt_ids=prompt, n_draft=args.n_draft)
            return toks, stats["iterations"], stats["drafted_accepted"]

        ref = run_greedy(first, state)          # compile + run
        spec, iters, acc = run_spec(first, state)
        assert jnp.array_equal(ref, spec), "speculative != greedy output"
        gen = jnp.concatenate([first[:, None], ref[:, :-1]], axis=1)
        em = float((gen == payload).all(axis=1).mean())

        t_greedy, _ = timed(lambda: run_greedy(first, state),
                            reps=args.reps)
        t_spec, _ = timed(lambda: run_spec(first, state), reps=args.reps)
        adaptive_row = None
        if args.adaptive:
            def run_adaptive():
                toks, _, st = speculative.adaptive_speculative_decode(
                    params, first, state, n_steps, mcfg, ccfg,
                    prompt_ids=prompt, n_draft=args.n_draft,
                    chunk=args.chunk)
                return toks, st
            toks_a, st_a = run_adaptive()        # compile both chunk arms
            assert jnp.array_equal(ref, toks_a), "adaptive != greedy output"
            t_adapt, _ = timed(run_adaptive, reps=args.reps)
            adaptive_row = dict(
                ms=t_adapt * 1e3, speedup=t_greedy / t_adapt,
                forwards=st_a["forwards"],
                spec_chunks=st_a["spec_chunks"],
                plain_chunks=st_a["plain_chunks"],
                draft_rate=st_a["draft_rate"], chunk=args.chunk)
        row = dict(
            filler=filler, n_steps=n_steps, eval_batch=args.eval_batch,
            n_draft=args.n_draft, em=em,
            iterations=int(iters),
            accept_rate=float(acc) / max(int(iters) * args.n_draft
                                         * args.eval_batch, 1),
            greedy_ms=t_greedy * 1e3, spec_ms=t_spec * 1e3,
            greedy_tok_s=n_steps * args.eval_batch / t_greedy,
            spec_tok_s=n_steps * args.eval_batch / t_spec,
            speedup=t_greedy / t_spec,
        )
        if adaptive_row is not None:
            row["adaptive"] = adaptive_row
        results.append(row)
        print(f"[filler={filler}] em={em:.3f} iters={row['iterations']}"
              f"/{n_steps} accept={row['accept_rate']:.2f} "
              f"greedy {row['greedy_ms']:.1f} ms vs spec "
              f"{row['spec_ms']:.1f} ms -> {row['speedup']:.2f}x",
              flush=True)
        if adaptive_row is not None:
            print(f"[filler={filler}] adaptive {adaptive_row['ms']:.1f} ms "
                  f"-> {adaptive_row['speedup']:.2f}x "
                  f"(spec_chunks={adaptive_row['spec_chunks']} "
                  f"plain_chunks={adaptive_row['plain_chunks']} "
                  f"forwards={adaptive_row['forwards']})", flush=True)

    os.makedirs(args.output_dir, exist_ok=True)
    out = dict(task=args.task, model_layers=args.model_layers,
               payload=args.payload, platform=args.platform,
               flash=args.flash, results=results,
               timestamp=time.strftime("%Y-%m-%d %H:%M:%S"))
    path = os.path.join(args.output_dir, "speculative_benchmark.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {path}", flush=True)


if __name__ == "__main__":
    main()
