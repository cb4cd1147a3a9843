#!/usr/bin/env python
"""Quality cost of compressed-prefix chunked prefill (VERDICT r4 item 2).

The compressed-prefix path makes later chunks attend over the
quantized/selected pools of earlier chunks (models/llama.py
prefill_chunked_compressed_*) — the mechanism that lets compression REDUCE
TTFT. This harness measures its token-accuracy cost on the hermetic recall
task (trained mini-Llama, quality_demo's machinery) against the one-shot
compressed prefill and the fp baseline, at several context lengths.

Arms per context length T (prompt padded by construction to a 4-chunk
multiple: filler = T - 9 for the recall task):
  baseline_fp     uncompressed prefill + decode
  comp_oneshot    one-shot compressed prefill (llama.generate)
  comp_prefix     compressed-prefix chunked prefill (chunk = T/4) + decode

Usage:
  python experiments/chunked_prefix_quality.py --platform gpu \
      --contexts 256,1024,4096 --steps 2400 --params-dir <dir>
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
    ap.add_argument("--contexts", default="256,1024",
                    help="comma list of prompt lengths T (each a multiple "
                    "of 16; chunk = T/4)")
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--payload", type=int, default=8)
    ap.add_argument("--model-layers", type=int, default=6)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--eval-samples", type=int, default=32)
    ap.add_argument("--eval-batch", type=int, default=8)
    ap.add_argument("--flash", action="store_true")
    ap.add_argument("--params-dir", default=None)
    ap.add_argument("--output-dir",
                    default="experiments/results/chunked_prefix_quality")
    args = ap.parse_args()

    import jax

    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    import realtime_kv_cache_compression_tpu as rtc
    from realtime_kv_cache_compression_tpu.models import llama

    def llama_init_template(mcfg):
        return llama.init_params(jax.random.PRNGKey(0), mcfg)

    contexts = [int(c) for c in args.contexts.split(",")]
    for t in contexts:
        if t % 16:
            raise SystemExit(f"context {t} must be a multiple of 16")
    fillers = [t - args.payload - 1 for t in contexts]  # recall prompt len

    max_pos = max(contexts) + args.payload + 16
    mcfg = rtc.tiny_test_model(vocab_size=64, hidden_size=128,
                               intermediate_size=256,
                               num_layers=args.model_layers,
                               num_heads=4, num_kv_heads=2, head_dim=32,
                               max_position_embeddings=max_pos)
    ccfg = rtc.CompressionConfig(num_layers=mcfg.num_layers,
                                 high_precision_bits=8,
                                 medium_precision_bits=4,
                                 low_precision_bits=2)

    ckpt = (os.path.join(os.path.abspath(args.params_dir), "recall")
            if args.params_dir else None)
    params = None
    if ckpt and os.path.exists(ckpt):
        from realtime_kv_cache_compression_tpu.models import checkpoint

        template = jax.eval_shape(
            lambda: llama_init_template(mcfg))
        params = checkpoint.load_checkpoint(ckpt, template)
        print(f"loaded params from {ckpt}", flush=True)
    if params is None:
        params = train_recall_model(mcfg, "recall", args.steps, args.batch,
                                    args.payload, fillers, lr=args.lr,
                                    use_flash=args.flash)
        if ckpt:
            from realtime_kv_cache_compression_tpu.models import checkpoint
            checkpoint.save_checkpoint(ckpt, params)
            print(f"saved params to {ckpt}", flush=True)

    results = {"meta": {"argv": sys.argv[1:], "contexts": contexts,
                        "model_layers": args.model_layers,
                        "steps": args.steps,
                        "date": time.strftime("%Y-%m-%d %H:%M")}}
    os.makedirs(args.output_dir, exist_ok=True)
    out_path = os.path.join(args.output_dir, "chunked_prefix_quality.json")

    def accuracy(out, payload):
        import numpy as np

        out = np.asarray(out)
        payload = np.asarray(payload)
        return (float((out == payload).mean()),
                float((out == payload).all(axis=1).mean()))

    for t, filler in zip(contexts, fillers):
        chunk = t // 4
        key = jax.random.PRNGKey(123 + filler)
        ids, prompt_len, payload = make_batch(
            key, args.eval_samples, args.payload, filler, mcfg.vocab_size,
            "recall")
        assert prompt_len == t, (prompt_len, t)
        prompt = ids[:, :prompt_len]
        row = {"chunk": chunk}
        for i in range(0, args.eval_samples, args.eval_batch):
            pb = prompt[i:i + args.eval_batch]
            plb = payload[i:i + args.eval_batch]

            # baseline_fp
            logits, kv = llama.prefill_uncompressed(params, pb, mcfg,
                                                    use_flash=args.flash)
            pad_len = t + args.payload
            kv = tuple(jnp.pad(a, ((0, 0), (0, 0),
                                   (0, pad_len - a.shape[2]), (0, 0),
                                   (0, 0))) for a in kv)
            tok = jnp.argmax(logits, -1)
            pos = jnp.full((pb.shape[0],), t, jnp.int32)
            rest, _, _ = llama.decode_loop_uncompressed(
                params, tok, kv, pos, args.payload - 1, mcfg)
            out_b = jnp.concatenate([tok[:, None], rest], axis=1)

            # comp_oneshot
            out_o, _ = llama.generate(params, pb, mcfg, ccfg,
                                      max_new_tokens=args.payload,
                                      use_flash=args.flash)

            # comp_prefix
            lg, st, _ = llama.prefill_compressed_prefix_chunked(
                params, pb, mcfg, ccfg, chunk_size=chunk,
                max_decode_len=args.payload + 4, use_flash=args.flash)
            tok_p = jnp.argmax(lg, -1)
            rest_p, _ = llama.decode_loop(params, tok_p, st,
                                          args.payload - 1, mcfg, ccfg)
            out_p = jnp.concatenate([tok_p[:, None], rest_p], axis=1)

            for name, o in (("baseline_fp", out_b), ("comp_oneshot", out_o),
                            ("comp_prefix", out_p)):
                acc, em = accuracy(o, plb)
                agg = row.setdefault(name, {"token_accuracy": 0.0,
                                            "exact_match": 0.0, "n": 0})
                n_new = agg["n"] + pb.shape[0]
                agg["token_accuracy"] = (agg["token_accuracy"] * agg["n"]
                                         + acc * pb.shape[0]) / n_new
                agg["exact_match"] = (agg["exact_match"] * agg["n"]
                                      + em * pb.shape[0]) / n_new
                agg["n"] = n_new
        row["prefix_vs_oneshot_acc_delta"] = round(
            row["comp_prefix"]["token_accuracy"]
            - row["comp_oneshot"]["token_accuracy"], 4)
        results[f"context{t}"] = row
        print(f"T={t} (chunk {chunk}): "
              + "  ".join(f"{k} acc={v['token_accuracy']:.3f}"
                          for k, v in row.items()
                          if isinstance(v, dict)), flush=True)
        with open(out_path, "w") as f:
            json.dump(results, f, indent=2)
            f.write("\n")
    print(f"wrote {out_path}", flush=True)


if __name__ == "__main__":
    main()
