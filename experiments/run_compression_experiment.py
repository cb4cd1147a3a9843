#!/usr/bin/env python
"""Main experiment CLI: baseline vs compressed LongBench evaluation.

Capability parity with the reference CLI
(/root/reference/experiments/run_compression_experiment.py): the same
hyperparameter surface (alpha/beta/gamma, theta_h/theta_m, layer-group
ratios, bit tiers, tasks, max_samples, max_new_tokens, output_dir,
experiment_name, --baseline), writing config.json + experiment_summary.json
+ per-task artifacts, with error.log on failure.

Additions: --mesh-model/--mesh-data GSPMD sharding, --flash (flash
prefill), --platform cpu|gpu, and a hermetic --synthetic mode with
planted-answer data (this environment has zero egress; real LongBench JSONL
can be supplied via --data-dir).
"""

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args():
    p = argparse.ArgumentParser(description=__doc__)
    # Model
    p.add_argument("--model", default="tinyllama",
                   choices=["tiny-test", "tinyllama", "llama2-7b",
                            "llama2-13b"])
    p.add_argument("--checkpoint", default=None,
                   help="local HF checkpoint dir (safetensors) for weights")
    p.add_argument("--layers", type=int, default=None,
                   help="override layer count (smoke tests)")
    p.add_argument("--platform", default=None, choices=["cpu", "gpu"])
    p.add_argument("--max-length", type=int, default=4096)
    p.add_argument("--max-new-tokens", type=int, default=64)
    # Compression hyperparameters (reference parity)
    p.add_argument("--alpha", type=float, default=0.4)
    p.add_argument("--beta", type=float, default=0.3)
    p.add_argument("--gamma", type=float, default=0.3)
    p.add_argument("--theta-h", type=float, default=0.7)
    p.add_argument("--theta-m", type=float, default=0.3)
    p.add_argument("--early-ratio", type=float, default=0.8)
    p.add_argument("--middle-ratio", type=float, default=0.6)
    p.add_argument("--later-ratio", type=float, default=0.4)
    p.add_argument("--high-bits", type=int, default=8)
    p.add_argument("--medium-bits", type=int, default=4)
    p.add_argument("--low-bits", type=int, default=2)
    p.add_argument("--tier-mode", default="quantile",
                   choices=["quantile", "threshold"])
    p.add_argument("--selection-mode", default="topk_prefix",
                   choices=["topk_prefix", "exact_greedy"])
    p.add_argument("--recompute-prefill", action="store_true",
                   help="reference-parity mode: recompute prefill attention "
                        "against compressed K/V")
    # Evaluation
    p.add_argument("--tasks", nargs="+", default=["narrativeqa", "qasper",
                                                  "multifieldqa_en"])
    p.add_argument("--max-samples", type=int, default=10)
    p.add_argument("--eval-batch", type=int, default=1,
                   help="samples per ragged evaluation batch")
    p.add_argument("--data-dir", default=None,
                   help="dir with {task}.jsonl LongBench files")
    p.add_argument("--synthetic-context-words", type=int, default=3000)
    # Execution
    p.add_argument("--baseline", action="store_true",
                   help="also run the uncompressed baseline arm")
    p.add_argument("--flash", action="store_true",
                   help="use the Pallas flash prefill kernel")
    p.add_argument("--mesh-data", type=int, default=1)
    p.add_argument("--mesh-model", type=int, default=1)
    # Output
    p.add_argument("--output-dir", default="experiments/results")
    p.add_argument("--experiment-name", default=None)
    return p.parse_args()


def build_configs(args):
    import realtime_kv_cache_compression_tpu as rtc

    presets = {
        "tiny-test": rtc.tiny_test_model(vocab_size=258),
        "tinyllama": rtc.TINYLLAMA_1_1B,
        "llama2-7b": rtc.LLAMA2_7B,
        "llama2-13b": rtc.LLAMA2_13B,
    }
    mcfg = presets[args.model]
    if args.layers:
        mcfg = dataclasses.replace(mcfg, num_layers=args.layers)
    if mcfg.max_position_embeddings < args.max_length + args.max_new_tokens:
        mcfg = dataclasses.replace(
            mcfg,
            max_position_embeddings=args.max_length + args.max_new_tokens)
    ccfg = rtc.CompressionConfig(
        alpha=args.alpha, beta=args.beta, gamma=args.gamma,
        theta_h=args.theta_h, theta_m=args.theta_m,
        early_layer_ratio=args.early_ratio,
        middle_layer_ratio=args.middle_ratio,
        later_layer_ratio=args.later_ratio,
        high_precision_bits=args.high_bits,
        medium_precision_bits=args.medium_bits,
        low_precision_bits=args.low_bits,
        num_layers=mcfg.num_layers,
        tier_mode=args.tier_mode,
        selection_mode=args.selection_mode,
        recompute_prefill_attention=args.recompute_prefill,
    )
    return mcfg, ccfg


def load_params(args, mcfg):
    import jax

    from realtime_kv_cache_compression_tpu.models import llama, weights

    if args.checkpoint:
        return weights.load_hf_checkpoint(args.checkpoint, mcfg)
    return llama.init_params(jax.random.PRNGKey(0), mcfg)


def main():
    args = parse_args()
    n_mesh = args.mesh_data * args.mesh_model
    if args.platform == "cpu" and n_mesh > 1:
        # Virtual multi-device CPU mesh; must be set before backend init.
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={n_mesh}"
            ).strip()
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    import jax

    from realtime_kv_cache_compression_tpu.eval.longbench import (
        LongBenchEvaluator, ModelRunner)
    from realtime_kv_cache_compression_tpu.utils.data import save_json
    from realtime_kv_cache_compression_tpu.utils.memory import MemoryMonitor
    from realtime_kv_cache_compression_tpu.utils.tokenizer import (
        load_tokenizer)

    name = args.experiment_name or f"compression_exp_{time.strftime('%Y%m%d_%H%M%S')}"
    out_dir = os.path.join(args.output_dir, name)
    os.makedirs(out_dir, exist_ok=True)
    save_json(os.path.join(out_dir, "config.json"),
              {**vars(args), "experiment_name": name})

    try:
        mcfg, ccfg = build_configs(args)
        params = load_params(args, mcfg)
        if args.mesh_data * args.mesh_model > 1:
            from realtime_kv_cache_compression_tpu.parallel import (
                create_mesh, shard_params)

            mesh = create_mesh(args.mesh_data, args.mesh_model)
            params = shard_params(params, mesh, mcfg)
        tokenizer = load_tokenizer(args.checkpoint)
        syn = {"context_words": args.synthetic_context_words}

        results = {}
        mon = MemoryMonitor()
        mon.start()
        runner_c = ModelRunner(params, mcfg, ccfg, use_flash=args.flash,
                               max_new_tokens=args.max_new_tokens)
        ev_c = LongBenchEvaluator(
            runner_c, tokenizer, output_dir=os.path.join(out_dir,
                                                         "compressed"),
            max_length=args.max_length, data_dir=args.data_dir,
            synthetic_kwargs=syn)
        results["compressed"] = ev_c.evaluate_all_tasks(
            args.tasks, args.max_samples, batch_size=args.eval_batch)
        results["compressed"]["memory_monitor"] = mon.stop()

        if args.baseline:
            mon = MemoryMonitor()
            mon.start()
            runner_b = ModelRunner(params, mcfg, ccfg=None,
                                   use_flash=args.flash,
                                   max_new_tokens=args.max_new_tokens)
            ev_b = LongBenchEvaluator(
                runner_b, tokenizer,
                output_dir=os.path.join(out_dir, "baseline"),
                max_length=args.max_length, data_dir=args.data_dir,
                synthetic_kwargs=syn)
            results["baseline"] = ev_b.evaluate_all_tasks(
                args.tasks, args.max_samples,
                batch_size=args.eval_batch)
            results["baseline"]["memory_monitor"] = mon.stop()

        summary = {
            "experiment_name": name,
            "model": args.model,
            "tasks": args.tasks,
            "results": {
                arm: {
                    "overall_quality_score":
                        r["overall"]["overall_quality_score"],
                    "avg_tokens_per_second":
                        r["overall"]["avg_tokens_per_second"],
                    "avg_ttft": r["overall"]["avg_ttft"],
                    **({"memory_savings":
                        r["overall"].get("overall_avg_memory_savings")}
                       if "overall_avg_memory_savings" in r["overall"]
                       else {}),
                } for arm, r in results.items()
            },
            "task_breakdown": {
                arm: {t: v.get("metrics", {}).get("quality")
                      for t, v in r["per_task"].items()}
                for arm, r in results.items()
            },
        }
        save_json(os.path.join(out_dir, "experiment_summary.json"), summary)
        print(json.dumps(summary["results"], indent=2))
        print(f"artifacts: {out_dir}")
    except Exception:
        with open(os.path.join(out_dir, "error.log"), "w") as f:
            f.write(traceback.format_exc())
        raise


if __name__ == "__main__":
    main()
