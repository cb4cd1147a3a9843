#!/usr/bin/env python
"""Ablation studies over the compression design space.

Capability parity with /root/reference/experiments/ablation_study.py (623
lines): five study types —
  component     7 configs incl. zeroed alpha/beta/gamma, uniform precision,
                uniform propagation, 16-bit no-quant (:265-351)
  weights       alpha/beta/gamma grid under alpha+beta+gamma=1 (:73-124)
  thresholds    theta grid with theta_m < theta_h (:126-168)
  ratios        early >= middle >= later grid (:170-214)
  bits          bit-tier grid high >= med >= low (:216-263)
— each quick-evaluated on two tasks (narrativeqa+qasper, :372-377), results
to pandas CSV + markdown summary (:460-496). Unlike the reference, this file
is directly runnable (`python experiments/ablation_study.py`): the reference
shipped package-relative imports with no __init__.py anywhere, so its
documented invocation fails (SURVEY.md §2.5).
"""

import argparse
import dataclasses
import itertools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def quick_eval(mcfg, params, ccfg, tokenizer, tasks, max_samples, max_length,
               max_new_tokens, synthetic_kwargs):
    """Evaluate one config; returns quality / savings / perf scalars."""
    from realtime_kv_cache_compression_tpu.eval.longbench import (
        LongBenchEvaluator, ModelRunner)

    runner = ModelRunner(params, mcfg, ccfg, max_new_tokens=max_new_tokens)
    ev = LongBenchEvaluator(runner, tokenizer, max_length=max_length,
                            synthetic_kwargs=synthetic_kwargs)
    res = ev.evaluate_all_tasks(tasks, max_samples)
    o = res["overall"]
    return {
        "quality": o["overall_quality_score"],
        "memory_savings": o.get("overall_avg_memory_savings", 0.0),
        "compression_ratio": o.get("overall_avg_compression_ratio", 1.0),
        "tokens_per_second": o["avg_tokens_per_second"],
        "ttft": o["avg_ttft"],
    }


def component_configs(base):
    """Seven component-ablation variants (ablation_study.py:265-351)."""
    rep = dataclasses.replace
    return {
        "full": base,
        "no_attention": rep(base, alpha=0.0, beta=base.beta + base.alpha / 2,
                            gamma=base.gamma + base.alpha / 2),
        "no_position": rep(base, beta=0.0, alpha=base.alpha + base.beta / 2,
                           gamma=base.gamma + base.beta / 2),
        "no_relevance": rep(base, gamma=0.0, alpha=base.alpha + base.gamma / 2,
                            beta=base.beta + base.gamma / 2),
        "uniform_precision": rep(base, theta_h=1.0, theta_m=0.0,
                                 tier_mode="threshold"),
        "uniform_propagation": rep(base, early_layer_ratio=0.6,
                                   middle_layer_ratio=0.6,
                                   later_layer_ratio=0.6),
        "no_quantization": rep(base, high_precision_bits=16,
                               medium_precision_bits=16,
                               low_precision_bits=16),
    }


def weight_grid(base, steps=(0.2, 0.4, 0.6)):
    """alpha+beta+gamma = 1 grid (ablation_study.py:73-124)."""
    out = {}
    for a, b in itertools.product(steps, steps):
        g = round(1.0 - a - b, 4)
        if g >= 0.05:
            out[f"a{a}_b{b}_g{g}"] = dataclasses.replace(
                base, alpha=a, beta=b, gamma=g)
    return out


def threshold_grid(base, highs=(0.5, 0.7, 0.9), mids=(0.1, 0.3, 0.5)):
    out = {}
    for th, tm in itertools.product(highs, mids):
        if tm < th:
            out[f"th{th}_tm{tm}"] = dataclasses.replace(
                base, theta_h=th, theta_m=tm, tier_mode="threshold")
    return out


def ratio_grid(base, grid=((0.9, 0.7, 0.5), (0.8, 0.6, 0.4),
                           (0.7, 0.5, 0.3), (0.6, 0.4, 0.25))):
    return {
        f"r{e}_{m}_{l}": dataclasses.replace(
            base, early_layer_ratio=e, middle_layer_ratio=m,
            later_layer_ratio=l)
        for e, m, l in grid
    }


def bits_grid(base, grid=((16, 8, 4), (8, 4, 2), (8, 8, 4), (4, 4, 2))):
    return {
        f"b{h}_{m}_{l}": dataclasses.replace(
            base, high_precision_bits=h, medium_precision_bits=m,
            low_precision_bits=l)
        for h, m, l in grid
    }


STUDIES = {
    "component": component_configs,
    "weights": weight_grid,
    "thresholds": threshold_grid,
    "ratios": ratio_grid,
    "bits": bits_grid,
}


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--study", default="component",
                    choices=list(STUDIES) + ["all"])
    ap.add_argument("--model", default="tiny-test",
                    choices=["tiny-test", "tinyllama"])
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"])
    ap.add_argument("--tasks", nargs="+", default=["narrativeqa", "qasper"])
    ap.add_argument("--max-samples", type=int, default=10)
    ap.add_argument("--max-length", type=int, default=1024)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--synthetic-context-words", type=int, default=600)
    ap.add_argument("--output-dir", default="experiments/results/ablation")
    args = ap.parse_args()

    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    import jax

    import realtime_kv_cache_compression_tpu as rtc
    from realtime_kv_cache_compression_tpu.models import llama
    from realtime_kv_cache_compression_tpu.utils.data import save_json
    from realtime_kv_cache_compression_tpu.utils.tokenizer import (
        ByteTokenizer)

    mcfg = (rtc.tiny_test_model(vocab_size=258) if args.model == "tiny-test"
            else rtc.TINYLLAMA_1_1B)
    if args.layers:
        mcfg = dataclasses.replace(mcfg, num_layers=args.layers)
    base = rtc.CompressionConfig(num_layers=mcfg.num_layers,
                                 high_precision_bits=8,
                                 medium_precision_bits=4,
                                 low_precision_bits=2)
    params = llama.init_params(jax.random.PRNGKey(0), mcfg)
    tokenizer = ByteTokenizer()
    syn = {"context_words": args.synthetic_context_words}

    studies = list(STUDIES) if args.study == "all" else [args.study]
    os.makedirs(args.output_dir, exist_ok=True)
    for study in studies:
        configs = STUDIES[study](base)
        rows = []
        for name, ccfg in configs.items():
            t0 = time.time()
            try:
                m = quick_eval(mcfg, params, ccfg, tokenizer, args.tasks,
                               args.max_samples, args.max_length,
                               args.max_new_tokens, syn)
                rows.append({"config": name, **m,
                             "wall_s": time.time() - t0})
                print(f"[{study}] {name}: quality={m['quality']:.4f} "
                      f"savings={m['memory_savings']:.3f}", flush=True)
            except Exception as e:  # record, keep sweeping (ref :113-115)
                rows.append({"config": name, "error": repr(e)})

        save_json(os.path.join(args.output_dir, f"{study}_results.json"),
                  rows)
        try:
            import pandas as pd

            df = pd.DataFrame(rows)
            df.to_csv(os.path.join(args.output_dir, f"{study}_results.csv"),
                      index=False)
        except ImportError:
            pass
        ok = [r for r in rows if "error" not in r]
        if ok:
            best = max(ok, key=lambda r: r["quality"])
            lines = [f"# Ablation: {study}", "",
                     f"best config: **{best['config']}** "
                     f"(quality {best['quality']:.4f}, savings "
                     f"{best['memory_savings']:.3f})", "",
                     "| config | quality | savings | tok/s |", "|---|---|---|---|"]
            for r in sorted(ok, key=lambda r: -r["quality"]):
                lines.append(f"| {r['config']} | {r['quality']:.4f} | "
                             f"{r['memory_savings']:.3f} | "
                             f"{r['tokens_per_second']:.1f} |")
            with open(os.path.join(args.output_dir, f"{study}_summary.md"),
                      "w") as f:
                f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
