#!/usr/bin/env python
"""Hyperparameter tuning with four optimizers over the compression space.

Capability parity with /root/reference/experiments/hyperparameter_tuning.py
(606 lines): a 10-dim search space (:41-62) with weights renormalized to sum
to 1 (:64-89), a multi-objective scalarization
0.6·quality + 0.3·memory-savings + 0.1·speed (:91-166), and four search
methods — grid (:168-239), random (:241-296), Bayesian (:298-369; the
reference used Optuna TPE, unavailable here, so Bayesian optimization is a
scikit-learn Gaussian-process EI loop — the reference imported sklearn's GP
and never used it), and genetic with tournament selection / single-point
crossover / uniform mutation (:371-465) — plus a method-comparison harness
with CSV output (:467-560). Directly runnable, unlike the reference
(SURVEY.md §2.5 import defect).

Unlike the reference — which rebuilt and re-loaded the full model every
trial (:104, SURVEY.md §3.5) — params are created once and shared.
"""

import argparse
import dataclasses
import itertools
import math
import os
import random
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SPACE = {
    "alpha": (0.1, 0.8),
    "beta": (0.1, 0.8),
    "gamma": (0.1, 0.8),
    "theta_h": (0.5, 0.9),
    "theta_m": (0.1, 0.45),
    "early_layer_ratio": (0.5, 0.95),
    "middle_layer_ratio": (0.35, 0.8),
    "later_layer_ratio": (0.2, 0.6),
    "high_precision_bits": (8, 16),     # categorical-ish
    "medium_precision_bits": (4, 8),
}

BITS_CHOICES = {"high_precision_bits": (8, 16),
                "medium_precision_bits": (4, 8)}


def normalize_point(pt):
    """Renormalize alpha/beta/gamma to sum 1, order ratios and thresholds,
    snap bits to allowed values (reference :64-89)."""
    s = pt["alpha"] + pt["beta"] + pt["gamma"]
    for k in ("alpha", "beta", "gamma"):
        pt[k] = pt[k] / s
    pt["theta_m"] = min(pt["theta_m"], pt["theta_h"] - 0.05)
    e, m, l = (pt["early_layer_ratio"], pt["middle_layer_ratio"],
               pt["later_layer_ratio"])
    e, m, l = sorted((e, m, l), reverse=True)
    pt.update(early_layer_ratio=e, middle_layer_ratio=m, later_layer_ratio=l)
    for k, choices in BITS_CHOICES.items():
        pt[k] = min(choices, key=lambda c: abs(c - pt[k]))
    return pt


def sample_point(rng):
    pt = {k: rng.uniform(lo, hi) for k, (lo, hi) in SPACE.items()}
    return normalize_point(pt)


def point_to_config(pt, num_layers):
    import realtime_kv_cache_compression_tpu as rtc

    return rtc.CompressionConfig(
        num_layers=num_layers,
        alpha=pt["alpha"], beta=pt["beta"], gamma=pt["gamma"],
        theta_h=pt["theta_h"], theta_m=pt["theta_m"],
        early_layer_ratio=pt["early_layer_ratio"],
        middle_layer_ratio=pt["middle_layer_ratio"],
        later_layer_ratio=pt["later_layer_ratio"],
        high_precision_bits=int(pt["high_precision_bits"]),
        medium_precision_bits=int(pt["medium_precision_bits"]),
        low_precision_bits=2,
    )


class Tuner:
    def __init__(self, mcfg, params, tokenizer, tasks, max_samples,
                 max_length, max_new_tokens, synthetic_kwargs, seed=0):
        self.mcfg = mcfg
        self.params = params
        self.tokenizer = tokenizer
        self.tasks = tasks
        self.max_samples = max_samples
        self.max_length = max_length
        self.max_new_tokens = max_new_tokens
        self.syn = synthetic_kwargs
        self.rng = random.Random(seed)
        self.history = []

    def objective(self, pt):
        """0.6·quality + 0.3·savings + 0.1·speed (reference :139-143)."""
        from realtime_kv_cache_compression_tpu.eval.longbench import (
            LongBenchEvaluator, ModelRunner)

        try:
            ccfg = point_to_config(pt, self.mcfg.num_layers)
            runner = ModelRunner(self.params, self.mcfg, ccfg,
                                 max_new_tokens=self.max_new_tokens)
            ev = LongBenchEvaluator(runner, self.tokenizer,
                                    max_length=self.max_length,
                                    synthetic_kwargs=self.syn)
            t0 = time.time()
            res = ev.evaluate_all_tasks(self.tasks, self.max_samples)
            wall = time.time() - t0
            o = res["overall"]
            score = (0.6 * o["overall_quality_score"]
                     + 0.3 * o.get("overall_avg_memory_savings", 0.0)
                     + 0.1 * (1.0 / (wall + 1.0)))
            rec = {"point": dict(pt), "score": score,
                   "quality": o["overall_quality_score"],
                   "savings": o.get("overall_avg_memory_savings", 0.0),
                   "wall_s": wall}
        except Exception as e:  # objective 0 on error (reference :164-166)
            rec = {"point": dict(pt), "score": 0.0, "error": repr(e)}
        self.history.append(rec)
        return rec["score"]

    # -- methods ------------------------------------------------------------

    def grid_search(self, n_trials):
        axes = {
            "alpha": (0.2, 0.4, 0.6),
            "theta_h": (0.6, 0.8),
            "early_layer_ratio": (0.7, 0.9),
        }
        combos = list(itertools.product(*axes.values()))[:n_trials]
        for combo in combos:
            pt = sample_point(random.Random(0))
            pt.update(dict(zip(axes.keys(), combo)))
            self.objective(normalize_point(pt))
        return self.best()

    def random_search(self, n_trials):
        for _ in range(n_trials):
            self.objective(sample_point(self.rng))
        return self.best()

    def bayesian_optimization(self, n_trials, n_init=4):
        """GP-EI over the continuous dims (bits handled by snapping)."""
        import numpy as np

        keys = list(SPACE.keys())

        def to_vec(pt):
            return np.array([(pt[k] - SPACE[k][0])
                             / (SPACE[k][1] - SPACE[k][0]) for k in keys])

        def from_vec(v):
            pt = {k: SPACE[k][0] + float(x) * (SPACE[k][1] - SPACE[k][0])
                  for k, x in zip(keys, v)}
            return normalize_point(pt)

        X, y = [], []
        for _ in range(min(n_init, n_trials)):
            pt = sample_point(self.rng)
            X.append(to_vec(pt))
            y.append(self.objective(pt))
        try:
            from sklearn.gaussian_process import GaussianProcessRegressor
            from sklearn.gaussian_process.kernels import Matern
        except ImportError:
            return self.random_search(max(0, n_trials - n_init))
        for _ in range(n_trials - len(X)):
            gp = GaussianProcessRegressor(kernel=Matern(nu=2.5),
                                          normalize_y=True, alpha=1e-4)
            gp.fit(np.stack(X), np.array(y))
            cands = np.random.default_rng(self.rng.randrange(1 << 30)) \
                .random((256, len(keys)))
            mu, sigma = gp.predict(cands, return_std=True)
            best_y = max(y)
            z = (mu - best_y) / np.maximum(sigma, 1e-9)
            ei = (mu - best_y) * _ncdf(z) + sigma * _npdf(z)
            v = cands[int(np.argmax(ei))]
            pt = from_vec(v)
            X.append(to_vec(pt))
            y.append(self.objective(pt))
        return self.best()

    def evolutionary_search(self, n_trials, pop_size=6, tournament=3,
                            mutate_p=0.25):
        pop = [sample_point(self.rng) for _ in range(pop_size)]
        scores = [self.objective(p) for p in pop]
        evals = pop_size
        keys = list(SPACE.keys())
        while evals < n_trials:
            def pick():
                idx = max(self.rng.sample(range(len(pop)), tournament),
                          key=lambda i: scores[i])
                return pop[idx]

            a, b = pick(), pick()
            cut = self.rng.randrange(1, len(keys))
            child = {k: (a if i < cut else b)[k]
                     for i, k in enumerate(keys)}
            for k in keys:
                if self.rng.random() < mutate_p:
                    lo, hi = SPACE[k]
                    child[k] = self.rng.uniform(lo, hi)
            child = normalize_point(child)
            s = self.objective(child)
            evals += 1
            worst = min(range(len(pop)), key=lambda i: scores[i])
            if s > scores[worst]:
                pop[worst], scores[worst] = child, s
        return self.best()

    def best(self):
        ok = [h for h in self.history if "error" not in h]
        return max(ok, key=lambda h: h["score"]) if ok else None


def _ncdf(z):
    import numpy as np

    return 0.5 * (1 + np.vectorize(math.erf)(z / math.sqrt(2)))


def _npdf(z):
    import numpy as np

    return np.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--method", default="random",
                    choices=["grid", "random", "bayesian", "genetic",
                             "compare"])
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--tasks", nargs="+", default=["narrativeqa", "qasper"])
    ap.add_argument("--max-samples", type=int, default=5)
    ap.add_argument("--max-length", type=int, default=1024)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--synthetic-context-words", type=int, default=600)
    ap.add_argument("--output-dir", default="experiments/results/tuning")
    ap.add_argument("--seed", type=int, default=0)
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

    mcfg = rtc.tiny_test_model(vocab_size=258, num_layers=args.layers)
    params = llama.init_params(jax.random.PRNGKey(0), mcfg)

    def make_tuner():
        return Tuner(mcfg, params, ByteTokenizer(), args.tasks,
                     args.max_samples, args.max_length, args.max_new_tokens,
                     {"context_words": args.synthetic_context_words},
                     seed=args.seed)

    os.makedirs(args.output_dir, exist_ok=True)
    methods = (["grid", "random", "bayesian", "genetic"]
               if args.method == "compare" else [args.method])
    comparison = {}
    for method in methods:
        tuner = make_tuner()
        fn = {"grid": tuner.grid_search, "random": tuner.random_search,
              "bayesian": tuner.bayesian_optimization,
              "genetic": tuner.evolutionary_search}[method]
        t0 = time.time()
        best = fn(args.trials)
        comparison[method] = {"best": best, "trials": len(tuner.history),
                              "wall_s": time.time() - t0}
        save_json(os.path.join(args.output_dir, f"{method}_history.json"),
                  tuner.history)
        print(f"[{method}] best score="
              f"{best['score'] if best else float('nan'):.4f} "
              f"({len(tuner.history)} trials)", flush=True)
    save_json(os.path.join(args.output_dir, "comparison.json"), comparison)
    try:
        import pandas as pd

        rows = [{"method": m, "best_score": v["best"]["score"] if v["best"]
                 else None, "trials": v["trials"], "wall_s": v["wall_s"]}
                for m, v in comparison.items()]
        pd.DataFrame(rows).to_csv(
            os.path.join(args.output_dir, "comparison.csv"), index=False)
    except ImportError:
        pass


if __name__ == "__main__":
    main()
