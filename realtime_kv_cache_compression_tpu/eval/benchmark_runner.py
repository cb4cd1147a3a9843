"""Performance benchmark suite: named scenarios × sequence lengths.

Capability parity with the reference `CompressionBenchmark`
(/root/reference/src/evaluation/benchmark runner.py:18-553): six named
config scenarios (:41-82), synthetic test sequences at target token lengths
(:84-114), per-config TTFT / tokens-per-second / memory measurement
(:170-253), mean/std/min/max/median aggregation (:255-297), matplotlib plots
(:373-508) and a markdown summary report (:510-552) — and, unlike the
reference, it is actually importable (the reference file has a space in its
name and a broken relative import, SURVEY.md §2.4).

Timing uses one-program scan decode, with the host clock around work that
ends in `block_until_ready` (utils/timing.py); memory is physical cache
bytes + device memory stats.
"""

from __future__ import annotations

import os
import statistics
from typing import Any, Dict, Optional, Sequence

import jax
import jax.numpy as jnp

from ..compression.compressor import summarize_layer_stats
from ..config import CompressionConfig, ModelConfig
from ..models import llama
from ..utils.data import save_json
from ..utils.memory import device_memory_stats
from ..utils.timing import timed


def named_scenarios(num_layers: int) -> Dict[str, Optional[CompressionConfig]]:
    """Six scenarios mirroring `benchmark runner.py`:41-82: an uncompressed
    baseline plus conservative/balanced/aggressive compression strengths and
    the two importance-weighting emphases."""
    mk = lambda **kw: CompressionConfig(num_layers=num_layers, **kw)
    return {
        "baseline": None,
        "conservative": mk(early_layer_ratio=0.9, middle_layer_ratio=0.8,
                           later_layer_ratio=0.7, high_precision_bits=16,
                           medium_precision_bits=8, low_precision_bits=4,
                           theta_h=0.5, theta_m=0.2),
        "balanced": mk(high_precision_bits=8, medium_precision_bits=4,
                       low_precision_bits=2),
        "aggressive": mk(early_layer_ratio=0.6, middle_layer_ratio=0.4,
                         later_layer_ratio=0.25, high_precision_bits=8,
                         medium_precision_bits=4, low_precision_bits=2,
                         theta_h=0.8, theta_m=0.5),
        "prompt_focused": mk(alpha=0.7, beta=0.15, gamma=0.15,
                             high_precision_bits=8, medium_precision_bits=4,
                             low_precision_bits=2),
        "position_focused": mk(alpha=0.15, beta=0.7, gamma=0.15,
                               high_precision_bits=8, medium_precision_bits=4,
                               low_precision_bits=2),
    }


class CompressionBenchmark:
    def __init__(self, mcfg: ModelConfig, params=None,
                 output_dir: Optional[str] = None,
                 seq_lens: Sequence[int] = (1024, 2048, 4096),
                 new_tokens: int = 50, batch: int = 1,
                 use_flash: bool = False):
        self.mcfg = mcfg
        self.params = params if params is not None else llama.init_params(
            jax.random.PRNGKey(0), mcfg)
        self.output_dir = output_dir
        self.seq_lens = list(seq_lens)
        self.new_tokens = new_tokens
        self.batch = batch
        self.use_flash = use_flash
        self.results: Dict[str, Any] = {}

    # -- measurement --------------------------------------------------------

    def _synthetic_ids(self, seq_len: int, seed: int = 0) -> jax.Array:
        return jax.random.randint(jax.random.PRNGKey(seed),
                                  (self.batch, seq_len), 0,
                                  self.mcfg.vocab_size)

    def measure_single_inference(self, ccfg: Optional[CompressionConfig],
                                 seq_len: int) -> Dict[str, float]:
        ids = self._synthetic_ids(seq_len)
        n = self.new_tokens - 1
        if ccfg is not None:
            prefill = jax.jit(lambda p, i: llama.prefill_compressed(
                p, i, self.mcfg, ccfg, max_decode_len=self.new_tokens,
                use_flash=self.use_flash))
            loop = jax.jit(lambda p, t, s: llama.decode_loop(
                p, t, s, n, self.mcfg, ccfg))
            logits, state, stats = prefill(self.params, ids)
            tok = jnp.argmax(logits, axis=-1)
            jax.block_until_ready(loop(self.params, tok, state))  # compile

            ttft, (logits, state, stats) = timed(
                lambda: prefill(self.params, ids))
            tok = jnp.argmax(logits, axis=-1)
            dt, _ = timed(lambda: loop(self.params, tok, state))
            comp = summarize_layer_stats(stats)
        else:
            prefill = jax.jit(lambda p, i: llama.prefill_uncompressed(
                p, i, self.mcfg))
            pad_len = seq_len + self.new_tokens
            loop = jax.jit(lambda p, t, kv, pos: llama.decode_loop_uncompressed(
                p, t, kv, pos, n, self.mcfg))

            def pad(a):
                return jnp.pad(a, ((0, 0), (0, 0),
                                   (0, pad_len - a.shape[2]), (0, 0),
                                   (0, 0)))

            logits, kv = prefill(self.params, ids)
            kvp = (pad(kv[0]), pad(kv[1]))
            pos = jnp.full((self.batch,), seq_len, jnp.int32)
            tok = jnp.argmax(logits, axis=-1)
            jax.block_until_ready(loop(self.params, tok, kvp, pos))  # compile

            ttft, (logits, kv) = timed(lambda: prefill(self.params, ids))
            kvp = (pad(kv[0]), pad(kv[1]))
            dt, _ = timed(lambda: loop(self.params, tok, kvp, pos))
            comp = None

        rec = {
            "seq_len": seq_len,
            "ttft_ms": ttft * 1e3,
            "tokens_per_second": self.batch * n / dt,
            "ms_per_step": dt * 1e3 / n,
            **device_memory_stats(),
        }
        if comp:
            rec["compression_ratio"] = comp["avg_compression_ratio"]
            rec["memory_savings"] = comp["avg_memory_savings"]
        return rec

    def benchmark_single_config(self, name: str,
                                ccfg: Optional[CompressionConfig]
                                ) -> Dict[str, Any]:
        per_len = []
        for s in self.seq_lens:
            try:
                per_len.append(self.measure_single_inference(ccfg, s))
            except Exception as e:
                per_len.append({"seq_len": s, "error": repr(e)})
        ok = [r for r in per_len if "error" not in r]
        agg = {}
        for key in ("ttft_ms", "tokens_per_second", "ms_per_step"):
            vals = [r[key] for r in ok]
            if vals:
                agg[key] = {
                    "mean": statistics.mean(vals),
                    "std": statistics.pstdev(vals) if len(vals) > 1 else 0.0,
                    "min": min(vals), "max": max(vals),
                    "median": statistics.median(vals),
                }
        return {"config": name, "per_seq_len": per_len, "aggregate": agg}

    def run_full_benchmark(self, configs: Optional[Sequence[str]] = None
                           ) -> Dict[str, Any]:
        scenarios = named_scenarios(self.mcfg.num_layers)
        names = list(configs or scenarios.keys())
        for name in names:
            self.results[name] = self.benchmark_single_config(
                name, scenarios[name])
            if self.output_dir:  # intermediate save enables manual resume
                save_json(os.path.join(self.output_dir,
                                       f"benchmark_{name}.json"),
                          self.results[name])
        if self.output_dir:
            save_json(os.path.join(self.output_dir, "benchmark_results.json"),
                      self.results)
            self.plot_results()
            self.write_report()
        return self.results

    # -- analysis artifacts (plots + markdown, `benchmark runner.py`:373-552)

    def plot_results(self):
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        fig, axes = plt.subplots(1, 3, figsize=(16, 4.5))
        for name, res in self.results.items():
            ok = [r for r in res["per_seq_len"] if "error" not in r]
            if not ok:
                continue
            xs = [r["seq_len"] for r in ok]
            axes[0].plot(xs, [r["ttft_ms"] for r in ok], marker="o",
                         label=name)
            axes[1].plot(xs, [r["tokens_per_second"] for r in ok],
                         marker="o", label=name)
            if any("memory_savings" in r for r in ok):
                axes[2].plot(xs, [r.get("memory_savings", 0) for r in ok],
                             marker="o", label=name)
        for ax, title, ylab in zip(
                axes, ["TTFT vs context", "Decode throughput",
                       "KV memory savings"],
                ["ms", "tokens/s", "fraction"]):
            ax.set_title(title)
            ax.set_xlabel("sequence length")
            ax.set_ylabel(ylab)
            ax.set_xscale("log", base=2)
            ax.legend(fontsize=7)
        fig.tight_layout()
        fig.savefig(os.path.join(self.output_dir, "benchmark_plots.png"),
                    dpi=120)

    def write_report(self):
        lines = ["# Compression benchmark report", "",
                 f"model: {self.mcfg.num_layers}L hidden="
                 f"{self.mcfg.hidden_size} kv_heads={self.mcfg.num_kv_heads}",
                 f"batch={self.batch} new_tokens={self.new_tokens} "
                 f"flash={self.use_flash}", ""]
        lines.append("| config | seq | TTFT (ms) | tok/s | savings |")
        lines.append("|---|---|---|---|---|")
        for name, res in self.results.items():
            for r in res["per_seq_len"]:
                if "error" in r:
                    lines.append(f"| {name} | {r['seq_len']} | error | | |")
                else:
                    lines.append(
                        f"| {name} | {r['seq_len']} | {r['ttft_ms']:.1f} | "
                        f"{r['tokens_per_second']:.1f} | "
                        f"{r.get('memory_savings', 0):.2f} |")
        with open(os.path.join(self.output_dir, "benchmark_report.md"),
                  "w") as f:
            f.write("\n".join(lines) + "\n")


def run_benchmark_suite(mcfg: ModelConfig, output_dir: str,
                        **kwargs) -> Dict[str, Any]:
    os.makedirs(output_dir, exist_ok=True)
    bench = CompressionBenchmark(mcfg, output_dir=output_dir, **kwargs)
    return bench.run_full_benchmark()
