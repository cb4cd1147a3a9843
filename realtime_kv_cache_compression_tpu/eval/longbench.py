"""LongBench evaluation harness.

Capability parity with the reference `LongBenchEvaluator`
(/root/reference/src/evaluation/longbench_eval.py:14-395): task registry +
prompt templates + truncation policy (utils/data.py), generation with
compression stats and perf stats (TTFT, tokens/s), per-task metric routing
(QA→F1/EM, summarization→ROUGE, few-shot→accuracy/F1), per-task and overall
aggregation, JSON artifacts with the reference's key names
(`{task}_detailed_results.json`, `comprehensive_evaluation_results.json`).

Differences from the reference:
  * Static shapes: prompts are middle-truncated to the largest power-of-two
    bucket ≤ their length, so each bucket jit-compiles once (the reference
    re-ran eager PyTorch per sample).
  * Perf is measured with `block_until_ready` walls, not CUDA synchronize.
  * Runs hermetically: local JSONL or synthetic planted-answer data when the
    HF hub is unreachable (this environment has zero egress).
"""

from __future__ import annotations

import functools
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp

from ..compression.compressor import summarize_layer_stats
from ..config import CompressionConfig, ModelConfig
from ..models import llama
from ..utils.data import (LONGBENCH_TASKS, CORE_TASKS, TaskSpec,
                          extract_answers, format_prompt, load_task_data,
                          save_json, truncate_middle)
from ..utils.tokenizer import ByteTokenizer, decode_ids, encode_ids
from . import metrics as M


def pick_bucket(n: int, max_length: int, min_bucket: int = 256) -> int:
    """Smallest power-of-two bucket >= n, clamped to [min_bucket,
    max_length]. Sequences longer than max_length are middle-truncated;
    shorter ones are right-padded and evaluated ragged (exact — padding is
    never attended or stored)."""
    b = min_bucket
    while b < min(n, max_length):
        b *= 2
    return min(b, max_length)


class ModelRunner:
    """Uniform generation interface for the compressed and baseline arms."""

    def __init__(self, params, mcfg: ModelConfig,
                 ccfg: Optional[CompressionConfig] = None,
                 use_flash: bool = False, max_new_tokens: int = 64):
        self.params = params
        self.mcfg = mcfg
        self.ccfg = ccfg
        self.use_flash = use_flash
        self.max_new_tokens = max_new_tokens
        self._prefill_cache: Dict[int, Callable] = {}
        self._step_cache: Dict[str, Callable] = {}
        self._warmed: set = set()

    @property
    def compressed(self) -> bool:
        return self.ccfg is not None

    def _prefill(self, bucket: int):
        if bucket not in self._prefill_cache:
            if self.compressed:
                fn = jax.jit(lambda p, i, n: llama.prefill_compressed(
                    p, i, self.mcfg, self.ccfg,
                    max_decode_len=self.max_new_tokens,
                    use_flash=self.use_flash, lengths=n))
            else:
                fn = jax.jit(lambda p, i, n: llama.prefill_uncompressed(
                    p, i, self.mcfg, use_flash=self.use_flash, lengths=n))
            self._prefill_cache[bucket] = fn
        return self._prefill_cache[bucket]

    def _decode(self, bucket: int):
        key = f"step{bucket if not self.compressed else 0}"
        if key not in self._step_cache:
            n = self.max_new_tokens - 1
            if self.compressed:
                fn = jax.jit(lambda p, t, s: llama.decode_loop(
                    p, t, s, n, self.mcfg, self.ccfg))
            else:
                fn = jax.jit(
                    lambda p, t, kv, pos: llama.decode_loop_uncompressed(
                        p, t, kv, pos, n, self.mcfg))
            self._step_cache[key] = fn
        return self._step_cache[key]

    def generate(self, ids: jax.Array, eos_token_id: Optional[int] = None,
                 lengths: Optional[jax.Array] = None) -> Dict[str, Any]:
        """Greedy generation; returns tokens + perf + compression stats.

        `ids` is a [B, bucket] right-padded batch; `lengths` the true
        per-row lengths (defaults to full bucket).
        """
        bucket = ids.shape[1]
        if lengths is None:
            lengths = jnp.full((ids.shape[0],), bucket, jnp.int32)
        prefill = self._prefill(bucket)
        step = self._decode(bucket)

        sync = jax.block_until_ready

        # Warm-up compile once per bucket (excluded from TTFT *and* from the
        # decode timer — the decode loop compiles here too, so the first
        # sample of a bucket is not charged tens of seconds of compilation).
        if bucket not in self._warmed:
            out = prefill(self.params, ids, lengths)
            sync(out[0])
            if self.max_new_tokens > 1:
                tok_w = jnp.argmax(out[0], axis=-1)
                if self.compressed:
                    rest_w, _ = step(self.params, tok_w, out[1])
                else:
                    pad_len = bucket + self.max_new_tokens
                    kv_w = tuple(jnp.pad(a, ((0, 0), (0, 0),
                                             (0, pad_len - a.shape[2]),
                                             (0, 0), (0, 0)))
                                 for a in out[1])
                    rest_w, _, _ = step(self.params, tok_w, kv_w, lengths)
                sync(rest_w)
            self._warmed.add(bucket)

        t0 = time.perf_counter()
        if self.compressed:
            logits, state, stats = prefill(self.params, ids, lengths)
        else:
            logits, kv = prefill(self.params, ids, lengths)
        sync(logits)
        ttft = time.perf_counter() - t0

        tok = jnp.argmax(logits, axis=-1)
        t0 = time.perf_counter()
        if self.max_new_tokens > 1:
            if self.compressed:
                rest, _ = step(self.params, tok, state)
            else:
                pad_len = bucket + self.max_new_tokens
                kv = tuple(jnp.pad(a, ((0, 0), (0, 0),
                                       (0, pad_len - a.shape[2]),
                                       (0, 0), (0, 0))) for a in kv)
                rest, _, _ = step(self.params, tok, kv, lengths)
            out_tokens = jnp.concatenate([tok[:, None], rest], axis=1)
        else:
            out_tokens = tok[:, None]
        out_tokens = jnp.asarray(jax.device_get(out_tokens))
        decode_time = time.perf_counter() - t0
        if eos_token_id is not None:
            hit = jnp.cumsum((out_tokens == eos_token_id).astype(jnp.int32),
                             axis=1)
            out_tokens = jnp.where(hit - (out_tokens == eos_token_id) > 0,
                                   eos_token_id, out_tokens)
        n_new = out_tokens.shape[1]

        result = {
            "tokens": out_tokens,
            "ttft": ttft,
            "decode_time": decode_time,
            "new_tokens": n_new,
            "tokens_per_second": (n_new - 1) / decode_time
                                 if decode_time > 0 and n_new > 1 else 0.0,
            "context_length": bucket,
        }
        if self.compressed:
            result["compression"] = summarize_layer_stats(stats)
        return result


class LongBenchEvaluator:
    """Evaluate a ModelRunner over LongBench tasks; write JSON artifacts."""

    def __init__(self, runner: ModelRunner, tokenizer=None,
                 output_dir: Optional[str] = None,
                 max_length: int = 4096, data_dir: Optional[str] = None,
                 synthetic_kwargs: Optional[Dict] = None,
                 reference_parity: bool = False):
        self.runner = runner
        self.tokenizer = tokenizer or ByteTokenizer()
        self.output_dir = output_dir
        self.max_length = max_length
        self.data_dir = data_dir
        self.synthetic_kwargs = synthetic_kwargs or {}
        # reference_parity=True scores F1/EM with the reference's exact
        # formulas (set-overlap F1, article-keeping normalize, empty->0.0 —
        # eval/metrics.py docstring) for BASELINE.md-comparable numbers.
        self.reference_parity = reference_parity

    # -- generation ---------------------------------------------------------

    def generate_response(self, prompt: str) -> Dict[str, Any]:
        ids = encode_ids(self.tokenizer, prompt)
        ids = truncate_middle(ids, self.max_length)
        bucket = pick_bucket(len(ids), self.max_length)
        length = len(ids)
        arr = jnp.asarray(ids + [0] * (bucket - length), jnp.int32)[None]
        eos = getattr(self.tokenizer, "eos_token_id", None)
        out = self.runner.generate(arr, eos_token_id=eos,
                                   lengths=jnp.asarray([length], jnp.int32))
        out["context_length"] = length
        text = decode_ids(self.tokenizer, [int(t) for t in out["tokens"][0]])
        out["response"] = text.strip()
        return out

    # -- metrics routing (longbench_eval.py:236-262) ------------------------

    def _sample_metrics(self, task: TaskSpec, response: str,
                        answers: List[str]) -> Dict[str, float]:
        out: Dict[str, float] = {}
        parity = self.reference_parity
        f1_fn = functools.partial(M.f1_score, reference_parity=parity)
        em_fn = functools.partial(M.exact_match, reference_parity=parity)
        for m in task.metrics:
            if m == "f1":
                out["f1"] = M.best_over_ground_truths(f1_fn, response,
                                                      answers)
            elif m == "em":
                out["em"] = M.best_over_ground_truths(em_fn, response,
                                                      answers)
            elif m == "accuracy":
                out["accuracy"] = M.best_over_ground_truths(
                    M.accuracy_score, response, answers)
            elif m.startswith("rouge"):
                if "rouge1" not in out:
                    best = {"rouge1": 0.0, "rouge2": 0.0, "rougeL": 0.0}
                    for a in answers:
                        r = M.rouge_scores(response, a)
                        for k in best:
                            best[k] = max(best[k], r[k])
                    out.update(best)
        # Headline quality score: F1 where defined, else ROUGE-L, else acc.
        out["quality"] = out.get("f1", out.get("rougeL",
                                               out.get("accuracy", 0.0)))
        return out

    # -- task loop (longbench_eval.py:165-234) ------------------------------

    def _record(self, i, sample, task, gen) -> Dict[str, Any]:
        answers = extract_answers(sample, task)
        sm = self._sample_metrics(task, gen["response"], answers)
        rec = {
            "sample_idx": i,
            "response": gen["response"][:2000],
            "answers": answers[:4],
            "metrics": sm,
            "ttft": gen["ttft"],
            "tokens_per_second": gen["tokens_per_second"],
            "context_length": gen["context_length"],
        }
        if "compression" in gen:
            c = gen["compression"]
            rec["compression_ratio"] = c.get("avg_compression_ratio")
            rec["memory_savings"] = c.get("avg_memory_savings")
            rec["cumulative_compression"] = c.get("cumulative_compression")
            rec["precision_distribution"] = c.get("precision_distribution")
        return rec

    def _evaluate_batched(self, task, samples, batch_size) -> List[Dict]:
        """Group samples by padding bucket and run ragged batches — each
        batch is one prefill + one scanned decode (the reference ran eager
        PyTorch one sample at a time)."""
        eos = getattr(self.tokenizer, "eos_token_id", None)
        prepared = []  # (idx, bucket, length, ids)
        details: List[Dict] = []
        for i, sample in enumerate(samples):
            try:
                ids = encode_ids(self.tokenizer, format_prompt(task, sample))
                ids = truncate_middle(ids, self.max_length)
                bucket = pick_bucket(len(ids), self.max_length)
                prepared.append((i, bucket, len(ids), ids))
            except Exception as e:
                details.append({"sample_idx": i, "error": repr(e)})
        by_bucket: Dict[int, List] = {}
        for item in prepared:
            by_bucket.setdefault(item[1], []).append(item)
        for bucket, items in sorted(by_bucket.items()):
            for c0 in range(0, len(items), batch_size):
                chunk = items[c0:c0 + batch_size]
                try:
                    arr = jnp.asarray(
                        [ids + [0] * (bucket - ln) for _, _, ln, ids in chunk],
                        jnp.int32)
                    lengths = jnp.asarray([ln for _, _, ln, _ in chunk],
                                          jnp.int32)
                    gen = self.runner.generate(arr, eos_token_id=eos,
                                               lengths=lengths)
                    for row, (i, _, ln, _) in enumerate(chunk):
                        text = decode_ids(self.tokenizer,
                                          [int(t) for t in
                                           gen["tokens"][row]])
                        g = dict(gen, response=text.strip(),
                                 context_length=ln)
                        details.append(self._record(i, samples[i], task, g))
                except Exception as e:
                    details.extend({"sample_idx": i, "error": repr(e)}
                                   for i, _, _, _ in chunk)
        details.sort(key=lambda d: d["sample_idx"])
        return details

    def evaluate_task(self, task_name: str, max_samples: int = 8,
                      batch_size: int = 1) -> Dict[str, Any]:
        task = LONGBENCH_TASKS[task_name]
        samples = load_task_data(task_name, self.data_dir, max_samples,
                                 synthetic_kwargs=self.synthetic_kwargs)
        if batch_size > 1:
            details = self._evaluate_batched(task, samples, batch_size)
        else:
            details = []
            for i, sample in enumerate(samples):
                try:
                    prompt = format_prompt(task, sample)
                    gen = self.generate_response(prompt)
                    details.append(self._record(i, sample, task, gen))
                except Exception as e:  # per-sample skip
                    details.append({"sample_idx": i, "error": repr(e)})

        ok = [d for d in details if "error" not in d]
        agg = M.aggregate_metrics([d["metrics"] for d in ok])
        result = {
            "task": task_name,
            "task_type": task.task_type,
            "num_samples": len(samples),
            "num_evaluated": len(ok),
            "metrics": agg,
            "avg_ttft": (sum(d["ttft"] for d in ok) / len(ok)) if ok else 0,
            "avg_tokens_per_second": (sum(d["tokens_per_second"]
                                          for d in ok) / len(ok)) if ok else 0,
            "details": details,
        }
        if ok and "compression_ratio" in ok[0]:
            result["avg_compression_ratio"] = sum(
                d["compression_ratio"] for d in ok) / len(ok)
            result["avg_memory_savings"] = sum(
                d["memory_savings"] for d in ok) / len(ok)
        if self.output_dir:
            save_json(os.path.join(self.output_dir,
                                   f"{task_name}_detailed_results.json"),
                      result)
        return result

    def evaluate_all_tasks(self, tasks: Optional[Sequence[str]] = None,
                           max_samples: int = 8,
                           batch_size: int = 1) -> Dict[str, Any]:
        tasks = list(tasks or CORE_TASKS)
        per_task: Dict[str, Any] = {}
        for t in tasks:
            try:
                per_task[t] = self.evaluate_task(t, max_samples, batch_size)
            except Exception as e:  # per-task skip (longbench_eval.py:337)
                per_task[t] = {"task": t, "error": repr(e)}
        ok = {k: v for k, v in per_task.items() if "error" not in v}
        overall = {
            "tasks_evaluated": len(ok),
            "overall_quality_score": (sum(v["metrics"].get("quality", 0.0)
                                          for v in ok.values()) / len(ok))
                                     if ok else 0.0,
            "avg_tokens_per_second": (sum(v["avg_tokens_per_second"]
                                          for v in ok.values()) / len(ok))
                                     if ok else 0.0,
            "avg_ttft": (sum(v["avg_ttft"] for v in ok.values()) / len(ok))
                        if ok else 0.0,
        }
        if ok and any("avg_compression_ratio" in v for v in ok.values()):
            cr = [v["avg_compression_ratio"] for v in ok.values()
                  if "avg_compression_ratio" in v]
            ms = [v["avg_memory_savings"] for v in ok.values()
                  if "avg_memory_savings" in v]
            overall["overall_avg_compression_ratio"] = sum(cr) / len(cr)
            overall["overall_avg_memory_savings"] = sum(ms) / len(ms)
        results = {"per_task": per_task, "overall": overall}
        if self.output_dir:
            save_json(os.path.join(self.output_dir,
                                   "comprehensive_evaluation_results.json"),
                      results)
        return results
