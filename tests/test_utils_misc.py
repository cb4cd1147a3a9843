"""Coverage for remaining utilities: checkpointing, profiling, memory, BLEU,
timing."""

import os

import jax
import jax.numpy as jnp
import numpy as np

from realtime_kv_cache_compression_tpu import tiny_test_model
from realtime_kv_cache_compression_tpu.eval import metrics as M
from realtime_kv_cache_compression_tpu.models import checkpoint, llama
from realtime_kv_cache_compression_tpu.utils import memory as mem
from realtime_kv_cache_compression_tpu.utils import profiling, timing


def test_checkpoint_roundtrip(tmp_path):
    cfg = tiny_test_model(num_layers=1)
    params = llama.init_params(jax.random.PRNGKey(0), cfg)
    path = str(tmp_path / "ckpt")
    checkpoint.save_checkpoint(path, params)
    restored = checkpoint.load_checkpoint(path, template=params)
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bleu_score():
    assert M.bleu_score("the cat sat", "the cat sat") > 0.5
    assert M.bleu_score("zzz", "the cat sat") < 0.2


def test_quality_adjusted_savings():
    assert M.quality_adjusted_savings(0.8, 0.95, 0.05) == \
        np.float64(0.8 * 0.95 - 0.05)


def test_memory_monitor_samples():
    m = mem.MemoryMonitor(interval_s=0.01)
    m.start()
    _ = jnp.ones((64, 64)) @ jnp.ones((64, 64))
    summary = m.stop()
    assert summary["num_samples"] >= 1
    assert summary["peak_rss_mb"] >= 0


def test_memory_estimators():
    cfg = tiny_test_model(num_layers=1)
    params = llama.init_params(jax.random.PRNGKey(0), cfg)
    assert mem.model_footprint_mb(params) > 0
    assert mem.kv_cache_bytes(1, 128, 2, 2, 16) == 2 * 128 * 2 * 2 * 16 * 2


def test_profiling_trace_and_annotation(tmp_path):
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir):
        with profiling.annotate("test-region"):
            _ = (jnp.ones((32, 32)) @ jnp.ones((32, 32))).block_until_ready()
    # A trace directory with content was produced.
    found = any(files for _, _, files in os.walk(log_dir))
    assert found


def test_timing_helpers():
    calls = []

    def work():
        calls.append(1)
        return jnp.ones((8, 8)).sum()

    dt, out = timing.timed(work, reps=2)
    assert dt > 0 and float(out) == 64.0 and len(calls) == 2
