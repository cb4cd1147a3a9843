"""Time each hand-written kernel against what XLA (or cuDNN) makes of the
plain version, on the GPU, at Mistral-7B attention widths.

    python scripts/kernel_timing.py [--out kernel_timing.json]

Every host time is the median over repeated calls of one jitted function,
on the host clock around `block_until_ready`, after a warm-up call. The
decode rows (one layer, the row-block/program-count sweep that chose the
decode kernel's defaults, and whole decode steps) also carry the device
time per call, summed from a profiler trace of the card's streams: at
~100 µs a call the host clock measures dispatch as much as the kernel.
Prints one line per comparison and writes all numbers, with the card's
name and power limit, to --out. The decisions in PERF.md ("Kernel
decisions on the H100") come from this script.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from realtime_kv_cache_compression_tpu.utils.compile_cache import (  # noqa
    enable_compile_cache)
from realtime_kv_cache_compression_tpu.utils.device import (  # noqa: E402
    card_info, require_gpu)


def bench(fn, *args, reps=20):
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def rnd(key, shape, dtype=jnp.bfloat16):
    return jax.random.normal(key, shape, jnp.float32).astype(dtype)


def attention_flops(hq, d, rows, keys_seen):
    return 4.0 * hq * d * rows * keys_seen


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="kernel_timing.json")
    args = ap.parse_args()
    dev = require_gpu()
    enable_compile_cache()
    card = card_info()
    print(f"card: {card}; device {dev}", flush=True)
    res = {"card": card, "device": dev, "rows": []}

    def row(name, **kw):
        kw["name"] = name
        res["rows"].append(kw)
        print(json.dumps(kw), flush=True)

    from realtime_kv_cache_compression_tpu.ops import attention as ref
    from realtime_kv_cache_compression_tpu.ops.pallas import flash_prefill as fp

    keys = iter(jax.random.split(jax.random.PRNGKey(0), 256))
    p = 128

    # Roofline context: what a large copy and a large bf16 GEMM reach here.
    x = rnd(next(keys), (1 << 28,))
    t = bench(jax.jit(lambda a: a * 2), x)
    row("copy 512 MiB", ms=t * 1e3, gb_s=2 * x.nbytes / t / 1e9)
    a, b = rnd(next(keys), (8192, 8192)), rnd(next(keys), (8192, 8192))
    t = bench(jax.jit(jnp.dot), a, b)
    row("bf16 GEMM 8192^3", ms=t * 1e3, tflop_s=2 * 8192 ** 3 / t / 1e12)
    del x, a, b

    for hq, hkv, d in ((32, 8, 128), (32, 4, 64)):
        s = 4096
        q, k, v = (rnd(next(keys), (1, s, h, d)) for h in (hq, hkv, hkv))
        fl = attention_flops(hq, d, s, s / 2)
        for impl in ("cudnn", "triton"):
            f = jax.jit(lambda q, k, v, impl=impl:
                        fp.flash_prefill_with_prompt_mass(q, k, v, p,
                                                          impl=impl))
            t = bench(f, q, k, v)
            row(f"square S={s} H={hq}/{hkv} d={d} [{impl}]",
                ms=t * 1e3, tflop_s=fl / t / 1e12)
        f = jax.jit(lambda q, k, v: fp._attention_with_lse(
            q, k, v, "cudnn"))
        t = bench(f, q, k, v)
        row(f"square S={s} H={hq}/{hkv} d={d} [cudnn attention only]",
            ms=t * 1e3, tflop_s=fl / t / 1e12)
        f = jax.jit(lambda q, k, v: ref.prefill_attention_with_prompt_mass(
            q, k, v, p))
        t = bench(f, q, k, v, reps=5)
        row(f"square S={s} H={hq}/{hkv} d={d} [xla dense]", ms=t * 1e3,
            tflop_s=fl / t / 1e12)

    hq, hkv, d = 32, 8, 128
    for c, n in ((4096, 4096), (4096, 32768)):
        q = rnd(next(keys), (1, c, hq, d))
        k, v = (rnd(next(keys), (1, n, hkv, d)) for _ in range(2))
        off = jnp.int32(n - c)
        fl = attention_flops(hq, d, c, n - c / 2)
        f = jax.jit(fp.flash_chunk_attention_with_prompt_mass,
                    static_argnums=4)
        t = bench(f, q, k, v, off, p)
        row(f"chunk c={c} N={n} [triton]", ms=t * 1e3,
            tflop_s=fl / t / 1e12)
        if n <= 4096:
            f = jax.jit(ref.chunk_attention_with_prompt_mass,
                        static_argnums=4)
            t = bench(f, q, k, v, off, p, reps=5)
            row(f"chunk c={c} N={n} [xla dense]", ms=t * 1e3,
                tflop_s=fl / t / 1e12)
    c, n = 1024, 8192
    q = rnd(next(keys), (1, c, hq, d))
    k, v = (rnd(next(keys), (1, n, hkv, d)) for _ in range(2))
    kpos = jax.random.permutation(next(keys), 2 * n)[:n][None].astype(
        jnp.int32)
    valid = jax.random.uniform(next(keys), (1, n)) > 0.25
    off = jnp.int32(2 * n - c)
    f = jax.jit(fp.flash_positioned_attention, static_argnums=5)
    t = bench(f, q, k, v, jnp.where(valid, kpos, fp.POS_SENTINEL), off, p)
    fl = attention_flops(hq, d, c, n)
    row(f"positioned c={c} N={n} [triton]", ms=t * 1e3,
        tflop_s=fl / t / 1e12)
    qpos = (2 * n - c + jnp.arange(c))[None]
    f = jax.jit(ref.positioned_attention_with_prompt_mass,
                static_argnums=6)
    t = bench(f, q, k, v, kpos, valid, qpos, p, reps=5)
    row(f"positioned c={c} N={n} [xla dense]", ms=t * 1e3,
        tflop_s=fl / t / 1e12)
    c = n = 4096
    q = rnd(next(keys), (1, c, hq, d))
    k, v = (rnd(next(keys), (1, n, hkv, d)) for _ in range(2))
    fl = attention_flops(hq, d, c, n)
    f = jax.jit(fp.flash_pair_attention, static_argnums=4)
    t = bench(f, q, k, v, jnp.full((1,), p, jnp.int32), False)
    row(f"pair non-causal {c}x{n} [triton]", ms=t * 1e3,
        tflop_s=fl / t / 1e12)
    allv = jnp.ones((1, n), bool)
    f = jax.jit(lambda q, k, v: ref.positioned_attention_with_prompt_mass(
        q, k, v, jnp.arange(n)[None], allv, jnp.full((1, c), n), p))
    t = bench(f, q, k, v, reps=5)
    row(f"pair non-causal {c}x{n} [xla dense]", ms=t * 1e3,
        tflop_s=fl / t / 1e12)

    decode_rows(row, keys)
    decode_e2e(row, keys)
    from realtime_kv_cache_compression_tpu.models.quantized_params import (
        quantize_tensor)
    from realtime_kv_cache_compression_tpu.ops.int8_matmul import (
        dynamic_int8_matmul)
    for m in (8, 256):
        x = rnd(next(keys), (m, 4096))
        w = rnd(next(keys), (4096, 14336))
        qt = quantize_tensor(w, axis=1)
        t_bf = bench(jax.jit(jnp.dot), x, w)
        t_w8 = bench(jax.jit(lambda x, q, s: dynamic_int8_matmul(x, q, s)),
                     x, qt.q, qt.scale)
        t_wo = bench(jax.jit(lambda x, q, s: (jnp.dot(
            x, q.astype(x.dtype), preferred_element_type=jnp.float32)
            * s).astype(x.dtype)), x, qt.q, qt.scale)
        row(f"matmul [{m},4096]x[4096,14336]", bf16_ms=t_bf * 1e3,
            w8a8_ms=t_w8 * 1e3, w8_weight_only_ms=t_wo * 1e3,
            weight_bytes_bf16=w.nbytes)
    int4_trace(row, keys)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)


def _decode_state(b, s, mcfg, ccfg, key):
    from realtime_kv_cache_compression_tpu.compression import (
        append_recent, compress_layer_kv, init_recent_cache)
    ks = jax.random.split(key, 3)
    k = rnd(ks[0], (b, s, mcfg.num_kv_heads, mcfg.head_dim))
    v = rnd(ks[1], (b, s, mcfg.num_kv_heads, mcfg.head_dim))
    mass = jax.random.uniform(ks[2], (b, s))
    cache, _ = jax.jit(lambda k, v, m: compress_layer_kv(
        k, v, m, 0, ccfg, mcfg))(k, v, mass)
    recent = init_recent_cache(b, 64, mcfg)
    for i in range(16):
        recent = append_recent(recent, k[:, i:i + 1], v[:, i:i + 1],
                               jnp.full((b, 1), s + i, jnp.int32))
    return cache, recent


def rate(nbytes, seconds):
    """GB/s, or None where the trace held no device time."""
    return nbytes / seconds / 1e9 if seconds else None


def cache_bytes(cache, recent):
    leaves = jax.tree_util.tree_leaves((cache, recent))
    return sum(x.nbytes for x in leaves)


# (ROW_BLOCK, TARGET_PROGRAMS) pairs swept for the decode kernel; the
# module's defaults are the pair that won here.
DECODE_SWEEP = ((64, 264), (32, 264), (64, 528), (128, 264))


def decode_rows(row, keys):
    from realtime_kv_cache_compression_tpu import CompressionConfig, MISTRAL_7B
    from realtime_kv_cache_compression_tpu.compression import (
        dequantize_layer_cache)
    from realtime_kv_cache_compression_tpu.ops.attention import (
        attention_over_tokens)
    from realtime_kv_cache_compression_tpu.ops.pallas import (
        decode_attention as da)

    mcfg = MISTRAL_7B
    ccfg = CompressionConfig(num_layers=32)
    defaults = (da.ROW_BLOCK, da.TARGET_PROGRAMS)
    for b, s in ((1, 4096), (8, 32768)):
        cache, recent = _decode_state(b, s, mcfg, ccfg, next(keys))
        q = rnd(next(keys), (b, 1, 32, 128))
        q_pos = jnp.full((b, 1), s + 16, jnp.int32)

        def xla(q, cache, recent):
            k_c, v_c, pos_c, valid_c = dequantize_layer_cache(cache, ccfg,
                                                              q.dtype)
            live = jnp.arange(recent.capacity)[None] < recent.length[:, None]
            return attention_over_tokens(
                q, jnp.concatenate([k_c, recent.k], 1),
                jnp.concatenate([v_c, recent.v], 1),
                jnp.concatenate([pos_c, recent.positions], 1),
                jnp.concatenate([valid_c, live], 1), q_pos)

        nbytes = cache_bytes(cache, recent)
        for rb, progs in DECODE_SWEEP:
            # The kernel reads both at trace time; a new jit retraces.
            da.ROW_BLOCK, da.TARGET_PROGRAMS = rb, progs
            f = jax.jit(lambda q, c, r: da.fused_decode_attention(
                q, c, r, q_pos, ccfg))
            t_k = bench(f, q, cache, recent)
            dev_k, _ = device_time(f, q, cache, recent)
            row(f"decode layer B={b} ctx={s} [triton rb={rb} progs={progs}]",
                host_us=t_k * 1e6, device_us=dev_k * 1e6,
                packed_bytes=nbytes, device_gb_s=rate(nbytes, dev_k))
        da.ROW_BLOCK, da.TARGET_PROGRAMS = defaults
        f = jax.jit(xla)
        t_x = bench(f, q, cache, recent)
        dev_x, _ = device_time(f, q, cache, recent)
        row(f"decode layer B={b} ctx={s} [xla dequant]", host_us=t_x * 1e6,
            device_us=dev_x * 1e6, packed_bytes=nbytes,
            device_gb_s=rate(nbytes, dev_x))


def decode_e2e(row, keys):
    """Decode steps of a 4-layer Mistral-width model, fused vs XLA."""
    from realtime_kv_cache_compression_tpu import CompressionConfig, MISTRAL_7B
    from realtime_kv_cache_compression_tpu.models import llama

    mcfg = dataclasses.replace(MISTRAL_7B, num_layers=4)
    ccfg = CompressionConfig(num_layers=4)
    params = llama.init_params(jax.random.PRNGKey(1), mcfg)
    steps = 32
    for b, s in ((1, 4096), (8, 32768)):
        ids = jax.random.randint(next(keys), (b, s), 0, mcfg.vocab_size)
        logits, state, _ = jax.jit(lambda p, i: llama.prefill_compressed(
            p, i, mcfg, ccfg, max_decode_len=64, use_flash=True))(params, ids)
        tok = jnp.argmax(logits, axis=-1)
        out = {}
        for fused in (True, False):
            f = jax.jit(lambda p, t, st, fused=fused: llama.decode_loop(
                p, t, st, steps, mcfg, ccfg, use_fused=fused)[0])
            host = bench(f, params, tok, state, reps=5) / steps
            dev, top = device_time(f, params, tok, state, reps=3)
            out[fused] = (host, dev / steps, top)
        row(f"decode loop 4 layers B={b} ctx={s}",
            fused_host_ms_per_step=out[True][0] * 1e3,
            fused_device_ms_per_step=out[True][1] * 1e3,
            xla_host_ms_per_step=out[False][0] * 1e3,
            xla_device_ms_per_step=out[False][1] * 1e3,
            fused_top_ops_us_per_step=[(k, v / steps)
                                       for k, v in out[True][2]],
            xla_top_ops_us_per_step=[(k, v / steps)
                                     for k, v in out[False][2]])


def int4_trace(row, keys):
    """One int4 batch-1 decode step at Mistral-7B widths (2 layers): does
    XLA keep the nibble unpack inside the dot, or write the unpacked
    weight? Read from the compiled step's temp buffers and its trace."""
    from realtime_kv_cache_compression_tpu import CompressionConfig, MISTRAL_7B
    from realtime_kv_cache_compression_tpu.models import llama
    from realtime_kv_cache_compression_tpu.models.quantized_params import (
        quantize_params)

    mcfg = dataclasses.replace(MISTRAL_7B, num_layers=2)
    ccfg = CompressionConfig(num_layers=2)
    params = llama.init_params(jax.random.PRNGKey(2), mcfg)
    ids = jax.random.randint(next(keys), (1, 512), 0, mcfg.vocab_size)
    for bits in (16, 8, 4):
        p = params if bits == 16 else quantize_params(params, bits=bits)
        logits, state, _ = jax.jit(lambda p, i: llama.prefill_compressed(
            p, i, mcfg, ccfg, max_decode_len=8))(p, ids)
        tok = jnp.argmax(logits, axis=-1)
        step = jax.jit(lambda p, t, s: llama.decode_step(p, t, s, mcfg,
                                                         ccfg)[0])
        comp = step.lower(p, tok, state).compile()
        mem = comp.memory_analysis()
        t = bench(comp, p, tok, state)
        wbytes = sum(x.nbytes for x in jax.tree_util.tree_leaves(
            p["layers"]))
        row(f"decode step 2 layers weights={bits}-bit B=1", ms=t * 1e3,
            layer_weight_bytes=wbytes,
            temp_bytes=getattr(mem, "temp_size_in_bytes", None),
            gb_s_layer_weights=wbytes / t / 1e9)
        if bits == 4:
            _, top = device_time(comp, p, tok, state, reps=3)
            row("int4 decode step trace: top device ops (us per step)",
                ops=top)


def device_time(fn, *args, reps=10, n_top=12):
    """(device seconds per call, top device ops as [name, µs per call])
    from a profiler trace of `reps` calls: kernel time summed over the
    card's streams, so the host's dispatch gaps are not counted."""
    import glob
    import shutil
    import tempfile

    jax.block_until_ready(fn(*args))
    d = tempfile.mkdtemp()
    try:
        with jax.profiler.trace(d):
            for _ in range(reps):
                jax.block_until_ready(fn(*args))
        path = glob.glob(os.path.join(d, "plugins", "profile", "*",
                                      "*.xplane.pb"))[0]
        pd = jax.profiler.ProfileData.from_file(path)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    tot = {}
    for plane in pd.planes:
        if "/device:GPU" not in plane.name:
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                tot[ev.name] = tot.get(ev.name, 0) + ev.duration_ns
    total_s = sum(tot.values()) / 1e9 / reps
    top = sorted(((k, v / 1e3 / reps) for k, v in tot.items()),
                 key=lambda kv: -kv[1])[:n_top]
    return total_s, top


if __name__ == "__main__":
    main()
